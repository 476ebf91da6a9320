"""How the synthetic BLOOM and GPT-2 amplify rounding with depth, in both
packages (tests/torch_phi2_depth.py's measurement for the ALiBi family and
gpt2).

For the port's `tiny-bloom`, `tiny-gpt2` and, as the control, `tiny`
(a llama) at 2, 8 and 30 layers, a 40-token prompt's last-row logits:
packed Q4_K_M planes against dense bf16 weights, in the port and in the
JAX package, and the port against the JAX package on each. A gap that
grows with depth in both packages is the random model's sensitivity to
rounding, not a fault of either; `chip_smoke.py` sizes its BLOOM-7B1
checks by it. Not a test: run it on the CPU from the repository root
(about 2 min):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_alibi_depth.py
"""

import os
import tempfile

import numpy as np
import torch

os.environ.setdefault("TPULLM_DEVICE_REPACK", "1")

import jax.numpy as jnp  # noqa: E402

from tpullm.runtime.engine import Engine as JEngine  # noqa: E402

from tpullm_torch.models.synth import make_synthetic_llama_gguf  # noqa: E402
from tpullm_torch.runtime.engine import Engine  # noqa: E402


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / np.mean(ref * ref))


def main():
    ids = [int(t) for t in np.random.default_rng(0).integers(5, 370, size=40)]
    with tempfile.TemporaryDirectory() as d:
        for shape in ("tiny-bloom", "tiny-gpt2", "tiny"):
            for n_layer in (2, 8, 30):
                path = make_synthetic_llama_gguf(f"{d}/{shape}-{n_layer}.gguf", shape=shape,
                                                 seed=0, n_layer=n_layer)
                packed = Engine(path, device="cpu", max_seq=64).prefill(ids)
                dense = Engine(path, device="cpu", max_seq=64, mode="dense").prefill(ids)
                j_packed = JEngine(path, max_seq=64, kv_dtype=jnp.bfloat16).prefill(ids)
                j_dense = JEngine(path, max_seq=64, mode="dense",
                                  kv_dtype=jnp.bfloat16).prefill(ids)
                print(f"{shape} {n_layer:2d} layers: packed vs dense NMSE port "
                      f"{_nmse(packed, dense):.2e}, JAX {_nmse(j_packed, j_dense):.2e}; port "
                      f"vs JAX packed {_nmse(packed, j_packed):.2e}, dense "
                      f"{_nmse(dense, j_dense):.2e}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    main()
