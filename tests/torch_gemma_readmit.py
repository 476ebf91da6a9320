"""The re-admitted slot of tests/test_torch_gemma.py's BatchEngine runs,
taken apart: how far the port and the JAX package part on its rows, on
packed bf16 and on dense f32, after a freed slot and on fresh engines; and
after how many layers of one forward they part (each package's gemma
forward cut to its first L layers, full cache and ring, the last prompt
row's and the next decode step's final hidden state).

    JAX_PLATFORMS=cpu TPULLM_DEVICE_REPACK=1 python tests/torch_gemma_readmit.py

Prints NMSEs; asserts nothing (the tests hold the bounds)."""

import os
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))
os.environ.setdefault("TPULLM_DEVICE_REPACK", "1")

import test_torch_gemma as G  # noqa: E402
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine  # noqa: E402

from tpullm_torch.models.synth import make_synthetic_llama_gguf  # noqa: E402
from tpullm_torch.runtime.batch_engine import BatchEngine  # noqa: E402


def _engines(path, kind):
    if kind == "f32":
        return (BatchEngine(path, device="cpu", mode="dense", dtype=torch.float32,
                            kv_dtype=torch.float32, **G._BATCH_KW),
                JBatchEngine(path, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                             **G._BATCH_KW))
    return (BatchEngine(path, device="cpu", **G._BATCH_KW),
            JBatchEngine(path, kv_dtype=jnp.bfloat16, **G._BATCH_KW))


def batch_rows(path):
    for kind in ("bf16", "f32"):
        te, je = _engines(path, kind)
        got, want = G._batch_ring_rows(te)[1], G._batch_ring_rows(je)[1]
        after = [G._nmse(a, b) for (s, a), (_, b) in zip(got, want) if s == 2]
        fresh = [G._nmse(a, b) for a, b in zip(*(G._fresh_slot_rows(e)
                                                 for e in _engines(path, kind)))]
        print(f"{kind}: slot 2 re-admitted, port against JAX (prefill, step 307, step 308): "
              f"{[f'{x:.2e}' for x in after]}; fresh engines {[f'{x:.2e}' for x in fresh]}")


def layer_split(path, n_prompt: int):
    print(f"hidden NMSE, port against JAX, after L layers ({n_prompt}-token prompt; "
          "last prompt row, decode step 307):")
    for cache_kind in ("full", "ring"):
        for L in range(1, 7):
            line = []
            for dt, mode in (("bf16", "auto"), ("f32", "dense")):
                hp, params, jhp, jparams = G._params(path, mode, dt)
                hp, jhp = replace(hp, n_layer=L), replace(jhp, n_layer=L)
                params = dict(params, layers=params["layers"][:L])
                jparams = dict(jparams, layers=jparams["layers"][:L])
                cache, jcache = G._caches(hp, jhp, cache_kind, dt)
                errs, n0 = [], 0
                for toks in (G._ids(n_prompt, 9), [307]):
                    pos = np.arange(n0, n0 + len(toks), dtype=np.int32)[None]
                    with torch.inference_mode():
                        h, cache = G.gemma.forward(hp, params, torch.tensor([toks]),
                                                   torch.from_numpy(pos), cache, n0,
                                                   return_hidden=True)
                    jh, jcache = G.jgemma.forward(jhp, jparams, jnp.asarray([toks]),
                                                  jnp.asarray(pos), jcache, n0,
                                                  return_hidden=True)
                    errs.append(G._nmse(h.float().numpy()[:, -1], np.asarray(jh)[:, -1]))
                    n0 += len(toks)
                line.append(f"{dt} {errs[0]:.2e} {errs[1]:.2e}")
            print(f"  {cache_kind} L={L}: " + "; ".join(line))


if __name__ == "__main__":
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        p = make_synthetic_llama_gguf(Path(d) / "tiny-gemma3.gguf", shape="tiny-gemma3",
                                      seed=0)
        batch_rows(p)
        for n in (9, 5):
            layer_split(p, n)
