"""tpullm-torch-fit-params: the largest context (and slots) whose cache fits
the card beside the weights (llama_params_fit, tools/fit-params; the JAX
package's runtime/fit.py), from the GGUF's tensor index, without loading the
model.

    python -m tpullm_torch.runtime.fit -m model.gguf -c 32768 -np 1

The JAX tool's flags, fields and rule: a 15 % reserve of the memory for
activations and scratch, slots shed before context when a slot would get
less than 256 positions, the context rounded down to 256. Where the port's
inputs differ from the JAX tool's:
  * the memory is the card's free memory (torch.cuda.mem_get_info), not a
    TPU's 16 GiB default (--hbm-gb sets it, and must on the CPU);
  * the weight bytes are what the port's loader makes (models/weights.py):
    for a quantized linear or expert stack its planes (codes one byte a
    plane row, scale and minus in bf16: ops/kernels/qmm.py `_plane_rows`),
    an expert stack no kernel takes dequantized to bf16, every other 2-D
    tensor (the embedding table, a float linear) in bf16, a vector in f32;
    the JAX tool counts the file's bytes times a plane overhead of 1.45
    measured on a TPU, and a float tensor at its file size;
  * the cache bytes a position are those of the cache the port's Engine
    makes for the arch and --kv-type (built on the meta device:
    runtime/kvcache.py, an MLA latent for deepseek2, the iSWA ring for
    gemma2/gemma3, sized at the wanted context), where the JAX tool counts
    2·Hkv·D bytes a layer for bf16 and half for q8 (the port's q8 cache
    also keeps an f32 scale a vector: 2·D·Hkv + 8·Hkv);
  * a recurrent model's state is counted a slot (`state_bytes_per_slot`:
    runtime/recurrent.py RecurrentCache's f32 conv tail and scan state of
    every layer; a hybrid's (models/jamba.py HybridCache) of its mixer
    layers only, beside K/V of its attention layers only), where the JAX
    tool counts K/V at full depth and no state.
The rule gives an Engine's weights and cache, not the load's transients
(a tensor's repack) nor a forward's activations: the reserve holds those.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass

import torch

from ..gguf.constants import TYPE_TRAITS
from ..gguf.reader import GGUFReader
from ..models.registry import get_arch, load_hparams
from ..ops import qmatmul

RESERVE_FRAC = 0.15  # activations and scratch headroom (the JAX tool's)
ALIGN = 256  # the fitted context is a multiple of this


@dataclass
class FitResult:
    weight_bytes: int
    kv_bytes_per_token: int
    max_seq: int
    n_slots: int
    fits: bool
    state_bytes_per_slot: int = 0  # a recurrent model's state a sequence

    @property
    def predicted_bytes(self) -> int:
        """The weights and the cache (of n_slots rows) at the fitted context:
        what the rule sets beside the reserve."""
        return self.weight_bytes + (self.kv_bytes_per_token * self.max_seq
                                    + self.state_bytes_per_slot) * self.n_slots


def linear_bytes(gtype, n_in: int, n_out: int) -> int:
    """The bytes of a quantized [n_in, n_out] weight's planes on the device."""
    from ..ops.kernels import qmm

    rows = qmm._plane_rows(gtype, n_in)
    return sum(r * n_out * (2 if name in ("scale", "minus") else 1) for name, r in rows.items())


def weight_bytes(r: GGUFReader) -> int:
    """The bytes of the weights the port's loader puts on the device."""
    from ..ops.kernels import qmm

    total = 0
    for info in r.tensors.values():
        shape = tuple(info.shape)
        n = 1
        for d in shape:
            n *= d
        if len(shape) == 1 or (len(shape) == 2 and 1 in shape):
            total += 4 * n  # a vector, f32 (load_vector)
        elif not TYPE_TRAITS[info.ggml_type].is_quantized or info.name == "token_embd.weight":
            total += 2 * n  # a float linear or the embedding table, bf16
        elif not qmatmul.supports(info.ggml_type):
            raise NotImplementedError(f"{info.name}: {info.ggml_type.name} is not ported")
        elif len(shape) == 3:  # an expert stack (n_in, n_out, E)
            n_in, n_out, n_exp = shape
            total += (n_exp * linear_bytes(info.ggml_type, n_in, n_out)
                      if qmm.takes(n_in, n_out) else 2 * n)
        else:
            total += linear_bytes(info.ggml_type, shape[0], shape[1])
    return total


def cache_bytes(r: GGUFReader, kv_type, max_seq: int, n_slots: int = 1) -> int:
    """The bytes of the cache the port's Engine makes for `kv_type` (a
    torch dtype or "f16", "bf16", "f32", "q8_0") at max_seq positions and
    n_slots batch rows, built on the meta device."""
    from .kvcache import SWACache, make_cache, takes_ring

    hp = load_hparams(r)
    arch = get_arch(r.architecture)
    if takes_ring(arch.iswa, hp, kv_type, max_seq):
        dtype = ({"f16": torch.float16, "bf16": torch.bfloat16, "f32": torch.float32}[kv_type]
                 if isinstance(kv_type, str) else kv_type)
        cache = SWACache.new(hp, n_slots, max_seq, dtype, max_chunk=min(max_seq, 1024),
                             device="meta")
    else:
        cache = (arch.make_cache or make_cache)(hp, n_slots, max_seq, kv_type, "meta")
    return sum(t.nbytes for t in vars(cache).values() if isinstance(t, torch.Tensor))


def fit_rule(weights: int, kv_per_tok: int, hbm: int, want_seq: int, want_slots: int,
             reserve_frac: float = RESERVE_FRAC, state_per_slot: int = 0) -> FitResult:
    """The JAX tool's rule: the cache takes what the reserve and the weights
    leave; slots are shed before context falls under ALIGN; the context is
    rounded down to ALIGN (or left as it is below it). A recurrent state
    (`state_per_slot`) is taken from the budget once a slot."""
    budget = int(hbm * (1.0 - reserve_frac)) - weights
    if budget <= 0:
        return FitResult(weights, kv_per_tok, 0, 0, False, state_per_slot)

    def seq(n_slots: int) -> int:
        left = budget - state_per_slot * n_slots
        return min(want_seq, max(left, 0) // max(kv_per_tok, 1) // max(n_slots, 1))

    n_slots = want_slots
    max_seq = seq(n_slots)
    while max_seq < ALIGN and n_slots > 1:  # shed slots before context
        n_slots -= 1
        max_seq = seq(n_slots)
    max_seq = max(0, (max_seq // ALIGN) * ALIGN or min(max_seq, want_seq))
    return FitResult(weights, kv_per_tok, int(max_seq), n_slots, max_seq >= ALIGN,
                     state_per_slot)


def fit_params(model_path, *, want_seq: int = 4096, want_slots: int = 1, kv_type="bf16",
               hbm_bytes: int | None = None, device=None,
               reserve_frac: float = RESERVE_FRAC) -> FitResult:
    """The largest (max_seq, n_slots) up to the wanted ones whose cache fits
    `hbm_bytes` (None: the free memory of `device`, the card by default)
    beside the weights, under the reserve."""
    from ..device import resolve_device

    if hbm_bytes is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("the CPU has no card memory to fit: give hbm_bytes (--hbm-gb)")
        hbm_bytes = int(torch.cuda.mem_get_info(dev)[0])  # the card's free memory
    r = GGUFReader(model_path)
    try:
        weights = weight_bytes(r)
        state = cache_bytes(r, kv_type, 0)  # what a sequence holds at no position
        kv_per_tok = (cache_bytes(r, kv_type, want_seq) - state) // want_seq
    finally:
        r.close()
    return fit_rule(weights, kv_per_tok, hbm_bytes, want_seq, want_slots, reserve_frac,
                    state)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpullm-torch-fit-params")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("-np", "--parallel", type=int, default=1)
    ap.add_argument("--kv-type", choices=["bf16", "f16", "f32", "q8_0"], default="bf16")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="memory to fit in GiB (default: the card's free memory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (needs --hbm-gb)")
    args = ap.parse_args(argv)
    res = fit_params(args.model, want_seq=args.ctx_size, want_slots=args.parallel,
                     kv_type=args.kv_type,
                     hbm_bytes=int(args.hbm_gb * 2**30) if args.hbm_gb else None,
                     device=args.device)
    print(f"weights (planes):   {res.weight_bytes / 2**30:.2f} GiB")
    print(f"kv bytes/token:     {res.kv_bytes_per_token}")
    if res.state_bytes_per_slot:
        print(f"state bytes/slot:   {res.state_bytes_per_slot}")
    print(f"predicted:          {res.predicted_bytes / 2**30:.2f} GiB (weights + cache)")
    print(f"fitted:             -c {res.max_seq} -np {res.n_slots}"
          + ("" if res.fits else "  (DOES NOT FIT)"))
    return 0 if res.fits else 1


if __name__ == "__main__":
    sys.exit(main())
