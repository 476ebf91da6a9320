"""The qmm kernel (fused dequantize×matmul over packed planes) and its plain
version.

Replaces tpullm/ops/pallas/qmm.py::_kernel_mat + _acc_tile (the pallas_call
in _qmm_2d, entry qmatmul), for Q4_K (`qs` + `scale` + `minus`, G = 32,
half-split U = 256) and Q6_K (wide `qw` + `scale`, G = 16). Source:
tpullm_torch/csrc/qmm.cu. What bounds it on the card: the plane bytes at
decode (M = 1) against 3.35 TB/s, the multiply-adds at prefill; the source
note says what its design does about each.

`qmm_reference` computes the same function with the same rounding points as
`_acc_tile`: x rounded to bf16, the weight rounded to bf16 after the f32
scale multiply, f32 sums, the min term through group sums of x, output in
x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ...gguf.constants import GGMLType
from ..qmatmul import _SCHEMA, plane_values
from . import _build

# launches of the kernel, by plane format; a plain count a run can read
LAUNCHES = {"Q4_K": 0, "Q6_K": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {
    GGMLType.Q4_K: ("tpullm_qmm_q4k", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    GGMLType.Q6_K: ("tpullm_qmm_q6k", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
}
_CHUNK = 256  # K rows per chunk, csrc/qmm.cu kChunk
_BLOCK_N = 512  # output columns per block, csrc/qmm.cu kBlockN


def qmm_reference(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
                  n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] → [M, N], the plain version of the kernel."""
    G = _SCHEMA[gtype]["G"]
    ng = n_in // G
    xb = x.to(torch.bfloat16).float()
    vals = plane_values(planes, gtype).reshape(ng, G, n_out)
    w = vals * planes["scale"].float().reshape(ng, 1, n_out)
    w = w.reshape(n_in, n_out).to(torch.bfloat16).float()
    acc = xb @ w
    if "minus" in planes:
        sx = xb.reshape(-1, ng, G).sum(-1)  # group sums of bf16 x, in f32
        acc = acc - sx @ planes["minus"].float()
    return acc.to(x.dtype)


def plan(M: int, K: int, N: int, n_sm: int) -> tuple[int, int, int]:
    """(rows per block, K splits, chunks per split) for an [M, K] × [K, N]
    product: enough blocks to cover the card about four times over."""
    tm = next(t for t in (1, 2, 4, 8, 16) if t >= min(M, 16))
    blocks = -(-N // _BLOCK_N) * -(-M // tm)
    n_chunks = K // _CHUNK
    split = max(1, min(n_chunks, -(-4 * n_sm // blocks)))
    per = -(-n_chunks // split)
    return tm, -(-n_chunks // per), per


def qmm(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
        n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] bf16 on the card → [M, N] bf16 through the CUDA kernel."""
    if gtype not in _ARGS:
        raise NotImplementedError(f"qmm kernel for {gtype.name} is not ported")
    codes = planes["qw" if gtype == GGMLType.Q6_K else "qs"]
    tensors = [x, codes, planes["scale"]] + ([planes["minus"]] if "minus" in planes else [])
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError("qmm: every operand must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qmm: operands must be contiguous and 16-byte aligned")
    M, K = x.shape
    N = n_out
    if K != n_in or K % _CHUNK or N % 4:
        raise ValueError(f"qmm: needs K % {_CHUNK} == 0 and N % 4 == 0, got K={K}, N={N}")
    if x.dtype != torch.bfloat16 or codes.dtype != torch.uint8 or \
            planes["scale"].dtype != torch.bfloat16:
        raise ValueError("qmm: x and scale/minus must be bf16, code planes uint8")
    G = _SCHEMA[gtype]["G"]
    rows = K // 2 if gtype == GGMLType.Q4_K else K
    if tuple(codes.shape) != (rows, N) or tuple(planes["scale"].shape) != (K // G, N):
        raise ValueError("qmm: plane shapes do not match the weight")

    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tm, split, per = plan(M, K, N, n_sm)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split if split > 1 else 0, M, N), dtype=torch.float32,
                          device=x.device)
    symbol, argtypes = _ARGS[gtype]
    fn = _build.bind("qmm", symbol, argtypes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr(), partial.data_ptr()]
    _build.check(fn(*ptrs, M, K, N, tm, split, per, stream), f"qmm {gtype.name}")
    LAUNCHES[gtype.name] += 1
    return out
