"""The qmm kernels (fused dequantize×matmul over packed planes) and their
plain versions.

- `qmm` replaces tpullm/ops/pallas/qmm.py::_kernel_mat + _acc_tile (the
  pallas_call in _qmm_2d, entry qmatmul), for all 22 plane formats of
  ops/qmatmul.py: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, MXFP4, IQ4_NL, Q2_K, Q3_K,
  Q4_K, Q5_K, Q6_K (wide `qw`), IQ4_XS and the codebook types IQ2_XXS,
  IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0. Source:
  tpullm_torch/csrc/qmm.cu, in two regimes of M: below TC_MIN_M
  rows (decode, the prefill bucket of 8) the CUDA-core kernel
  (csrc/qmm_gemv.cuh, `gemv_plan`), one launch a call, its K split summed by the last
  block of each column tile, counted in LAUNCHES; from TC_MIN_M rows
  (prefill) the tensor-core kernel (csrc/qmm_tc.cuh, `plan`), counted in
  TC_LAUNCHES.
- `qmm_grouped` replaces the group-factored body _kernel of the same
  pallas_call, which _qmm_2d picks for the types of its GROUPED_TYPES: the
  scale is applied once per group to Σ x·value instead of to every weight.
  As in the JAX package, GROUPED_TYPES is read once from
  TPULLM_QMM_GROUPED (comma-separated type names) and is empty by default;
  `ops.qmatmul.matmul` sends a listed type to it. Same source, regimes
  and plans as `qmm`, on the same device bodies: below TC_MIN_M rows the
  gemv body (`gemv_plan`, one launch a call), from TC_MIN_M rows the
  grouped form of the tensor-core body (`plan`), both counted in
  GROUPED_LAUNCHES.
- `qmm_stack` replaces _kernel_stack (the pallas_call in _qmm_stack, entry
  qmatmul_stack): every expert of a stack [E, rows, N] on a shared x [M, K]
  or per-expert x [E, M, K] → [E, M, N], on the tensor-core body at every
  M (the main path calls it from 32 rows up).
- `qmm_gather` replaces _kernel_gather (the pallas_call in _qmm_gather,
  entry qmatmul_gather): row t of x [T, K] through expert ids[t] → [T, N];
  the blocks read ids on the card, each streams one routed expert for up to
  8 of its slots at once (`gather_plan`), one launch a call.
The expert kernels take the same 22 formats; their source is
tpullm_torch/csrc/qmm_moe.cu, on the device bodies that `qmm` uses too
(csrc/qmm_tc.cuh for the stack, csrc/qmm_gemv.cuh for the gather). Each
source builds once per format family (`_FAMILY`). What bounds each on the
card, and what its design does about it, is in the source notes. Every
kernel takes K % 256 == 0 and N % 4 == 0 (`takes`); ops.qmatmul sends
other shapes on the card to its counted dequantize-then-matmul route
(DEQUANT_ROUTES), as the JAX package sends the shapes its kernel refuses
to matmul_reference.

The plain versions compute the same functions with the same rounding points
as `_acc_tile`: x rounded to bf16, the weight rounded to bf16 after the f32
scale multiply, f32 sums, the min term through group sums of x, output in
x's dtype. `qmm_stack_reference` and `qmm_gather_reference` are built on
`qmm_reference`, expert by expert. `qmm_grouped_reference` has _kernel's:
x rounded to bf16, the unscaled value (the raw code of the identity and
bias maps, the table value, or the signed byte) rounded to bf16, f32 group
sums scaled once, the bias types' bias through scale·bias times the group
sums of x.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...gguf.constants import GGMLType
from ..qmatmul import _SCHEMA, WIDE_TYPES, _expand_codes, _padded_lut, has_minus, plane_values
from . import _build

# csrc/qmm_body.cuh QmmFmt ids, and the format family (library) of each
_FMT = {GGMLType.Q4_K: 0, GGMLType.Q6_K: 1, GGMLType.Q5_K: 2, GGMLType.Q8_0: 3,
        GGMLType.Q4_0: 4, GGMLType.Q4_1: 5, GGMLType.Q5_0: 6, GGMLType.Q5_1: 7,
        GGMLType.MXFP4: 8, GGMLType.IQ4_NL: 9, GGMLType.Q2_K: 10, GGMLType.Q3_K: 11,
        GGMLType.IQ4_XS: 12, GGMLType.IQ2_XXS: 13, GGMLType.IQ2_XS: 14,
        GGMLType.IQ2_S: 15, GGMLType.IQ3_XXS: 16, GGMLType.IQ3_S: 17, GGMLType.IQ1_S: 18,
        GGMLType.IQ1_M: 19, GGMLType.TQ1_0: 20, GGMLType.TQ2_0: 21}
_FAMILY = {GGMLType.Q4_K: 0, GGMLType.Q5_K: 1, GGMLType.IQ4_XS: 2, GGMLType.IQ3_XXS: 3,
           GGMLType.IQ3_S: 4, GGMLType.Q6_K: 5, GGMLType.Q8_0: 5,
           GGMLType.Q4_0: 6, GGMLType.Q4_1: 6, GGMLType.MXFP4: 7, GGMLType.IQ4_NL: 7,
           GGMLType.Q5_0: 8, GGMLType.Q5_1: 8, GGMLType.Q2_K: 9, GGMLType.Q3_K: 9,
           GGMLType.IQ2_XXS: 10, GGMLType.IQ2_XS: 10, GGMLType.IQ2_S: 10,
           GGMLType.IQ1_S: 11, GGMLType.IQ1_M: 11, GGMLType.TQ1_0: 12, GGMLType.TQ2_0: 12}

# the types ops.qmatmul.matmul sends to qmm_grouped (tpullm/ops/pallas/qmm.py
# GROUPED_TYPES); a run may change the set in place
GROUPED_TYPES: set = {GGMLType[t.strip()] for t in
                      os.environ.get("TPULLM_QMM_GROUPED", "").split(",") if t.strip()}

# launches of each kernel, by plane format; plain counts a run can read.
# LAUNCHES: qmm on CUDA cores (M < TC_MIN_M); TC_LAUNCHES: qmm on the tensor
# cores (M >= TC_MIN_M); STACK_LAUNCHES: qmm_stack (tensor cores).
LAUNCHES = {t.name: 0 for t in _FMT}
TC_LAUNCHES = {t.name: 0 for t in _FMT}
STACK_LAUNCHES = {t.name: 0 for t in _FMT}
GATHER_LAUNCHES = {t.name: 0 for t in _FMT}
GROUPED_LAUNCHES = {t.name: 0 for t in _FMT}
# calls ops.qmatmul sent to its dequantize-then-matmul route on the card
# because no kernel takes their shape (`takes`), by plane format; 0 on a
# model whose every linear the kernels take
DEQUANT_ROUTES = {t.name: 0 for t in _FMT}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_QMM_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)  # and grouped
_TC_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)  # and grouped_tc
_STACK_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P)
_GATHER_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_CHUNK = 256  # K rows per chunk, csrc/qmm_body.cuh kQmmChunk
GEMV_BLOCK_N = 128  # output columns per block below TC_MIN_M and of the gather, kGemvBN
GEMV_X_BYTES = 32768  # x of a block's K range in shared memory at most (kGemvXBytes)
# rows of x a block of the gemv body (qmm and qmm_grouped below TC_MIN_M:
# csrc/qmm.cu launch; the gather's row tiles: csrc/qmm_moe.cu)
GEMV_TMS = (1, 2, 4, 8)
GEMV_WAVE_BLOCKS = 2  # blocks an SM that every format's gemv block fits at any TM
GATHER_MAX_EXPERTS = 65535  # experts of a stack the gather takes (kGatherMaxExperts)
TC_MIN_M = 16  # rows of x from which qmm and qmm_grouped run on the tensor cores
TC_TILE = 128  # rows and columns of a tensor-core block (csrc/qmm_tc.cuh kTcBM, kTcBN)
TC_BLOCKS = 2  # tensor-core blocks an SM holds (csrc/qmm_tc.cuh kTcBlocksPerSm)


def takes(K: int, N: int) -> bool:
    """Whether the qmm kernels take a [K, N] weight: whole 256-row chunks
    and whole groups of 4 output columns (csrc/qmm_body.cuh qmm_shape_ok)."""
    return K % _CHUNK == 0 and N % 4 == 0


def _code_plane(gtype: GGMLType) -> str:
    return "qw" if gtype in WIDE_TYPES else "qs"


def _plane_rows(gtype: GGMLType, K: int) -> dict[str, int]:
    """Rows of each plane of one [K, N] weight of `gtype` (as the JAX
    package's pallas/qmm.py::_plane_rows sizes its tiles)."""
    meta = _SCHEMA[gtype]
    if gtype in WIDE_TYPES:
        rows = {"qw": K}
    else:
        rows = {"qs": {2: K // 4, 3: K // 4, 4: K // 2, 5: K // 2, 8: K}[meta["bits"]]}
        if meta["bits"] in (3, 5):
            rows["qh"] = K // 8
    rows["scale"] = K // meta["G"]
    if has_minus(gtype):
        rows["minus"] = K // meta["G"]
    return rows


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


def qmm_grouped_reference(x: torch.Tensor, planes: dict[str, torch.Tensor],
                          gtype: GGMLType, n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] → [M, N], the plain version of qmm_grouped (_kernel's
    rounding points; groups taken a few at a time to bound the [groups, M,
    N] temporary)."""
    G = _SCHEMA[gtype]["G"]
    ng = n_in // G
    M = x.shape[0]
    xb = x.to(torch.bfloat16).float()
    vals, minus = grouped_values(planes, gtype)
    w = vals.to(torch.bfloat16).float().reshape(ng, G, n_out)
    xg = xb.reshape(M, ng, G).transpose(0, 1)  # (ng, M, G)
    scale = planes["scale"].float()  # (ng, N)
    acc = torch.zeros((M, n_out), dtype=torch.float32, device=x.device)
    step = max(1, (1 << 26) // max(1, M * n_out))
    for g in range(0, ng, step):
        dot = torch.bmm(xg[g:g + step], w[g:g + step])  # (groups, M, N)
        acc += (dot * scale[g:g + step, None, :]).sum(0)
    if minus is not None:
        acc = acc - xg.sum(-1).transpose(0, 1) @ minus  # group sums of bf16 x, in f32
    return acc.to(x.dtype)


def grouped_values(planes: dict[str, torch.Tensor],
                   gtype: GGMLType) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The group-factored function's unscaled values [K, N] in f32 (the raw
    code of the identity and bias maps, the table value, or the signed
    byte) and its minus_eff [K/G, N] (the minus plane, or scale · bias of a
    bias map; None for neither)."""
    meta = _SCHEMA[gtype]
    bias = None
    if "qw" in planes:  # bias folded at repack
        vals = planes["qw"].view(torch.int8).float()
    else:
        codes = _expand_codes(planes, gtype)
        vals = (_padded_lut(gtype, codes.device)[codes.to(torch.int32)] if "lut" in meta
                else codes.float())
        bias = meta.get("bias")
    minus = (planes["minus"].float() if "minus" in planes
             else planes["scale"].float() * float(bias) if bias else None)
    return vals, minus


def _expert(planes: dict[str, torch.Tensor], e: int) -> dict[str, torch.Tensor]:
    return {k: v[e] for k, v in planes.items()}


def qmm_stack_reference(x: torch.Tensor, planes: dict[str, torch.Tensor],
                        gtype: GGMLType, n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] or [E, M, K] → [E, M, N], the plain version of qmm_stack."""
    E = planes["scale"].shape[0]
    return torch.stack([qmm_reference(x[e] if x.dim() == 3 else x, _expert(planes, e),
                                      gtype, n_out, n_in) for e in range(E)])


def qmm_gather_reference(x: torch.Tensor, ids: torch.Tensor,
                         planes: dict[str, torch.Tensor], gtype: GGMLType, n_out: int,
                         n_in: int) -> torch.Tensor:
    """x [T, K], ids [T] → [T, N], the plain version of qmm_gather: the rows
    routed to each expert go through that expert's weight together."""
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    ids = ids.long()
    for e in torch.unique(ids).tolist():
        rows = (ids == e).nonzero()[:, 0]
        out[rows] = qmm_reference(x[rows], _expert(planes, e), gtype, n_out, n_in)
    return out


def _gemv_split(tiles: int, n_chunks: int, n_sm: int, tm: int) -> tuple[int, int]:
    """(K splits, chunks per split) of the gemv body for `tiles` output
    tiles (blocks before the split) of tm rows: against the wave of
    GEMV_WAVE_BLOCKS blocks an SM that every format's block fits,
    - at most half a wave: K is split into as many splits as keep every
      block in that one wave (a wave and a few blocks more left most SMs
      idle for a whole block's time on the card);
    - between half a wave and a wave: one wave would leave some SMs with one
      block and others with two, so K is split into short blocks of about
      an eighth of an SM's share, which the card spreads evenly over
      several waves;
    - a wave or more: no split.
    Each split's x (tm rows) stays within GEMV_X_BYTES."""
    wave = GEMV_WAVE_BLOCKS * n_sm
    if 2 * tiles <= wave:
        per = -(-n_chunks // max(1, min(n_chunks, wave // tiles)))
    elif tiles < wave:
        per = max(1, round(tiles * n_chunks / n_sm / 8))
    else:
        per = n_chunks
    per = min(per, GEMV_X_BYTES // (tm * _CHUNK * 2))
    return -(-n_chunks // per), per


def gemv_plan(M: int, K: int, N: int, n_sm: int) -> tuple[int, int, int]:
    """(rows per block, K splits, chunks per split) of qmm and qmm_grouped
    below TC_MIN_M rows: the least of GEMV_TMS that covers M (else the
    largest), 128 columns a block, K split by `_gemv_split` over the
    output tiles. The splits of a column tile are summed by its last block
    through one entry a tile of the counter buffer (`_build.counters`,
    which checks that the tiles fit)."""
    tm = next((t for t in GEMV_TMS if t >= M), GEMV_TMS[-1])
    return (tm, *_gemv_split(-(-N // GEMV_BLOCK_N) * -(-M // tm), K // _CHUNK, n_sm, tm))


def gather_plan(T: int, E: int, K: int, N: int, n_sm: int) -> tuple[int, int, int]:
    """(x rows a block holds, K splits, chunks per split) of qmm_gather over
    T slots and an E-expert stack. The host never reads the ids, so it
    plans for min(T, E) routed experts (the grid's expert ranks), each one
    row tile: the x rows are the least of GEMV_TMS that covers min(T, 8)
    (the largest row tile a block runs), and K is split by `_gemv_split`
    over the ranks' 128-column tiles. The splits of a (rank, column tile)
    are summed by its last block through one counter each."""
    tm = next(t for t in GEMV_TMS if t >= min(T, GEMV_TMS[-1]))
    ranks = min(T, E)
    return (tm, *_gemv_split(-(-N // GEMV_BLOCK_N) * ranks, K // _CHUNK, n_sm, tm))


def plan(M: int, K: int, N: int, n_sm: int, batches: int = 1) -> tuple[int, int, int]:
    """(rows per block, K splits, chunks per split) of the tensor-core body
    for `batches` [M, K] × [K, N] products (qmm and qmm_grouped from
    TC_MIN_M rows, qmm_stack): TC_TILE × TC_TILE output tiles, TC_BLOCKS
    blocks an SM; K is split only when the tiles are fewer than the blocks
    one wave holds, into as many splits as it holds. Below TC_MIN_M rows qmm
    and qmm_grouped plan with `gemv_plan`."""
    n_chunks = K // _CHUNK
    tiles = -(-M // TC_TILE) * -(-N // TC_TILE) * batches
    per = -(-n_chunks // max(1, min(n_chunks, n_sm * TC_BLOCKS // tiles)))
    return TC_TILE, -(-n_chunks // per), per


def _check(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType, K: int,
           N: int, lead: tuple[int, ...], what: str) -> list[torch.Tensor]:
    """Validates x and the planes of `gtype` (shapes lead + [rows, N]) for a
    kernel call; returns [codes, qh, scale, minus] (None where absent)."""
    rows = _plane_rows(gtype, K)
    if sorted(planes) != sorted(rows):
        raise ValueError(f"{what}: planes {sorted(planes)} are not those of {gtype.name}")
    for t in [x, *planes.values()]:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: every operand must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")
    if x.shape[-1] != K or not takes(K, N):
        raise ValueError(f"{what}: needs K % {_CHUNK} == 0 and N % 4 == 0, got "
                         f"K={x.shape[-1]} (weight {K}), N={N}")
    if x.dtype != torch.bfloat16 or any(planes[k].dtype != torch.bfloat16
                                        for k in ("scale", "minus") if k in planes):
        raise ValueError(f"{what}: x and scale/minus must be bf16, code planes uint8")
    for name, r in rows.items():
        if tuple(planes[name].shape) != (*lead, r, N):
            raise ValueError(f"{what}: plane {name} is {tuple(planes[name].shape)}, "
                             f"not {(*lead, r, N)}")
        if name not in ("scale", "minus") and planes[name].dtype != torch.uint8:
            raise ValueError(f"{what}: code planes must be uint8")
    return [planes[_code_plane(gtype)], planes.get("qh"), planes["scale"], planes.get("minus")]


def _ported(gtype: GGMLType, what: str) -> None:
    if gtype not in _FMT:
        raise NotImplementedError(f"{what} kernel for {gtype.name} is not ported")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _qmm_2d(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
            n_out: int, n_in: int, grouped: bool) -> torch.Tensor:
    """x [M, K] bf16 on the card → [M, N] bf16 through the kernel of M's
    regime, materializing (`qmm`) or group-factored (`qmm_grouped`): the
    tensor-core kernel (`plan`) from TC_MIN_M rows, else the CUDA-core one
    (`gemv_plan`)."""
    what = "qmm_grouped" if grouped else "qmm"
    _ported(gtype, what)
    ops = _check(x, planes, gtype, n_in, n_out, (), what)
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, K]")
    M, K, N = x.shape[0], n_in, n_out
    n_sm = _build.n_sm(x.device)
    tc = M >= TC_MIN_M
    tm, split, per = plan(M, K, N, n_sm) if tc else gemv_plan(M, K, N, n_sm)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split, M, N), dtype=torch.float32,
                          device=x.device) if split > 1 else None
    lib, stream = f"qmm{_FAMILY[gtype]}", torch.cuda.current_stream(x.device).cuda_stream
    entry = "tpullm_qmm_grouped" if grouped else "tpullm_qmm"
    args = (_FMT[gtype], x.data_ptr(), *map(_ptr, ops), out.data_ptr(), _ptr(partial))
    if tc:
        fn = _build.bind(lib, entry + "_tc", _TC_ARGS)
        _build.check(fn(*args, M, K, N, split, per, stream), f"{what} tensor-core {gtype.name}")
    else:
        tiles = -(-N // GEMV_BLOCK_N) * -(-M // tm)
        counters = _build.counters(x.device, stream, tiles) if split > 1 else None
        fn = _build.bind(lib, entry, _QMM_ARGS)
        _build.check(fn(*args, _ptr(counters), M, K, N, tm, split, per, stream),
                     f"{what} {gtype.name}")
    (GROUPED_LAUNCHES if grouped else TC_LAUNCHES if tc else LAUNCHES)[gtype.name] += 1
    return out


def qmm(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
        n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] bf16 on the card → [M, N] bf16 through the materializing
    kernel of M's regime (`_qmm_2d`); counted in TC_LAUNCHES from TC_MIN_M
    rows, else in LAUNCHES."""
    return _qmm_2d(x, planes, gtype, n_out, n_in, grouped=False)


def qmm_grouped(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
                n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] bf16 on the card → [M, N] bf16 through the group-factored
    kernel of M's regime (`_qmm_2d`: the regimes and plans of `qmm`);
    counted in GROUPED_LAUNCHES."""
    return _qmm_2d(x, planes, gtype, n_out, n_in, grouped=True)


def qmm_stack(x: torch.Tensor, planes: dict[str, torch.Tensor], gtype: GGMLType,
              n_out: int, n_in: int) -> torch.Tensor:
    """x [M, K] (shared) or [E, M, K] bf16 on the card, planes [E, rows, N]
    → [E, M, N] bf16 through the qmm_stack kernel (tensor cores)."""
    _ported(gtype, "qmm_stack")
    E = planes["scale"].shape[0]
    ops = _check(x, planes, gtype, n_in, n_out, (E,), "qmm_stack")
    if x.dim() not in (2, 3) or (x.dim() == 3 and x.shape[0] != E):
        raise ValueError(f"qmm_stack: x must be [M, K] or [{E}, M, K], got {tuple(x.shape)}")
    M, K, N = x.shape[-2], n_in, n_out
    _, split, per = plan(M, K, N, _build.n_sm(x.device), batches=E)
    out = torch.empty((E, M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split if split > 1 else 0, E * M, N), dtype=torch.float32,
                          device=x.device)
    fn = _build.bind(f"qmm_moe{_FAMILY[gtype]}", "tpullm_qmm_stack", _STACK_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    x_stride = M * K if x.dim() == 3 else 0
    _build.check(fn(_FMT[gtype], x.data_ptr(), *map(_ptr, ops), out.data_ptr(),
                    partial.data_ptr(), M, K, N, E, x_stride, split, per, stream),
                 f"qmm_stack {gtype.name}")
    STACK_LAUNCHES[gtype.name] += 1
    return out


def qmm_gather(x: torch.Tensor, ids: torch.Tensor, planes: dict[str, torch.Tensor],
               gtype: GGMLType, n_out: int, n_in: int) -> torch.Tensor:
    """x [T, K] bf16 and ids [T] int32 on the card, planes [E, rows, N] →
    [T, N] bf16 through the qmm_gather kernel. The ids are never read on the
    host: an id outside 0..E-1 gives a NaN row."""
    _ported(gtype, "qmm_gather")
    E = planes["scale"].shape[0]
    ops = _check(x, planes, gtype, n_in, n_out, (E,), "qmm_gather")
    T = x.shape[0]
    if x.dim() != 2 or tuple(ids.shape) != (T,) or ids.dtype != torch.int32 \
            or ids.device != x.device or not ids.is_contiguous():
        raise ValueError("qmm_gather: x must be [T, K] and ids a contiguous int32 [T] "
                         "on the same device")
    if T < 1 or E > GATHER_MAX_EXPERTS:
        raise ValueError(f"qmm_gather: needs T ≥ 1 slots and E ≤ {GATHER_MAX_EXPERTS} experts, "
                         f"got T={T}, E={E}")
    K, N = n_in, n_out
    tm, split, per = gather_plan(T, E, K, N, _build.n_sm(x.device))
    out = torch.empty((T, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split, T, N), dtype=torch.float32,
                          device=x.device) if split > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tiles = -(-N // GEMV_BLOCK_N) * min(T, E)
    counters = _build.counters(x.device, stream, tiles) if split > 1 else None
    fn = _build.bind(f"qmm_moe{_FAMILY[gtype]}", "tpullm_qmm_gather", _GATHER_ARGS)
    _build.check(fn(_FMT[gtype], x.data_ptr(), ids.data_ptr(), *map(_ptr, ops),
                    out.data_ptr(), _ptr(partial), _ptr(counters), T, K, N, E, tm, split, per,
                    stream),
                 f"qmm_gather {gtype.name}")
    GATHER_LAUNCHES[gtype.name] += 1
    return out
