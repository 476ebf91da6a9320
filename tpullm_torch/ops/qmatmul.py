"""Packed-weight planes: repack of ggml blocks on the device, dequantization,
and the dequantize×matmul dispatch.

## Plane schema (v2, unified affine form)

At load time ggml blocks are repacked into column-major planes
(K = n_in rows × N = n_out columns) that reduce every type to one form:

    w[k, n] = scale[k//G, n] · map(code[k, n]) − minus[k//G, n]

- Q4_K: `qs` [K/2, N] uint8, 4-bit codes in half-split packing
  (byte[r] = q[r] | q[r + U/2] << 4 within each U = 256-row unit), `scale`
  and `minus` [K/32, N]: the premultiplied d·sc and dmin·m.
- Q5_K: Q4_K's `qs`/`scale`/`minus` plus `qh` [K/8, N], the fifth bit in
  bit-plane packing (field j of packed row r of a U-row unit holds the bit
  of row j·U/8 + r).
- Q6_K: widened to one signed byte per weight, `qw` [K, N] int8 stored as
  uint8 with the bias 32 folded in, `scale` [K/16, N] = d·sc.
- Q8_0: `qs` [K, N], the int8 codes stored as uint8 (sign-extended on
  read), `scale` [K/32, N] = d.

`scale`/`minus` live on the device as bf16 (as the JAX package's
`upload_planes` stores them). The repack runs on the device with torch bit
ops: the packed blocks are the smallest bytes that exist, so they are what
crosses the host link. Only the Q4_K, Q5_K, Q6_K and Q8_0 rows of the
schema are ported.

Expert stacks (`models.weights.QuantExpertStack`) hold the same planes with
a leading expert axis, [E, rows, N]; `stack_matmul` and `gather_matmul`
dispatch them as `matmul` dispatches a 2-D weight.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..gguf.constants import GGMLType, TYPE_TRAITS

# metadata: code bits, scale-group size G, split unit U (= SB), symmetric bias
_SCHEMA = {
    GGMLType.Q8_0: dict(bits=8, G=32, signed=True),  # bias folded by sign-extension
    GGMLType.Q4_K: dict(bits=4, G=32, SB=256),
    GGMLType.Q5_K: dict(bits=5, G=32, SB=256),
    GGMLType.Q6_K: dict(bits=6, G=16, SB=256, bias=32),
}

# Types repacked to wide int8 "qw" planes (bias folded) instead of packed
# sub-byte codes: one byte load and one sign extension per weight.
WIDE_TYPES = frozenset({GGMLType.Q6_K})


def supports(gtype: GGMLType) -> bool:
    return gtype in _SCHEMA


def split_unit(gtype: GGMLType) -> int:
    """Row chunk within which code planes are split."""
    return _SCHEMA[gtype].get("SB", _SCHEMA[gtype]["G"])


def upload_blocks(data: np.ndarray, device) -> torch.Tensor:
    """Packed GGUF payload (a read-only mmap view) → flat uint8 tensor on
    `device`. The view is never written."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8).reshape(-1))
    return t.to(device)


# ---------------------------------------------------------------------------
# repack: packed ggml blocks -> planes (torch bit ops, on any device)
# ---------------------------------------------------------------------------

def _f16(b: torch.Tensor) -> torch.Tensor:
    """Little-endian f16 from a trailing axis of 2 uint8 → f32."""
    return b.contiguous().view(torch.float16)[..., 0].float()


def _col(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, groups...) → (K', n_out) K-major planes."""
    return torch.movedim(x, 0, -1).reshape(-1, n_out).contiguous()


def _half_split_pack4(codes: torch.Tensor, unit: int) -> torch.Tensor:
    """codes (K, N) uint8 in 0..15 → (K/2, N): packed row r of chunk c =
    codes[c·U + r] | codes[c·U + U/2 + r] << 4."""
    K, N = codes.shape
    c = codes.reshape(K // unit, unit, N)
    return (c[:, : unit // 2] | (c[:, unit // 2:] << 4)).reshape(K // 2, N)


def _bitplane_pack(bits: torch.Tensor, width: int, unit: int) -> torch.Tensor:
    """bits (K, N) uint8 < 2**width → (K·width/8, N): field j of packed row
    r of chunk c holds bits[c·U + j·U·width/8 + r]."""
    K, N = bits.shape
    fields = 8 // width
    rows = unit * width // 8  # packed rows per chunk
    c = bits.reshape(K // unit, fields, rows, N)
    out = torch.zeros((K // unit, rows, N), dtype=torch.uint8, device=bits.device)
    for j in range(fields):
        out |= c[:, j] << (j * width)
    return out.reshape(K * width // 8, N)


def _scale_min_k4(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q4_K 12-byte packed 6-bit scales/mins → (sc, m) each (..., 8) int32."""
    q = q.to(torch.int32)
    sc = [q[..., j] & 63 for j in range(4)]
    m = [q[..., j + 4] & 63 for j in range(4)]
    for j in range(4, 8):
        sc.append((q[..., j + 4] & 0x0F) | ((q[..., j - 4] >> 6) << 4))
        m.append((q[..., j + 4] >> 4) | ((q[..., j] >> 6) << 4))
    return torch.stack(sc, dim=-1), torch.stack(m, dim=-1)


def _decode_blocks(b: torch.Tensor, gtype: GGMLType, n_out: int):
    """Packed blocks (n_out, nb, type_size) uint8 → (codes (K, N) uint8,
    scale (K/G, N) f32, minus (K/G, N) f32 | None). Every factored scale
    is resolved here, in f32."""
    nb = b.shape[1]
    if gtype == GGMLType.Q8_0:
        codes = b[..., 2:34]  # int8 bits stored as u8
        return _col(codes, n_out), _col(_f16(b[..., 0:2]), n_out), None
    if gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        d = _f16(b[..., 0:2])
        dmin = _f16(b[..., 2:4])
        sc, mi = _scale_min_k4(b[..., 4:16])
        scale = d[..., None] * sc.float()  # exact ggml d1 = d·sc
        minus = dmin[..., None] * mi.float()
        off = 16 if gtype == GGMLType.Q4_K else 48
        qs = b[..., off:off + 128].reshape(n_out, nb, 4, 32)
        codes = torch.cat([qs & 0x0F, qs >> 4], dim=3).reshape(n_out, nb, 256)
        if gtype == GGMLType.Q5_K:
            qh = b[..., 16:48]
            hb = torch.stack([(qh >> j) & 1 for j in range(8)], dim=2)  # (n_out, nb, 8, 32)
            codes = codes | (hb.reshape(n_out, nb, 256) << 4)
        return _col(codes, n_out), _col(scale, n_out), _col(minus, n_out)
    if gtype == GGMLType.Q6_K:
        ql = b[..., 0:128].reshape(n_out, nb, 2, 64)
        qh = b[..., 128:192].reshape(n_out, nb, 2, 32)
        sc = b[..., 192:208].view(torch.int8).float()  # (n_out, nb, 16)
        d = _f16(b[..., 208:210])
        lo = torch.cat([ql & 0x0F, ql >> 4], dim=3)
        hi = torch.stack([(qh >> (2 * j)) & 3 for j in range(4)], dim=3).reshape(
            n_out, nb, 2, 128)
        codes = (lo | (hi << 4)).reshape(n_out, nb, 256)
        scale = d[..., None] * sc
        return _col(codes, n_out), _col(scale, n_out), None  # bias 32 in qw
    raise NotImplementedError(f"repack of {gtype.name} is not ported")


def repack_planes(blocks: torch.Tensor, gtype: GGMLType, n_out: int,
                  n_in: int) -> dict[str, torch.Tensor]:
    """Flat packed bytes (uint8 tensor) → planes with f32 scale/minus, on
    the blocks' device (≡ the JAX package's host `repack_np`)."""
    tt = TYPE_TRAITS[gtype]
    b = blocks.reshape(n_out, n_in // tt.block_size, tt.type_size)
    codes, scale, minus = _decode_blocks(b, gtype, n_out)
    meta = _SCHEMA[gtype]
    U = split_unit(gtype)
    planes: dict[str, torch.Tensor] = {}
    if gtype in WIDE_TYPES:
        qw = (codes.to(torch.int16) - meta["bias"]).to(torch.int8)
        planes["qw"] = qw.view(torch.uint8)
    elif meta["bits"] == 8:
        planes["qs"] = codes
    elif meta["bits"] == 5:
        planes["qs"] = _half_split_pack4(codes & 0x0F, U)
        planes["qh"] = _bitplane_pack(codes >> 4, 1, U)
    else:
        planes["qs"] = _half_split_pack4(codes, U)
    planes["scale"] = scale
    if minus is not None:
        planes["minus"] = minus
    return planes


def repack(data, gtype: GGMLType, n_out: int, n_in: int,
           device) -> dict[str, torch.Tensor]:
    """Packed GGUF payload → device planes, scale/minus stored as bf16
    (≡ `upload_planes(repack_np(...))`: halves the per-group overhead at
    ≤2^-9 relative scale rounding)."""
    blocks = data if isinstance(data, torch.Tensor) else upload_blocks(data, device)
    planes = repack_planes(blocks.to(device), gtype, n_out, n_in)
    return {k: (v.to(torch.bfloat16) if k in ("scale", "minus") else v)
            for k, v in planes.items()}


# ---------------------------------------------------------------------------
# plain dequantization (embedding tables, the kernel's plain version)
# ---------------------------------------------------------------------------

def _half_split_unpack4(qs: torch.Tensor, unit: int) -> torch.Tensor:
    rows, N = qs.shape
    half = unit // 2
    c = qs.reshape(rows // half, half, N)
    return torch.cat([c & 0x0F, c >> 4], dim=1).reshape(rows * 2, N)


def _bitplane_unpack(q: torch.Tensor, width: int, unit: int) -> torch.Tensor:
    rows, N = q.shape
    fields = 8 // width
    mask = (1 << width) - 1
    chunk_rows = unit * width // 8
    c = q.reshape(rows // chunk_rows, chunk_rows, N)
    return torch.cat([(c >> (j * width)) & mask for j in range(fields)],
                     dim=1).reshape(rows * fields, N)


def plane_values(planes: dict[str, torch.Tensor], gtype: GGMLType) -> torch.Tensor:
    """(K, N) f32 unscaled values: wide int8 `qw` planes (bias pre-folded),
    sign-extended int8 `qs` (Q8_0), or half-split 4-bit codes with the
    fifth bit from the `qh` bit plane (Q5_K)."""
    if "qw" in planes:
        return planes["qw"].view(torch.int8).float()
    bits, U = _SCHEMA[gtype]["bits"], split_unit(gtype)
    if bits == 8:
        return planes["qs"].view(torch.int8).float()
    if bits == 4:
        return _half_split_unpack4(planes["qs"], U).float()
    if bits == 5:
        return (_half_split_unpack4(planes["qs"], U)
                | (_bitplane_unpack(planes["qh"], 1, U) << 4)).float()
    raise NotImplementedError(f"planes of {gtype.name} are not ported")


def dequant_planes(planes: dict[str, torch.Tensor], gtype: GGMLType, n_out: int,
                   n_in: int, dtype=torch.float32) -> torch.Tensor:
    """Dequant of the full plane set → dense [K, N] = [n_in, n_out]."""
    G = _SCHEMA[gtype]["G"]
    n_groups = n_in // G
    vals = plane_values(planes, gtype).reshape(n_groups, G, n_out)
    vals = vals * planes["scale"].float().reshape(n_groups, 1, n_out)
    if "minus" in planes:
        vals = vals - planes["minus"].float().reshape(n_groups, 1, n_out)
    return vals.reshape(n_in, n_out).to(dtype)


def matmul(x: torch.Tensor, ql) -> torch.Tensor:
    """Fused dequant matmul: x [..., n_in] → [..., n_out].

    A CUDA tensor goes to the hand-written qmm kernel (which raises on what
    it does not take); a CPU tensor to the kernel's plain version."""
    from .kernels import qmm

    lead = x.shape[:-1]
    x2 = x.reshape(-1, ql.n_in)
    if x2.is_cuda:
        out = qmm.qmm(x2.contiguous(), ql.planes, ql.gtype, ql.n_out, ql.n_in)
    else:
        out = qmm.qmm_reference(x2, ql.planes, ql.gtype, ql.n_out, ql.n_in)
    return out.reshape(*lead, ql.n_out)


def stack_matmul(x: torch.Tensor, stack) -> torch.Tensor:
    """All-experts packed matmul (MoE prefill): x [M, K] (shared) or
    [E, M, K] (per expert) through a QuantExpertStack → [E, M, n_out]. A
    CUDA tensor goes to the qmm_stack kernel, a CPU tensor to its plain
    version."""
    from .kernels import qmm

    if x.is_cuda:
        return qmm.qmm_stack(x.contiguous(), stack.planes, stack.gtype, stack.n_out,
                             stack.n_in)
    return qmm.qmm_stack_reference(x, stack.planes, stack.gtype, stack.n_out, stack.n_in)


def gather_matmul(x: torch.Tensor, ids: torch.Tensor, stack) -> torch.Tensor:
    """Expert-indexed packed matmul (MoE decode): row t of x [T, K] through
    expert ids[t] → [T, n_out], reading only the routed experts' planes. A
    CUDA tensor goes to the qmm_gather kernel (which reads `ids` on the
    card), a CPU tensor to its plain version."""
    from .kernels import qmm

    if x.is_cuda:
        return qmm.qmm_gather(x.contiguous(), ids.to(torch.int32).contiguous(), stack.planes,
                              stack.gtype, stack.n_out, stack.n_in)
    return qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, stack.n_out, stack.n_in)
