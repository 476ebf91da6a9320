"""Packed-weight planes: repack of ggml blocks on the device, dequantization,
and the dequantize×matmul dispatch.

## Plane schema (v2, unified affine form)

At load time ggml blocks are repacked into column-major planes
(K = n_in rows × N = n_out columns) that reduce every type to one form:

    w[k, n] = scale[k//G, n] · map(code[k, n]) − minus[k//G, n]

Five code layouts, each split within a U-row unit (U = 256 for the
K-quants and the 256-weight i-quants, 32 for the 32-weight block types):
- 4-bit half-split, `qs` [K/2, N]: byte[r] = q[r] | q[r + U/2] << 4 within
  each unit (Q4_0, Q4_1, MXFP4, IQ4_NL at U = 32; Q4_K, IQ4_XS, IQ3_XXS,
  IQ3_S at U = 256);
- the same plus a 1-bit plane `qh` [K/8, N], the fifth bit (field j of
  packed row r of a unit holds the bit of row j·U/8 + r): Q5_0, Q5_1 at
  U = 32, Q5_K at U = 256;
- a 2-bit plane `qs` [K/4, N] (field j of packed row r holds row
  j·U/4 + r): Q2_K, TQ1_0, TQ2_0;
- the 2-bit plane plus a 1-bit `qh`, the code lo | hi << 2: Q3_K and the
  3-bit codebook codes of IQ2_XXS, IQ2_XS, IQ2_S, IQ1_S, IQ1_M;
- one byte per weight: Q8_0's int8 `qs` [K, N] (sign-extended on read) and
  Q6_K widened to `qw` [K, N] int8 with the bias 32 folded in.

`scale` [K/G, N] is the premultiplied group scale (d·sc, d, or MXFP4's
2^(e-128)); `minus` [K/G, N] the min term (dmin·m for Q4_K/Q5_K/Q2_K, −m for
Q4_1/Q5_1). `map` is the identity, a bias subtracted from the code (Q4_0 8,
Q5_0 16, Q3_K 4, TQ 1) or a code table of 6 or 16 entries (MXFP4, IQ4_NL,
IQ4_XS and the IQ1/IQ2/IQ3 codebook types).

The codebook types (CODEBOOK_TYPES: IQ1/IQ2/IQ3, TQ) collapse to this form
because every decoded value is a group scale times a value of a small set:
their repack decodes the blocks (quant/iq_codecs.py) and matches each
value/scale ratio to the nearest table entry, as the JAX package's
`repack_np` does.

`scale`/`minus` live on the device as bf16 (as the JAX package's
`upload_planes` stores them). The repack runs on the device with torch ops:
the packed blocks are the smallest bytes that exist, so they are what
crosses the host link. All 22 rows of the JAX package's schema are ported.

Expert stacks (`models.weights.QuantExpertStack`) hold the same planes with
a leading expert axis, [E, rows, N]; `stack_matmul` and `gather_matmul`
dispatch them as `matmul` dispatches a 2-D weight.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..gguf.constants import GGMLType, IQ4_NL_VALUES, MXFP4_VALUES, QK_K, TYPE_TRAITS

# the codebook types' value tables (tpullm/ops/qmatmul.py): the IQ2 grids
# hold {8, 25, 43}, IQ3_XXS's {4 .. 62}, IQ3_S's the odd 1 .. 15, each with
# its sign; IQ1's grid value g in {-1, 0, 1} and its group's ±0.125 delta
# fold into one 6-entry map, code = (g + 1) + 3·[delta < 0]
IQ2_VALUES = (8.0, 25.0, 43.0, -8.0, -25.0, -43.0)
IQ3XXS_VALUES = tuple(float(s * m) for s in (1, -1) for m in (4, 12, 20, 28, 36, 44, 52, 62))
IQ3S_VALUES = tuple(float(s * m) for s in (1, -1) for m in (1, 3, 5, 7, 9, 11, 13, 15))
IQ1_VALUES = (-0.875, 0.125, 1.125, -1.125, -0.125, 0.875)

# metadata: code bits, scale-group size G, split unit U (= SB, else G),
# symmetric bias or code table
_SCHEMA = {
    GGMLType.Q4_0: dict(bits=4, G=32, bias=8),
    GGMLType.Q4_1: dict(bits=4, G=32),
    GGMLType.Q5_0: dict(bits=5, G=32, bias=16),
    GGMLType.Q5_1: dict(bits=5, G=32),
    GGMLType.Q8_0: dict(bits=8, G=32, signed=True),  # bias folded by sign-extension
    GGMLType.MXFP4: dict(bits=4, G=32, lut=MXFP4_VALUES),
    GGMLType.IQ4_NL: dict(bits=4, G=32, lut=IQ4_NL_VALUES),
    GGMLType.Q4_K: dict(bits=4, G=32, SB=256),
    GGMLType.Q5_K: dict(bits=5, G=32, SB=256),
    GGMLType.Q6_K: dict(bits=6, G=16, SB=256, bias=32),
    GGMLType.Q2_K: dict(bits=2, G=16, SB=256),
    GGMLType.Q3_K: dict(bits=3, G=16, SB=256, bias=4),
    GGMLType.IQ4_XS: dict(bits=4, G=32, SB=256, lut=IQ4_NL_VALUES),
    GGMLType.IQ2_XXS: dict(bits=3, G=32, SB=256, lut=IQ2_VALUES),
    GGMLType.IQ2_XS: dict(bits=3, G=16, SB=256, lut=IQ2_VALUES),
    GGMLType.IQ2_S: dict(bits=3, G=16, SB=256, lut=IQ2_VALUES),
    GGMLType.IQ3_XXS: dict(bits=4, G=32, SB=256, lut=IQ3XXS_VALUES),
    GGMLType.IQ3_S: dict(bits=4, G=32, SB=256, lut=IQ3S_VALUES),
    GGMLType.IQ1_S: dict(bits=3, G=32, SB=256, lut=IQ1_VALUES),
    GGMLType.IQ1_M: dict(bits=3, G=16, SB=256, lut=IQ1_VALUES),
    GGMLType.TQ1_0: dict(bits=2, G=256, SB=256, bias=1),
    GGMLType.TQ2_0: dict(bits=2, G=256, SB=256, bias=1),
}

# The types repacked through their decoded values (nearest-table match)
CODEBOOK_TYPES = frozenset({
    GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S,
    GGMLType.IQ1_S, GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0})
# blocks decoded and matched at once: bounds the [blocks, 256, entries]
# temporary of the match to 1 GiB
_MATCH_BLOCKS = 1 << 16

# Types repacked to wide int8 "qw" planes (bias folded) instead of packed
# sub-byte codes: one byte load and one sign extension per weight.
WIDE_TYPES = frozenset({GGMLType.Q6_K})


def supports(gtype: GGMLType) -> bool:
    return gtype in _SCHEMA


def split_unit(gtype: GGMLType) -> int:
    """Row chunk within which code planes are split."""
    return _SCHEMA[gtype].get("SB", _SCHEMA[gtype]["G"])


def has_minus(gtype: GGMLType) -> bool:
    """Whether the planes of `gtype` hold a `minus` plane: the affine types
    with no symmetric bias, sign or code table (Q4_1, Q5_1, Q2_K, Q4_K,
    Q5_K)."""
    meta = _SCHEMA[gtype]
    return not (meta.get("bias") or meta.get("signed") or "lut" in meta)


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


def _u32le(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 from a trailing axis of 4 uint8, as int64."""
    x = b.to(torch.int64)
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16) | (x[..., 3] << 24)


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """(..., n) packed bytes → (..., 2n): the low nibbles, then the high."""
    return torch.cat([qs & 0x0F, qs >> 4], dim=-1)


def _crumbs(qs: torch.Tensor, n_out: int, nb: int) -> torch.Tensor:
    """K-quant 2-bit fields: (n_out, nb, 64) bytes → (n_out, nb, 256), each
    32-byte half giving its fields at shifts 0, 2, 4, 6 in turn."""
    qs = qs.reshape(n_out, nb, 2, 32)
    return torch.stack([(qs >> s) & 3 for s in (0, 2, 4, 6)], dim=3).reshape(n_out, nb, 256)


def _bit_rows(h: torch.Tensor, n_out: int, nb: int) -> torch.Tensor:
    """K-quant high-bit masks: (n_out, nb, 32) bytes → (n_out, nb, 256), bit
    j of byte r giving row 32·j + r."""
    return torch.stack([(h >> j) & 1 for j in range(8)], dim=2).reshape(n_out, nb, 256)


def _q3k_scales(q: torch.Tensor) -> torch.Tensor:
    """Q3_K 12-byte packed 6-bit scales → (..., 16) int64, minus 32
    (ggml-quants.c dequantize_row_q3_K's kmask1/kmask2 unpack)."""
    a = [_u32le(q[..., 4 * i:4 * i + 4]) for i in range(3)]
    k1, k2, t = 0x03030303, 0x0F0F0F0F, a[2]
    aux = [(a[0] & k2) | (((t >> 0) & k1) << 4), (a[1] & k2) | (((t >> 2) & k1) << 4),
           ((a[0] >> 4) & k2) | (((t >> 4) & k1) << 4),
           ((a[1] >> 4) & k2) | (((t >> 6) & k1) << 4)]
    return torch.stack([(w >> (8 * j)) & 0xFF for w in aux for j in range(4)], dim=-1) - 32


def _e8m0_half(e: torch.Tensor) -> torch.Tensor:
    """MXFP4 exponent bytes → exactly 2^(e-128) in f32, built from its bits:
    the normal exponent field e - 1 for e ≥ 2, the subnormals 2^-127 and
    2^-128 (mantissa bit 22 or 21) for e = 1 and 0, which exp2 may flush."""
    e = e.to(torch.int32)
    bits = torch.where(e >= 2, (e - 1) << 23, 1 << (21 + e.clamp(max=1)))
    return bits.view(torch.float32)


def _decode_blocks(b: torch.Tensor, gtype: GGMLType, n_out: int):
    """Packed blocks (n_out, nb, type_size) uint8 → (codes (K, N) uint8,
    scale (K/G, N) f32, minus (K/G, N) f32 | None). Every factored scale
    is resolved here, in f32."""
    nb = b.shape[1]
    if gtype in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        off = {GGMLType.Q4_0: 2, GGMLType.Q4_1: 4, GGMLType.Q5_0: 6, GGMLType.Q5_1: 8}[gtype]
        codes = _nibbles(b[..., off:off + 16])
        if gtype in (GGMLType.Q5_0, GGMLType.Q5_1):
            qh = _u32le(b[..., off - 4:off])
            hbits = (qh[..., None] >> torch.arange(32, device=b.device)) & 1
            codes = codes | (hbits.to(torch.uint8) << 4)
        d = _f16(b[..., 0:2])
        if gtype in (GGMLType.Q4_0, GGMLType.Q5_0):
            return _col(codes, n_out), _col(d, n_out), None  # bias in the map
        return _col(codes, n_out), _col(d, n_out), _col(-_f16(b[..., 2:4]), n_out)
    if gtype == GGMLType.Q8_0:
        codes = b[..., 2:34]  # int8 bits stored as u8
        return _col(codes, n_out), _col(_f16(b[..., 0:2]), n_out), None
    if gtype == GGMLType.MXFP4:
        return (_col(_nibbles(b[..., 1:17]), n_out), _col(_e8m0_half(b[..., 0]), n_out),
                None)
    if gtype == GGMLType.IQ4_NL:
        return _col(_nibbles(b[..., 2:18]), n_out), _col(_f16(b[..., 0:2]), n_out), None
    if gtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        d = _f16(b[..., 0:2])
        dmin = _f16(b[..., 2:4])
        sc, mi = _scale_min_k4(b[..., 4:16])
        scale = d[..., None] * sc.float()  # exact ggml d1 = d·sc
        minus = dmin[..., None] * mi.float()
        off = 16 if gtype == GGMLType.Q4_K else 48
        codes = _nibbles(b[..., off:off + 128].reshape(n_out, nb, 4, 32)).reshape(n_out, nb, 256)
        if gtype == GGMLType.Q5_K:
            codes = codes | (_bit_rows(b[..., 16:48], n_out, nb) << 4)
        return _col(codes, n_out), _col(scale, n_out), _col(minus, n_out)
    if gtype == GGMLType.Q6_K:
        ql = b[..., 0:128].reshape(n_out, nb, 2, 64)
        qh = b[..., 128:192].reshape(n_out, nb, 2, 32)
        sc = b[..., 192:208].view(torch.int8).float()  # (n_out, nb, 16)
        d = _f16(b[..., 208:210])
        lo = _nibbles(ql)
        hi = torch.stack([(qh >> (2 * j)) & 3 for j in range(4)], dim=3).reshape(
            n_out, nb, 2, 128)
        codes = (lo | (hi << 4)).reshape(n_out, nb, 256)
        scale = d[..., None] * sc
        return _col(codes, n_out), _col(scale, n_out), None  # bias 32 in qw
    if gtype == GGMLType.Q2_K:
        sc = b[..., 0:16]
        codes = _crumbs(b[..., 16:80], n_out, nb)
        scale = _f16(b[..., 80:82])[..., None] * (sc & 0x0F).float()
        minus = _f16(b[..., 82:84])[..., None] * (sc >> 4).float()
        return _col(codes, n_out), _col(scale, n_out), _col(minus, n_out)
    if gtype == GGMLType.Q3_K:
        codes = _crumbs(b[..., 32:96], n_out, nb) | (_bit_rows(b[..., 0:32], n_out, nb) << 2)
        scale = _f16(b[..., 108:110])[..., None] * _q3k_scales(b[..., 96:108]).float()
        return _col(codes, n_out), _col(scale, n_out), None  # bias 4 in the map
    if gtype == GGMLType.IQ4_XS:
        d = _f16(b[..., 0:2])
        scales_h = b[..., 2].to(torch.int32) | (b[..., 3].to(torch.int32) << 8)
        scales_l = b[..., 4:8].to(torch.int32)
        codes = _nibbles(b[..., 8:136].reshape(n_out, nb, 8, 16)).reshape(n_out, nb, 256)
        ls = torch.stack([(((scales_l[..., ib // 2] >> (4 * (ib & 1))) & 0x0F)
                           | (((scales_h >> (2 * ib)) & 3) << 4)) - 32 for ib in range(8)],
                         dim=-1)
        return _col(codes, n_out), _col(d[..., None] * ls.float(), n_out), None
    if gtype in CODEBOOK_TYPES:
        return _match_codebook(b, gtype, n_out)
    raise NotImplementedError(f"repack of {gtype.name} is not ported")


def _match_codebook(b: torch.Tensor, gtype: GGMLType, n_out: int):
    """A codebook type's blocks → (codes, scale, None): the blocks decoded
    in f32 (quant/iq_codecs.py), each value divided by its group scale (0/0
    taken as 0) and matched to the nearest entry of the type's table, ties
    to the lower index (the TQ types: the bias form -1, 0, 1). Runs over
    _MATCH_BLOCKS blocks at a time, on the blocks' device."""
    from ..quant.iq_codecs import IQ_DEQUANT, iq_group_scales

    meta = _SCHEMA[gtype]
    G = meta["G"]
    lut = torch.tensor(meta.get("lut", [i - meta.get("bias", 0) for i in range(3)]),
                       dtype=torch.float32, device=b.device)
    blocks = b.reshape(-1, b.shape[-1])
    scale = iq_group_scales(blocks, gtype)  # (blocks, 256/G)
    codes = torch.empty((blocks.shape[0], QK_K), dtype=torch.uint8, device=b.device)
    for i in range(0, blocks.shape[0], _MATCH_BLOCKS):
        v = IQ_DEQUANT[gtype](blocks[i:i + _MATCH_BLOCKS])
        s = scale[i:i + _MATCH_BLOCKS]
        ratio = torch.nan_to_num(v.reshape(s.shape[0], -1, G) / s[..., None])
        codes[i:i + _MATCH_BLOCKS] = (ratio[..., None] - lut).abs().argmin(-1).reshape(-1, QK_K)
    return _col(codes.reshape(n_out, -1), n_out), _col(scale.reshape(n_out, -1), n_out), None


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
    elif meta["bits"] == 3:
        planes["qs"] = _bitplane_pack(codes & 0x03, 2, U)
        planes["qh"] = _bitplane_pack(codes >> 2, 1, U)
    elif meta["bits"] == 2:
        planes["qs"] = _bitplane_pack(codes, 2, U)
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


def _expand_codes(planes: dict[str, torch.Tensor], gtype: GGMLType) -> torch.Tensor:
    """(K, N) codes from the packed code planes: uint8, int8 for Q8_0."""
    bits, U = _SCHEMA[gtype]["bits"], split_unit(gtype)
    if bits == 8:
        return planes["qs"].view(torch.int8)
    if bits == 4:
        return _half_split_unpack4(planes["qs"], U)
    if bits == 5:
        return _half_split_unpack4(planes["qs"], U) | (_bitplane_unpack(planes["qh"], 1, U) << 4)
    if bits == 3:
        return _bitplane_unpack(planes["qs"], 2, U) | (_bitplane_unpack(planes["qh"], 1, U) << 2)
    if bits == 2:
        return _bitplane_unpack(planes["qs"], 2, U)
    raise NotImplementedError(f"planes of {gtype.name} are not ported")


def plane_values(planes: dict[str, torch.Tensor], gtype: GGMLType) -> torch.Tensor:
    """(K, N) f32 unscaled values: wide int8 `qw` planes (bias pre-folded),
    or the packed codes through the type's map (the identity, the bias
    subtracted, or the code table), as the JAX package's _plane_values."""
    if "qw" in planes:
        return planes["qw"].view(torch.int8).float()
    codes = _expand_codes(planes, gtype)
    meta = _SCHEMA[gtype]
    if meta.get("bias"):
        return (codes.to(torch.int32) - meta["bias"]).float()
    if "lut" in meta:
        return _padded_lut(gtype, codes.device)[codes.to(torch.int32)]
    return codes.float()


def _padded_lut(gtype: GGMLType, device) -> torch.Tensor:
    """The type's code table padded to 2^bits entries with entry 0: a code
    past a 6-entry table maps to entry 0, as the JAX package's where-chain
    maps it."""
    meta = _SCHEMA[gtype]
    lut = list(meta["lut"])
    lut += [lut[0]] * ((1 << meta["bits"]) - len(lut))
    return torch.tensor(lut, dtype=torch.float32, device=device)


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


def matmul_dequant(x: torch.Tensor, ql) -> torch.Tensor:
    """Dequantize, then one product: x [M, n_in] → [M, n_out] with the
    rounding points of the JAX package's matmul_reference
    (tpullm/ops/qmatmul.py), its route for the shapes its kernel refuses:
    the planes dequantized in f32 (values·scale − minus), rounded once to
    x's dtype, then one product with its output in x's dtype."""
    w = dequant_planes(ql.planes, ql.gtype, ql.n_out, ql.n_in).to(x.dtype)
    return torch.matmul(x, w)


def _dequant_stack(stack, dtype) -> torch.Tensor:
    """Every expert dequantized in f32 and rounded once: [E, n_in, n_out]."""
    return torch.stack([
        dequant_planes({k: v[e] for k, v in stack.planes.items()}, stack.gtype, stack.n_out,
                       stack.n_in).to(dtype) for e in range(stack.planes["scale"].shape[0])])


def stack_matmul_dequant(x: torch.Tensor, stack) -> torch.Tensor:
    """x [M, K] or [E, M, K] → [E, M, n_out] as the JAX package's
    stack_matmul_reference computes it (matmul_dequant for every expert)."""
    return torch.matmul(x, _dequant_stack(stack, x.dtype))


def gather_matmul_dequant(x: torch.Tensor, ids: torch.Tensor, stack) -> torch.Tensor:
    """x [T, K], ids [T] → [T, n_out] as the JAX package's
    gather_matmul_reference computes it (row t through expert ids[t]'s
    dequantized weight)."""
    w = _dequant_stack(stack, x.dtype)[ids.long()]  # [T, K, N]
    return torch.bmm(x[:, None, :], w)[:, 0]


def _dequant_route(gtype: GGMLType, x: torch.Tensor, n_in: int, n_out: int) -> bool:
    """Whether a call takes the dequantize-then-matmul route: on the card,
    for a shape no qmm kernel takes (counted in qmm.DEQUANT_ROUTES). The
    shape decides, before any launch; a kernel failure never leads here."""
    from .kernels import qmm

    if not x.is_cuda or qmm.takes(n_in, n_out):
        return False
    qmm.DEQUANT_ROUTES[gtype.name] += 1
    return True


def matmul(x: torch.Tensor, ql) -> torch.Tensor:
    """Fused dequant matmul: x [..., n_in] → [..., n_out].

    A CUDA tensor goes to the hand-written qmm kernel (which raises on what
    it does not take), or to the group-factored qmm_grouped kernel for the
    types of `qmm.GROUPED_TYPES`, or, for a shape no kernel takes, to
    matmul_dequant; a CPU tensor to the kernel's plain version."""
    from .kernels import qmm

    lead = x.shape[:-1]
    x2 = x.reshape(-1, ql.n_in)
    grouped = ql.gtype in qmm.GROUPED_TYPES
    if _dequant_route(ql.gtype, x2, ql.n_in, ql.n_out):
        out = matmul_dequant(x2, ql)
    elif x2.is_cuda:
        fn = qmm.qmm_grouped if grouped else qmm.qmm
        out = fn(x2.contiguous(), ql.planes, ql.gtype, ql.n_out, ql.n_in)
    else:
        fn = qmm.qmm_grouped_reference if grouped else qmm.qmm_reference
        out = fn(x2, ql.planes, ql.gtype, ql.n_out, ql.n_in)
    return out.reshape(*lead, ql.n_out)


def stack_matmul(x: torch.Tensor, stack) -> torch.Tensor:
    """All-experts packed matmul (MoE prefill): x [M, K] (shared) or
    [E, M, K] (per expert) through a QuantExpertStack → [E, M, n_out]. A
    CUDA tensor goes to the qmm_stack kernel (stack_matmul_dequant for a
    shape it does not take), a CPU tensor to its plain version."""
    from .kernels import qmm

    if _dequant_route(stack.gtype, x, stack.n_in, stack.n_out):
        return stack_matmul_dequant(x, stack)
    if x.is_cuda:
        return qmm.qmm_stack(x.contiguous(), stack.planes, stack.gtype, stack.n_out,
                             stack.n_in)
    return qmm.qmm_stack_reference(x, stack.planes, stack.gtype, stack.n_out, stack.n_in)


def gather_matmul(x: torch.Tensor, ids: torch.Tensor, stack) -> torch.Tensor:
    """Expert-indexed packed matmul (MoE decode): row t of x [T, K] through
    expert ids[t] → [T, n_out], reading only the routed experts' planes. A
    CUDA tensor goes to the qmm_gather kernel (which reads `ids` on the
    card; gather_matmul_dequant for a shape it does not take), a CPU tensor
    to its plain version."""
    from .kernels import qmm

    if _dequant_route(stack.gtype, x, stack.n_in, stack.n_out):
        return gather_matmul_dequant(x, ids, stack)
    if x.is_cuda:
        return qmm.qmm_gather(x.contiguous(), ids.to(torch.int32).contiguous(), stack.planes,
                              stack.gtype, stack.n_out, stack.n_in)
    return qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, stack.n_out, stack.n_in)
