"""Dequant codecs of the i-quant and ternary ggml formats, in torch, on any
device.

Bit-compatible with ggml's CPU kernels (ggml-quants.c dequantize_row_iq2_xxs
.. dequantize_row_tq2_0) and with the JAX package's numpy codecs
(tpullm/quant/iq_codecs.py): the same unpacking and the same f32 operation
order, so every value and every group scale agrees bit for bit (the repack's
nearest-table match divides by these scales, and one rounding more or less
would change a code). The lattice codebooks (ggml-common.h iq*_grid) ship
as format-constant data in `iq_grids.npz`, a copy of the JAX package's.

Each function takes blocks as a (n, type_size) uint8 tensor and returns
(n, 256) f32 values on the blocks' device; `iq_group_scales` returns the
(n, 256/G) effective f32 group scales, the `scale` planes of ops/qmatmul.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..gguf.constants import QK_K, GGMLType

_GRIDS = np.load(os.path.join(os.path.dirname(__file__), "iq_grids.npz"))
_GRID_NAMES = ("iq2xxs_grid", "iq2xs_grid", "iq2s_grid", "iq3xxs_grid", "iq3s_grid",
               "iq1s_grid")
IQ1_DELTA = 0.125


def _ksigns() -> np.ndarray:
    """ksigns_iq2xs expanded to (128, 8) of ±1: entry i carries the 7 low
    sign bits of i plus an odd-parity bit 7 (bit set = negative)."""
    i = np.arange(128, dtype=np.uint8)
    parity = np.zeros(128, dtype=np.uint8)
    for b in range(7):
        parity ^= (i >> b) & 1
    byte = i | (parity << 7)
    return np.where((byte[:, None] >> np.arange(8, dtype=np.uint8)) & 1, -1.0, 1.0).astype(
        np.float32)


KSIGNS = _ksigns()


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict[str, torch.Tensor]:
    """The grids (f32) and KSIGNS on `device`, made once per device."""
    out = {name: torch.from_numpy(_GRIDS[name].astype(np.float32)).to(device)
           for name in _GRID_NAMES}
    out["ksigns"] = torch.from_numpy(KSIGNS).to(device)
    return out


def _t(b: torch.Tensor) -> dict[str, torch.Tensor]:
    return _tables(str(b.device))


def _f16(b2: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8, little-endian IEEE half → (...) f32."""
    return b2.contiguous().view(torch.float16)[..., 0].float()


def _u16(b2: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8 → (...) little-endian u16, as int64."""
    x = b2.to(torch.int64)
    return x[..., 0] | (x[..., 1] << 8)


def _u32(b4: torch.Tensor) -> torch.Tensor:
    """(..., 4) uint8 → (...) little-endian u32, as int64."""
    x = b4.to(torch.int64)
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16) | (x[..., 3] << 24)


def _ar(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _sign_bytes(sb: torch.Tensor) -> torch.Tensor:
    """(...) explicit sign bytes → (..., 8) of ±1 (bit set = negative)."""
    bits = (sb.to(torch.int64)[..., None] >> _ar(8, sb)) & 1
    return torch.where(bits == 1, -1.0, 1.0).to(torch.float32)


def _half_scales(scales: torch.Tensor) -> torch.Tensor:
    """(n, 8) bytes of two 4-bit scales → (n, 8, 2) f32, low nibble first."""
    return torch.stack([scales & 0xF, scales >> 4], dim=-1).float()


def _iq1m_scales(sc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """IQ1_M's four scale words (n, 4) → the scales of the first and second
    16 elements of each 32-group, (n, 8) f32 each. The block's f16 d is
    spread over the words' top nibbles; group ib's 3-bit scales sit in word
    ib//2 at bit 6·(ib%2), the second half's 3 bits above."""
    bits = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
            | (sc[:, 3] & 0xF000))
    d = (bits - ((bits & 0x8000) << 1)).to(torch.int16).view(torch.float16).float()
    shift = 6 * (_ar(8, sc) % 2)
    w = sc[:, _ar(8, sc) // 2]
    dl1 = d[:, None] * (2 * ((w >> shift) & 7) + 1).float()
    dl2 = d[:, None] * (2 * ((w >> (shift + 3)) & 7) + 1).float()
    return dl1, dl2


def dequant_iq2_xxs(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    q = b[:, 2:66].reshape(n, 8, 8)  # per 32-group: 4 grid bytes, then the aux word
    gidx = q[:, :, 0:4].long()
    aux = _u32(q[:, :, 4:8])  # (n, 8) signs + scale
    db = d[:, None] * (0.5 + (aux >> 28).float()) * 0.25
    sidx = (aux[..., None] >> (7 * _ar(4, b))) & 127
    vals = db[:, :, None, None] * _t(b)["iq2xxs_grid"][gidx]  # (n, 8, 4, 8)
    return (vals * _t(b)["ksigns"][sidx]).reshape(n, QK_K)


def dequant_iq2_xs(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    q16 = _u16(b[:, 2:66].reshape(n, 8, 4, 2))
    db = d[:, None, None] * (0.5 + _half_scales(b[:, 66:74])) * 0.25
    db4 = db[:, :, [0, 0, 1, 1]]  # l = 0, 1: low nibble; 2, 3: high
    vals = db4[..., None] * _t(b)["iq2xs_grid"][q16 & 511]
    return (vals * _t(b)["ksigns"][q16 >> 9]).reshape(n, QK_K)


def dequant_iq2_s(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(n, 8, 4)  # grid low bytes
    sgn = b[:, 34:66].reshape(n, 8, 4)  # explicit sign bytes
    qh = b[:, 66:74]
    hi = ((qh.to(torch.int64)[:, :, None] >> (2 * _ar(4, b))) & 3) << 8
    gidx = qs.long() | hi
    db = d[:, None, None] * (0.5 + _half_scales(b[:, 74:82])) * 0.25
    vals = db[:, :, [0, 0, 1, 1], None] * _t(b)["iq2s_grid"][gidx]
    return (vals * _sign_bytes(sgn)).reshape(n, QK_K)


def dequant_iq3_xxs(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    gidx = b[:, 2:66].reshape(n, 8, 4, 2).long()  # 8 codewords of 4 per 32-group
    aux = _u32(b[:, 66:98].reshape(n, 8, 4))
    db = d[:, None] * (0.5 + (aux >> 28).float()) * 0.5
    sidx = (aux[..., None] >> (7 * _ar(4, b))) & 127
    vals = _t(b)["iq3xxs_grid"][gidx].reshape(n, 8, 4, 8)
    return ((db[:, :, None, None] * vals) * _t(b)["ksigns"][sidx]).reshape(n, QK_K)


def dequant_iq3_s(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:66].reshape(n, 8, 8)  # 8 low bytes per 32-group
    qh = b[:, 66:74]  # one high-bit byte per 32-group
    sgn = b[:, 74:106].reshape(n, 8, 4)
    scales = b[:, 106:110]  # one nibble pair per two groups
    hi = ((qh.to(torch.int64)[:, :, None] >> _ar(8, b)) & 1) << 8
    gidx = qs.long() | hi
    nib = torch.stack([scales & 0xF, scales >> 4], dim=-1).reshape(n, 8)
    db = d[:, None] * (1.0 + 2.0 * nib.float())
    vals = _t(b)["iq3s_grid"][gidx].reshape(n, 8, 4, 8)
    return ((db[:, :, None, None] * vals) * _sign_bytes(sgn)).reshape(n, QK_K)


def dequant_iq1_s(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 0:2])
    qs = b[:, 2:34].reshape(n, 8, 4)
    qh = _u16(b[:, 34:50].reshape(n, 8, 2))
    dl = d[:, None] * (2 * ((qh >> 12) & 7) + 1).float()
    delta = torch.where((qh & 0x8000) != 0, -IQ1_DELTA, IQ1_DELTA).float()
    hi = ((qh[:, :, None] >> (3 * _ar(4, b))) & 7) << 8
    gidx = qs.long() | hi
    vals = _t(b)["iq1s_grid"][gidx] + delta[:, :, None, None]
    return (dl[:, :, None, None] * vals).reshape(n, QK_K)


def dequant_iq1_m(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    qs = b[:, 0:32].reshape(n, 8, 4)
    qh = b[:, 32:48].reshape(n, 8, 2)
    dl1, dl2 = _iq1m_scales(_u16(b[:, 48:56].reshape(n, 4, 2)))
    dl = torch.stack([dl1, dl1, dl2, dl2], dim=-1)  # (n, 8, 4) per l
    qh_l = qh[:, :, [0, 0, 1, 1]].to(torch.int64)  # the qh byte each l reads
    hsh = torch.tensor([8, 4, 8, 4], device=b.device)  # << 8 then & 0x700: low or high nibble
    gidx = qs.long() | ((qh_l << hsh) & 0x700)
    dmask = torch.tensor([0x08, 0x80, 0x08, 0x80], device=b.device)
    delta = torch.where((qh_l & dmask) != 0, -IQ1_DELTA, IQ1_DELTA).float()
    vals = _t(b)["iq1s_grid"][gidx] + delta[..., None]
    return (dl[..., None] * vals).reshape(n, QK_K)


def _ternary_digits(q: torch.Tensor, n_digits: int) -> torch.Tensor:
    """ggml's base-3 digits: digit k of byte q is uint8(q·3^k)·3 >> 8, in
    0..2, minus 1. (n, m) → (n, n_digits, m), digit-major."""
    pow3 = torch.tensor([1, 3, 9, 27, 81][:n_digits], dtype=torch.int64, device=q.device)
    scaled = (q.to(torch.int64)[:, None, :] * pow3[:, None]) & 0xFF
    return ((scaled * 3) >> 8) - 1


def dequant_tq1_0(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    d = _f16(b[:, 52:54])[:, None]
    vals = torch.cat([_ternary_digits(b[:, 0:32], 5).reshape(n, 160),
                      _ternary_digits(b[:, 32:48], 5).reshape(n, 80),
                      _ternary_digits(b[:, 48:52], 4).reshape(n, 16)], dim=1)
    return vals.float() * d


def dequant_tq2_0(b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    qs = b[:, 0:64].reshape(n, 2, 32).to(torch.int64)
    d = _f16(b[:, 64:66])[:, None]
    two = (qs[:, :, None, :] >> (2 * _ar(4, b))[:, None]) & 3
    return (two - 1).reshape(n, QK_K).float() * d


IQ_DEQUANT = {
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
    GGMLType.TQ1_0: dequant_tq1_0,
    GGMLType.TQ2_0: dequant_tq2_0,
}


def iq_group_scales(b: torch.Tensor, gtype: GGMLType) -> torch.Tensor:
    """Effective f32 scales of each scale group: (n, type_size) blocks →
    (n, 256/G). With the value tables of ops/qmatmul.py, dequant ==
    scale[g] · table[code] bit for bit (sign flips and the IQ1 ±0.125 delta
    are exact in f32)."""
    n = b.shape[0]
    if gtype in (GGMLType.TQ1_0, GGMLType.TQ2_0):
        off = 52 if gtype == GGMLType.TQ1_0 else 64
        return _f16(b[:, off:off + 2]).reshape(n, 1)
    if gtype == GGMLType.IQ1_M:
        dl1, dl2 = _iq1m_scales(_u16(b[:, 48:56].reshape(n, 4, 2)))
        return torch.stack([dl1, dl2], dim=-1).reshape(n, 16)  # per 16 elements
    d = _f16(b[:, 0:2])
    if gtype == GGMLType.IQ2_XXS:
        aux = _u32(b[:, 2:66].reshape(n, 8, 2, 4)[:, :, 1])
        return d[:, None] * (0.5 + (aux >> 28).float()) * 0.25
    if gtype in (GGMLType.IQ2_XS, GGMLType.IQ2_S):
        off = 66 if gtype == GGMLType.IQ2_XS else 74
        return (d[:, None, None] * (0.5 + _half_scales(b[:, off:off + 8])) * 0.25).reshape(n, 16)
    if gtype == GGMLType.IQ3_XXS:
        aux = _u32(b[:, 66:98].reshape(n, 8, 4))
        return d[:, None] * (0.5 + (aux >> 28).float()) * 0.5
    if gtype == GGMLType.IQ3_S:
        scales = b[:, 106:110]
        nib = torch.stack([scales & 0xF, scales >> 4], dim=-1).reshape(n, 8)
        return d[:, None] * (1.0 + 2.0 * nib.float())
    if gtype == GGMLType.IQ1_S:
        qh = _u16(b[:, 34:50].reshape(n, 8, 2))
        return d[:, None] * (2 * ((qh >> 12) & 7) + 1).float()
    raise NotImplementedError(gtype)
