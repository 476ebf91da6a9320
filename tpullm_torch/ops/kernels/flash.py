"""The flash-attention kernel over the head-major KV cache, and its plain
version.

Replaces tpullm/ops/pallas/flash.py::_make_kernel (the pallas_call in _run):
the bf16-KV instantiation (quant=False, entry flash_attention) and the
int8+scale-KV instantiation (quant=True, entry flash_attention_q8). Source:
tpullm_torch/csrc/flash.cu. What bounds it on the card: the K/V bytes up to
kv_len at decode, the QK and PV products at prefill.

Layouts as in the JAX package: q [B, T, H, D] (caller layout), k/v
[B, Hkv, S, D] (cache layout), k_s/v_s [B, Hkv, S] f32, offsets [B] int32
(query row t sits at position off_b + t; kv_len_b = off_b + T).
`flash_reference` computes the same function densely in f32 and casts the
output to q's dtype; rows that see no key give 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the kernel, by KV format; a plain count a run can read
LAUNCHES = {"bf16": 0, "q8": 0}
# calls ops.attention sent to its dense path on the card because the kernel
# does not take their head dims (`takes`), by KV format; 0 on a model whose
# heads the kernel takes
ATTN_DENSE_ROUTES = {"bf16": 0, "q8": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BF16_ARGS = (_P,) * 7 + (_I,) * 6 + (_F, _F, _I, _P)
_Q8_ARGS = (_P,) * 9 + (_I,) * 6 + (_F, _F, _I, _P)
_HEAD_DIMS = (64, 128)


def flash_reference(q, k, v, offsets, scale: float, softcap: float = 0.0,
                    sliding_window: int = 0, sinks=None, alibi_slopes=None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """Dense f32 attention with the kernel's semantics; with k_scale/v_scale
    the K/V are int8 codes dequantized as code · scale[pos]."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float() if k_scale is None else k.float() * k_scale.float()[..., None]
    vf = v.float() if v_scale is None else v.float() * v_scale.float()[..., None]
    qf = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bhsd->bhgts", qf, kf) * scale  # [B, Hkv, G, T, S]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = offsets.to(torch.int64)[:, None] + torch.arange(T, device=q.device)[None]
    k_pos = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        dist = (k_pos[None, None, :] - q_pos[:, :, None]).float()  # [B, T, S]
        s = s + alibi_slopes.float().reshape(Hkv, G)[None, :, :, None, None] * dist[:, None, None]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    if sliding_window > 0:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    mask = mask[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1)  # [B, Hkv, G, T]
    if sinks is not None:
        m = torch.maximum(m, sinks.float().reshape(Hkv, G)[None, :, :, None])
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    if sinks is not None:
        l = l + torch.exp(sinks.float().reshape(Hkv, G)[None, :, :, None] - m)
    out = torch.einsum("bhgts,bhsd->bthgd", e, vf)
    out = out / torch.where(l > 0, l, torch.ones_like(l)).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


def takes(d: int, dv: int) -> bool:
    """Whether the kernel takes query/key head dim d and value head dim dv."""
    return d in _HEAD_DIMS and dv == d


def _check(q, kv, offsets, sinks, slopes):
    B, T, H, D = q.shape
    k, v = kv[0], kv[-1]
    if not takes(D, v.shape[-1]) or k.shape[0] != B or H % k.shape[1]:
        raise ValueError(f"flash: needs head_dim in {_HEAD_DIMS} (K and V alike), "
                         f"H % Hkv == 0; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError("flash: q must be bf16")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (B,):
        raise ValueError("flash: offsets must be int32 [B]")
    for t in (q, *kv, offsets, sinks, slopes):
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash: every operand must be on the same CUDA device")
        # K/V rows are read 16 bytes at a time, everything else by element
        align = 16 if t is k or t is v else t.element_size()
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("flash: operands must be contiguous and aligned")
    for t in (sinks, slopes):
        if t is not None and (t.dtype != torch.float32 or t.numel() != H):
            raise ValueError("flash: sinks / ALiBi slopes must be f32 [H]")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def flash_attention(q, k, v, offsets, scale: float, softcap: float = 0.0,
                    sliding_window: int = 0, sinks=None, alibi_slopes=None):
    """bf16 KV: q [B,T,H,D], k/v [B,Hkv,S,D] → [B,T,H,D]. The kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        return flash_reference(q, k, v, offsets, scale, softcap, sliding_window,
                               sinks, alibi_slopes)
    _check(q, (k, v), offsets, sinks, alibi_slopes)
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError("flash: the bf16 kernel takes a bf16 cache")
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    fn = _build.bind("flash", "tpullm_flash_bf16", _BF16_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets.data_ptr(),
            _ptr(sinks), _ptr(alibi_slopes), out.data_ptr(), B, T, H, k.shape[1],
            k.shape[2], D, float(scale), float(softcap), int(sliding_window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash bf16")
    LAUNCHES["bf16"] += 1
    return out


def flash_attention_q8(q, k_q, k_s, v_q, v_s, offsets, scale: float,
                       softcap: float = 0.0, sliding_window: int = 0, sinks=None,
                       alibi_slopes=None):
    """int8 KV with one f32 scale per position: k_q/v_q [B,Hkv,S,D] int8,
    k_s/v_s [B,Hkv,S] f32 → [B,T,H,D]."""
    if not q.is_cuda:
        return flash_reference(q, k_q, v_q, offsets, scale, softcap, sliding_window,
                               sinks, alibi_slopes, k_scale=k_s, v_scale=v_s)
    _check(q, (k_q, k_s, v_s, v_q), offsets, sinks, alibi_slopes)
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8 or \
            k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise ValueError("flash: the q8 kernel takes int8 codes and f32 scales")
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    fn = _build.bind("flash", "tpullm_flash_q8", _Q8_ARGS)
    rc = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), offsets.data_ptr(), _ptr(sinks), _ptr(alibi_slopes),
            out.data_ptr(), B, T, H, k_q.shape[1], k_q.shape[2], D, float(scale),
            float(softcap), int(sliding_window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash q8")
    LAUNCHES["q8"] += 1
    return out
