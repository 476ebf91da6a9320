"""Attention ops: the dense reference (KQ·softmax·V with an explicit mask)
and the cached-attention dispatch.

`attention_cached` sends every call to the flash kernel for the cache's
format: a CUDA tensor goes to the kernel, at every T and every S, and a CPU
tensor to the kernel's plain version. (The JAX package sends bf16 decode at
S < 4096 to its dense path; on the card the plain version never runs on the
main path.) The one exception is a shape the kernel does not take (a head
dim outside flash._HEAD_DIMS, or Dk ≠ Dv): on the card it goes to the dense
path, as the JAX package sends the shapes its flash kernel refuses there
(tpullm/ops/attention.py `attention`), counted in flash.ATTN_DENSE_ROUTES.
"""

from __future__ import annotations

import functools
import math

import torch

from .kernels import flash


@functools.lru_cache(maxsize=None)
def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes, matching ggml's soft_max_ext formula; made
    once per device (a captured decode step copies nothing from the host)."""
    n_log2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n_log2)
    m1 = 2.0 ** (-max_bias / 2.0 / n_log2)
    return torch.tensor(
        [m0 ** (h + 1) if h < n_log2 else m1 ** (2 * (h - n_log2) + 1)
         for h in range(n_head)], dtype=torch.float32, device=device)


def causal_mask(positions: torch.Tensor, n_keys: int, kv_len,
                sliding_window: int = 0) -> torch.Tensor:
    """[B, T, S] boolean mask over a cache laid out as absolute slots 0..n_keys."""
    key_pos = torch.arange(n_keys, device=positions.device)[None, None, :]
    qpos = positions[:, :, None]
    mask = key_pos <= qpos
    kv_len = torch.as_tensor(kv_len, device=positions.device)
    if kv_len.ndim == 1:  # per-slot lengths
        kv_len = kv_len[:, None, None]
    mask &= key_pos < kv_len
    if sliding_window > 0:
        mask &= key_pos > qpos - sliding_window
    return mask


def attention_reference(q, k, v, mask, scale: float, softcap: float = 0.0) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,Hkv,S,D], mask [B,T,S] (True = attend) → [B,T,H,Dv]."""
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, k.float()) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    m = mask[:, None, None]
    scores = scores.masked_fill(~m, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key (fully masked) produce NaN; zero them
    probs = torch.where(m.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    out = torch.einsum("bhgts,bhsd->bthgd", probs, v.float())
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)


def _attention_dense(q, k, v, offsets, scale: float, softcap: float, sliding_window: int,
                     sinks, alibi_slopes) -> torch.Tensor:
    """The dense path for the shapes the flash kernel does not take: query
    row t of batch b at position offsets[b] + t, keys up to it in the
    window. With sinks or ALiBi the kernel's plain version, which computes
    them densely; otherwise attention_reference with the causal mask."""
    if sinks is not None or alibi_slopes is not None:
        return flash.flash_reference(q, k, v, offsets, scale, softcap, sliding_window,
                                     sinks, alibi_slopes)
    T = q.shape[1]
    off = offsets.to(torch.int64)
    positions = off[:, None] + torch.arange(T, device=q.device)[None]
    mask = causal_mask(positions, k.shape[2], off + T, sliding_window)
    return attention_reference(q, k, v, mask, scale, softcap)


def attention_cached(q, cache, li: int, scale: float, offsets: torch.Tensor,
                     softcap: float = 0.0, sliding_window: int = 0,
                     sinks=None, alibi_slopes=None) -> torch.Tensor:
    """Attention of q [B,T,H,D] against cache layer `li` through the flash
    kernel of the cache's format (int8 + scales stream straight in for a
    QuantKVCache; the cache never widens in device memory), or on the card,
    for a head dim the kernel does not take, through the dense path."""
    quant = hasattr(cache, "kv_packed")
    if q.is_cuda and not flash.takes(q.shape[-1], (cache.v_q if quant else cache.v).shape[-1]):
        flash.ATTN_DENSE_ROUTES["q8" if quant else "bf16"] += 1
        if quant:
            k_q, k_s, v_q, v_s = cache.kv_packed(li)
            k, v = k_q.float() * k_s[..., None], v_q.float() * v_s[..., None]
        else:
            k, v = cache.kv(li)
        return _attention_dense(q, k, v, offsets, scale, softcap, sliding_window, sinks,
                                alibi_slopes)
    if quant:
        k_q, k_s, v_q, v_s = cache.kv_packed(li)
        return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, offsets, scale, softcap,
                                        sliding_window, sinks, alibi_slopes)
    k, v = cache.kv(li)
    return flash.flash_attention(q, k, v, offsets, scale, softcap, sliding_window,
                                 sinks, alibi_slopes)
