"""Attention ops: the dense reference (KQ·softmax·V with an explicit mask)
and the cached-attention dispatch.

`attention_cached` sends every call to the flash kernel for the cache's
format: a CUDA tensor always goes to the kernel, at every T and every S, and
a CPU tensor to the kernel's plain version. (The JAX package sends bf16
decode at S < 4096 to its dense path; on the card the plain version never
runs on the main path.)
"""

from __future__ import annotations

import math

import torch

from .kernels import flash


def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes, matching ggml's soft_max_ext formula."""
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


def attention_cached(q, cache, li: int, scale: float, offsets: torch.Tensor,
                     softcap: float = 0.0, sliding_window: int = 0,
                     sinks=None, alibi_slopes=None) -> torch.Tensor:
    """Attention of q [B,T,H,D] against cache layer `li` through the flash
    kernel of the cache's format (int8 + scales stream straight in for a
    QuantKVCache; the cache never widens in device memory)."""
    if hasattr(cache, "kv_packed"):
        k_q, k_s, v_q, v_s = cache.kv_packed(li)
        return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, offsets, scale, softcap,
                                        sliding_window, sinks, alibi_slopes)
    k, v = cache.kv(li)
    return flash.flash_attention(q, k, v, offsets, scale, softcap, sliding_window,
                                 sinks, alibi_slopes)
