"""Llama 4 decoder (Scout, Maverick; the JAX package's models/llama4.py,
reference graph llm_build_llama_iswa).

The qwen-moe tensor set (models/qwen_moe.py build_params) under a graph of
its own:
  * chunked attention: a layer il with hp.is_swa(il) (three of every four
    at the default pattern 4) attends only to the keys of its query's
    chunk of hp.sliding_window positions, after RoPE and then a weightless
    L2 norm of q and k (an RMS norm without weight, eps hp.rms_eps);
  * every fourth layer NoPE: no RoPE, no qk norm, q scaled by the
    attention temperature log(floor((pos + 1) / 8192) + 1) · 0.1 + 1,
    computed in f32 and rounded to q's dtype;
  * MoE layers: sigmoid top-k routing without renormalisation, the routing
    weight applied to the expert input (ops/moe.py weight_before_ffn), plus
    an ungated shared expert; a layer without a router a dense SwiGLU
    (Maverick's interleave).

The chunked layers' attention: the flash kernel derives its causal mask
from the offsets and cannot express chunks. Where the cache holds at most
one chunk (max_len ≤ sliding_window) every key slot and every query lies
in chunk 0, the chunk mask equals the causal one, and the layer takes the
flash kernel; a longer cache takes ops/attention.py attention_chunked,
dense attention under the chunk mask (the JAX package's route for every
chunked layer). The choice is the cache's shape, made once a forward.
"""

from __future__ import annotations

import torch

from ..ops.attention import attention_cached, attention_chunked, chunk_mask
from ..ops.moe import moe_ffn, route
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from .hparams import HParams
from .llama import Params, dense_ffn, finish, forward_offsets, router_logits, silu_glu
from .qwen_moe import build_params  # noqa: F401 (the same tensor set)

ATTN_TEMP_FLOOR = 8192  # n_attn_temp_floor_scale
ATTN_TEMP_SCALE = 0.1
ATTN_TEMP_OFFSET = 1.0


def l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama4TextL2Norm: x · rsqrt(mean(x²) + eps) in f32, rounded to x's
    dtype (a weightless RMS norm)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(x.dtype)


def attn_temperature(positions: torch.Tensor) -> torch.Tensor:
    """The NoPE layers' query scale of positions [B, T] → [B, T, 1, 1] f32."""
    p = positions.float()
    return (torch.log(torch.floor((p + ATTN_TEMP_OFFSET) / ATTN_TEMP_FLOOR) + 1.0)
            * ATTN_TEMP_SCALE + 1.0)[:, :, None, None]


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits, cache), with models/llama.py
    forward's `cache_offset` (a host int, a 0-d device tensor, or per-slot
    offsets with −1 idle), `last_index` and `return_hidden`."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    scale = hp.attn_scale if hp.attn_scale is not None else hp.head_dim ** -0.5
    W = hp.sliding_window  # the chunk
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    cos, sin = rope_angles(hp.rope, positions)
    # the chunked layers leave the kernel only where a chunk boundary lies in the cache
    mask = chunk_mask(positions, offsets, cache.max_len, W) if 0 < W < cache.max_len else None
    temp = attn_temperature(positions)
    for li, layer in enumerate(params["layers"]):
        use_rope = W == 0 or hp.is_swa(li)
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        fused = layer.get("wqkv")
        q, k, v = fused(h) if fused is not None else (layer["wq"](h), layer["wk"](h),
                                                      layer["wv"](h))
        q = q.reshape(B, T, hp.n_head, hp.head_dim)
        k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
        v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
        if use_rope:  # RoPE, then the L2 norm (the JAX order)
            q = l2_norm(apply_rope_angles(q, cos, sin, hp.rope.style), hp.rms_eps)
            k = l2_norm(apply_rope_angles(k, cos, sin, hp.rope.style), hp.rms_eps)
        else:
            q = q * temp.to(q.dtype)
        cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
        if use_rope and mask is not None:
            attn = attention_chunked(q, cache, li, mask, scale)
        else:
            attn = attention_cached(q.contiguous(), cache, li, scale, offsets)
        x = x + layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v))

        h = rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        if layer.get("router") is None:  # an interleaved dense layer
            x = x + dense_ffn(layer, h)
            continue
        hs = h.reshape(B * T, -1)
        weights, idx = route(router_logits(layer["router"], hs), hp.n_expert_used,
                             gating="sigmoid", norm_weights=False)
        ffn = moe_ffn(hs, weights, idx, layer["w_gate_exps"], layer["w_up_exps"],
                      layer["w_down_exps"], weight_before_ffn=True)
        if layer.get("w_gate_shexp") is not None:  # the ungated shared expert
            shared = layer["w_down_shexp"](silu_glu(layer["w_gate_shexp"](hs),
                                                    layer["w_up_shexp"](hs)))
            ffn = ffn + shared.to(ffn.dtype)
        x = x + ffn.reshape(B, T, -1)
    return finish(hp, params, x, last_index, return_hidden), cache

