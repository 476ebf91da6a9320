"""DeepSeek-V2/V3 decoder: multi-head latent attention (MLA) and MoE with
shared experts (the JAX package's models/deepseek2.py, arch `deepseek2`,
and its aliases `minicpm3`, whose embedding, residual and logit multipliers
come from models/hparams.py, and `plm`, all dense with a gateless ReLU²).

The graph of llm_build_deepseek2: q direct (V2-Lite) or through a q LoRA
with its norm (wq_a, q_a_norm, wq_b), the kv compression wkv_a_mqa into the
kv_lora_rank latent (normed by kv_a_norm) and one shared RoPE key of n_rot
dims, RoPE on the trailing n_rot dims of each head's query; leading dense
layers (SwiGLU, or plm's gateless ReLU²), then MoE layers routed by
softmax or sigmoid gating, with the selection bias exp_probs_b (V3),
renormalised and scaled weights, and an always-on shared expert.

Two forms of the attention, picked by the cache's type as the JAX package
picks them:
  * absorbed (MLACache, the default): the cache holds the latent
    [kv_cmpr | k_pe] of each position (one KV head), attn_kv_b is split at
    load into wk_b [H, n_nope, kvr] and wv_b [H, Dv, kvr], the queries
    q_nope · wk_b concatenated with q_pe score against the latent directly
    (Dk = kvr + n_rot: 576 for DeepSeek-V2 and PLM, 288 for MiniCPM3), the
    values are the latent's first kvr features (Dv = 512, 256), and wv_b
    projects the output. The two einsums around the kernel are plain
    products, as the JAX package computes them outside Pallas; the
    attention is the flash kernel's latent form;
  * decompressed (a per-head KVCache, or QuantKVCache for a q8 request,
    TPULLM_MLA=0): the latent is expanded through wkv_b into per-head keys
    [k_nope | k_pe] and values, MHA at Dk = 192, Dv = 128 (DeepSeek-V2,
    PLM) or Dk = 96, Dv = 64 (MiniCPM3): the JAX package's oracle, on the
    card the flash kernel at Dk ≠ Dv.
The softmax scale is Dk^-0.5 with Dk the per-head key width (192, 96), in
both. The form is read at load from TPULLM_MLA, as in the JAX package.
Offsets take the three forms of models/llama.py.
"""

from __future__ import annotations

import os

import torch

from ..gguf.reader import GGUFReader
from ..ops.attention import attention_cached
from ..ops.moe import moe_ffn, route
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from ..runtime import kvcache
from .hparams import HParams
from .llama import Params, dense_ffn, finish, forward_offsets, router_logits, silu_glu
from .weights import (MODES, dense_weight, load_embedding, load_expert_stack, load_linear,
                      load_vector)


def mla_absorbed(hp: HParams) -> bool:
    """Whether the model runs the absorbed-latent form (every MLA model,
    unless TPULLM_MLA=0 asks for the decompressed one)."""
    return hp.n_lora_kv > 0 and os.environ.get("TPULLM_MLA", "1") != "0"


def mla_dims(hp: HParams) -> tuple[int, int, int, int]:
    """(Dk, Dv, n_rot, n_nope) of a head: files that store the MQA form in
    key_length / value_length carry the per-head dims in *_mla."""
    Dk = hp.head_dim_k_mla or hp.head_dim
    Dv = hp.head_dim_v_mla or hp.head_dim_v
    return Dk, Dv, hp.rope.dims, Dk - hp.rope.dims


def make_cache(hp: HParams, batch: int, max_len: int, kv_dtype, device=None):
    """The JAX package's MLA cache rule (models/registry.py `_mla_cache`):
    every named cache type ("f16", "bf16", "f32", "q8_0") gives a bf16
    cache, a torch dtype its own. Absorbed: the latent cache (MLACache;
    the latent is already ~9× smaller than the decompressed cache).
    TPULLM_MLA=0: the decompressed form's per-head cache at the *_mla
    dims, or, where the file's key_length holds the per-head dims,
    kvcache.make_cache (the names mapped there, q8 too)."""
    dtype = torch.bfloat16 if isinstance(kv_dtype, str) else kv_dtype
    if mla_absorbed(hp):
        return kvcache.MLACache.new(hp.n_layer, batch, max_len, hp.n_lora_kv, hp.rope.dims,
                                    dtype, device)
    if not hp.head_dim_k_mla:
        return kvcache.make_cache(hp, batch, max_len, kv_dtype, device)
    Dk, Dv, _, _ = mla_dims(hp)
    return kvcache.KVCache(
        torch.zeros((hp.n_layer, batch, hp.n_head, max_len, Dk), dtype=dtype, device=device),
        torch.zeros((hp.n_layer, batch, hp.n_head, max_len, Dv), dtype=dtype, device=device))


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """Weights from GGUF onto `device` as models/llama.py loads them, in the
    JAX package's deepseek2 param tree: absent tensors None; absorbed, wk_b
    and wv_b dense in `dtype` from attn_kv_b's f32 values (wkv_b None);
    an expert stack the kernels do not take dense (load_expert_stack)."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors
    absorbed = mla_absorbed(hp)
    _, Dv, _, n_nope = mla_dims(hp)

    def linear(name):
        return load_linear(t[name], device, dtype, mode) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layer = {
            "attn_norm": vector(p + "attn_norm.weight"),
            "wq": linear(p + "attn_q.weight"),  # q direct (lite) or through the LoRA
            "wq_a": linear(p + "attn_q_a.weight"),
            "q_a_norm": vector(p + "attn_q_a_norm.weight"),
            "wq_b": linear(p + "attn_q_b.weight"),
            "wkv_a": linear(p + "attn_kv_a_mqa.weight"),
            "kv_a_norm": vector(p + "attn_kv_a_norm.weight"),
            "wkv_b": None if absorbed else linear(p + "attn_kv_b.weight"),
            "wo": linear(p + "attn_output.weight"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
        }
        if absorbed:  # attn_kv_b's per-head [k_nope; v] row blocks, split
            kvb = dense_weight(t[p + "attn_kv_b.weight"], device, torch.float32).T
            kvb = kvb.reshape(hp.n_head, n_nope + Dv, hp.n_lora_kv)
            layer["wk_b"] = kvb[:, :n_nope].to(dtype).contiguous()
            layer["wv_b"] = kvb[:, n_nope:].to(dtype).contiguous()
        if p + "ffn_gate_inp.weight" not in t:  # a dense lead layer (plm: gateless)
            layer.update(w_gate=linear(p + "ffn_gate.weight"), w_up=linear(p + "ffn_up.weight"),
                         w_down=linear(p + "ffn_down.weight"))
        else:
            layer.update(router=linear(p + "ffn_gate_inp.weight"),
                         exp_probs_b=vector(p + "exp_probs_b.bias"),
                         w_gate_shexp=linear(p + "ffn_gate_shexp.weight"),
                         w_up_shexp=linear(p + "ffn_up_shexp.weight"),
                         w_down_shexp=linear(p + "ffn_down_shexp.weight"))
            for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                layer["w_" + key.removeprefix("ffn_")] = load_expert_stack(
                    t[p + key + ".weight"], device, dtype, mode)
        layers.append(layer)
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight"),  # None: tied to tok_embd
    }


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits [B, T, n_vocab] f32, cache), with
    models/llama.py forward's `cache_offset`, `last_index` and
    `return_hidden`; the absorbed form on an MLACache, the decompressed one
    on a KVCache."""
    B, T = tokens.shape
    H, kvr = hp.n_head, hp.n_lora_kv
    Dk, Dv, n_rot, n_nope = mla_dims(hp)
    absorbed = isinstance(cache, kvcache.MLACache)
    x = params["tok_embd"][tokens]
    if hp.embd_scale != 1.0:
        x = x * hp.embd_scale
    scale = hp.attn_scale if hp.attn_scale is not None else Dk ** -0.5
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    cos, sin = rope_angles(hp.rope, positions)

    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        if layer["wq"] is not None:
            q = layer["wq"](h)
        else:
            q = layer["wq_b"](rms_norm(layer["wq_a"](h), layer["q_a_norm"], hp.rms_eps))
        q = q.reshape(B, T, H, Dk)
        q_nope = q[..., :n_nope]
        q_pe = apply_rope_angles(q[..., n_nope:], cos, sin, hp.rope.style)
        kv_pe = layer["wkv_a"](h)  # [B, T, kvr + n_rot]
        kv_cmpr = rms_norm(kv_pe[..., :kvr], layer["kv_a_norm"], hp.rms_eps)
        k_pe = apply_rope_angles(kv_pe[..., kvr:].reshape(B, T, 1, n_rot), cos, sin,
                                 hp.rope.style)

        if absorbed:  # q_nope · wk_b scores against the cached latent
            q_abs = torch.einsum("bthd,hdc->bthc", q_nope, layer["wk_b"].to(q_nope.dtype))
            qf = torch.cat([q_abs, q_pe], dim=-1)  # [B, T, H, kvr + n_rot]
            latent = torch.cat([kv_cmpr.reshape(B, T, 1, kvr), k_pe], dim=-1)
            cache = cache.update(li, latent.transpose(1, 2), None, cache_offset)
            o = attention_cached(qf.contiguous(), cache, li, scale, offsets)  # [B, T, H, kvr]
            attn = torch.einsum("bthc,hec->bthe", o, layer["wv_b"].to(o.dtype))
        else:  # the latent decompressed through wkv_b: per-head keys and values
            kv = layer["wkv_b"](kv_cmpr).reshape(B, T, H, n_nope + Dv)
            qf = torch.cat([q_nope, q_pe], dim=-1)
            kf = torch.cat([kv[..., :n_nope], k_pe.expand(B, T, H, n_rot)], dim=-1)
            cache = cache.update(li, kf.transpose(1, 2), kv[..., n_nope:].transpose(1, 2),
                                 cache_offset)
            attn = attention_cached(qf.contiguous(), cache, li, scale, offsets)
        attn = layer["wo"](attn.reshape(B, T, H * Dv))
        if hp.residual_scale != 1.0:
            attn = attn * hp.residual_scale
        x = x + attn

        h = rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        if layer.get("router") is None:
            ffn = dense_ffn(layer, h)
        else:
            hs = h.reshape(B * T, -1)
            weights, idx = route(router_logits(layer["router"], hs), hp.n_expert_used,
                                 gating=hp.expert_gating_func,
                                 norm_weights=hp.expert_weights_norm,
                                 scale=hp.expert_weights_scale,
                                 select_bias=layer["exp_probs_b"])
            ffn = moe_ffn(hs, weights, idx, layer["w_gate_exps"], layer["w_up_exps"],
                          layer["w_down_exps"])
            shared = layer["w_down_shexp"](silu_glu(layer["w_gate_shexp"](hs),
                                                    layer["w_up_shexp"](hs)))
            ffn = (ffn + shared.to(ffn.dtype)).reshape(B, T, -1)
        if hp.residual_scale != 1.0:
            ffn = ffn * hp.residual_scale
        x = x + ffn
    return finish(hp, params, x, last_index, return_hidden), cache
