"""LLaMA-family decoder: RMSNorm → GQA attention with RoPE and KV-cache
append → SwiGLU FFN, residual chain, final norm and output head.

The graph of the JAX package's models/llama.py, dense FFN and MoE FFN
(mixtral: a router, softmax top-k with renormalised weights, stacked
experts), run eagerly: `forward` updates the cache in place. The cache
offset is a host int, or, for one decode row, a device int32 tensor (the
captured decode step: nothing in the forward then reads a value back to the
host).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.attention import alibi_slopes, attention_cached
from ..ops.moe import moe_ffn, route
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from .hparams import HParams
from .weights import load_embedding, load_expert_stack, load_linear, load_vector

Params = dict[str, Any]


def build_params(r: GGUFReader, hp: HParams, device,
                 dtype=torch.bfloat16) -> Params:
    """Weights from GGUF onto `device`: packed planes for quantized
    linears, f32 norm vectors, a dense embedding table."""
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layer = {
            "attn_norm": vector(p + "attn_norm.weight"),
            "wq": linear(p + "attn_q.weight"),
            "wk": linear(p + "attn_k.weight"),
            "wv": linear(p + "attn_v.weight"),
            "wo": linear(p + "attn_output.weight"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "w_gate": linear(p + "ffn_gate.weight"),
            "w_up": linear(p + "ffn_up.weight"),
            "w_down": linear(p + "ffn_down.weight"),
            # optional extras: qwen2-style attention biases, per-head qk norms
            "bq": vector(p + "attn_q.bias"),
            "bk": vector(p + "attn_k.bias"),
            "bv": vector(p + "attn_v.bias"),
            "bo": vector(p + "attn_output.bias"),
            "q_norm": vector(p + "attn_q_norm.weight"),
            "k_norm": vector(p + "attn_k_norm.weight"),
        }
        if p + "ffn_gate_inp.weight" in t:  # mixtral: a router and stacked experts
            layer["router"] = linear(p + "ffn_gate_inp.weight")
            for key, name in (("w_gate_exps", "ffn_gate_exps"), ("w_up_exps", "ffn_up_exps"),
                              ("w_down_exps", "ffn_down_exps")):
                layer[key] = load_expert_stack(t[p + name + ".weight"], device, dtype)
        layers.append(layer)
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight"),  # None: tied to tok_embd
    }


def attn_block(hp: HParams, layer: dict, x: torch.Tensor, rope_cs, cache, li: int,
               cache_offset, offsets: torch.Tensor, slopes=None):
    """One pre-norm GQA attention block with residual."""
    B, T = x.shape[:2]
    scale = hp.attn_scale if hp.attn_scale is not None else hp.head_dim ** -0.5
    h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
    fused = layer.get("wqkv")
    if fused is not None:  # one plane stream for q|k|v
        q, k, v = fused(h)
    else:
        q, k, v = layer["wq"](h), layer["wk"](h), layer["wv"](h)
    if layer.get("bq") is not None:
        q = q + layer["bq"].to(q.dtype)
    if layer.get("bk") is not None:
        k = k + layer["bk"].to(k.dtype)
    if layer.get("bv") is not None:
        v = v + layer["bv"].to(v.dtype)
    q = q.reshape(B, T, hp.n_head, hp.head_dim)
    k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
    v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
    if layer.get("q_norm") is not None:
        q = rms_norm(q, layer["q_norm"], hp.rms_eps)
    if layer.get("k_norm") is not None:
        k = rms_norm(k, layer["k_norm"], hp.rms_eps)
    use_rope = hp.max_alibi_bias <= 0.0 and (
        hp.no_rope_step == 0 or (li + 1) % hp.no_rope_step != 0)
    if use_rope:
        cos, sin = rope_cs
        q = apply_rope_angles(q, cos, sin, hp.rope.style)
        k = apply_rope_angles(k, cos, sin, hp.rope.style)

    cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
    attn = attention_cached(q.contiguous(), cache, li, scale, offsets,
                            sliding_window=hp.sliding_window, alibi_slopes=slopes)
    attn = layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v))
    if layer.get("bo") is not None:
        attn = attn + layer["bo"].to(attn.dtype)
    if hp.residual_scale != 1.0:
        attn = attn * hp.residual_scale
    return x + attn, cache


def router_logits(router, hs: torch.Tensor) -> torch.Tensor:
    """[N, n_expert] f32 router logits from bf16 hs and the bf16 router
    weight, summed and kept in f32. The JAX graph writes a bf16 dot read as
    f32, but XLA drops that bf16 round trip (its default excess-precision
    rule), so the JAX package routes on f32 sums; rounding them to bf16
    here would flip top-2 decisions whose margin is under one bf16 ulp."""
    return hs.float() @ router.w.float()


def output_head(hp: HParams, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["output_norm"], hp.rms_eps)
    if params["output"] is not None:
        logits = params["output"](x)
    else:  # tied head: a plain product outside any kernel
        logits = x @ params["tok_embd"].T.to(x.dtype)
    logits = logits.float()
    if hp.logit_scale != 1.0:
        logits = logits / hp.logit_scale
    return logits


def forward(hp: HParams, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor, cache, cache_offset,
            last_index: int | None = None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits [B, T, n_vocab] f32, cache). With
    last_index=i the head runs on row i only and logits are [B, 1, n_vocab]
    (the prefill path: the head of an 8B model is ~6% of its FLOPs). With
    return_hidden, (the final-norm hidden states [B, T, n_embd] f32, cache)
    instead (the embeddings path).

    `cache_offset` is the cache slot of row 0: a host int, or at T = 1 a
    device int32 tensor of one element, which the flash kernel then reads as
    its offsets and the cache write as its index."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    if hp.embd_scale != 1.0:
        x = x * hp.embd_scale
    if isinstance(cache_offset, torch.Tensor):
        offsets = cache_offset.reshape(1).to(torch.int32).expand(B).contiguous()
    else:
        offsets = torch.full((B,), int(cache_offset), dtype=torch.int32, device=x.device)
    rope_cs = rope_angles(hp.rope, positions)
    slopes = (alibi_slopes(hp.n_head, hp.max_alibi_bias, x.device)
              if hp.max_alibi_bias > 0.0 else None)
    for li, layer in enumerate(params["layers"]):
        x, cache = attn_block(hp, layer, x, rope_cs, cache, li, cache_offset,
                              offsets, slopes)
        h = rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        if layer.get("router") is not None:  # the MoE branch
            hs = h.reshape(B * T, -1)
            weights, idx = route(router_logits(layer["router"], hs), hp.n_expert_used,
                                 gating="softmax", norm_weights=True)
            ffn = moe_ffn(hs, weights, idx, layer["w_gate_exps"], layer["w_up_exps"],
                          layer["w_down_exps"]).reshape(B, T, -1)
        else:
            if layer.get("wgu") is not None:  # one plane stream for gate|up
                gate, up = layer["wgu"](h)
            else:
                gate, up = layer["w_gate"](h), layer["w_up"](h)
            act = F.silu(gate.float()).to(up.dtype) * up
            ffn = layer["w_down"](act)
        if hp.residual_scale != 1.0:
            ffn = ffn * hp.residual_scale
        x = x + ffn
    if return_hidden:
        return rms_norm(x, params["output_norm"], hp.rms_eps).float(), cache
    if last_index is not None:
        x = x[:, last_index:last_index + 1]
    return output_head(hp, params, x), cache
