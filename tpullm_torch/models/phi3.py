"""Phi-3 decoder (the JAX package's models/phi3.py build_params; reference
graph llm_build_phi3).

Phi-3 is the llama graph once its fused projections are read:
  blk.N.attn_qkv.weight  [n_embd + 2·n_embd_gqa rows] → q | k | v
  blk.N.ffn_up.weight    [2·n_ff rows]                → gate | up
(ggml_swiglu's first half is the gate). The JAX package slices the packed
rows at load and fuses them again; here each fused tensor loads once as one
linear inside a FusedLinear of those splits (models/weights.py
`load_fused`), so q|k|v and gate|up each stream one plane set, and in the
"dense" weight mode the splits are the JAX package's wq/wk/wv and
w_gate/w_up bit for bit. The forward is llama.forward (models/registry.py):
its attention passes hp.sliding_window (2047 on every layer of
Phi-3-mini, a full cache with the window in the flash kernel) and RoPE is
NEOX (models/hparams.py NEOX_ROPE_ARCHS).

PhiMoE (build_params_moe / forward_moe, arch `phimoe`) is the phi3
attention with LayerNorms where the file gives its norms biases, q/k/v and
wo biases, a sparsemixer-routed expert FFN (ops/moe.py route_sparsemixer)
and a biased head.
"""

from __future__ import annotations

import torch

from ..gguf.reader import GGUFReader
from ..ops.moe import moe_ffn, route, route_sparsemixer
from ..ops.rope import rope_angles
from .hparams import HParams
from .llama import Params, attn_block, finish, forward_offsets, pre_norm, router_logits
from .weights import (MODES, load_embedding, load_expert_stack, load_fused, load_linear,
                      load_vector)


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """The llama layer layout with `wqkv` and `wgu` loaded fused, no biases,
    per-head q/k norms where the file has them."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    n_q, n_kv = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        up = t[p + "ffn_up.weight"]
        n_ff = up.shape[1] // 2
        layers.append({
            "attn_norm": vector(p + "attn_norm.weight"),
            "wqkv": load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device, dtype, mode),
            "wq": None, "wk": None, "wv": None,
            "wo": load_linear(t[p + "attn_output.weight"], device, dtype, mode),
            "bo": None, "bq": None, "bk": None, "bv": None,
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "wgu": load_fused(up, (n_ff, n_ff), device, dtype, mode),
            "w_gate": None, "w_up": None,
            "w_down": load_linear(t[p + "ffn_down.weight"], device, dtype, mode),
            "q_norm": vector(p + "attn_q_norm.weight"),
            "k_norm": vector(p + "attn_k_norm.weight"),
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": (load_linear(t["output.weight"], device, dtype, mode)
                   if "output.weight" in t else None),
    }


def build_params_moe(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                     mode: str = "auto") -> Params:
    """The PhiMoE tensor set (the JAX package's phi3.build_params_moe):
    q|k|v fused in one `wqkv` where the file has attn_qkv, else apart (an
    Engine fuses them where they share a type); their biases, wo's bias;
    LayerNorm biases beside the attention, FFN and output norms where the
    file has them; the router and the three expert stacks; the head and
    its bias."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode)

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    n_q, n_kv = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        if p + "attn_qkv.weight" in t:
            qkv = dict(wqkv=load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device,
                                       dtype, mode), wq=None, wk=None, wv=None)
        else:
            qkv = {k: linear(p + f"attn_{k[1]}.weight") for k in ("wq", "wk", "wv")}
        layers.append({
            "attn_norm": vector(p + "attn_norm.weight"),
            "attn_norm_b": vector(p + "attn_norm.bias"),
            **qkv,
            "bq": vector(p + "attn_q.bias"), "bk": vector(p + "attn_k.bias"),
            "bv": vector(p + "attn_v.bias"),
            "wo": linear(p + "attn_output.weight"),
            "bo": vector(p + "attn_output.bias"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "ffn_norm_b": vector(p + "ffn_norm.bias"),
            "router": linear(p + "ffn_gate_inp.weight"),
            **{"w_" + key.removeprefix("ffn_"): load_expert_stack(
                t[p + key + ".weight"], device, dtype, mode)
               for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")},
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output_norm_b": vector("output_norm.bias"),
        "output": linear("output.weight") if "output.weight" in t else None,
        "output_b": vector("output.bias"),
    }


def forward_moe(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
                cache, cache_offset, last_index=None, return_hidden: bool = False):
    """The PhiMoE forward (the JAX package's phi3.forward_moe) with
    llama.forward's `cache_offset`, `last_index` and `return_hidden`:
    llama.attn_block (its LayerNorm pre-norm, the q/k/v and wo biases,
    NEOX RoPE, the window on every layer in the flash kernel); the FFN
    LayerNorm, then sparsemixer top-2 routing (softmax top-k renormalised
    at another k) over the expert stacks; the output LayerNorm and the
    biased head through llama.finish, on the rows of `last_index`."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    rope_cs = rope_angles(hp.rope, positions)
    for li, layer in enumerate(params["layers"]):
        x, cache = attn_block(hp, layer, x, rope_cs, cache, li, cache_offset, offsets)
        hs = pre_norm(hp, x, layer["ffn_norm"], layer.get("ffn_norm_b")).reshape(B * T, -1)
        logits = router_logits(layer["router"], hs)
        if hp.n_expert_used == 2:
            weights, idx = route_sparsemixer(logits)
        else:
            weights, idx = route(logits, hp.n_expert_used, gating="softmax", norm_weights=True)
        ffn = moe_ffn(hs, weights, idx, layer["w_gate_exps"], layer["w_up_exps"],
                      layer["w_down_exps"])
        x = x + ffn.reshape(B, T, -1)
    return finish(hp, params, x, last_index, return_hidden), cache
