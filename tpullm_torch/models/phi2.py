"""Phi-2 decoder (the JAX package's models/phi2.py; reference graph
llm_build_phi2).

One LayerNorm with bias feeds a parallel attention and FFN, x = x +
attn(h) + ffn(h); partial NEOX RoPE (rope.dims = 32 of head dim 80); q, k
and v fused (attn_qkv, loaded as one linear: models/weights.py
`load_fused`) or split, with biases; an un-gated FFN, up + b_up, the exact
GELU in f32 (erf, as the JAX package computes it), down + b_down; the final
LayerNorm, then the head in f32 plus its bias. The offsets take the three
forms of llama.forward_offsets, and nothing is read back to the host, so
the forward is captured as the llama one is (the decode graphs, the batched
step, the verify graphs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.attention import attention_cached
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope_angles, rope_angles
from .hparams import HParams
from .llama import Params, forward_offsets, pick_rows
from .weights import MODES, load_embedding, load_fused, load_linear, load_vector


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """The LayerNorm weights and biases, the fused (or split) qkv and its
    biases, wo, up and down with their biases, and the head with its bias."""
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
        layer = {
            "attn_norm": vector(p + "attn_norm.weight"),
            "attn_norm_b": vector(p + "attn_norm.bias"),
            "wo": linear(p + "attn_output.weight"),
            "bo": vector(p + "attn_output.bias"),
            "w_up": linear(p + "ffn_up.weight"),
            "b_up": vector(p + "ffn_up.bias"),
            "w_down": linear(p + "ffn_down.weight"),
            "b_down": vector(p + "ffn_down.bias"),
        }
        if p + "attn_qkv.weight" in t:
            bqkv = load_vector(t[p + "attn_qkv.bias"], device)
            layer.update(
                wqkv=load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device, dtype, mode),
                wq=None, wk=None, wv=None,
                bq=bqkv[:n_q], bk=bqkv[n_q:n_q + n_kv], bv=bqkv[n_q + n_kv:])
        else:  # split (Engine fuses them where they share a type)
            layer.update(wq=linear(p + "attn_q.weight"), wk=linear(p + "attn_k.weight"),
                         wv=linear(p + "attn_v.weight"), bq=vector(p + "attn_q.bias"),
                         bk=vector(p + "attn_k.bias"), bv=vector(p + "attn_v.bias"))
        layers.append(layer)
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output_norm_b": vector("output_norm.bias"),
        "output": linear("output.weight"),
        "output_b": vector("output.bias"),
    }


def _biased(y: torch.Tensor, b) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits f32, cache), as llama.forward: the
    head on every row, on row last_index (a host int) or on row
    last_index[b] of batch row b (a [B] device tensor); with return_hidden
    the final-norm hidden states in f32. `cache_offset` in the three forms
    of llama.forward."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    cos, sin = rope_angles(hp.rope, positions)
    scale = hp.head_dim ** -0.5
    for li, layer in enumerate(params["layers"]):
        h = layer_norm(x, layer["attn_norm"], layer["attn_norm_b"], hp.rms_eps)
        fused = layer.get("wqkv")
        q, k, v = fused(h) if fused is not None else (layer["wq"](h), layer["wk"](h),
                                                      layer["wv"](h))
        q = _biased(q, layer["bq"]).reshape(B, T, hp.n_head, hp.head_dim)
        k = _biased(k, layer["bk"]).reshape(B, T, hp.n_head_kv, hp.head_dim)
        v = _biased(v, layer["bv"]).reshape(B, T, hp.n_head_kv, hp.head_dim_v)
        q = apply_rope_angles(q, cos, sin, hp.rope.style)  # the first rope.dims features
        k = apply_rope_angles(k, cos, sin, hp.rope.style)
        cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
        attn = attention_cached(q.contiguous(), cache, li, scale, offsets)
        attn = _biased(layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v)), layer["bo"])
        # the FFN in parallel, from the same normed input
        up = _biased(layer["w_up"](h), layer["b_up"])
        act = F.gelu(up.float(), approximate="none").to(up.dtype)
        ffn = _biased(layer["w_down"](act), layer["b_down"])
        x = x + attn + ffn
    if return_hidden:
        return layer_norm(x, params["output_norm"], params["output_norm_b"],
                          hp.rms_eps).float(), cache
    x = layer_norm(pick_rows(x, last_index), params["output_norm"], params["output_norm_b"],
                   hp.rms_eps)
    logits = params["output"](x).float()
    if params["output_b"] is not None:
        logits = logits + params["output_b"]
    return logits, cache
