"""Falcon and GPT-NeoX decoders (the JAX package's models/falcon.py;
reference graphs llm_build_falcon, llm_build_gptneox, llm_build_codeshell).

Shared: LayerNorms with bias; q, k and v fused in attn_qkv (q rows, then k,
then v), loaded as one linear inside a FusedLinear of those splits
(models/weights.py `load_fused`: in the "dense" mode the splits are the JAX
package's wq / wk / wv bit for bit), with gptneox's and codeshell's fused
bias; NEOX RoPE on the first rope.dimension_count features (partial for
gptneox); an un-gated FFN, up + b_up, the exact GELU in f32 (erf), down +
b_down; the final LayerNorm, then the head in f32.

The residual layouts:
  * falcon, always parallel: x + attn(h) + ffn(a), a the first norm's
    output; h = a, or Falcon-40B's attn_norm_2 output where the layer has
    one;
  * gptneox and codeshell, sequential: x + attn(a), then + ffn(ffn_norm);
  * gptneox under use_parallel_residual (hp.par_residual): x + attn(a) +
    ffn(ffn_norm(x)).

Falcon-7B's 71 query heads share one KV head: a decode token is R = 71
rows, which flash's decode regime takes in row groups
(ops/kernels/flash.py). Its n_embd 4544 is no whole number of 256-row
chunks, so its q|k|v, wo, up and head take qmm's counted dequantize route
on the card; its down projection (K = 18176 = 71·256) takes the kernel.
The offsets take the three forms of llama.forward_offsets and nothing is
read back to the host, so the forward is captured as the llama one is.
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
    """The LayerNorms with their biases (attn_norm_2 and ffn_norm where the
    file has them), the fused qkv and its bias, wo, up and down with their
    biases, and the head (None: tied to the embedding)."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    n_q, n_kv = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        bqkv = vector(p + "attn_qkv.bias")
        layers.append({
            "attn_norm": vector(p + "attn_norm.weight"),
            "attn_norm_b": vector(p + "attn_norm.bias"),
            "attn_norm_2": vector(p + "attn_norm_2.weight"),
            "attn_norm_2_b": vector(p + "attn_norm_2.bias"),
            "wqkv": load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device, dtype, mode),
            "bqkv": bqkv,
            "wo": linear(p + "attn_output.weight"),
            "bo": vector(p + "attn_output.bias"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "ffn_norm_b": vector(p + "ffn_norm.bias"),
            "w_up": linear(p + "ffn_up.weight"),
            "b_up": vector(p + "ffn_up.bias"),
            "w_down": linear(p + "ffn_down.weight"),
            "b_down": vector(p + "ffn_down.bias"),
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output_norm_b": vector("output_norm.bias"),
        "output": linear("output.weight"),
    }


def _biased(y: torch.Tensor, b) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def _ffn(layer: dict, z: torch.Tensor) -> torch.Tensor:
    up = _biased(layer["w_up"](z), layer["b_up"])
    return _biased(layer["w_down"](F.gelu(up.float(), approximate="none").to(up.dtype)),
                   layer["b_down"])


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
        a = layer_norm(x, layer["attn_norm"], layer["attn_norm_b"], hp.rms_eps)
        h = a if layer["attn_norm_2"] is None else layer_norm(
            x, layer["attn_norm_2"], layer["attn_norm_2_b"], hp.rms_eps)
        q, k, v = layer["wqkv"](h)
        if layer["bqkv"] is not None:
            q, k, v = (y + b.to(y.dtype) for y, b in
                       zip((q, k, v), torch.split(layer["bqkv"], layer["wqkv"].splits)))
        q = q.reshape(B, T, hp.n_head, hp.head_dim)
        k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
        v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
        q = apply_rope_angles(q, cos, sin, hp.rope.style)  # the first rope.dims features
        k = apply_rope_angles(k, cos, sin, hp.rope.style)
        cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
        attn = attention_cached(q.contiguous(), cache, li, scale, offsets)
        attn = _biased(layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v)), layer["bo"])
        if hp.arch == "falcon":  # parallel; the FFN takes the first norm's output
            x = x + attn + _ffn(layer, a)
        elif hp.par_residual:  # gptneox parallel: its own ffn_norm over x
            x = x + attn + _ffn(layer, layer_norm(x, layer["ffn_norm"], layer["ffn_norm_b"],
                                                  hp.rms_eps))
        else:  # gptneox and codeshell, sequential
            x = x + attn
            x = x + _ffn(layer, layer_norm(x, layer["ffn_norm"], layer["ffn_norm_b"],
                                           hp.rms_eps))
    if return_hidden:
        return layer_norm(x, params["output_norm"], params["output_norm_b"],
                          hp.rms_eps).float(), cache
    x = layer_norm(pick_rows(x, last_index), params["output_norm"], params["output_norm_b"],
                   hp.rms_eps)
    if params["output"] is not None:
        logits = params["output"](x)
    else:  # tied head: a plain product outside any kernel
        logits = x @ params["tok_embd"].T.to(x.dtype)
    return logits.float(), cache
