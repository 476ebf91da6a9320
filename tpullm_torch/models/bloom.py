"""BLOOM, MPT and JAIS decoders, the ALiBi family (the JAX package's
models/bloom.py; reference graphs llm_build_bloom, llm_build_mpt,
llm_build_jais).

Shared: LayerNorm pre-norms (with their biases where the file has them),
q, k and v fused in attn_qkv (q rows, then k, then v), loaded as one
linear inside a FusedLinear of those splits (models/weights.py
`load_fused`) with its fused bias; no RoPE: position enters as each head's
ALiBi bias, −slope·|query position − key slot|, which the flash kernels
add from `alibi_slopes` (made once at load, on the device); a sequential
residual chain; the final LayerNorm, then the head in f32, through the
output linear or, tied, a plain product on the embedding table.

Per arch:
  * bloom: token_embd_norm (a LayerNorm with bias) right after the lookup;
  * mpt: an optional learned position_embd (its positions clamped to the
    table, as JAX clamps a gather index), clamp_kqv on q, k and v, and an
    optional LayerNorm of q and of k over their full width before the head
    split; usually no biases;
  * jais: a SiLU-gated FFN (ffn_gate, with its bias) and the scale
    1/head_dim in place of head_dim^-1/2.
The FFN otherwise is up + b_up, the exact GELU in f32 (erf), down + b_down.
The offsets take the three forms of llama.forward_offsets and nothing is
read back to the host, so the forward is captured as the llama one is.
models/gpt2.py runs this graph without ALiBi.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.attention import alibi_slopes, attention_cached
from ..ops.norms import layer_norm
from .hparams import GPT2_ARCHS, HParams
from .llama import Params, forward_offsets, pick_rows, silu_glu
from .weights import MODES, load_embedding, load_fused, load_linear, load_vector


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """The LayerNorms and their biases, the fused qkv and its bias, mpt's
    q/k norms, wo, (jais' gate,) up and down with their biases, the
    embedding with bloom's norm or mpt's positions, the head (None: tied to
    the embedding) and the heads' ALiBi slopes on the device."""
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
        layers.append({
            "attn_norm": vector(p + "attn_norm.weight"),
            "attn_norm_b": vector(p + "attn_norm.bias"),
            "wqkv": load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device, dtype, mode),
            "bqkv": vector(p + "attn_qkv.bias"),
            "q_norm": vector(p + "attn_q_norm.weight"),
            "q_norm_b": vector(p + "attn_q_norm.bias"),
            "k_norm": vector(p + "attn_k_norm.weight"),
            "k_norm_b": vector(p + "attn_k_norm.bias"),
            "wo": linear(p + "attn_output.weight"),
            "bo": vector(p + "attn_output.bias"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "ffn_norm_b": vector(p + "ffn_norm.bias"),
            "w_gate": linear(p + "ffn_gate.weight"),
            "b_gate": vector(p + "ffn_gate.bias"),
            "w_up": linear(p + "ffn_up.weight"),
            "b_up": vector(p + "ffn_up.bias"),
            "w_down": linear(p + "ffn_down.weight"),
            "b_down": vector(p + "ffn_down.bias"),
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "tok_norm": vector("token_embd_norm.weight"),
        "tok_norm_b": vector("token_embd_norm.bias"),
        "pos_embd": (load_embedding(t["position_embd.weight"], device, dtype)
                     if "position_embd.weight" in t else None),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output_norm_b": vector("output_norm.bias"),
        "output": linear("output.weight"),
        "alibi_slopes": alibi_slopes(hp.n_head, hp.max_alibi_bias, torch.device(device)),
    }


def _biased(y: torch.Tensor, b) -> torch.Tensor:
    return y if b is None else y + b.to(y.dtype)


def learned_positions(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rows `positions` of a learned position table, each index clamped to
    the table (a JAX gather clamps an index past the end; a CUDA index past
    it is a device-side assert): the pad rows of a prefill bucket, which
    run past the last position, near n_ctx_train."""
    return table[positions.long().clamp(0, table.shape[0] - 1)]


def _ffn(layer: dict, h: torch.Tensor, gelu: str) -> torch.Tensor:
    if layer.get("wgu") is not None:  # jais' gate|up as one plane stream
        gate, up = layer["wgu"](h)
    else:
        gate = None if layer["w_gate"] is None else layer["w_gate"](h)
        up = layer["w_up"](h)
    up = _biased(up, layer["b_up"])
    if gate is not None:  # jais: SiLU-gated
        mid = silu_glu(_biased(gate, layer["b_gate"]), up)
    else:
        mid = F.gelu(up.float(), approximate=gelu).to(up.dtype)
    return _biased(layer["w_down"](mid), layer["b_down"])


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits f32, cache), as llama.forward: the
    head on every row, on row last_index (a host int) or on row
    last_index[b] of batch row b (a [B] device tensor); with return_hidden
    the final-norm hidden states in f32. `cache_offset` in the three forms
    of llama.forward. gpt2 and starcoder (models/gpt2.py): no ALiBi slopes,
    the tanh GELU."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    if params["tok_norm"] is not None:  # bloom's norm of the embedding
        x = layer_norm(x, params["tok_norm"], params["tok_norm_b"], hp.rms_eps)
    if params["pos_embd"] is not None:  # mpt's and gpt2's learned positions
        x = x + learned_positions(params["pos_embd"], positions)
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    scale = 1.0 / hp.head_dim if hp.arch == "jais" else hp.head_dim ** -0.5
    slopes = params["alibi_slopes"]
    gelu = "tanh" if hp.arch in GPT2_ARCHS else "none"
    for li, layer in enumerate(params["layers"]):
        h = layer_norm(x, layer["attn_norm"], layer["attn_norm_b"], hp.rms_eps)
        q, k, v = layer["wqkv"](h)
        if layer["bqkv"] is not None:
            q, k, v = (y + b.to(y.dtype) for y, b in
                       zip((q, k, v), torch.split(layer["bqkv"], layer["wqkv"].splits)))
        if hp.clamp_kqv > 0.0:  # mpt
            q, k, v = (torch.clamp(y, -hp.clamp_kqv, hp.clamp_kqv) for y in (q, k, v))
        if layer["q_norm"] is not None:  # mpt: over the full q and k widths
            q = layer_norm(q, layer["q_norm"], layer["q_norm_b"], hp.rms_eps)
            k = layer_norm(k, layer["k_norm"], layer["k_norm_b"], hp.rms_eps)
        q = q.reshape(B, T, hp.n_head, hp.head_dim)
        k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
        v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
        cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
        attn = attention_cached(q.contiguous(), cache, li, scale, offsets, alibi_slopes=slopes)
        x = x + _biased(layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v)), layer["bo"])
        x = x + _ffn(layer, layer_norm(x, layer["ffn_norm"], layer["ffn_norm_b"], hp.rms_eps),
                     gelu)
    return finish(hp, params, x, last_index, return_hidden), cache


def finish(hp: HParams, params: Params, x: torch.Tensor, last_index, return_hidden: bool):
    """The final LayerNorm, then (but with return_hidden: the hidden states
    in f32) the head in f32 on the rows of `last_index` (llama.pick_rows):
    the output linear, or tied, x @ the embedding table in x's dtype, a
    plain product outside any kernel, as the JAX package computes it."""
    if return_hidden:
        return layer_norm(x, params["output_norm"], params["output_norm_b"],
                          hp.rms_eps).float()
    x = layer_norm(pick_rows(x, last_index), params["output_norm"], params["output_norm_b"],
                   hp.rms_eps)
    if params["output"] is not None:
        return params["output"](x).float()
    return (x @ params["tok_embd"].T.to(x.dtype)).float()
