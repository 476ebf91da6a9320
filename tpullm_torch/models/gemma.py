"""Gemma, Gemma-2 and Gemma-3 decoders (the JAX package's models/gemma.py).

The graph of llm_build_gemma / gemma2_iswa / gemma3_iswa: embeddings scaled
by sqrt(n_embd) in the table's dtype, pre- and post-RMS norms around the
attention and the FFN (post-norms from gemma2; the GGUF converter has folded
the +1 into every norm weight), per-head q/k RMS norms before RoPE
(gemma3), a GELU (tanh) FFN, interleaved sliding-window attention (gemma2
alternates 1:1 and softcaps the scores and the logits; gemma3 runs 5 local
layers to 1 global, the local ones at their own RoPE base), a tied head.

Attention: on a full cache (KVCache, QuantKVCache: with `swa_full`, and
always for a q8 cache) every layer goes through the flash kernel, the
sliding-window layers with their window. On an iSWA ring cache
(runtime/kvcache.py SWACache) the global layers go through the flash
kernel and the sliding-window layers through ops.attention.attention_ring,
dense attention under the mask the ring's slot positions give, as the JAX
package runs them. Offsets take the three forms of models/llama.py.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.attention import attention_cached, attention_ring
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from ..runtime.kvcache import SWACache
from .hparams import HParams
from .llama import Params, finish, forward_offsets
from .weights import MODES, load_embedding, load_linear, load_vector


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """Weights from GGUF onto `device`, as models/llama.py build_params
    loads them; the layer keys of the JAX package's gemma param tree (the
    post-norms and q/k norms None where the file has none)."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode)

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layers.append({
            "attn_norm": vector(p + "attn_norm.weight"),
            "wq": linear(p + "attn_q.weight"),
            "wk": linear(p + "attn_k.weight"),
            "wv": linear(p + "attn_v.weight"),
            "wo": linear(p + "attn_output.weight"),
            "attn_post_norm": vector(p + "post_attention_norm.weight"),
            "q_norm": vector(p + "attn_q_norm.weight"),
            "k_norm": vector(p + "attn_k_norm.weight"),
            "ffn_norm": vector(p + "ffn_norm.weight"),
            "w_gate": linear(p + "ffn_gate.weight"),
            "w_up": linear(p + "ffn_up.weight"),
            "w_down": linear(p + "ffn_down.weight"),
            "ffn_post_norm": vector(p + "post_ffw_norm.weight"),
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight") if "output.weight" in t else None,
    }


def _pair(layer: dict, fused_key: str, keys: tuple, h: torch.Tensor):
    fused = layer.get(fused_key)
    return fused(h) if fused is not None else tuple(layer[k](h) for k in keys)


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache, cache_offset, last_index=None, return_hidden: bool = False):
    """tokens/positions [B, T] → (logits [B, T, n_vocab] f32, cache), with
    models/llama.py forward's `cache_offset`, `last_index` and
    `return_hidden` (the final logits softcapped in f32 for gemma2:
    llama.output_head)."""
    B, T = tokens.shape
    emb = params["tok_embd"]
    # the scale rounded to the table's dtype first (√2560 is 50.5 in bf16)
    x = emb[tokens] * float(torch.tensor(hp.embd_scale, dtype=emb.dtype))
    scale = hp.attn_scale if hp.attn_scale is not None else hp.head_dim ** -0.5
    ring = isinstance(cache, SWACache)
    if ring:  # the ring's slot positions first: the mask covers the rows written
        ring_rows = cache.advance(positions, cache_offset)
        mask_swa = cache.ring_mask(positions)
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    # the SWA layers replace only the RoPE base (the JAX package's rule)
    cs_global = rope_angles(hp.rope, positions)
    cs_swa = cs_global
    if hp.rope_freq_base_swa > 0 and hp.rope_freq_base_swa != hp.rope.freq_base:
        cs_swa = rope_angles(replace(hp.rope, freq_base=hp.rope_freq_base_swa), positions)

    for li, layer in enumerate(params["layers"]):
        swa = hp.is_swa(li)
        in_ring = ring and swa
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        q, k, v = _pair(layer, "wqkv", ("wq", "wk", "wv"), h)
        q = q.reshape(B, T, hp.n_head, hp.head_dim)
        k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
        v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
        if layer["q_norm"] is not None:
            q = rms_norm(q, layer["q_norm"], hp.rms_eps)
        if layer["k_norm"] is not None:
            k = rms_norm(k, layer["k_norm"], hp.rms_eps)
        cos, sin = cs_swa if swa else cs_global
        q = apply_rope_angles(q, cos, sin, hp.rope.style)
        k = apply_rope_angles(k, cos, sin, hp.rope.style)

        cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2),
                             ring_rows if in_ring else cache_offset)
        if in_ring:
            attn = attention_ring(q, *cache.kv(li), mask_swa, scale, hp.softcap_attn)
        else:
            attn = attention_cached(q.contiguous(), cache, li, scale, offsets,
                                    softcap=hp.softcap_attn,
                                    sliding_window=hp.sliding_window if swa else 0)
        attn = layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v))
        if layer["attn_post_norm"] is not None:
            attn = rms_norm(attn, layer["attn_post_norm"], hp.rms_eps)
        x = x + attn

        h = rms_norm(x, layer["ffn_norm"], hp.rms_eps)
        gate, up = _pair(layer, "wgu", ("w_gate", "w_up"), h)
        ffn = layer["w_down"](F.gelu(gate.float(), approximate="tanh").to(up.dtype) * up)
        if layer["ffn_post_norm"] is not None:
            ffn = rms_norm(ffn, layer["ffn_post_norm"], hp.rms_eps)
        x = x + ffn

    return finish(hp, params, x, last_index, return_hidden), cache
