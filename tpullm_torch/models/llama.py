"""LLaMA-family decoder: RMSNorm → GQA attention with RoPE and KV-cache
append → SwiGLU FFN, residual chain, final norm and output head.

The graph of the JAX package's models/llama.py, dense FFN and MoE FFN
(mixtral: a router, softmax top-k with renormalised weights, stacked
experts), run eagerly: `forward` updates the cache in place. Its options:
the gateless FFNs (arcee's ReLU², apertus' xIELU), float input embeddings
in place of token ids, M-RoPE position streams [S, B, T] (qwen2vl,
qwen3vl) and qwen3vl's deepstack residuals. The cache
offset is a host int, or, for one decode row, a 0-d device int32 tensor
(the captured decode step: nothing in the forward then reads a value back
to the host), or an int32 [B] device tensor of per-slot offsets with −1 for
an idle slot (continuous batching, runtime/batch_engine.py).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFReader
from ..ops.attention import alibi_slopes, attention_cached
from ..ops.moe import moe_ffn, route
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from ..runtime.kvcache import slot_rows
from .hparams import HParams
from .weights import MODES, load_embedding, load_expert_stack, load_linear, load_vector

Params = dict[str, Any]


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """Weights from GGUF onto `device`: packed planes for quantized
    linears and expert stacks (mode "auto" or "quant"; "dense": every
    linear and stack dequantized to `dtype`, models.weights.dense_weight),
    f32 norm vectors, a dense embedding table."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layer = {
            **attn_params(p, linear, vector),
            "bo": vector(p + "attn_output.bias"),
            "w_gate": linear(p + "ffn_gate.weight"),
            "w_up": linear(p + "ffn_up.weight"),
            "w_down": linear(p + "ffn_down.weight"),
        }
        if p + "ffn_gate_inp.weight" in t:  # mixtral: a router and stacked experts
            layer["router"] = linear(p + "ffn_gate_inp.weight")
            for key, name in (("w_gate_exps", "ffn_gate_exps"), ("w_up_exps", "ffn_up_exps"),
                              ("w_down_exps", "ffn_down_exps")):
                layer[key] = load_expert_stack(t[p + name + ".weight"], device, dtype, mode)
        layers.append(layer)
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight"),  # None: tied to tok_embd
    }


def attn_params(p: str, linear, vector) -> dict:
    """The attention entries of layer prefix `p` (attn_block's keys but
    "bo") and its FFN pre-norm, as the llama family and the qwen-moe graph
    load them: ffn_norm, or post_attention_norm where a file names it so
    (seed_oss, glm4moe); qwen2-style q/k/v biases and qk norms (per head,
    or over the whole projection) where the file has them. `linear` and
    `vector` load a tensor by name, None where it is absent."""
    ffn_norm = vector(p + "ffn_norm.weight")
    return {
        "attn_norm": vector(p + "attn_norm.weight"),
        "wq": linear(p + "attn_q.weight"),
        "wk": linear(p + "attn_k.weight"),
        "wv": linear(p + "attn_v.weight"),
        "wo": linear(p + "attn_output.weight"),
        "ffn_norm": ffn_norm if ffn_norm is not None
        else vector(p + "post_attention_norm.weight"),
        "bq": vector(p + "attn_q.bias"),
        "bk": vector(p + "attn_k.bias"),
        "bv": vector(p + "attn_v.bias"),
        "q_norm": vector(p + "attn_q_norm.weight"),
        "k_norm": vector(p + "attn_k_norm.weight"),
    }


def attn_block(hp: HParams, layer: dict, x: torch.Tensor, rope_cs, cache, li: int,
               cache_offset, offsets: torch.Tensor, slopes=None):
    """One pre-norm GQA attention block with residual (the llama family's,
    the qwen-moe graph's and phimoe's). The pre-norm is a LayerNorm where
    the layer has its bias "attn_norm_b" (phimoe), else an RMSNorm. The
    order of the optional steps: biases; a full-projection qk norm (q_norm
    over n_head·head_dim, minimax-m2, bailingmoe2 and olmoe) before the
    head split; per-head qk norms before RoPE, or after it where
    hp.qk_norm_post_rope (maincoder, hunyuan)."""
    B, T = x.shape[:2]
    scale = hp.attn_scale if hp.attn_scale is not None else hp.head_dim ** -0.5
    h = pre_norm(hp, x, layer["attn_norm"], layer.get("attn_norm_b"))
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
    q_norm, k_norm = layer.get("q_norm"), layer.get("k_norm")
    full_qk_norm = (q_norm is not None and hp.n_head > 1
                    and q_norm.shape[-1] == hp.n_head * hp.head_dim)
    if full_qk_norm:
        q = rms_norm(q, q_norm, hp.rms_eps)
        k = rms_norm(k, k_norm, hp.rms_eps)
    q = q.reshape(B, T, hp.n_head, hp.head_dim)
    k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
    v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
    head_norms = not full_qk_norm
    if head_norms and not hp.qk_norm_post_rope:
        q, k = _head_norms(hp, q, k, q_norm, k_norm)
    use_rope = hp.max_alibi_bias <= 0.0 and (
        hp.no_rope_step == 0 or (li + 1) % hp.no_rope_step != 0)
    if use_rope:
        cos, sin = rope_cs
        q = apply_rope_angles(q, cos, sin, hp.rope.style)
        k = apply_rope_angles(k, cos, sin, hp.rope.style)
    if head_norms and hp.qk_norm_post_rope:
        q, k = _head_norms(hp, q, k, q_norm, k_norm)

    cache = cache.update(li, k.transpose(1, 2), v.transpose(1, 2), cache_offset)
    attn = attention_cached(q.contiguous(), cache, li, scale, offsets,
                            sliding_window=hp.sliding_window, alibi_slopes=slopes)
    attn = layer["wo"](attn.reshape(B, T, hp.n_head * hp.head_dim_v))
    if layer.get("bo") is not None:
        attn = attn + layer["bo"].to(attn.dtype)
    if hp.residual_scale != 1.0:
        attn = attn * hp.residual_scale
    return x + attn, cache


def pre_norm(hp: HParams, x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """A LayerNorm where the norm has a bias (phimoe's norms are true
    LayerNorms), else an RMSNorm, both with hp.rms_eps."""
    if bias is not None:
        return layer_norm(x, weight, bias, hp.rms_eps)
    return rms_norm(x, weight, hp.rms_eps)


def _head_norms(hp: HParams, q, k, q_norm, k_norm):
    """Per-head RMS norms of q [B, T, H, D] and k, where the layer has them."""
    if q_norm is not None:
        q = rms_norm(q, q_norm, hp.rms_eps)
    if k_norm is not None:
        k = rms_norm(k, k_norm, hp.rms_eps)
    return q, k


def silu_glu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) · up, the activation in f32 rounded to up's dtype."""
    return F.silu(gate.float()).to(up.dtype) * up


def xielu(up: torch.Tensor, alpha_n: float, alpha_p: float, beta: float,
          eps: float) -> torch.Tensor:
    """apertus' xIELU in f32, rounded to up's dtype (ggml_xielu, its
    softplus folding in models/hparams.py `_read_xielu`): αp·x² + β·x for
    x > 0, else (expm1(min(x, eps)) − x)·αn + β·x."""
    u = up.float()
    neg = (torch.expm1(torch.clamp(u, max=eps)) - u) * alpha_n + beta * u
    return torch.where(u > 0.0, alpha_p * u * u + beta * u, neg).to(up.dtype)


def dense_ffn(layer: dict, h: torch.Tensor, xielu_values: tuple | None = None) -> torch.Tensor:
    """A dense FFN: SwiGLU (gate and up fused where they share a type), or,
    where the layer has no gate, xIELU with the layer's `xielu_values`
    (apertus) or ReLU² (arcee, plm): the JAX graph's order."""
    if layer.get("wgu") is not None:  # one plane stream for gate|up
        gate, up = layer["wgu"](h)
    elif layer["w_gate"] is not None:
        gate, up = layer["w_gate"](h), layer["w_up"](h)
    else:
        up = layer["w_up"](h)
        if xielu_values is not None:
            return layer["w_down"](xielu(up, *xielu_values))
        return layer["w_down"](torch.square(F.relu(up.float())).to(up.dtype))
    return layer["w_down"](silu_glu(gate, up))


def router_logits(router, hs: torch.Tensor) -> torch.Tensor:
    """[N, n_expert] f32 router logits from bf16 hs and the bf16 router
    weight, summed and kept in f32. The JAX graph writes a bf16 dot read as
    f32, but XLA drops that bf16 round trip (its default excess-precision
    rule), so the JAX package routes on f32 sums; rounding them to bf16
    here would flip top-2 decisions whose margin is under one bf16 ulp."""
    return hs.float() @ router.w.float()


def forward_offsets(cache_offset, B: int, T: int, max_len: int, device):
    """A forward's cache offset in its three forms (a host int, a 0-d device
    tensor, or per-slot int32 [B] with −1 idle) → (the flash kernel's int32
    [B] offsets, the offset every layer's cache write takes: per-slot
    offsets planned once as SlotRows)."""
    if isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1:
        if cache_offset.shape[0] != B:
            raise ValueError(f"per-slot offsets [{cache_offset.shape[0]}] for a batch of {B}")
        offsets = cache_offset.to(torch.int32).contiguous()
        return offsets, slot_rows(offsets, T, max_len)
    if isinstance(cache_offset, torch.Tensor):
        return cache_offset.reshape(1).to(torch.int32).expand(B).contiguous(), cache_offset
    return torch.full((B,), int(cache_offset), dtype=torch.int32, device=device), cache_offset


def output_head(hp: HParams, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The final norm (a LayerNorm where params has "output_norm_b":
    phimoe) and the head in f32: phimoe's head bias "output_b" added in the
    head's dtype before the cast, as the JAX package adds it; then divided
    by logit_scale, and the final-logit softcap where the model has one
    (gemma2)."""
    x = pre_norm(hp, x, params["output_norm"], params.get("output_norm_b"))
    if params["output"] is not None:
        logits = params["output"](x)
    else:  # tied head: a plain product outside any kernel
        logits = x @ params["tok_embd"].T.to(x.dtype)
    if params.get("output_b") is not None:
        logits = logits + params["output_b"].to(logits.dtype)
    logits = logits.float()
    if hp.logit_scale != 1.0:
        logits = logits / hp.logit_scale
    if hp.softcap_final:
        logits = torch.tanh(logits / hp.softcap_final) * hp.softcap_final
    return logits


def finish(hp: HParams, params: Params, x: torch.Tensor, last_index, return_hidden: bool):
    """The end of a forward from the last layer's x [B, T, E]: with
    return_hidden the final-norm hidden states in f32; else the logits of
    every row, of row last_index (a host int), or of row last_index[b] of
    batch row b (a [B] device tensor)."""
    if return_hidden:
        return pre_norm(hp, x, params["output_norm"], params.get("output_norm_b")).float()
    return output_head(hp, params, pick_rows(x, last_index))


def pick_rows(x: torch.Tensor, last_index) -> torch.Tensor:
    """The rows of x [B, T, E] the head runs on: every row (None), row
    last_index (a host int), or row last_index[b] of batch row b (a [B]
    device tensor: no read-back, so a captured forward holds it)."""
    if isinstance(last_index, torch.Tensor):  # one flagged row per batch row
        B = x.shape[0]
        idx = last_index.to(torch.int64).reshape(B, 1, 1).expand(B, 1, x.shape[-1])
        return x.gather(1, idx)
    if last_index is not None:
        return x[:, last_index:last_index + 1]
    return x


def forward(hp: HParams, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor, cache, cache_offset,
            last_index=None, return_hidden: bool = False, layer_states: list | None = None,
            deepstack: torch.Tensor | None = None):
    """tokens/positions [B, T] → (logits [B, T, n_vocab] f32, cache). With
    last_index=i the head runs on row i only and logits are [B, 1, n_vocab]
    (the prefill path: the head of an 8B model is ~6% of its FLOPs); a [B]
    device tensor of indices picks row last_index[b] of batch row b (a
    joint prefill round of several slots). With return_hidden, (the
    final-norm hidden states [B, T, n_embd] f32, cache) instead (the
    embeddings path).

    `cache_offset` is the cache slot of row 0: a host int, or at T = 1 a 0-d
    device int32 tensor, which the flash kernel then reads as its offsets
    and the cache write as its index; or an int32 [B] device tensor, the
    offset of each batch row (a slot), −1 where the slot is idle: its cache
    rows are left as they are (runtime/kvcache.py `_slot_write`).

    params["cvec"] [n_layer, n_embd], where an engine has control vectors,
    is added to the residual stream after each layer, in x's dtype (the JAX
    llama graph's llama_adapter_cvec). `layer_states`, a list, receives x
    [B, T, n_embd] after each layer (tools/cvector.py's capture).

    `tokens` may be float [B, T, n_embd]: input embeddings in place of ids
    (runtime/engine.py prefill_embeddings), taken in the table's dtype and
    not scaled. `positions` may be [S, B, T], one RoPE stream per M-RoPE
    section (ops/rope.py). `deepstack` [n_ds, B, T, n_embd] is added to x
    after layers 0 .. n_ds − 1, in x's dtype (qwen3vl's visual residuals).
    hp.causal changes nothing here: the JAX graph's bidirectional mask
    reaches only its dense attention path, which its Engine takes for no
    forward of T ≥ 8 rows; Engine.embed_tokens gives llama-embed what the
    JAX package computes."""
    if tokens.is_floating_point():
        B, T = tokens.shape[:2]
        x = tokens.to(params["tok_embd"].dtype)
    else:
        B, T = tokens.shape
        x = params["tok_embd"][tokens]
        if hp.embd_scale != 1.0:
            x = x * hp.embd_scale
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    rope_cs = rope_angles(hp.rope, positions)
    slopes = (alibi_slopes(hp.n_head, hp.max_alibi_bias, x.device)
              if hp.max_alibi_bias > 0.0 else None)
    cvec = params.get("cvec")
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
            ffn = dense_ffn(layer, h, hp.xielu[li] if hp.xielu is not None else None)
        if hp.residual_scale != 1.0:
            ffn = ffn * hp.residual_scale
        x = x + ffn
        if cvec is not None:
            x = x + cvec[li].to(x.dtype)
        if deepstack is not None and li < deepstack.shape[0]:
            x = x + deepstack[li].to(x.dtype)
        if layer_states is not None:
            layer_states.append(x)
    return finish(hp, params, x, last_index, return_hidden), cache
