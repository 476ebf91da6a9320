"""The qwen-moe graph: Qwen2-MoE, Qwen3-MoE, DeepSeek (v1), Granite-MoE and
the other archs that ride it (the JAX package's models/qwen_moe.py, arch
`qwen3moe`).

The llama family's GQA attention (models/llama.py attn_block: qwen2moe's
biases, qwen3moe's per-head qk norms, the full-projection norms of
minimax-m2, bailingmoe2 and olmoe, hunyuan-moe's post-RoPE norms), then a
routed expert FFN (ops/moe.py), with options that ride tensors and hparams
(olmoe, the JAX package's models/olmoe.py, takes none of them: softmax
top-k, not renormalised, no shared expert):
  * leading dense layers (deepseek, ernie4_5-moe, dots1, glm4moe, ...):
    a layer without expert stacks runs a SwiGLU FFN;
  * routing by softmax or sigmoid, renormalised per arch
    (`norm_weights_policy`), scaled, and ranked with the selection bias
    exp_probs_b where a layer has one;
  * a shared expert added to the routed ones, sigmoid-gated by
    ffn_gate_inp_shexp (qwen2moe) in f32;
  * granite-moe's embedding, residual and logit multipliers;
  * trailing NextN layers (bailingmoe2, glm4moe) left out of the forward.
Offsets take the three forms of models/llama.py; the head goes through its
`finish`, so `last_index` and `return_hidden` work on every entry point.
"""

from __future__ import annotations

import torch

from ..gguf.reader import GGUFReader
from ..ops.moe import moe_ffn, route
from ..ops.norms import rms_norm
from ..ops.rope import rope_angles
from .hparams import HParams
from .llama import (Params, attn_block, attn_params, dense_ffn, finish, forward_offsets,
                    router_logits, silu_glu)
from .weights import MODES, load_embedding, load_expert_stack, load_linear, load_vector

# the archs whose top-k routing weights are renormalised whatever the file
# says (llama.cpp's build_moe_ffn norm_w per graph)
_NORM_WEIGHTS_ARCHS = ("qwen3moe", "granitemoe", "ernie4_5-moe", "hunyuan-moe", "minimax-m2",
                       "dots1", "bailingmoe2")


def norm_weights_policy(hp: HParams) -> bool:
    """Whether the top-k routing weights are renormalised for this arch."""
    return hp.expert_weights_norm or hp.arch in _NORM_WEIGHTS_ARCHS


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """Weights from GGUF onto `device` as models/llama.py loads them, in the
    JAX package's qwen-moe param tree: the first n_layer − nextn_layers
    layers; the attention entries and FFN pre-norm of llama's attn_params;
    a router and expert stacks where the layer has
    ffn_gate_exps, else the dense lead's SwiGLU; exp_probs_b; the shared
    expert, with its sigmoid gate vector where ffn_gate_inp_shexp exists."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode) if name in t else None

    def vector(name):
        return load_vector(t[name], device) if name in t else None

    layers = []
    for i in range(hp.n_layer - hp.nextn_layers):
        p = f"blk.{i}."
        layer = attn_params(p, linear, vector)
        if p + "ffn_gate_exps.weight" in t:
            layer["router"] = linear(p + "ffn_gate_inp.weight")
            for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                layer["w_" + key.removeprefix("ffn_")] = load_expert_stack(
                    t[p + key + ".weight"], device, dtype, mode)
        else:  # a dense lead layer
            layer.update(w_gate=linear(p + "ffn_gate.weight"), w_up=linear(p + "ffn_up.weight"),
                         w_down=linear(p + "ffn_down.weight"))
        if p + "exp_probs_b.bias" in t:
            layer["exp_probs_b"] = vector(p + "exp_probs_b.bias")
        if p + "ffn_gate_shexp.weight" in t:
            if p + "ffn_gate_inp_shexp.weight" in t:
                layer["shexp_gate_inp"] = vector(p + "ffn_gate_inp_shexp.weight").reshape(-1)
            layer.update(w_gate_shexp=linear(p + "ffn_gate_shexp.weight"),
                         w_up_shexp=linear(p + "ffn_up_shexp.weight"),
                         w_down_shexp=linear(p + "ffn_down_shexp.weight"))
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
    `return_hidden`."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    if hp.embd_scale != 1.0:
        x = x * hp.embd_scale
    offsets, cache_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    rope_cs = rope_angles(hp.rope, positions)
    norm_w = norm_weights_policy(hp)
    for li, layer in enumerate(params["layers"]):
        x, cache = attn_block(hp, layer, x, rope_cs, cache, li, cache_offset, offsets)
        hs = rms_norm(x, layer["ffn_norm"], hp.rms_eps).reshape(B * T, -1)
        if layer.get("router") is None:  # a dense lead layer
            ffn = dense_ffn(layer, hs)
        else:
            weights, idx = route(router_logits(layer["router"], hs), hp.n_expert_used,
                                 gating=hp.expert_gating_func, norm_weights=norm_w,
                                 scale=hp.expert_weights_scale,
                                 select_bias=layer.get("exp_probs_b"))
            ffn = moe_ffn(hs, weights, idx, layer["w_gate_exps"], layer["w_up_exps"],
                          layer["w_down_exps"])
        if layer.get("w_gate_shexp") is not None:
            shared = layer["w_down_shexp"](silu_glu(layer["w_gate_shexp"](hs),
                                                    layer["w_up_shexp"](hs)))
            if layer.get("shexp_gate_inp") is not None:  # qwen2moe's gate, in f32
                g = torch.sigmoid(hs.float() @ layer["shexp_gate_inp"].float())[:, None]
                shared = (shared.float() * g).to(shared.dtype)
            ffn = ffn + shared.to(ffn.dtype)
        if hp.residual_scale != 1.0:
            ffn = ffn * hp.residual_scale
        x = x + ffn.reshape(B, T, -1)
    return finish(hp, params, x, last_index, return_hidden), cache
