"""Hybrid attention + SSM decoders (the JAX package's models/jamba.py):
Jamba, Nemotron-H, Granite-4.0-H (granitehybrid), Nemotron-H-MoE and
Falcon-H1 (≡ llm_build_jamba, llm_build_nemotron_h, llm_build_granite_hybrid,
llm_build_falcon_h1 over llama_memory_hybrid).

A layer's kind comes from its tensors, as in the JAX package: ssm_in with
ssm_x is a mamba1 mixer (jamba, with its dt/B/C norms), ssm_in alone a
Mamba-2 mixer (models/mamba.py), attn_q attention (GQA through the flash
kernel; RoPE only under granitehybrid's rope_finetuned), neither
nemotron-h's FFN-only layer. A mixer layer pairs with an FFN sub-block
where it has one: SwiGLU, nemotron-h's ReLU² (with biases where the file
has them), or routed experts (`route` and `moe_ffn`: softmax top-k over
SiLU experts for jamba and granitehybrid; nemotron_h_moe's sigmoid gating
with its selection bias and weight scale over gateless ReLU² experts),
plus a shared expert (granitehybrid's gated one, nemotron_h_moe's ungated
ReLU²). granitehybrid applies the granite multipliers (embedding,
residual, logits). Falcon-H1 runs attention (with RoPE) and a Mamba-2
mixer in parallel on every layer, their sum into the residual, then a
SwiGLU FFN (`forward_falcon_h1`).

`HybridCache` holds K/V for the attention layers only and the conv/ssm
state for the mixer layers only, through a layer map (as SWACache maps
its layers): the JAX package's HybridCache carries both stores at full
depth, unused slices zero, which computes the same thing. For
Jamba-Mini-1.5 (4 attention layers of 32) at 8192 positions that is 128
MiB of bf16 K/V a sequence instead of 1 GiB. Which layers are which comes
from the hparams, as llama.cpp's recurrent_layer_arr: an attention layer
has KV heads; a mixer layer has none (and, in nemotron_h's files, no FFN
width either); Falcon-H1's layers are both. The K/V store takes the
engine's float dtype, and bf16 for every named cache type ("f16", "q8_0",
…), as the JAX HybridCache.new gives bf16 for a named type (ROADMAP.md §3,
"Not faults"). Everything is written in place; an idle slot (per-slot
offset −1) keeps its K/V rows and its state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..gguf.reader import GGUFReader
from ..ops.attention import attention_cached
from ..ops.moe import moe_ffn, route
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_angles, rope_angles
from ..runtime.kvcache import _write
from ..runtime.recurrent import StateRows, active_slots, conv_width
from .hparams import HParams
from .llama import Params, finish, forward_offsets, router_logits, silu_glu
from .mamba import mamba2_mixer, mixer, ssm_params, tensor_loaders
from .weights import load_embedding, load_expert_stack

NEMOTRON_ARCHS = ("nemotron_h", "nemotron_h_moe")


def layer_kinds(hp: HParams) -> tuple[tuple[bool, bool], ...]:
    """(attention, mixer) of each layer from the hparams (llama.cpp's
    recurrent_layer_arr): Falcon-H1's layers are both; otherwise a layer
    with KV heads is attention, and one without is a mixer, but for
    nemotron-h's FFN-only layers (an FFN width and no KV heads)."""
    if hp.arch == "falcon-h1":
        return ((True, True),) * hp.n_layer
    kinds = []
    for li in range(hp.n_layer):
        attn = hp.n_head_kv_l(li) > 0
        ffn_only = hp.arch in NEMOTRON_ARCHS and hp.n_ff_l(li) > 0
        kinds.append((attn, not attn and not ffn_only))
    return tuple(kinds)


@dataclass
class HybridCache(StateRows):
    """K/V of the attention layers and conv/ssm state of the mixer layers;
    `layer_map[li]` = (index among the attention layers or −1, index among
    the mixer layers or −1)."""

    k: torch.Tensor  # [n_attn, B, Hkv, S, Dk]
    v: torch.Tensor  # [n_attn, B, Hkv, S, Dv]
    conv: torch.Tensor  # [n_mix, B, conv width, d_conv − 1] f32
    ssm: torch.Tensor  # [n_mix, B, d_inner, d_state] f32
    layer_map: tuple

    @classmethod
    def new(cls, hp: HParams, batch: int, max_len: int, kv_dtype=torch.bfloat16,
            device=None) -> "HybridCache":
        dtype = torch.bfloat16 if isinstance(kv_dtype, str) else kv_dtype
        layer_map, n_attn, n_mix = [], 0, 0
        for li, (attn, mix) in enumerate(layer_kinds(hp)):
            if attn and (hp.n_head_kv_l(li) or hp.n_head_kv) != hp.n_head_kv:
                raise NotImplementedError(
                    f"layer {li}: {hp.n_head_kv_l(li)} KV heads beside the model's "
                    f"{hp.n_head_kv} (the JAX package pads them; no ported model has such)")
            layer_map.append((n_attn if attn else -1, n_mix if mix else -1))
            n_attn += attn
            n_mix += mix

        def zeros(*shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(zeros(n_attn, batch, hp.n_head_kv, max_len, hp.head_dim, dt=dtype),
                   zeros(n_attn, batch, hp.n_head_kv, max_len, hp.head_dim_v, dt=dtype),
                   zeros(n_mix, batch, conv_width(hp), hp.ssm_d_conv - 1, dt=torch.float32),
                   zeros(n_mix, batch, hp.ssm_d_inner, hp.ssm_d_state, dt=torch.float32),
                   tuple(layer_map))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def first_slots(self, n: int) -> "HybridCache":
        """A view of batch rows [0, n): its writes land in this cache."""
        return HybridCache(self.k[:, :n], self.v[:, :n], self.conv[:, :n], self.ssm[:, :n],
                           self.layer_map)

    def slot_view(self, slot: int) -> "HybridCache":
        """A view of batch row `slot` alone: its writes land in this cache."""
        rows = slice(slot, slot + 1)
        return HybridCache(self.k[:, rows], self.v[:, rows], self.conv[:, rows],
                           self.ssm[:, rows], self.layer_map)

    def kv(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        a = self.layer_map[layer][0]
        return self.k[a], self.v[a]

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "HybridCache":
        """Write an attention layer's k/v [B, Hkv, T, D] at `offset` (the
        forms KVCache.update takes)."""
        a = self.layer_map[layer][0]
        _write(self.k, k_new, offset, 2, a)
        _write(self.v, v_new, offset, 2, a)
        return self

    def state_index(self, layer: int) -> int:
        """A mixer layer's conv/ssm plane (K/V rows need no reset: the
        offsets alone invalidate them)."""
        return self.layer_map[layer][1]


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """A hybrid file's weights onto `device`, layer by layer from the
    tensors present (the JAX package's build_params): the SSM entries
    (models/mamba.py ssm_params), attention's wq/wk/wv/wo, and the FFN
    slot: a router with expert stacks (gated or not), nemotron_h_moe's
    selection bias and a shared expert, or a dense FFN with its optional
    gate and biases. The kinds must agree with the cache's layer map."""
    t, linear, vector = tensor_loaders(r, device, dtype, mode)
    kinds = layer_kinds(hp)
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        layer = {"attn_norm": vector(p + "attn_norm.weight"),
                 "ffn_norm": vector(p + "ffn_norm.weight")}
        if p + "ssm_in.weight" in t:
            layer.update(ssm_params(t, p, hp, linear, vector))
        if p + "attn_q.weight" in t:
            layer.update({key: linear(p + f"attn_{name}.weight") for key, name in
                          (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "output"))})
        if ((p + "attn_q.weight" in t), (p + "ssm_in.weight" in t)) != kinds[i]:
            raise ValueError(f"{hp.arch} layer {i}: its tensors and its hparams "
                             f"(KV heads, FFN width) disagree on its kind")
        if p + "ffn_gate_inp.weight" in t:
            layer["router"] = linear(p + "ffn_gate_inp.weight")
            for key in ("gate", "up", "down"):
                name = p + f"ffn_{key}_exps.weight"
                layer[f"w_{key}_exps"] = (load_expert_stack(t[name], device, dtype, mode)
                                          if name in t else None)
            layer["exp_probs_b"] = vector(p + "exp_probs_b.bias")
            for key in ("gate", "up", "down"):
                layer[f"w_{key}_shexp"] = linear(p + f"ffn_{key}_shexp.weight")
        elif p + "ffn_up.weight" in t:
            layer.update(w_gate=linear(p + "ffn_gate.weight"), w_up=linear(p + "ffn_up.weight"),
                         b_up=vector(p + "ffn_up.bias"), w_down=linear(p + "ffn_down.weight"),
                         b_down=vector(p + "ffn_down.bias"))
        layers.append(layer)
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": vector("output_norm.weight"),
        "output": linear("output.weight"),
    }


def in_dtype(scale: float, dtype: torch.dtype) -> float:
    """A multiplier rounded to the activations' dtype, as the JAX package
    multiplies by jnp.asarray(scale, x.dtype)."""
    return float(torch.tensor(scale, dtype=dtype))


def _has_attn(layer: dict) -> bool:
    return layer.get("wqkv") is not None or layer.get("wq") is not None


def _has_ffn(layer: dict) -> bool:
    return any(layer.get(k) is not None for k in ("router", "w_up", "wgu"))


def attention(hp: HParams, layer: dict, h: torch.Tensor, rope_cs, cache, li: int,
              write_offset, offsets: torch.Tensor) -> torch.Tensor:
    """A hybrid's attention on its normed input h [B, T, E] (no biases, no
    qk norms; RoPE where `rope_cs` is given): K/V written at the layer's
    slot of the cache, the flash kernel over it, the output projection."""
    B, T = h.shape[:2]
    scale = hp.attn_scale if hp.attn_scale is not None else hp.head_dim ** -0.5
    fused = layer.get("wqkv")
    q, k, v = fused(h) if fused is not None else (layer["wq"](h), layer["wk"](h), layer["wv"](h))
    q = q.reshape(B, T, hp.n_head, hp.head_dim)
    k = k.reshape(B, T, hp.n_head_kv, hp.head_dim)
    v = v.reshape(B, T, hp.n_head_kv, hp.head_dim_v)
    if rope_cs is not None:
        q = apply_rope_angles(q, *rope_cs, hp.rope.style)
        k = apply_rope_angles(k, *rope_cs, hp.rope.style)
    cache.update(li, k.transpose(1, 2), v.transpose(1, 2), write_offset)
    out = attention_cached(q.contiguous(), cache, li, scale, offsets)
    return layer["wo"](out.reshape(B, T, hp.n_head * hp.head_dim_v))


def _relu_sqr(up: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(up.float())).to(up.dtype)


def ffn_block(hp: HParams, layer: dict, h: torch.Tensor) -> torch.Tensor:
    """A layer's FFN slot (the JAX package's _ffn_block): routed experts
    with the shared expert where the layer has one, or the dense FFN
    (SwiGLU, or nemotron-h's ReLU² where there is no gate; biases where
    the file has them)."""
    B, T = h.shape[:2]
    if layer.get("router") is not None:
        hs = h.reshape(B * T, -1)
        gateless = layer.get("w_gate_exps") is None  # nemotron_h_moe's ReLU² experts
        weights, idx = route(router_logits(layer["router"], hs), hp.n_expert_used,
                             gating=hp.expert_gating_func if gateless else "softmax",
                             norm_weights=hp.expert_weights_norm,
                             scale=hp.expert_weights_scale if gateless else 1.0,
                             select_bias=layer.get("exp_probs_b"))
        ffn = moe_ffn(hs, weights, idx, layer.get("w_gate_exps"), layer["w_up_exps"],
                      layer["w_down_exps"], act="relu_sqr" if gateless else "silu")
        if layer.get("w_up_shexp") is not None:
            up = layer["w_up_shexp"](hs)
            gate = layer.get("w_gate_shexp")
            mid = silu_glu(gate(hs), up) if gate is not None else _relu_sqr(up)
            ffn = ffn + layer["w_down_shexp"](mid).to(ffn.dtype)
        return ffn.reshape(B, T, -1)
    if layer.get("wgu") is not None:
        gate, up = layer["wgu"](h)
    else:
        gate = layer["w_gate"](h) if layer.get("w_gate") is not None else None
        up = layer["w_up"](h)
    if layer.get("b_up") is not None:
        up = up + layer["b_up"].to(up.dtype)
    down = layer["w_down"](silu_glu(gate, up) if gate is not None else _relu_sqr(up))
    if layer.get("b_down") is not None:
        down = down + layer["b_down"].to(down.dtype)
    return down


def forward(hp: HParams, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache: HybridCache, cache_offset, last_index=None, return_hidden: bool = False):
    """jamba, nemotron_h, granitehybrid and nemotron_h_moe: tokens [B, T]
    → (logits f32, cache), as llama.forward returns them (last_index,
    return_hidden, and the three forms of the cache offset alike)."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    if hp.embd_scale != 1.0:
        x = x * in_dtype(hp.embd_scale, x.dtype)
    offsets, write_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    active = active_slots(cache_offset)
    rope_cs = rope_angles(hp.rope, positions) if hp.rope_finetuned else None
    res = in_dtype(hp.residual_scale, x.dtype)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        ssm = layer.get("ssm_in") is not None
        if ssm:
            out, conv_state, ssm_state = mixer(hp, layer)(hp, layer, h, *cache.state(li))
            cache.write(li, conv_state, ssm_state, active)
        elif _has_attn(layer):
            out = attention(hp, layer, h, rope_cs, cache, li, write_offset, offsets)
        else:  # nemotron-h's FFN-only layer
            out = ffn_block(hp, layer, h)
        if hp.residual_scale != 1.0:
            out = out * res
        x = x + out
        # jamba and granitehybrid pair each mixer with an FFN sub-block
        if (ssm or _has_attn(layer)) and _has_ffn(layer):
            out = ffn_block(hp, layer, rms_norm(x, layer["ffn_norm"], hp.rms_eps))
            if hp.residual_scale != 1.0:
                out = out * res
            x = x + out
    return finish(hp, params, x, last_index, return_hidden), cache


def forward_falcon_h1(hp: HParams, params: Params, tokens: torch.Tensor,
                      positions: torch.Tensor, cache: HybridCache, cache_offset,
                      last_index=None, return_hidden: bool = False):
    """Falcon-H1: on every layer attention (with RoPE) and the Mamba-2
    mixer over the same normed input, their sum into the residual, then
    the SwiGLU FFN."""
    B, T = tokens.shape
    x = params["tok_embd"][tokens]
    offsets, write_offset = forward_offsets(cache_offset, B, T, cache.max_len, x.device)
    active = active_slots(cache_offset)
    rope_cs = rope_angles(hp.rope, positions)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], hp.rms_eps)
        attn = attention(hp, layer, h, rope_cs, cache, li, write_offset, offsets)
        ssm_out, conv_state, ssm_state = mamba2_mixer(hp, layer, h, *cache.state(li))
        cache.write(li, conv_state, ssm_state, active)
        x = x + attn + ssm_out
        x = x + ffn_block(hp, layer, rms_norm(x, layer["ffn_norm"], hp.rms_eps))
    return finish(hp, params, x, last_index, return_hidden), cache
