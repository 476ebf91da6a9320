"""Qwen (v1) decoder (the JAX package's models/qwen.py; reference graph
llm_build_qwen): the llama graph with q, k and v in one fused attn_qkv
tensor and one fused bias (Qwen v1 is MHA, so the three spans are equal).
The weight loads fused as phi3's (models/weights.py `load_fused`), the bias
splits into f32 bq / bk / bv, and the forward is llama.forward
(models/registry.py)."""

from __future__ import annotations

import torch

from ..gguf.reader import GGUFReader
from .hparams import HParams
from .llama import Params
from .weights import MODES, load_embedding, load_fused, load_linear, load_vector


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """The llama layer layout: `wqkv` fused, its bias split into bq / bk /
    bv (f32), gate and up apart (Engine fuses them where they share a
    type), no qk norms."""
    if mode not in MODES:
        raise ValueError(f"weight mode {mode!r} is not one of {MODES}")
    t = r.tensors

    def linear(name):
        return load_linear(t[name], device, dtype, mode)

    n_q, n_kv = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    layers = []
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        bqkv = load_vector(t[p + "attn_qkv.bias"], device)
        layers.append({
            "attn_norm": load_vector(t[p + "attn_norm.weight"], device),
            "wqkv": load_fused(t[p + "attn_qkv.weight"], (n_q, n_kv, n_kv), device, dtype, mode),
            "wq": None, "wk": None, "wv": None,
            "bq": bqkv[:n_q], "bk": bqkv[n_q:n_q + n_kv], "bv": bqkv[n_q + n_kv:n_q + 2 * n_kv],
            "wo": linear(p + "attn_output.weight"),
            "bo": None,
            "ffn_norm": load_vector(t[p + "ffn_norm.weight"], device),
            "w_gate": linear(p + "ffn_gate.weight"),
            "w_up": linear(p + "ffn_up.weight"),
            "w_down": linear(p + "ffn_down.weight"),
            "q_norm": None, "k_norm": None,
        })
    return {
        "tok_embd": load_embedding(t["token_embd.weight"], device, dtype),
        "layers": layers,
        "output_norm": load_vector(t["output_norm.weight"], device),
        "output": linear("output.weight") if "output.weight" in t else None,
    }
