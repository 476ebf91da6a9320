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
NEOX (models/hparams.py NEOX_ROPE_ARCHS). phimoe (build_params_moe /
forward_moe) waits for ROADMAP 1.5.4.
"""

from __future__ import annotations

import torch

from ..gguf.reader import GGUFReader
from .hparams import HParams
from .llama import Params
from .weights import MODES, load_embedding, load_fused, load_linear, load_vector


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
