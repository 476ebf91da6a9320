"""Weights carried across from the JAX package.

`params_from_jax(tree_np, device)` turns the JAX llama parameter tree, with
its arrays converted to numpy (e.g. `jax.tree_util.tree_map(np.asarray,
params)`), into the port's modules. The JAX containers are read by their
attributes, so this module imports nothing of the JAX package:
QuantExpertStack-like objects (`n_expert` beside `planes`) become
`QuantExpertStack`, QuantLinear-like (`gtype`, `n_out`, `n_in`, `planes`)
`QuantLinear`, DenseLinear-like (`w`, the MoE router among them)
`DenseLinear`, and FusedLinear-like (`base`, `splits`) `FusedLinear`; both
the fused (`wqkv`/`wgu`) and the unfused layout carry over, and dense
expert stacks stay tensors. Any layer keys carry over as they are: the
gemma tree's norms, deepseek2's (`wk_b` / `wv_b` as tensors, the shared
experts as linears, `exp_probs_b`, `wkv_b` None when absorbed), and the
qwen-moe tree's (`shexp_gate_inp` as a tensor, the shared experts as
linears, the dense lead layers' linears, `exp_probs_b`; a key the JAX
layer lacks stays absent, as the forwards read layers with `get`), the
phi3 and qwen trees (q|k|v and gate|up fused by the JAX Engine from the
row slices of one tensor: a FusedLinear whose planes are the port's
fused load's; qwen's f32 biases) and phi2's (`attn_norm_b`, `bo`, `b_up`,
`b_down`), phimoe's (`attn_norm_b`, `ffn_norm_b`, the q/k/v and o biases)
and llama4's (the shared expert's linears, a dense layer's SwiGLU). The
top-level entries beside the embedding and the layers carry over the same
way (phi2's and phimoe's `output_norm_b` and `output_b`), and so does a
JAX Engine's `cvec` (its control vectors, [n_layer, n_embd]). A
LoraLinear-like (`base`, `a_t`, `b_t`, `scale`) becomes models/lora.py's
`LoraLinear` around its base. Split q/k/v and gate/up of one type are then
fused as the port's Engine fuses them (models/weights.py
fuse_llama_params): phi2's, which the JAX Engine leaves apart, become the
FusedLinear of the port's fused load; a tree with LoRA wrappers stays
unfused, as an Engine with adapters does.
"""

from __future__ import annotations

import numpy as np
import torch

from .gguf.constants import GGMLType
from .models.lora import LoraLinear
from .models.weights import (DenseLinear, FusedLinear, QuantExpertStack, QuantLinear,
                             fuse_llama_params)


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array → tensor on `device`; ml_dtypes bfloat16 arrays (what
    np.asarray gives for a bf16 JAX array) map to torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def module_from_jax(obj, device):
    """One JAX weight container (or None) → the port's module."""
    if obj is None:
        return None
    if hasattr(obj, "a_t") and hasattr(obj, "b_t"):
        return LoraLinear(module_from_jax(obj.base, device), tensor_from_numpy(obj.a_t, device),
                          tensor_from_numpy(obj.b_t, device), obj.scale)
    if hasattr(obj, "splits"):
        return FusedLinear(module_from_jax(obj.base, device), tuple(obj.splits))
    if hasattr(obj, "planes"):
        planes = {k: tensor_from_numpy(v, device) for k, v in obj.planes.items()}
        if hasattr(obj, "n_expert"):  # 3-D planes [E, rows, N]
            return QuantExpertStack(GGMLType(int(obj.gtype)), obj.n_expert, obj.n_out,
                                    obj.n_in, planes)
        return QuantLinear(GGMLType(int(obj.gtype)), obj.n_out, obj.n_in, planes)
    if hasattr(obj, "w"):
        return DenseLinear(tensor_from_numpy(obj.w, device))
    return tensor_from_numpy(obj, device)


def params_from_jax(tree_np: dict, device) -> dict:
    """A JAX param tree (numpy leaves) of a forward the port runs → the
    port's param dict."""
    layers = [{k: module_from_jax(v, device) for k, v in layer.items()}
              for layer in tree_np["layers"]]
    out = {k: module_from_jax(v, device) for k, v in tree_np.items()
           if k not in ("tok_embd", "layers")}
    params = {"tok_embd": tensor_from_numpy(tree_np["tok_embd"], device), "layers": layers,
              "output": None, **out}
    if any(isinstance(m, LoraLinear) for layer in layers for m in layer.values()):
        return params  # an Engine with adapters keeps its projections apart
    # q|k|v and gate|up fused where the port's Engine fuses them (the JAX
    # Engine leaves phi2's apart)
    return fuse_llama_params(params)
