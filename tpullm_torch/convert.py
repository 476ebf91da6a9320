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
expert stacks stay tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .gguf.constants import GGMLType
from .models.weights import DenseLinear, FusedLinear, QuantExpertStack, QuantLinear


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
    """The JAX llama param tree (numpy leaves) → the port's param dict."""
    layers = [{k: module_from_jax(v, device) for k, v in layer.items()}
              for layer in tree_np["layers"]]
    return {
        "tok_embd": tensor_from_numpy(tree_np["tok_embd"], device),
        "layers": layers,
        "output_norm": tensor_from_numpy(tree_np["output_norm"], device),
        "output": module_from_jax(tree_np.get("output"), device),
    }
