"""LoRA adapters (the JAX package's models/lora.py; reference:
src/llama-adapter.cpp + convert_lora_to_gguf.py).

GGUF adapter files carry general.type="adapter", adapter.type="lora",
adapter.lora.alpha, and per-weight low-rank factors named
"<base_tensor>.lora_a" (r, n_in) / "<base_tensor>.lora_b" (n_out, r).

Applied at load as a wrapper linear, y = base(x) + scale·((x Aᵀ) Bᵀ),
scale = user_scale · alpha / r (llama_adapter_lora_weight::get_scale),
over a dense or a packed base (a packed base stays on the qmm kernels;
the low-rank pair is two plain products in x's dtype, the scale applied in
f32, as the JAX package computes it outside any kernel). The factors and
the scale are fixed at load, so a captured decode graph holds them like
any other weight: adapters are not swapped at run time (nor in the JAX
package). Merging is export-lora's job (`merge_lora_dense`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader


class LoraLinear(nn.Module):
    """base(x) + scale · (x @ a_t) @ b_t: the two products in x's dtype
    (the factors are stored in the engine's dtype, so the products cast
    nothing on the engine's path), the scale in f32, the sum in y's dtype
    (the JAX package's LoraLinear)."""

    def __init__(self, base: nn.Module, a_t: torch.Tensor, b_t: torch.Tensor, scale: float):
        super().__init__()
        self.base = base
        self.register_buffer("a_t", a_t)  # [n_in, r]
        self.register_buffer("b_t", b_t)  # [r, n_out]
        self.scale = float(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        lo = (x @ self.a_t.to(x.dtype)) @ self.b_t.to(x.dtype)
        return y + (lo.float() * self.scale).to(y.dtype)


@dataclass
class LoraAdapter:
    alpha: float
    # base tensor name (".weight" suffix kept) → (a (r, n_in), b (n_out, r))
    tensors: dict[str, tuple[np.ndarray, np.ndarray]]

    def scale_for(self, name: str, user_scale: float) -> float:
        a, _ = self.tensors[name]
        r = a.shape[0]
        return user_scale * self.alpha / r if self.alpha else user_scale


def load_lora_gguf(path) -> LoraAdapter:
    r = GGUFReader(path)
    md = r.metadata
    gtype = md.get("general.type")
    atype = md.get("adapter.type")
    if gtype not in (None, "adapter") or atype not in (None, "lora"):
        raise ValueError(f"not a LoRA adapter GGUF: type={gtype}/{atype}")
    alpha = float(md.get("adapter.lora.alpha", 0.0))
    pairs: dict[str, dict[str, np.ndarray]] = {}
    for name, info in r.tensors.items():
        if name.endswith(".lora_a"):
            pairs.setdefault(name[: -len(".lora_a")], {})["a"] = np.array(info.to_numpy())
        elif name.endswith(".lora_b"):
            pairs.setdefault(name[: -len(".lora_b")], {})["b"] = np.array(info.to_numpy())
    tensors = {}
    for base, ab in pairs.items():
        if "a" not in ab or "b" not in ab:
            raise ValueError(f"LoRA tensor {base} missing lora_a or lora_b")
        tensors[base] = (ab["a"], ab["b"])
    r.close()
    return LoraAdapter(alpha=alpha, tensors=tensors)


# GGUF tensor-name stem → param-dict key used by the model modules
_LAYER_KEYS = {
    "attn_q": "wq",
    "attn_k": "wk",
    "attn_v": "wv",
    "attn_output": "wo",
    "ffn_gate": "w_gate",
    "ffn_up": "w_up",
    "ffn_down": "w_down",
}


def _check_shape(name: str, base, a: np.ndarray, b: np.ndarray) -> None:
    """The factors must fit the base linear: a (r, n_in), b (n_out, r)."""
    n_in, n_out = base.n_in, base.n_out
    if a.shape[1] != n_in or b.shape[0] != n_out or a.shape[0] != b.shape[1]:
        raise ValueError(f"LoRA {name}: lora_a {a.shape} / lora_b {b.shape} do not fit a "
                         f"base of n_in {n_in}, n_out {n_out}")


def apply_lora(params: dict, adapter: LoraAdapter, user_scale: float = 1.0,
               dtype=torch.bfloat16) -> dict:
    """Wrap the matched linears of `params` in LoraLinear, the factors in
    `dtype` on the base's device. A tensor with no matching base weight,
    or whose shape does not fit it, raises (the strictness of
    llama_adapter_lora init)."""
    device = params["tok_embd"].device
    unmatched = []
    for name, (a, b) in adapter.tensors.items():
        scale = adapter.scale_for(name, user_scale)
        parts = name.split(".")
        if parts[0] == "blk" and len(parts) >= 3:
            li = int(parts[1])
            key = _LAYER_KEYS.get(parts[2])
            if key is None or li >= len(params["layers"]) or params["layers"][li].get(key) is None:
                unmatched.append(name)
                continue
            holder = params["layers"][li]
        elif parts[0] == "output" and params.get("output") is not None:
            holder, key = params, "output"
        else:
            unmatched.append(name)
            continue
        _check_shape(name, holder[key], a, b)
        a_t = torch.from_numpy(np.ascontiguousarray(a.T, dtype=np.float32))
        b_t = torch.from_numpy(np.ascontiguousarray(b.T, dtype=np.float32))
        holder[key] = LoraLinear(holder[key], a_t.to(device=device, dtype=dtype),
                                 b_t.to(device=device, dtype=dtype), scale)
    if unmatched:
        raise ValueError(f"LoRA tensors with no matching base weight: {unmatched}")
    return params


def merge_lora_dense(base_w: np.ndarray, a: np.ndarray, b: np.ndarray,
                     scale: float) -> np.ndarray:
    """W' = W + scale·(B A) for export-lora (base_w (n_out, n_in))."""
    return base_w + scale * (b.astype(np.float32) @ a.astype(np.float32))


def save_lora_gguf(path, tensors: dict[str, tuple[np.ndarray, np.ndarray]],
                   alpha: float = 0.0, arch: str = "llama"):
    """Write a LoRA adapter GGUF (test fixture / converter output)."""
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(path, architecture=arch)
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", float(alpha))
    for base, (a, b) in tensors.items():
        w.add_tensor(base + ".lora_a", a.astype(np.float32), GGMLType.F32)
        w.add_tensor(base + ".lora_b", b.astype(np.float32), GGMLType.F32)
    w.write()
    return str(path)
