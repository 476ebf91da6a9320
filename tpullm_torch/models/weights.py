"""Weight containers: dense and packed-quantized linears as nn.Modules, and
their loading from GGUF tensors.

`QuantLinear` keeps the repacked planes resident on the device and computes
through the fused dequant matmul (ops.qmatmul.matmul: the qmm kernel on the
card). `DenseLinear` is the F32/F16/BF16 path, and every linear in the weight
mode "dense" (the user's choice of a plain product, torch.matmul, on
dequantized weights; never taken for a type the kernels hold unless asked). `FusedLinear` concatenates
same-input linears along N so QKV and gate+up stream one plane set.
`QuantExpertStack` holds a MoE layer's stacked experts as planes with a
leading expert axis; ops/moe.py computes through it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..gguf.constants import GGMLType, TYPE_TRAITS
from ..gguf.reader import GGUFTensorInfo
from ..ops import qmatmul


class DenseLinear(nn.Module):
    """y = x @ w, w: [n_in, n_out]."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)

    @property
    def n_in(self) -> int:
        return self.w.shape[0]

    @property
    def n_out(self) -> int:
        return self.w.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.to(x.dtype)


class QuantLinear(nn.Module):
    """Packed-quantized weight of logical shape (n_out, n_in); `planes`
    follows the plane schema of ops.qmatmul for `gtype`."""

    def __init__(self, gtype: GGMLType, n_out: int, n_in: int,
                 planes: dict[str, torch.Tensor]):
        super().__init__()
        self.gtype = GGMLType(gtype)
        self.n_out = int(n_out)
        self.n_in = int(n_in)
        self._names = tuple(planes)
        for name, t in planes.items():
            self.register_buffer(name, t)

    @property
    def planes(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qmatmul.matmul(x, self)


class QuantExpertStack(nn.Module):
    """Packed-quantized stacked MoE experts, logical (E, n_out, n_in): each
    expert's weight repacked to the plane schema of ops.qmatmul and stacked
    on a leading expert axis ([E, rows, N] per plane), so the experts stay
    at their packed size on the device. ops/moe.py computes through
    ops.qmatmul.gather_matmul (decode: only the routed experts' planes are
    read) and stack_matmul (prefill: every expert on every token)."""

    def __init__(self, gtype: GGMLType, n_expert: int, n_out: int, n_in: int,
                 planes: dict[str, torch.Tensor]):
        super().__init__()
        self.gtype = GGMLType(gtype)
        self.n_expert = int(n_expert)
        self.n_out = int(n_out)
        self.n_in = int(n_in)
        self._names = tuple(planes)
        for name, t in planes.items():
            self.register_buffer(name, t)

    @property
    def planes(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    @property
    def shape(self) -> tuple[int, int, int]:
        # the layout of the widened stack, [E, n_in, n_out]
        return (self.n_expert, self.n_in, self.n_out)


class FusedLinear(nn.Module):
    """Output concatenation of same-input linears computed as one matmul;
    returns the split outputs. Each output column is computed by the same
    arithmetic as unfused, so fusion changes no value."""

    def __init__(self, base: nn.Module, splits: tuple[int, ...]):
        super().__init__()
        self.base = base
        self.splits = tuple(int(s) for s in splits)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return torch.split(self.base(x), self.splits, dim=-1)


def load_fused(info: GGUFTensorInfo, splits: tuple[int, ...], device, dtype=torch.bfloat16,
               mode: str = "auto") -> FusedLinear:
    """A GGUF tensor that holds several same-input linears one after another
    in its rows (phi3's and qwen's attn_qkv, phi3's gate|up ffn_up) as one
    FusedLinear of `splits` output widths: the tensor loads once as one
    linear (a packed tensor's rows are whole blocks, so its planes are the
    parts' planes side by side), never split and fused again."""
    if sum(splits) != info.shape[1]:
        raise ValueError(f"{info.name}: splits {splits} of {info.shape[1]} rows")
    return FusedLinear(load_linear(info, device, dtype, mode), splits)


def fuse_linears(linears: list) -> FusedLinear | None:
    """Concatenate same-type, same-n_in linears along n_out; None when the
    set is heterogeneous (e.g. Q4_K wq/wk beside a Q6_K wv: the Q4_K_M
    recipe mixes types per layer, so fusion is a per-layer decision)."""
    splits = tuple(int(l.n_out) for l in linears)
    if all(isinstance(l, DenseLinear) for l in linears):
        if len({l.w.dtype for l in linears}) != 1 or len({l.n_in for l in linears}) != 1:
            return None
        return FusedLinear(DenseLinear(torch.cat([l.w for l in linears], dim=1)), splits)
    if all(isinstance(l, QuantLinear) for l in linears):
        if len({l.gtype for l in linears}) != 1 or len({l.n_in for l in linears}) != 1 \
                or len({tuple(sorted(l.planes)) for l in linears}) != 1:
            return None
        names = list(linears[0].planes)
        planes = {nm: torch.cat([l.planes[nm] for l in linears], dim=1) for nm in names}
        return FusedLinear(QuantLinear(linears[0].gtype, sum(splits), linears[0].n_in,
                                       planes), splits)
    return None


def fuse_llama_params(params: dict) -> dict:
    """Fuse each layer's QKV and gate+up projections in place (llama param
    layout); layers whose projections mix types keep the separate linears.
    The unfused keys are cleared so the planes are not held twice."""
    for layer in params["layers"]:
        for fused_key, src_keys in (("wqkv", ("wq", "wk", "wv")),
                                    ("wgu", ("w_gate", "w_up"))):
            if any(layer.get(k) is None for k in src_keys):
                continue
            fused = fuse_linears([layer[k] for k in src_keys])
            if fused is None:
                continue
            layer[fused_key] = fused
            for k in src_keys:
                layer[k] = None
    return params


# the weight modes of build_params (the JAX package's load_linear modes):
# "auto" and "quant" keep the ported quantized types packed on the kernels,
# "dense" dequantizes every linear and expert stack at load
MODES = ("auto", "quant", "dense")


def _dense_array(info: GGUFTensorInfo) -> np.ndarray:
    """A writable f32 copy (the reader's arrays view a read-only mmap)."""
    return np.array(info.to_numpy(), dtype=np.float32)


def dense_weight(info: GGUFTensorInfo, device, dtype=torch.bfloat16) -> torch.Tensor:
    """A GGUF 2-D weight (logical (n_out, n_in)) as a dense [n_in, n_out]
    tensor of `dtype` on `device`, with the values of the JAX package's
    dense_from_info (its host f32 codec rounded once to dtype): a quantized
    type's blocks go up packed and dequantize on the device from their
    f32-scale planes (values · scale − minus in f32, the codec's
    arithmetic), one tensor at a time, so no model's f32 weights are held
    on the host."""
    n_out, n_in = info.shape[1], info.shape[0]
    if not TYPE_TRAITS[info.ggml_type].is_quantized:
        w = torch.from_numpy(np.ascontiguousarray(_dense_array(info).T))
        return w.to(device=device, dtype=dtype)
    if not qmatmul.supports(info.ggml_type):
        raise NotImplementedError(f"{info.name}: {info.ggml_type.name} is not ported")
    planes = qmatmul.repack_planes(qmatmul.upload_blocks(info.data, device), info.ggml_type,
                                   n_out, n_in)
    return qmatmul.dequant_planes(planes, info.ggml_type, n_out, n_in).to(dtype)


def load_linear(info: GGUFTensorInfo, device, dtype=torch.bfloat16,
                mode: str = "auto") -> nn.Module:
    """A GGUF 2-D weight (logical (n_out, n_in)) → QuantLinear for the ported
    quant types, DenseLinear [n_in, n_out] for plain float types and, in
    mode "dense", for every type."""
    n_out, n_in = info.shape[1], info.shape[0]
    if mode == "dense" or not TYPE_TRAITS[info.ggml_type].is_quantized:
        return DenseLinear(dense_weight(info, device, dtype))
    if not qmatmul.supports(info.ggml_type):
        raise NotImplementedError(f"{info.name}: {info.ggml_type.name} is not ported")
    planes = qmatmul.repack(info.data, info.ggml_type, n_out, n_in, device)
    return QuantLinear(info.ggml_type, n_out, n_in, planes)


EMBEDDING_CHUNK_ROWS = 16384  # table rows (tokens) load_embedding dequantizes at a time


def load_embedding(info: GGUFTensorInfo, device, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding table as [n_vocab, n_embd]: a quantized table uploads
    packed and dequantizes on the device through dequant_planes,
    EMBEDDING_CHUNK_ROWS tokens at a time into the table, so that its f32 intermediates are one
    chunk's (Gemma-3's 262144 × 2560 table is 2.7 GB in f32); each row's
    blocks dequantize alone, so the chunks give the values of one pass. A
    codebook type dequantizes from its f32-scale planes, scale·value in f32
    rounded once to `dtype`: the JAX package's dequant of such a table (a
    type its device repack does not take) is its f32 codec, whose values
    those planes hold bit for bit; the other types from the bf16-scale
    planes of `repack`, as the JAX package's device load does."""
    if not TYPE_TRAITS[info.ggml_type].is_quantized:
        return torch.from_numpy(_dense_array(info)).to(device=device, dtype=dtype)
    n_out, n_in = info.shape[1], info.shape[0]
    rows = info.data.reshape(n_out, -1)  # the packed blocks of one token a row
    out = torch.empty((n_out, n_in), dtype=dtype, device=device)
    for r0 in range(0, n_out, EMBEDDING_CHUNK_ROWS):
        n = min(EMBEDDING_CHUNK_ROWS, n_out - r0)
        if info.ggml_type in qmatmul.CODEBOOK_TYPES:
            blocks = qmatmul.upload_blocks(rows[r0:r0 + n], device)
            planes = qmatmul.repack_planes(blocks, info.ggml_type, n, n_in)
        else:
            planes = qmatmul.repack(rows[r0:r0 + n], info.ggml_type, n, n_in, device)
        out[r0:r0 + n] = qmatmul.dequant_planes(planes, info.ggml_type, n, n_in, dtype=dtype).T
    return out


def load_expert_stack(info: GGUFTensorInfo, device, dtype=torch.bfloat16,
                      mode: str = "auto"):
    """A stacked expert tensor (ggml ne (n_in, n_out, E)) → QuantExpertStack
    for the ported quant types at a shape the qmm_stack and qmm_gather
    kernels take (`qmm.takes`), else (and in mode "dense") a dense
    [E, n_in, n_out] tensor, each expert as `dense_weight` makes it: the
    JAX package's rule (`_expert_stack_packable`), so that a stack no
    kernel takes is dequantized once at load and not on every call
    (DeepSeek-V2-Lite's down experts, K = 1408). The packed bytes go up and
    are repacked one expert at a time into planes allocated once for the
    whole stack, so the transient memory is one expert's repack, not the
    stack's."""
    from ..ops.kernels import qmm

    n_in, n_out, E = info.shape
    if not TYPE_TRAITS[info.ggml_type].is_quantized:
        w = _dense_array(info).transpose(0, 2, 1)  # (E, n_out, n_in) → (E, n_in, n_out)
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=device, dtype=dtype)
    if not qmatmul.supports(info.ggml_type):
        raise NotImplementedError(f"{info.name}: {info.ggml_type.name} is not ported")
    data = info.data.reshape(E, -1)
    if mode == "dense" or not qmm.takes(n_in, n_out):
        w = torch.empty((E, n_in, n_out), dtype=dtype, device=device)
        for e in range(E):
            planes = qmatmul.repack_planes(qmatmul.upload_blocks(data[e], device),
                                           info.ggml_type, n_out, n_in)
            w[e].copy_(qmatmul.dequant_planes(planes, info.ggml_type, n_out, n_in))
        return w
    planes: dict[str, torch.Tensor] = {}
    for e in range(E):
        one = qmatmul.repack(data[e], info.ggml_type, n_out, n_in, device)
        if not planes:
            planes = {k: torch.empty((E, *v.shape), dtype=v.dtype, device=v.device)
                      for k, v in one.items()}
        for k, v in one.items():
            planes[k][e].copy_(v)
    return QuantExpertStack(info.ggml_type, E, n_out, n_in, planes)


def load_vector(info: GGUFTensorInfo, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(_dense_array(info)).to(device=device, dtype=dtype)
