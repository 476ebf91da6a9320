"""Normalization ops (f32 accumulation, matching ggml norm semantics)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: x * w / rms(x), computed in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """LayerNorm: (x − mean) / std(x) · w (+ b), in f32, cast back to x's
    dtype (Phi-2's norms; ggml NORM + MUL + ADD)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
