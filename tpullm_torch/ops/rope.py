"""Rotary position embeddings with linear/YaRN scaling.

Math follows ggml_rope_ext: "norm" style rotates adjacent element pairs (the
interleaved layout llama-family GGUF weights are permuted for), "neox"
rotates the two halves; the YaRN ramp and mscale follow ggml's rope_yarn.
Angles are computed in f32. M-RoPE is not ported.
"""

from __future__ import annotations

import functools
import math

import torch

from ..models.hparams import RopeParams


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


@functools.lru_cache(maxsize=None)
def inv_freq(dims: int, freq_base: float, device: torch.device) -> torch.Tensor:
    """base^(-2i/dims) for i < dims/2, f32, made once per device (a captured
    decode step copies nothing from the host)."""
    expo = -torch.arange(0, dims // 2, dtype=torch.float32, device=device) * 2.0 / dims
    return torch.pow(torch.tensor(freq_base, dtype=torch.float32, device=device), expo)


def rope_angles(rp: RopeParams, positions: torch.Tensor,
                mscale_on: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions [...] → ([..., dims/2], [..., dims/2]) f32."""
    dev = positions.device
    freq_scale = 1.0 / rp.scale_factor if rp.scaling_type in ("linear", "yarn") else 1.0
    theta_extrap = positions[..., None].float() * inv_freq(rp.dims, rp.freq_base, dev)
    theta = theta_extrap * freq_scale
    mscale = rp.attn_factor if mscale_on else 1.0

    if rp.scaling_type == "yarn" and rp.ext_factor != 0.0:
        n_ctx_orig = rp.orig_ctx or 1
        low = max(0.0, math.floor(_yarn_corr_dim(rp.dims, n_ctx_orig, rp.beta_fast, rp.freq_base)))
        high = min(rp.dims - 1.0, math.ceil(_yarn_corr_dim(rp.dims, n_ctx_orig, rp.beta_slow, rp.freq_base)))
        i0 = torch.arange(0, rp.dims, 2, dtype=torch.float32, device=dev)
        ramp = 1.0 - torch.clamp((i0 / 2.0 - low) / max(0.001, high - low), 0.0, 1.0)
        ramp_mix = ramp * rp.ext_factor
        theta = theta * (1.0 - ramp_mix) + theta_extrap * ramp_mix
        if mscale_on:
            mscale *= 1.0 + 0.1 * math.log(1.0 / freq_scale)

    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope_angles(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      style: str) -> torch.Tensor:
    """x [B, T, H, D] with cos/sin [B, T, n_rot/2] → rotated first n_rot dims."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    n_rot = cos.shape[-1] * 2
    rot = x[..., :n_rot].float()
    if style == "norm":
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(rot.shape)
    elif style == "neox":
        half = n_rot // 2
        x0, x1 = rot[..., :half], rot[..., half:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style}")
    out = out.to(x.dtype)
    if x.shape[-1] > n_rot:
        out = torch.cat([out, x[..., n_rot:]], dim=-1)
    return out


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rp: RopeParams) -> torch.Tensor:
    """x: [B, T, H, D], positions: [B, T] → same shape, first rp.dims rotated."""
    cos, sin = rope_angles(rp, positions)
    return apply_rope_angles(x, cos, sin, rp.style)
