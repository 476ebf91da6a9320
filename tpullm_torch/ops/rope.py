"""Rotary position embeddings with linear/YaRN scaling.

Math follows ggml_rope_ext: "norm" style rotates adjacent element pairs (the
interleaved layout llama-family GGUF weights are permuted for), "neox"
rotates the two halves; the YaRN ramp and mscale follow ggml's rope_yarn.
Angles are computed in f32.

M-RoPE (qwen2vl, qwen3vl, qwen3vlmoe; the JAX package's ops/rope.py
apply_rope): where rp.sections is set and positions are [S, B, T], one
stream per section role (t, h, w, extra), each frequency dim takes its
angle from the stream its section covers: contiguous sections (qwen2vl), or
interleaved [T H W T H W … T] (IMROPE, rp.mrope_interleaved). With all
streams equal it is NEOX RoPE exactly.
"""

from __future__ import annotations

import dataclasses
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


@functools.lru_cache(maxsize=None)
def mrope_streams(sections: tuple, interleaved: bool, half: int, n_streams: int,
                  device: torch.device) -> torch.Tensor:
    """The stream index [half] int64 of each frequency dim under M-RoPE,
    made once on the host per RopeParams and device (a captured graph reads
    no host value): IMROPE gives dims 1, 4, 7, … below 3·sections[1] to
    stream 1 and 2, 5, 8, … below 3·sections[2] to stream 2; contiguous
    sections cover the dims in order, cycling over their total; an index
    past the streams given takes the last."""
    if interleaved:
        stream = [0] * half
        for d in (1, 2):
            for i in range(d, min(sections[d] * 3, half), 3):
                stream[i] = d
    else:
        total = max(1, sum(sections))
        bounds = [sum(sections[:i + 1]) for i in range(len(sections))]
        stream = [sum(j % total >= b for b in bounds) for j in range(half)]
    return torch.tensor([min(s, n_streams - 1) for s in stream], dtype=torch.int64,
                        device=device)


def rope_angles(rp: RopeParams, positions: torch.Tensor,
                mscale_on: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions [...] → ([..., dims/2], [..., dims/2]) f32;
    under M-RoPE (rp.sections, positions [S, B, T]) → [B, T, dims/2], each
    dim's angle from its stream (`mrope_streams`)."""
    if rp.sections and positions.ndim == 3:
        cos, sin = rope_angles(dataclasses.replace(rp, sections=()), positions, mscale_on)
        idx = mrope_streams(rp.sections, rp.mrope_interleaved, rp.dims // 2,
                            positions.shape[0], positions.device)
        pick = idx.reshape(1, 1, 1, -1).expand(1, *cos.shape[1:])
        return cos.gather(0, pick)[0], sin.gather(0, pick)[0]
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


def rotate_cached_keys(k: torch.Tensor, delta: torch.Tensor, rp: RopeParams) -> torch.Tensor:
    """Cached, already rotated keys k [..., S, D] turned by a further delta
    [S] positions (the JAX package's ops/rope.py rotate_cached_keys, for a
    context shift): R(pos + delta) = R(delta)·R(pos) for every scaling the
    port has, and the magnitude scale is already in the keys, so it is not
    applied again. f32 math; the result in k's dtype."""
    cos, sin = rope_angles(rp, delta, mscale_on=False)  # [S, n_rot/2]
    n_rot = cos.shape[-1] * 2
    rot = k[..., :n_rot].float()
    if rp.style == "norm":
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(rot.shape)
    elif rp.style == "neox":
        half = n_rot // 2
        x0, x1 = rot[..., :half], rot[..., half:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        raise ValueError(f"unknown rope style {rp.style}")
    out = out.to(k.dtype)
    if k.shape[-1] > n_rot:
        out = torch.cat([out, k[..., n_rot:]], dim=-1)
    return out
