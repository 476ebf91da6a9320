"""KV cache: preallocated per-layer K/V tensors written in place.

Head-major layout [n_layer, B, Hkv, S, D], so a layer's [B, Hkv, S, D] view
is contiguous and the flash kernel reads (S, D) rows directly. Writes update
the preallocated tensors in place (the JAX package returns new arrays and
relies on buffer donation instead). `QuantKVCache` stores int8 codes with one
f32 scale per (layer, batch, head, position) vector.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.hparams import HParams


def _seq_write(cache_arr: torch.Tensor, new_arr: torch.Tensor, off,
               seq_axis: int, layer: int | None = None) -> None:
    """Write `new_arr` (T wide on seq_axis) at sequence position `off` of
    `cache_arr` (S wide), in place; off < 0 skips the write.

    `off` is a host int, or for T = 1 a device int tensor of one element
    (the captured decode step, whose offset lives on the device): then the
    row goes in with index_copy_ and nothing is read back to the host (the
    JAX package's dynamic_update_slice at a traced offset); the caller
    keeps 0 <= off < S.

    With `layer` given, `cache_arr` is the full [L, ...] cache, `new_arr`
    has the per-layer shape and `seq_axis` is relative to it.

    A prefill bucket may overshoot the context end (off + T > S though every
    real token fits). The JAX package then clamps the window left to
    start = S − T, rolls the payload right by off − start and keeps the
    existing cache content in the wrapped-in columns; the net effect, kept
    here, is that slots [off, start + T) take new_arr[:start + T − off] and
    nothing else changes."""
    dst = cache_arr if layer is None else cache_arr[layer]
    S = dst.shape[seq_axis]
    T = new_arr.shape[seq_axis]
    if isinstance(off, torch.Tensor):
        if T != 1 or off.numel() != 1:
            raise ValueError(f"a write at a device offset takes one row, got T={T}")
        dst.index_copy_(seq_axis, off.reshape(1).long(), new_arr)
        return
    if off < 0:
        return
    start = min(off, max(S - T, 0))
    n = start + T - off
    if n <= 0:
        return
    dst.narrow(seq_axis, off, n).copy_(new_arr.narrow(seq_axis, 0, n))


@dataclass
class KVCache:
    k: torch.Tensor  # [n_layer, B, Hkv, S, Dk]
    v: torch.Tensor  # [n_layer, B, Hkv, S, Dv]

    @classmethod
    def new(cls, hp: HParams, batch: int, max_len: int, dtype=torch.bfloat16,
            device=None) -> "KVCache":
        shape_k = (hp.n_layer, batch, hp.n_head_kv, max_len, hp.head_dim)
        shape_v = (hp.n_layer, batch, hp.n_head_kv, max_len, hp.head_dim_v)
        return cls(torch.zeros(shape_k, dtype=dtype, device=device),
                   torch.zeros(shape_v, dtype=dtype, device=device))

    def kv(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Attention-ready (k, v) views for a layer: [B, Hkv, S, D]."""
        return self.k[layer], self.v[layer]

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "KVCache":
        """Write k/v [B, Hkv, T, D] at sequence position `offset` of `layer`
        (a host int, or a device tensor at T = 1: `_seq_write`)."""
        _seq_write(self.k, k_new, offset, seq_axis=2, layer=layer)
        _seq_write(self.v, v_new, offset, seq_axis=2, layer=layer)
        return self


@dataclass
class QuantKVCache:
    """Q8 KV storage: int8 codes with one f32 scale per vector (per row
    rather than ggml's per-32-block scale, which keeps a clean [..., S, D]
    int8 plane for the kernel)."""

    k_q: torch.Tensor  # [L, B, Hkv, S, Dk] int8
    v_q: torch.Tensor  # [L, B, Hkv, S, Dv] int8
    k_s: torch.Tensor  # [L, B, Hkv, S] f32
    v_s: torch.Tensor  # [L, B, Hkv, S] f32

    @classmethod
    def new(cls, hp: HParams, batch: int, max_len: int, device=None) -> "QuantKVCache":
        sk = (hp.n_layer, batch, hp.n_head_kv, max_len, hp.head_dim)
        sv = (hp.n_layer, batch, hp.n_head_kv, max_len, hp.head_dim_v)
        ss = (hp.n_layer, batch, hp.n_head_kv, max_len)
        return cls(torch.zeros(sk, dtype=torch.int8, device=device),
                   torch.zeros(sv, dtype=torch.int8, device=device),
                   torch.zeros(ss, dtype=torch.float32, device=device),
                   torch.zeros(ss, dtype=torch.float32, device=device))

    @staticmethod
    def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[..., D] → (int8 codes, f32 scale[...]): amax/127, round half to
        even, clip to ±127."""
        xf = x.float()
        scale = xf.abs().amax(dim=-1) / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        inv = torch.where(scale > 0, 1.0 / safe, torch.zeros_like(scale))
        q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
        return q, scale

    def kv_packed(self, layer: int):
        """(k_q, k_s, v_q, v_s) views of a layer for the q8 flash kernel."""
        return self.k_q[layer], self.k_s[layer], self.v_q[layer], self.v_s[layer]

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "QuantKVCache":
        k_q, k_s = self._quantize(k_new)  # [B, Hkv, T, D], [B, Hkv, T]
        v_q, v_s = self._quantize(v_new)
        _seq_write(self.k_q, k_q, offset, seq_axis=2, layer=layer)
        _seq_write(self.v_q, v_q, offset, seq_axis=2, layer=layer)
        _seq_write(self.k_s, k_s, offset, seq_axis=2, layer=layer)
        _seq_write(self.v_s, v_s, offset, seq_axis=2, layer=layer)
        return self


def make_cache(hp: HParams, batch: int, max_len: int, kv_dtype, device=None):
    """kv_dtype: a torch dtype for dense storage, or the string 'q8_0'."""
    if isinstance(kv_dtype, str):
        if kv_dtype in ("q8_0", "q8"):
            return QuantKVCache.new(hp, batch, max_len, device=device)
        kv_dtype = {"f16": torch.float16, "bf16": torch.bfloat16,
                    "f32": torch.float32}[kv_dtype]
    return KVCache.new(hp, batch, max_len, kv_dtype, device=device)
