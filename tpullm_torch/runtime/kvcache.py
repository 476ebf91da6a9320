"""KV cache: preallocated per-layer K/V tensors written in place.

Head-major layout [n_layer, B, Hkv, S, D], so a layer's [B, Hkv, S, D] view
is contiguous and the flash kernel reads (S, D) rows directly. Writes update
the preallocated tensors in place (the JAX package returns new arrays and
relies on buffer donation instead). `QuantKVCache` stores int8 codes with one
f32 scale per (layer, batch, head, position) vector.

An offset is a host int or a 0-d device tensor (every batch row writes at
that position: the single-stream Engine), or an int32 [B] device tensor of
per-slot positions (continuous batching, runtime/batch_engine.py), where a
negative entry leaves that slot's rows as they are (the JAX package's rule:
`offset.ndim == 0` is the scalar path); a forward turns per-slot offsets
into `SlotRows` once for all its layers.

`SWACache` is the iSWA dual store (the JAX package's SWACache): the
full-attention layers keep [n_full, B, Hkv, S, D], the sliding-window
layers a ring of R slots whose absolute positions `slot_pos` records.

`MLACache` is the absorbed-MLA latent of DeepSeek-V2/V3 (the JAX package's
MLACache): one plane [n_layer, B, 1, S, kv_lora_rank + n_rot] whose rows
are the keys of an MQA attention and whose first kv_lora_rank features are
its values, written in place as `KVCache` writes.
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
        dst.index_copy_(seq_axis, off.reshape(1).long(), new_arr.to(dst.dtype))
        return
    if off < 0:
        return
    start = min(off, max(S - T, 0))
    n = start + T - off
    if n <= 0:
        return
    dst.narrow(seq_axis, off, n).copy_(new_arr.narrow(seq_axis, 0, n))


@dataclass(frozen=True)
class SlotRows:
    """Where a per-slot write of T rows per slot goes, computed once a
    forward (`slot_rows`) and shared by every layer's K, V (and q8 scale)
    writes: row t of slot b goes to position idx[b, t] where keep[b, t]."""

    idx: torch.Tensor  # [B, T] int64
    keep: torch.Tensor  # [B, T] bool


def slot_rows(offsets: torch.Tensor, T: int, S: int) -> SlotRows:
    """The rows of a per-slot write of T rows into an S-position cache: row
    t of slot b at offsets[b] + t where offsets[b] >= 0 and the position is
    below S (each slot clamped at the context end as `_seq_write` clamps
    one). A masked entry points at its slot's row offsets[b] − 1 (0 for an
    idle slot), which no kept entry of that slot writes."""
    off = offsets.to(torch.int64).reshape(-1, 1)
    pos = off + torch.arange(T, device=offsets.device)[None]  # [B, T]
    keep = (off >= 0) & (pos < S)
    return SlotRows(torch.where(keep, pos, (off - 1).clamp(min=0)), keep)


def _slot_write(cache_arr: torch.Tensor, new_arr: torch.Tensor, rows: SlotRows,
                seq_axis: int, layer: int) -> None:
    """Per-slot write of `new_arr` [B, ..., T, ...] into layer `layer` of
    the full cache `cache_arr` [L, B, ..., S, ...], in place, at `rows`;
    everything else keeps what was there.

    Nothing is read back to the host (a captured decode step runs it): the
    rows at the write's positions are gathered, blended with the new rows
    under the mask and scattered back, so a masked entry writes back its
    row's own value (the scatter's duplicate indices all carry one value)."""
    dst = cache_arr[layer]
    shape = [dst.shape[0]] + [1] * (dst.ndim - 1)
    shape[seq_axis] = new_arr.shape[seq_axis]
    idx = rows.idx.reshape(shape).expand(new_arr.shape)
    old = dst.gather(seq_axis, idx)
    dst.scatter_(seq_axis, idx,
                 torch.where(rows.keep.reshape(shape), new_arr.to(dst.dtype), old))


def _write(cache_arr: torch.Tensor, new_arr: torch.Tensor, offset, seq_axis: int,
           layer: int) -> None:
    """A scalar offset through `_seq_write`; per-slot offsets (SlotRows, or
    an int32 [B] tensor) through `_slot_write`."""
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        offset = slot_rows(offset, new_arr.shape[seq_axis], cache_arr.shape[seq_axis + 1])
    if isinstance(offset, SlotRows):
        _slot_write(cache_arr, new_arr, offset, seq_axis, layer)
    else:
        _seq_write(cache_arr, new_arr, offset, seq_axis, layer=layer)


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

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def first_slots(self, n: int) -> "KVCache":
        """A view of batch rows [0, n): its writes land in this cache (each
        layer's rows stay contiguous)."""
        return KVCache(self.k[:, :n], self.v[:, :n])

    def kv(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Attention-ready (k, v) views for a layer: [B, Hkv, S, D]."""
        return self.k[layer], self.v[layer]

    def clear_slots(self, n: int, row: int | None = None) -> None:
        """Slots [0, n) of every layer zeroed, as a new cache holds them (in
        place), in batch row `row` (None: every row)."""
        rows = slice(None) if row is None else slice(row, row + 1)
        for arr in (self.k, self.v):
            arr[:, rows, :, :n].zero_()

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "KVCache":
        """Write k/v [B, Hkv, T, D] at sequence position `offset` of `layer`
        (a host int or 0-d device tensor, the latter at T = 1: `_seq_write`;
        per-slot int32 [B] offsets or their SlotRows: `_slot_write`)."""
        _write(self.k, k_new, offset, 2, layer)
        _write(self.v, v_new, offset, 2, layer)
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

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    def first_slots(self, n: int) -> "QuantKVCache":
        """A view of batch rows [0, n), as KVCache.first_slots."""
        return QuantKVCache(self.k_q[:, :n], self.v_q[:, :n], self.k_s[:, :n], self.v_s[:, :n])

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

    def clear_slots(self, n: int, row: int | None = None) -> None:
        """Slots [0, n) of every layer zeroed (codes and scales), as a new
        cache holds them (in place), in batch row `row` (None: every row)."""
        rows = slice(None) if row is None else slice(row, row + 1)
        for arr in (self.k_q, self.v_q, self.k_s, self.v_s):
            arr[:, rows, :, :n].zero_()

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "QuantKVCache":
        k_q, k_s = self._quantize(k_new)  # [B, Hkv, T, D], [B, Hkv, T]
        v_q, v_s = self._quantize(v_new)
        for arr, new in ((self.k_q, k_q), (self.v_q, v_q), (self.k_s, k_s), (self.v_s, v_s)):
            _write(arr, new, offset, 2, layer)
        return self


@dataclass
class MLACache:
    """The absorbed-MLA latent cache (the JAX package's MLACache, ≡ the
    reference's is_mla cache: llama-kv-cache.cpp caches the kv_lora_rank +
    n_rot latent and llm_build_deepseek2 runs MQA at DKQ = kv_lora_rank +
    n_rot, DV = kv_lora_rank).

    One plane a layer: c[..., :kvr] is the compressed KV latent, shared by
    the no-RoPE scores and the values (V is a view of K, not a copy),
    c[..., kvr:] the shared RoPE key. A position holds kvr + n_rot values
    in place of n_head · (Dk + Dv): 576 against 16 · (192 + 128) = 5120 for
    DeepSeek-V2-Lite. Written in place at the offsets KVCache takes (a host
    int, a 0-d device tensor at T = 1, per-slot int32 [B] or SlotRows), so
    the decode graphs and the batched step hold it."""

    c: torch.Tensor  # [n_layer, B, 1, S, kvr + n_rot]
    kvr: int  # the latent's width: the values are c[..., :kvr]

    @classmethod
    def new(cls, n_layer: int, batch: int, max_len: int, kvr: int, n_rot: int,
            dtype=torch.bfloat16, device=None) -> "MLACache":
        return cls(torch.zeros((n_layer, batch, 1, max_len, kvr + n_rot), dtype=dtype,
                               device=device), kvr)

    @property
    def max_len(self) -> int:
        return self.c.shape[3]

    @property
    def batch(self) -> int:
        return self.c.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    def first_slots(self, n: int) -> "MLACache":
        """A view of batch rows [0, n): its writes land in this cache."""
        return MLACache(self.c[:, :n], self.kvr)

    def kv(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v): k [B, 1, S, kvr + n_rot] and v = k[..., :kvr], a view."""
        k = self.c[layer]
        return k, k[..., :self.kvr]

    def update(self, layer: int, k_new: torch.Tensor, v_new=None, offset=0) -> "MLACache":
        """Write the latent rows k_new [B, 1, T, kvr + n_rot] of `layer` at
        `offset` (the forms KVCache.update takes); v_new is unused."""
        _write(self.c, k_new, offset, 2, layer)
        return self


def describe(cache) -> str:
    """A cache's kind, dtype and bytes a cached position (every layer and
    store, one batch row; a ring's slots counted as positions), for
    Engine.report; a recurrent state (runtime/recurrent.py RecurrentCache,
    models/jamba.py HybridCache) its bytes a sequence beside its K/V's."""
    if hasattr(cache, "state_bytes"):
        kv = [a for a in (getattr(cache, "k", None), getattr(cache, "v", None)) if a is not None]
        per = sum(a[:, :1, :, :1].nbytes for a in kv)
        dtype = str((kv[0] if kv else cache.ssm).dtype).removeprefix("torch.")
        pos = f"{per} B a position, " if kv else ""
        return (f"{type(cache).__name__} {dtype} ({pos}{cache.state_bytes()} B of f32 state "
                "a sequence)")
    arrs = [v for v in vars(cache).values() if isinstance(v, torch.Tensor) and v.dim() >= 4]
    per = sum(a.numel() // (a.shape[1] * a.shape[3]) * a.element_size() for a in arrs)
    dtype = str(arrs[0].dtype).removeprefix("torch.")
    return f"{type(cache).__name__} {dtype} ({per} B a position)"


def takes_ring(iswa: bool, hp: HParams, kv_dtype, max_len: int) -> bool:
    """Whether a cache gets the iSWA ring (the JAX package's rule): an iSWA
    arch (registry `iswa`) with a window below max_len, on a dense dtype
    (a q8 cache stays full, its windows in the flash kernel)."""
    return (iswa and 0 < hp.sliding_window < max_len
            and not isinstance(kv_dtype, str))


def ring_len(window: int, max_chunk: int, max_len: int) -> int:
    """The ring slots an iSWA cache gives its sliding-window layers: a
    prefill chunk of C tokens needs window − 1 past keys and C new ones,
    rounded up to 128 and at most max_len."""
    r = window - 1 + min(max_chunk, max_len)
    return min(max_len, -(-r // 128) * 128)


@dataclass
class SWACache:
    """Dual KV store for interleaved sliding-window attention (the JAX
    package's runtime/kvcache.py SWACache, ≡ llama_kv_cache_unified_iswa).

    Full-attention layers keep [n_full, B, Hkv, max_len, D]; sliding-window
    layers share a ring of R = `ring_len` slots, where the row at position
    p of a write at offset o lands in slot (o + i) mod R (a write of more
    than R rows keeps its last R). `slot_pos` [B, R] holds the absolute
    position in each slot, −1 while empty, and the SWA mask comes from it:
    a query at p attends slot s iff 0 ≤ pos_s ≤ p and p − pos_s < window.

    Everything is written in place, and a forward's ring rows are computed
    on the device from its offset (a host int, a 0-d device tensor, or
    per-slot int32 [B] with −1 for an idle slot, whose rows and positions
    stay as they are), so a decode step on the ring is captured as a CUDA
    graph like one on a full cache. Dense dtypes only: a q8 cache keeps
    the full QuantKVCache, its windows in the flash kernel.

    Speculative rollback is a rewind of n_past, as on the JAX package's
    ring: a rejected row stays in `slot_pos` at a position above every
    later query (`ring_mask`'s pos_s ≤ p hides it) until the write of that
    position, which lands in the same slot, overwrites it. A forward of T
    rows at offset o overwrites the slots of positions o + i − R; a query
    at o + j needs the window before it, so T may be at most
    `max_rows` = R − window + 1 (≥ the prefill chunk the ring was sized
    for): verification forwards (n_draft + 1 rows) sit far below it, and
    the engines refuse a wider one (runtime/engine.py, batch_engine.py)."""

    full_k: torch.Tensor  # [n_full, B, Hkv, S, Dk]
    full_v: torch.Tensor  # [n_full, B, Hkv, S, Dv]
    swa_k: torch.Tensor  # [n_swa, B, Hkv, R, Dk]
    swa_v: torch.Tensor  # [n_swa, B, Hkv, R, Dv]
    slot_pos: torch.Tensor  # [B, R] int32, −1 empty
    layer_map: tuple  # layer → (is_swa, index among its kind)
    window: int

    @classmethod
    def new(cls, hp: HParams, batch: int, max_len: int, dtype=torch.bfloat16,
            max_chunk: int = 1024, device=None) -> "SWACache":
        layer_map, n_full, n_swa = [], 0, 0
        for li in range(hp.n_layer):
            if hp.is_swa(li):
                layer_map.append((True, n_swa))
                n_swa += 1
            else:
                layer_map.append((False, n_full))
                n_full += 1
        R = ring_len(hp.sliding_window, max_chunk, max_len)

        def zeros(n, s, d):
            return torch.zeros((n, batch, hp.n_head_kv, s, d), dtype=dtype, device=device)

        return cls(zeros(n_full, max_len, hp.head_dim), zeros(n_full, max_len, hp.head_dim_v),
                   zeros(n_swa, R, hp.head_dim), zeros(n_swa, R, hp.head_dim_v),
                   torch.full((batch, R), -1, dtype=torch.int32, device=device),
                   tuple(layer_map), hp.sliding_window)

    @property
    def max_len(self) -> int:
        return self.full_k.shape[3]

    @property
    def ring_len(self) -> int:
        return self.swa_k.shape[3]

    @property
    def batch(self) -> int:
        return self.full_k.shape[1]

    @property
    def max_rows(self) -> int:
        """The most rows one forward may write without overwriting a slot
        that one of its own queries still sees (a ring as long as the
        context never wraps inside it)."""
        return self.max_len if self.ring_len >= self.max_len else self.ring_len - self.window + 1

    def first_slots(self, n: int) -> "SWACache":
        """A view of batch rows [0, n): its writes land in this cache."""
        return SWACache(self.full_k[:, :n], self.full_v[:, :n], self.swa_k[:, :n],
                        self.swa_v[:, :n], self.slot_pos[:n], self.layer_map, self.window)

    def advance(self, positions: torch.Tensor, offset) -> SlotRows:
        """Record this forward's positions [B, T] in `slot_pos`, in place
        (once a forward, before its layers, so that the SWA mask covers the
        rows being written), and return the ring rows every SWA layer's
        write takes. `offset` is a host int, a 0-d device tensor or
        per-slot int32 [B] (−1 idle: nothing kept); the rows are computed on
        the device: rows [T − T', T), T' = min(T, R), go to slots
        (o + T − T' + i) mod R."""
        B, R, T = self.batch, self.ring_len, positions.shape[1]
        dev = self.slot_pos.device
        if isinstance(offset, torch.Tensor):
            off = offset.to(torch.int64).reshape(-1).expand(B)
        else:
            off = torch.full((B,), int(offset), dtype=torch.int64, device=dev)
        t = min(T, R)
        idx = (off.clamp(min=0)[:, None] + (T - t) + torch.arange(t, device=dev)[None]) % R
        rows = SlotRows(idx, (off >= 0)[:, None].expand(B, t))
        old = self.slot_pos.gather(1, idx)
        self.slot_pos.scatter_(1, idx, torch.where(rows.keep, positions[:, T - t:].to(torch.int32),
                                                   old))
        return rows

    def ring_mask(self, positions: torch.Tensor) -> torch.Tensor:
        """[B, T, R] SWA mask from the slot positions (after `advance`)."""
        sp = self.slot_pos[:, None, :]
        qp = positions[:, :, None]
        return (sp >= 0) & (sp <= qp) & (sp > qp - self.window)

    def kv(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        swa, loc = self.layer_map[layer]
        if swa:
            return self.swa_k[loc], self.swa_v[loc]
        return self.full_k[loc], self.full_v[loc]

    def update(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "SWACache":
        """Write k/v [B, Hkv, T, D] for `layer`: a full layer as KVCache
        writes (offset: host int, 0-d tensor, per-slot tensor or SlotRows);
        a ring layer at the ring rows `advance` returned (`offset`)."""
        swa, loc = self.layer_map[layer]
        if not swa:
            _write(self.full_k, k_new, offset, 2, loc)
            _write(self.full_v, v_new, offset, 2, loc)
            return self
        t = offset.idx.shape[1]
        for arr, new in ((self.swa_k, k_new), (self.swa_v, v_new)):
            _slot_write(arr, new[:, :, new.shape[2] - t:], offset, 2, loc)
        return self

    def reset_slots(self, slot: int | None = None) -> None:
        """Mark every ring slot empty (of one batch row, or of all), in place:
        a new sequence attends no stale entry."""
        (self.slot_pos if slot is None else self.slot_pos[slot]).fill_(-1)


def make_cache(hp: HParams, batch: int, max_len: int, kv_dtype, device=None):
    """kv_dtype: a torch dtype for dense storage, or the string 'q8_0'."""
    if isinstance(kv_dtype, str):
        if kv_dtype in ("q8_0", "q8"):
            return QuantKVCache.new(hp, batch, max_len, device=device)
        kv_dtype = {"f16": torch.float16, "bf16": torch.bfloat16,
                    "f32": torch.float32}[kv_dtype]
    return KVCache.new(hp, batch, max_len, kv_dtype, device=device)
