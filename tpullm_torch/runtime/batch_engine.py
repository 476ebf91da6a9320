"""Multi-slot batched engine: the compute substrate of continuous batching
on one card (the JAX package's runtime/batch_engine.py).

N slots share one KV cache ([L, n_slots, Hkv, S, D]); a scheduler iteration
runs one joint prefill round (one chunk of each prefilling slot's prompt in
one forward, the head on each slot's last row only) and one batched decode
step for every generating slot. Idle rows carry offset −1: their cache
rows are left as they are (runtime/kvcache.py `_slot_write`) and their
outputs are ignored.

The decode step runs on static device buffers (runtime/graph.py
`BatchRunner`): on the card one forward over the first `width` slots (the
highest generating slot's index + 1; the scheduler fills the lowest free
slot first) captured as a CUDA graph per width and replayed a step; it
writes both the logits [width, V] (read back by `decode_batch`) and their
argmax ids [width] (read back by `decode_batch_greedy`). Speculative
verification (`verify_step`, `verify_batch`, `verify_batch_greedy`) is the
same runner at a fixed number of rows a slot (the scheduler's n_draft + 1):
one graph per (width, rows), each slot's pending token and drafts padded
to the rows; it does not advance n_past, and the rows past the committed
prefix stay invisible (causal by position) until they are overwritten.
The cache is written in place by every path here (prefill rounds, the
decode and verify steps, `shift_slot`, slot state files), so the graphs
stay valid for the engine's life; `drop_graphs` releases them.

An iSWA model (gemma2, gemma3) gets the ring cache (runtime/kvcache.py
SWACache) with one ring a slot, sized for `prefill_chunk`, as the JAX
package's BatchEngine gives it; a freed slot's ring is marked empty. The
verify step runs on it as on a full cache: each slot's ring rows come from
its offset on the device (an idle slot's −1 writes none), and a rejected
draft's rows stay invisible until their positions are written again;
a verify wider than the ring's `max_rows` is refused.

A recurrent arch (the SSMs and the hybrids: registry `recurrent`) gets its
own cache with a state a slot. Its state absorbs every token fed, so its
prompts never run in a joint padded round: `prefill_slots` runs the slots
one after another, each prompt in exact-length chunks (runtime/engine.py
`recurrent_chunks`: pieces of prefill_chunk, each cut by the JAX ladder),
each chunk a forward of the slot's row alone, on a view of its cache rows
(`slot_view`), so that no idle row runs a layer.
An idle slot (offset −1) keeps its conv/ssm rows bit for bit through
every step (the forward selects on the slot axis before each state
write, on the device), `free_slot` zeroes the slot's state, and there is
no verify step and no cache shift (ROADMAP.md §3).

Not ported yet (ROADMAP.md 1.3.7, 1.3.9): mesh serving and the pipeline,
and multimodal prefill (`prefill_slot_embeddings`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.rope import rotate_cached_keys
from .engine import (PREFILL_BUCKETS, SPEC_REFUSED, PerfCounters, pool_hidden,
                     recurrent_chunks)
from .graph import BatchRunner
from .kvcache import KVCache, QuantKVCache, SWACache, make_cache, takes_ring
from .model import Model


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class BatchEngine:
    def __init__(self, model_path, *, device=None, n_slots: int = 4, max_seq: int = 2048,
                 mode: str = "auto", dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                 prefill_chunk: int = 512, mesh=None):
        """`device=None` means CUDA (raises when there is none); the tests
        pass device="cpu". `mode`, `dtype` and `kv_dtype` as Engine's;
        `prefill_chunk` caps the prompt tokens of one slot a round.
        `model_path` may be a loaded `runtime/model.py` Model, whose weights
        the engine then shares."""
        if mesh is not None:
            raise _not_ported("mesh serving (tensor, data and pipeline parallel)", "1.3.9")
        t0 = time.perf_counter()
        self.model = Model.of(model_path, device, mode, dtype)
        self.device = self.model.device
        self.reader, self.hp, self.arch = self.model.reader, self.model.hp, self.model.arch
        self.tokenizer, self.params = self.model.tokenizer, self.model.fused()
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.prefill_chunk = min(prefill_chunk, max_seq)
        self.kv_dtype = kv_dtype
        if takes_ring(self.arch.iswa, self.hp, kv_dtype, max_seq):
            self.cache = SWACache.new(self.hp, n_slots, max_seq, kv_dtype,
                                      max_chunk=self.prefill_chunk, device=self.device)
        else:
            make = self.arch.make_cache or make_cache
            self.cache = make(self.hp, n_slots, max_seq, kv_dtype, self.device)
        self.n_past = np.zeros(n_slots, dtype=np.int32)
        # per-slot RoPE position offset against the cache slot count (the
        # JAX package's M-RoPE image grids; 0 here until mtmd is ported)
        self.rope_delta = np.zeros(n_slots, dtype=np.int32)
        self._runners: dict[int, BatchRunner] = {}  # width → decode runner
        self._verify_runners: dict[tuple[int, int], BatchRunner] = {}  # (width, rows) → runner
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.perf = PerfCounters(t_load_s=time.perf_counter() - t0)

    # -- graphs ------------------------------------------------------------------

    def runner(self, width: int, rows: int = 1) -> BatchRunner:
        """The engine's batched step over its first `width` slots, `rows`
        tokens a slot (1: the decode step; more: the verify step), its CUDA
        graph captured at its first run, on the calling thread."""
        runners = self._runners if rows == 1 else self._verify_runners
        key = width if rows == 1 else (width, rows)
        r = runners.get(key)
        if r is None:
            r = runners[key] = BatchRunner(self, width, rows)
        return r

    def precompile(self, widths: tuple = ()):
        """Captures every decode graph (one a width) and, for each verify
        row count in `widths` (the scheduler's n_draft + 1), its verify
        graph of every width, ahead of the first request (the JAX package
        compiles its programs here): one step with every slot idle, which
        writes no cache row. Call it on the thread that will decode."""
        with torch.inference_mode():
            for rows in (1, *widths):
                for width in range(1, self.n_slots + 1):
                    idle = torch.zeros(2 * rows + 1, width, dtype=torch.int32)
                    idle[2 * rows] = -1
                    self.runner(width, rows).run(idle)

    def drop_graphs(self):
        """Releases the decode and verify graphs (and their memory pools);
        the next step captures anew."""
        self._runners.clear()
        self._verify_runners.clear()

    # -- slot lifecycle ----------------------------------------------------------

    def free_slot(self, slot: int):
        """The slot's state dropped: n_past 0, on the ring its slot
        positions marked empty (in place), so that the next request in it
        attends nothing of the last one's window; a recurrent state zeroed
        (in place)."""
        self.n_past[slot] = 0
        self.rope_delta[slot] = 0
        if isinstance(self.cache, SWACache) or self.arch.recurrent:
            self.cache.reset_slots(slot)

    def ring_holds(self, slot: int, n: int) -> bool:
        """Whether a query at position `n` of the slot finds its window in
        the cache: on the ring, every position of [n − window + 1, n) still
        in a ring slot (a longer sequence since has overwritten them); a
        full cache holds them all. Prompt-cache reuse asks it (the
        reference server likewise re-processes the prompt of an SWA model
        whose window left its cache)."""
        if not isinstance(self.cache, SWACache) or n <= 0:
            return True
        need = np.arange(max(0, n - self.hp.sliding_window + 1), n)
        return bool(np.isin(need, self.cache.slot_pos[slot].cpu().numpy()).all())

    def _bucket(self, n: int) -> int:
        for b in PREFILL_BUCKETS:
            if n <= b:
                return min(b, self.max_seq)
        raise ValueError(n)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def prefill_slot(self, slot: int, tokens: list[int]) -> np.ndarray:
        """Feed `tokens` into one slot (chunked to prefill_chunk; a
        recurrent arch's chunks cut by the ladder, each at its exact
        length); returns the last token's logits [n_vocab]."""
        logits_last = None
        if self.arch.recurrent:
            sizes = recurrent_chunks(len(tokens), self.prefill_chunk)
        else:
            sizes = [min(self.prefill_chunk, len(tokens) - i)
                     for i in range(0, len(tokens), self.prefill_chunk)]
        idx = 0
        for c in sizes:
            logits_last = self.prefill_slots_round({slot: tokens[idx: idx + c]})[slot]
            idx += c
        return logits_last

    def prefill_slots(self, tokens: dict[int, list[int]]) -> dict[int, np.ndarray]:
        """Feed several slots' prompts in joint rounds: each round one chunk
        per slot, per-row offsets, the head on each row's last token.
        Returns {slot: last-token logits}. A recurrent arch's slots run one
        after another (`prefill_slot`)."""
        if len(tokens) == 1 or self.arch.recurrent:
            return {s: self.prefill_slot(s, toks) for s, toks in tokens.items()}
        remaining = {s: list(toks) for s, toks in tokens.items()}
        for s, toks in remaining.items():
            if int(self.n_past[s]) + len(toks) > self.max_seq:
                raise ValueError(f"slot {s} context overflow: {self.n_past[s]}+{len(toks)}")
        out: dict[int, np.ndarray] = {}
        while remaining:
            chunk = {s: toks[: self.prefill_chunk] for s, toks in remaining.items()}
            rows = self.prefill_slots_round(chunk)
            for s, c in chunk.items():
                rest = remaining[s][len(c):]
                if rest:
                    remaining[s] = rest
                else:
                    out[s] = rows[s]
                    del remaining[s]
        return out

    @torch.inference_mode()
    def prefill_slots_round(self, chunk: dict[int, list[int]]) -> dict[int, np.ndarray]:
        """One joint prefill round: at most prefill_chunk tokens of each
        slot in `chunk` through one forward of n_slots × bucket rows (the
        other slots idle at offset −1); each fed slot's last-row logits. A
        recurrent arch runs each slot's chunk as a forward of its own row
        at its exact length (`_slot_forward`)."""
        t0 = time.perf_counter()
        if self.arch.recurrent:  # each slot a forward of its own row, at its exact length
            rows = {s: self._slot_forward(s, c, last_index=len(c) - 1)[0, 0].cpu().numpy()
                    for s, c in chunk.items()}
            for s, c in chunk.items():
                self.n_past[s] += len(c)
                self.perf.n_prefill += len(c)
            self.perf.t_prefill_s += time.perf_counter() - t0
            return rows
        bucket = self._bucket(max(len(c) for c in chunk.values()))
        toks = np.zeros((self.n_slots, bucket), dtype=np.int64)
        pos = np.zeros((self.n_slots, bucket), dtype=np.int32)
        offsets = np.full(self.n_slots, -1, dtype=np.int32)
        n_last = np.zeros(self.n_slots, dtype=np.int64)
        for s, c in chunk.items():
            start = int(self.n_past[s])
            if start + len(c) > self.max_seq:
                raise ValueError(f"slot {s} context overflow: {start}+{len(c)}")
            toks[s, :len(c)] = c
            rs = start + int(self.rope_delta[s])
            pos[s] = np.arange(rs, rs + bucket)
            offsets[s] = start
            n_last[s] = len(c) - 1
        logits, self.cache = self.arch.forward(
            self.hp, self.params, self._dev(toks), self._dev(pos), self.cache,
            self._dev(offsets), last_index=self._dev(n_last))
        slots = list(chunk)
        got = logits[torch.tensor(slots, device=self.device), 0].cpu().numpy()
        rows = dict(zip(slots, got))
        for s, c in chunk.items():
            self.n_past[s] += len(c)
            self.perf.n_prefill += len(c)
        self.perf.t_prefill_s += time.perf_counter() - t0
        return rows

    def _slot_forward(self, slot: int, tokens: list[int], **kw):
        """A recurrent slot's forward: `tokens` as one row at the slot's
        n_past, on a view of its cache rows (`slot_view`), so that no other
        slot's row runs a layer. Returns the forward's output."""
        start = int(self.n_past[slot])
        n = len(tokens)
        if start + n > self.max_seq:
            raise ValueError(f"slot {slot} context overflow: {start}+{n}")
        rs = start + int(self.rope_delta[slot])
        out, _ = self.arch.forward(
            self.hp, self.params, self._dev(np.asarray([tokens], dtype=np.int64)),
            self._dev(np.arange(rs, rs + n, dtype=np.int32)[None]),
            self.cache.slot_view(slot), start, **kw)
        return out

    def prefill_slot_embeddings(self, slot: int, embds, positions=None, deepstack=None):
        raise _not_ported("multimodal prefill (mtmd)", "1.3.7")

    @torch.inference_mode()
    def embed_tokens(self, slot: int, tokens: list[int], pooling: str | None = None,
                     normalize: bool = True) -> np.ndarray:
        """Pooled embedding [n_embd] of the final-norm hidden states,
        computed in slot `slot` (its state is consumed: n_past 0 after). A
        non-causal model (llama-embed) runs at offset n over its slot's
        first n cache slots zeroed, as Engine.embed_tokens (see there)."""
        pooling = pooling or (self.hp.pooling if self.hp.pooling != "none" else "mean")
        if self.arch.recurrent:  # from a zero state, one row; the slot is freed after
            self.free_slot(slot)
            hidden = self._slot_forward(slot, tokens, return_hidden=True)
            self.free_slot(slot)
            return pool_hidden(hidden[0].cpu().numpy(), pooling, normalize)
        n = len(tokens)
        bucket = self._bucket(n)
        toks = np.zeros((self.n_slots, bucket), dtype=np.int64)
        toks[slot, :n] = tokens
        pos = np.broadcast_to(np.arange(bucket, dtype=np.int32), (self.n_slots, bucket)).copy()
        offsets = np.full(self.n_slots, -1, dtype=np.int32)
        offsets[slot] = 0  # a causal model writes its rows (thrown away: slot freed after)
        if not self.hp.causal:
            if n + bucket > self.max_seq:
                raise ValueError(f"a non-causal embedding of {n} tokens (bucket {bucket}) "
                                 f"needs {n + bucket} cache slots; max_seq is {self.max_seq}")
            self.cache.clear_slots(n, row=slot)
            offsets[slot] = n
        hidden, self.cache = self.arch.forward(
            self.hp, self.params, self._dev(toks), self._dev(pos), self.cache,
            self._dev(offsets), return_hidden=True)
        self.n_past[slot] = 0
        return pool_hidden(hidden[slot, :n].cpu().numpy(), pooling, normalize)

    def verify_step(self, tokens: dict[int, list[int]], width: int) -> BatchRunner:
        """Speculative verification (≡ the reference server's can_speculate
        batch: one llama_batch of token + drafts per slot): up to `width`
        tokens of each slot in `tokens` fed at its n_past in one replay of
        the verify graph of `width` rows a slot (the rows past a slot's
        tokens padded with id 0, written and never read), the slots not in
        `tokens` idle. Does NOT advance n_past: the caller commits the
        accepted prefix. Returns the runner, whose `ids` [slots, width] and
        `logits` [slots, width, V] hold the rows until its next run. On the
        ring, `width` is at most the cache's `max_rows`. Refused on a
        recurrent arch (ROADMAP.md §3)."""
        if self.arch.recurrent:
            raise ValueError(SPEC_REFUSED)
        if isinstance(self.cache, SWACache) and width > self.cache.max_rows:
            raise ValueError(f"a verify of {width} rows a slot on a ring of "
                             f"{self.cache.ring_len} slots (window {self.cache.window}) "
                             f"exceeds its {self.cache.max_rows} rows")
        t0 = time.perf_counter()
        slots = max(tokens) + 1
        a = np.zeros((2 * width + 1, slots), dtype=np.int32)
        a[2 * width] = -1
        for slot, seq in tokens.items():
            start = int(self.n_past[slot])
            if not 0 < len(seq) <= width or start + width > self.max_seq:
                raise ValueError(f"slot {slot} verify of {len(seq)} tokens at {start} "
                                 f"({width} rows, max_seq {self.max_seq})")
            a[:len(seq), slot] = seq
            rs = start + int(self.rope_delta[slot])
            a[width:2 * width, slot] = np.arange(rs, rs + width)
            a[2 * width, slot] = start
        with torch.inference_mode():
            r = self.runner(slots, width)
            r.run(torch.from_numpy(a))
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += sum(len(s) for s in tokens.values())
        return r

    def verify_batch(self, tokens: dict[int, list[int]], width: int) -> dict[int, np.ndarray]:
        """verify_step, then {slot: logits [width, V]}: each slot's own
        rows read back. n_past is not advanced."""
        r = self.verify_step(tokens, width)
        return {slot: r.logits[slot].to("cpu", copy=True).numpy() for slot in tokens}

    def verify_batch_greedy(self, tokens: dict[int, list[int]],
                            width: int) -> dict[int, list[int]]:
        """verify_step, then {slot: argmax ids [width]} computed on the
        device (the read-back is the ids only). n_past is not advanced."""
        ids = self.verify_step(tokens, width).ids.tolist()
        return {slot: ids[slot] for slot in tokens}

    def rewind(self, slot: int, n_past: int):
        """Roll a slot's valid-cache length back."""
        self.n_past[slot] = n_past

    @property
    def can_shift(self) -> bool:
        """Whether cached K rows can be moved by re-rotating them (the JAX
        package's rule for the archs the port has: never on recurrent
        state)."""
        return (isinstance(self.cache, (KVCache, QuantKVCache)) and not self.arch.recurrent
                and self.hp.no_rope_step == 0
                and self.hp.rope.scaling_type != "longrope"
                and self.hp.rope.dims > 0)

    @torch.inference_mode()
    def shift_slot(self, slot: int, idx: np.ndarray, delta: np.ndarray):
        """Permute one slot's cache rows in place: row i takes row idx[i],
        with K re-rotated by delta[i] positions (V, and keys under ALiBi,
        carry no position and just move); q8 keys are dequantized, turned
        and quantized again, as the JAX package does."""
        idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=self.device)
        delta_t = torch.as_tensor(np.asarray(delta), dtype=torch.int32, device=self.device)
        rotate = self.hp.max_alibi_bias <= 0.0
        c = self.cache
        if isinstance(c, QuantKVCache):
            kq = c.k_q[:, slot].index_select(2, idx_t)
            ks = c.k_s[:, slot].index_select(2, idx_t)
            vq = c.v_q[:, slot].index_select(2, idx_t)
            vs = c.v_s[:, slot].index_select(2, idx_t)
            if rotate:
                kq, ks = QuantKVCache._quantize(
                    rotate_cached_keys(kq.float() * ks[..., None], delta_t, self.hp.rope))
            for dst, src in ((c.k_q, kq), (c.k_s, ks), (c.v_q, vq), (c.v_s, vs)):
                dst[:, slot].copy_(src)
            return
        k = c.k[:, slot].index_select(2, idx_t)
        v = c.v[:, slot].index_select(2, idx_t)
        if rotate:
            k = rotate_cached_keys(k, delta_t, self.hp.rope)
        c.k[:, slot].copy_(k)
        c.v[:, slot].copy_(v)

    # -- decode --------------------------------------------------------------------

    def _inputs(self, tokens: dict[int, int], width: int) -> torch.Tensor:
        """The int32 [3, width] host tensor of a decode step over the first
        `width` slots: tokens, positions, offsets (−1 for the slots not in
        `tokens`)."""
        a = np.zeros((3, width), dtype=np.int32)
        a[2] = -1
        for slot, tok in tokens.items():
            n = int(self.n_past[slot])
            if n >= self.max_seq:
                raise ValueError(f"slot {slot} context overflow: decode at n_past={n} >= "
                                 f"max_seq={self.max_seq}")
            a[:, slot] = (tok, n + int(self.rope_delta[slot]), n)
        return torch.from_numpy(a)

    def decode_batch_greedy(self, tokens: dict[int, int]) -> dict[int, int]:
        """One decode step returning argmax ids only, computed on the device
        (the read-back shrinks from [B, V] f32 logits to [B] ids). Exact for
        pure-greedy slots only (the scheduler checks _device_greedy_ok)."""
        t0 = time.perf_counter()
        width = max(tokens) + 1
        with torch.inference_mode():
            r = self.runner(width)
            r.run(self._inputs(tokens, width))
            ids = r.ids[:, 0].tolist()
        out = {}
        for slot in tokens:
            self.n_past[slot] += 1
            out[slot] = int(ids[slot])
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += len(tokens)
        return out

    def decode_batch(self, tokens: dict[int, int]) -> dict[int, np.ndarray]:
        """One decode step for the given {slot: token}; returns {slot: logits}."""
        t0 = time.perf_counter()
        width = max(tokens) + 1
        with torch.inference_mode():
            r = self.runner(width)
            r.run(self._inputs(tokens, width))
            logits = r.logits[:, 0].to("cpu", copy=True).numpy()
        out = {}
        for slot in tokens:
            self.n_past[slot] += 1
            out[slot] = logits[slot]
        self.perf.t_decode_s += time.perf_counter() - t0
        self.perf.n_decode += len(tokens)
        return out
