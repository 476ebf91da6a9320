"""Speculative decoding: draft-model and n-gram speculators + verify loop
(the JAX package's runtime/speculative.py on the port's Engine).

Reference: common/speculative.cpp (strategies draft-model, ngram_simple,
ngram_map — speculative.cpp:21-39) and the server's speculative branch
(server-context.cpp update_slots can_speculate path).

Verification of k draft tokens is ONE forward at a fixed shape (the
prefill bucket of k + 1 tokens, runtime/graph.py `VerifyRunner`: on the
card a CUDA graph per bucket, replayed a round), so a round costs one draft
chain and one target pass however many tokens are accepted. Under a greedy
sampler only the argmax ids of the verified rows come back to the host.
Cache rollback is free: rejecting tokens just rewinds n_past, and the next
forward overwrites the stale rows before any query can attend them, on a
full cache and on an iSWA ring alike (a ring slot keeps its rejected row's
position, above every later query, until that position is written again).

A draft Engine catches up through `Engine.feed` (one or a few tokens on
the logits and verify graphs) and drafts greedily through a decode runner
(runtime/graph.py `DecodeRunner`: k steps with the argmax on the device,
the ids read back once).

A recurrent model (the SSMs and the hybrids) is refused as a target and as
a draft: its state absorbs every token fed, and rewinding n_past leaves a
rejected draft in it (the JAX package's generate_speculative rewinds
n_past alone; ROADMAP.md §3).

Speculator contract:
  resync(ctx)       — bring internal state to "has processed ctx[:-1]";
                      ctx is the authoritative token list ending in the next
                      token to feed (cur)
  propose(cur, max) — return up to `max` draft tokens continuing ctx
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.sampling_ops import SamplingParams
from .engine import SPEC_REFUSED, Engine
from .sampling import Sampler, SamplerParams, argmax_exact

GREEDY = SamplingParams(temp=0.0)


class DraftModelSpeculator:
    """Greedy draft continuation from a (smaller) second model."""

    def __init__(self, engine: Engine, n_draft: int = 5):
        if engine.arch.recurrent:
            raise ValueError(SPEC_REFUSED)
        self.engine = engine
        self.n_draft = n_draft

    def resync(self, ctx: list[int]):
        """Cache must hold exactly ctx[:-1]. Rolling n_past back is safe (the
        accepted prefix in the cache matches ctx); missing tokens are fed."""
        want = len(ctx) - 1
        if self.engine.n_past > want:
            self.engine.n_past = want
        elif self.engine.n_past < want:
            self.engine.feed(list(ctx[self.engine.n_past : want]))

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        # cap at the draft cache's remaining room: each step feeds one token
        # (cur, then the drafts but the last), so k steps need k free rows
        room = self.engine.max_seq - self.engine.n_past - 1
        k = min(self.n_draft, max_tokens, room)
        if k <= 0:
            return []
        eng = self.engine
        runner = eng.decode_runner(GREEDY, self.n_draft)
        with torch.inference_mode():
            runner.start(torch.tensor([int(cur)]), eng.n_past)
            out = runner.run(k)
        eng.n_past += k
        return out


def _align_history(history: list[int], want: list[int]) -> list[int]:
    """Truncate `history` in place to its common prefix with `want` and
    return the tail of `want` still to observe. Handles both normal append
    (history is a prefix) and divergence (context shift rewrote the middle
    of the window, new request reused the slot)."""
    n = 0
    for a, b in zip(history, want):
        if a != b:
            break
        n += 1
    del history[n:]
    return want[n:]


class NgramSpeculator:
    """Prompt/self n-gram lookup (≡ ngram_simple/ngram_map): propose the
    continuation that followed the most recent occurrence of the current
    n-gram suffix in the context. Draft-model-free speculation for
    self-repetitive text (code, structured output)."""

    def __init__(self, n: int = 3, n_draft: int = 5, n_min: int = 1):
        self.n = n
        self.n_min = n_min
        self.n_draft = n_draft
        self.history: list[int] = []
        self.maps: dict[int, dict[tuple, int]] = {k: {} for k in range(n_min, n + 1)}

    def _observe(self, tokens: list[int]):
        for t in tokens:
            h = self.history
            for k in range(self.n_min, self.n + 1):
                if len(h) >= k:
                    self.maps[k][tuple(h[-k:])] = t
            h.append(t)

    def resync(self, ctx: list[int]):
        self._observe(_align_history(self.history, list(ctx[:-1])))

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        sim = self.history + [cur]
        out: list[int] = []
        for _ in range(min(self.n_draft, max_tokens)):
            nxt = None
            for k in range(self.n, self.n_min - 1, -1):  # longest match first
                if len(sim) >= k:
                    nxt = self.maps[k].get(tuple(sim[-k:]))
                    if nxt is not None:
                        break
            if nxt is None:
                break
            out.append(nxt)
            sim.append(nxt)
        return out


class NgramModSpeculator:
    """Fixed-size modular-hash n-gram table (≡ common/ngram-mod.h, PR
    #19164): maps the hash of the trailing n-gram to the token that followed
    it, newest occurrence wins (collision-overwrite). O(1) memory regardless
    of context length; drafts chain greedily through the table."""

    def __init__(self, n: int = 3, n_draft: int = 5, size: int = 1 << 16):
        self.n = n
        self.n_draft = n_draft
        self.size = size
        self.keys: dict[int, tuple] = {}
        self.vals: dict[int, int] = {}
        self.history: list[int] = []

    def _hash(self, gram: tuple) -> int:
        h = 2166136261
        for t in gram:
            h = (h ^ (t & 0xFFFFFFFF)) * 16777619 & 0xFFFFFFFF
        return h % self.size

    def _observe(self, tokens: list[int]):
        h = self.history
        for t in tokens:
            if len(h) >= self.n:
                gram = tuple(h[-self.n:])
                idx = self._hash(gram)
                self.keys[idx] = gram
                self.vals[idx] = t
            h.append(t)

    def resync(self, ctx: list[int]):
        self._observe(_align_history(self.history, list(ctx[:-1])))

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        sim = self.history + [cur]
        out: list[int] = []
        for _ in range(min(self.n_draft, max_tokens)):
            if len(sim) < self.n:
                break
            gram = tuple(sim[-self.n:])
            idx = self._hash(gram)
            if self.keys.get(idx) != gram:  # empty or collision
                break
            nxt = self.vals[idx]
            out.append(nxt)
            sim.append(nxt)
        return out


class NgramMapSpeculator:
    """Key n-gram → value m-gram map with per-value occurrence counts and
    acceptance feedback (≡ common/ngram-map.h ngram_map_k / ngram_map_k4v,
    PR #18471): each key n-gram keeps up to `max_values` distinct follower
    m-grams; drafting picks the best-scoring value (count + how much of it
    was accepted last time) and emits the whole m-gram at once."""

    def __init__(self, size_ngram: int = 2, size_mgram: int = 6,
                 max_values: int = 4, min_hits: int = 2):
        self.n = size_ngram
        self.m = size_mgram
        self.max_values = max_values  # 1 ≡ ngram_map_k, 4 ≡ ngram_map_k4v
        self.min_hits = min_hits
        # key-gram -> list of [mgram tuple, count, last_n_accepted]
        self.map: dict[tuple, list[list]] = {}
        self.history: list[int] = []
        self._last_key: tuple | None = None
        self._last_val: int | None = None

    def _observe(self, tokens: list[int]):
        h = self.history
        for t in tokens:
            h.append(t)
            # a complete key+value window ends at the new token
            w = self.n + self.m
            if len(h) >= w:
                key = tuple(h[-w:-self.m])
                val = tuple(h[-self.m:])
                vals = self.map.setdefault(key, [])
                for ent in vals:
                    if ent[0] == val:
                        ent[1] += 1
                        break
                else:
                    if len(vals) < self.max_values:
                        vals.append([val, 1, -1])
                    else:  # replace the weakest entry
                        weakest = min(range(len(vals)), key=lambda i: vals[i][1])
                        vals[weakest] = [val, 1, -1]

    def resync(self, ctx: list[int]):
        self._observe(_align_history(self.history, list(ctx[:-1])))

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        sim = self.history + [cur]
        if len(sim) < self.n:
            return []
        key = tuple(sim[-self.n:])
        vals = self.map.get(key)
        if not vals:
            return []
        best = max(range(len(vals)),
                   key=lambda i: (vals[i][1], vals[i][2]))
        ent = vals[best]
        if ent[1] < self.min_hits and ent[2] <= 0:
            return []
        self._last_key, self._last_val = key, best
        return list(ent[0])[:max_tokens]

    def accept(self, n_accepted: int):
        """Feedback: record how much of the last drafted m-gram survived."""
        if self._last_key is not None:
            self.map[self._last_key][self._last_val][2] = n_accepted
            self._last_key = self._last_val = None


def make_speculator(spec_type: str, *, n_draft: int = 5, engine=None):
    """Factory over the reference's strategy names (speculative.cpp:32-39).
    `engine` is the draft Engine/BatchEngine for type 'draft'."""
    if spec_type == "draft":
        if engine is None:
            raise ValueError("draft speculation needs a draft model engine")
        return DraftModelSpeculator(engine, n_draft=n_draft)
    if spec_type == "ngram_simple":
        return NgramSpeculator(n_draft=n_draft)
    if spec_type == "ngram_map_k":
        return NgramMapSpeculator(max_values=1)
    if spec_type == "ngram_map_k4v":
        return NgramMapSpeculator(max_values=4)
    if spec_type == "ngram_mod":
        return NgramModSpeculator(n_draft=n_draft)
    if spec_type == "ngram_cache":
        from .ngram_cache import NgramCacheSpeculator

        return NgramCacheSpeculator(n_draft=n_draft)
    raise ValueError(f"unknown speculative type {spec_type!r} "
                     "(draft|ngram_simple|ngram_map_k|ngram_map_k4v|"
                     "ngram_mod|ngram_cache)")


@dataclass
class SpecStats:
    n_rounds: int = 0
    n_drafted: int = 0
    n_accepted: int = 0
    n_generated: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


def generate_speculative(
    target: Engine,
    speculator,
    prompt_tokens: list[int],
    max_new_tokens: int = 128,
    sampler: Sampler | None = None,
    stop_on_eog: bool = True,
) -> tuple[list[int], SpecStats]:
    """Verify-accept loop (≡ the reference's draft+decode+accept cycle).

    Works with any sampler; a drafted token is accepted iff the sampler,
    applied to the target logits at that position, yields the same id
    (exact-match acceptance, the reference's default). A sampler that picks
    the argmax (`argmax_exact`) reads back the verified rows' ids only."""
    if target.arch.recurrent:
        raise ValueError(SPEC_REFUSED)
    sampler = sampler or Sampler(SamplerParams(temp=0.0))
    stats = SpecStats()
    vocab = target.tokenizer.vocab
    out: list[int] = []
    prompt_tokens = list(prompt_tokens)
    ids_only = argmax_exact(sampler)

    logits = target.prefill(prompt_tokens)
    cur = sampler.sample(logits)
    sampler.accept(cur)
    if stop_on_eog and vocab.is_eog(cur):
        return out, stats
    out.append(cur)

    def ctx():
        return prompt_tokens + out

    while len(out) < max_new_tokens:
        budget = max_new_tokens - len(out)
        speculator.resync(ctx())
        drafts = speculator.propose(cur, budget - 1) if budget > 1 else []
        stats.n_rounds += 1
        stats.n_drafted += len(drafts)

        seq = [cur] + drafts
        if target.n_past + len(seq) >= target.max_seq:
            break
        rows = target.verify_ids(seq) if ids_only else target.verify_logits(seq)

        def pick(i):
            return rows[i] if ids_only else sampler.sample(rows[i])

        n_accept = 0
        done = False
        mismatch_tok = None  # the corrective token on draft rejection
        for i, d in enumerate(drafts):
            t = pick(i)
            if t != d:
                mismatch_tok = t
                break
            sampler.accept(t)
            n_accept += 1
            if stop_on_eog and vocab.is_eog(t):
                done = True
                break
            out.append(t)
            if len(out) >= max_new_tokens:
                done = True
                break
        stats.n_accepted += n_accept
        # rewind the target cache past the rejected tail
        target.n_past -= len(drafts) - n_accept
        if done:
            break

        # corrective (mismatch) or bonus (all accepted) token
        nxt = mismatch_tok if mismatch_tok is not None else pick(n_accept)
        sampler.accept(nxt)
        if stop_on_eog and vocab.is_eog(nxt):
            break
        out.append(nxt)
        cur = nxt
    stats.n_generated = len(out)
    return out, stats
