"""Persistent n-gram caches for lookup decoding (the JAX package's
runtime/ngram_cache.py; pure Python and numpy, its npz files interchangeable
with that package's both ways).

Reference: common/ngram-cache.{h,cpp} + tools/lookup/* — empirical
next-token distributions keyed by the preceding n-gram, in three tiers:

  context — built from the current conversation, updated as tokens arrive
  dynamic — persistent, accumulated across sessions (lookup-merge)
  static  — built offline from a large corpus (lookup-create), consulted
            with the fixed LLAMA_NGRAM_STATIC=2 gram size

Drafting consults context first (strict thresholds), then context×static
cross-scoring (lax), then static alone. A candidate is accepted only when
its n-gram has enough observations (min sample size) and the top token holds
a large enough share (min percent) — both per gram length, mirroring the
reference's draft_min_sample_size/draft_min_percent tables.
"""

from __future__ import annotations

import numpy as np

NGRAM_MIN = 1
NGRAM_MAX = 4
NGRAM_STATIC = 2

# per-gram-length acceptance thresholds (index = gram length - 1)
_MIN_SAMPLE_LAX = (2, 2, 1, 1)
_MIN_PERCENT_LAX = (66, 50, 50, 50)
_MIN_SAMPLE_STRICT = (4, 3, 2, 2)
_MIN_PERCENT_STRICT = (75, 66, 66, 66)


class NgramCache:
    """{(tok, ..., tok): {next_token: count}} over gram sizes min..max."""

    def __init__(self, ngram_min: int = NGRAM_MIN, ngram_max: int = NGRAM_MAX):
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        self.grams: dict[tuple, dict[int, int]] = {}

    def update(self, tokens: list[int], nnew: int | None = None):
        """Count n-grams ending within the last `nnew` tokens (all if None)."""
        n = len(tokens)
        nnew = n if nnew is None else nnew
        for size in range(self.ngram_min, self.ngram_max + 1):
            start = max(size, n - nnew)
            for i in range(start, n):
                key = tuple(tokens[i - size : i])
                part = self.grams.setdefault(key, {})
                part[tokens[i]] = part.get(tokens[i], 0) + 1

    def merge(self, other: "NgramCache"):
        for key, part in other.grams.items():
            mine = self.grams.setdefault(key, {})
            for tok, cnt in part.items():
                mine[tok] = mine.get(tok, 0) + cnt

    # -- persistence (npz: one [N, size+2] int64 table per gram size) --------

    def save(self, path: str):
        tables: dict[str, np.ndarray] = {}
        by_size: dict[int, list] = {}
        for key, part in self.grams.items():
            rows = by_size.setdefault(len(key), [])
            for tok, cnt in part.items():
                rows.append((*key, tok, cnt))
        for size, rows in by_size.items():
            tables[f"grams_{size}"] = np.asarray(rows, dtype=np.int64)
        tables["meta"] = np.asarray([self.ngram_min, self.ngram_max], np.int64)
        np.savez_compressed(path, **tables)

    @classmethod
    def load(cls, path: str) -> "NgramCache":
        data = np.load(path)
        lo, hi = (int(x) for x in data["meta"])
        cache = cls(lo, hi)
        for name in data.files:
            if not name.startswith("grams_"):
                continue
            size = int(name.split("_")[1])
            for row in data[name]:
                key = tuple(int(x) for x in row[:size])
                cache.grams.setdefault(key, {})[int(row[size])] = int(row[size + 1])
        return cache

    def n_grams(self) -> int:
        return len(self.grams)

    def n_observations(self) -> int:
        return sum(sum(p.values()) for p in self.grams.values())


def _vote(part: dict[int, int], size: int, min_sample, min_percent):
    """Top token of a distribution if it clears the thresholds, else None."""
    if not part:
        return None
    max_tok = max(part, key=part.get)
    max_count = part[max_tok]
    total = sum(part.values())
    if total < min_sample[size - 1]:
        return None
    if 100 * max_count < min_percent[size - 1] * total:
        return None
    return max_tok


def _vote_cross(part_primary: dict[int, int], part_static: dict[int, int],
                size: int, min_sample, min_percent):
    """Primary counts weighted by static-corpus agreement (×100 when the
    static tier also saw the pair, ×1 otherwise)."""
    best_tok, best_score = None, 0
    max_count = total = 0
    for tok, cnt in part_primary.items():
        w = 100 * part_static.get(tok, 0) or 1
        if cnt * w > best_score:
            best_tok, best_score = tok, cnt * w
            max_count = cnt
        total += cnt
    if best_tok is None or total < min_sample[size - 1]:
        return None
    if 100 * max_count < min_percent[size - 1] * total:
        return None
    return best_tok


def draft_token(context: NgramCache, history: list[int],
                dynamic: NgramCache | None = None,
                static: NgramCache | None = None):
    """One drafted token from the tiered caches, or None
    (≡ common_ngram_cache_draft inner step)."""
    part_static: dict[int, int] = {}
    if static is not None and len(history) >= NGRAM_STATIC:
        part_static = static.grams.get(tuple(history[-NGRAM_STATIC:]), {})

    # primary tiers, longest gram first
    for primary, min_sample, min_percent in (
        (context, _MIN_SAMPLE_STRICT, _MIN_PERCENT_STRICT),
        (dynamic, _MIN_SAMPLE_LAX, _MIN_PERCENT_LAX),
    ):
        if primary is None:
            continue
        for size in range(primary.ngram_max, primary.ngram_min - 1, -1):
            if len(history) < size:
                continue
            part = primary.grams.get(tuple(history[-size:]))
            if not part:
                continue
            tok = (
                _vote_cross(part, part_static, size, min_sample, min_percent)
                if part_static
                else _vote(part, size, min_sample, min_percent)
            )
            if tok is not None:
                return tok

    if part_static:
        return _vote(part_static, NGRAM_STATIC, _MIN_SAMPLE_LAX, _MIN_PERCENT_LAX)
    return None


class NgramCacheSpeculator:
    """Lookup-decoding speculator over the tiered caches (≡ tools/lookup
    lookup.cpp main loop). Satisfies the Speculator contract of
    runtime/speculative.py."""

    def __init__(self, n_draft: int = 5, dynamic: NgramCache | None = None,
                 static: NgramCache | None = None):
        self.n_draft = n_draft
        self.context = NgramCache()
        self.dynamic = dynamic
        self.static = static
        self.history: list[int] = []

    def resync(self, ctx: list[int]):
        from .speculative import _align_history

        missing = _align_history(self.history, list(ctx[:-1]))
        if missing:
            self.history.extend(missing)
            self.context.update(self.history, nnew=len(missing))
            if self.dynamic is not None:
                self.dynamic.update(self.history, nnew=len(missing))

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        sim = self.history + [cur]
        out: list[int] = []
        for _ in range(min(self.n_draft, max_tokens)):
            tok = draft_token(self.context, sim, self.dynamic, self.static)
            if tok is None:
                break
            out.append(tok)
            sim.append(tok)
        return out
