"""Host sampler chain over one row of logits (llama.cpp src/llama-sampler.cpp,
common/sampling.cpp), in numpy: the JAX package's runtime/sampling.py, the
same chain in the same order with the same `np.random` draws, so one seed
gives one sequence in both packages. The device sampler
(ops/sampling_ops.py) covers greedy/temp/top-k/top-p/min-p on the card.

Samplers: logit-bias, repetition/frequency/presence penalties, DRY, top-k,
typical-p, top-p, min-p, XTC, top-n-sigma, temperature (and the dynamic
"temp-ext"), mirostat v1/v2, greedy, dist. Default chain order:
  bias → penalties → dry → [mirostat | top-n-sigma → top-k → typical →
  top-p → min-p → xtc → temp] → dist.
A grammar hooks in through `constraint_fn` (see tpullm_torch.grammar).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


@dataclass
class SamplerParams:
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0  # 1.0 = disabled
    seed: int = 0xFFFFFFFF  # LLAMA_DEFAULT_SEED semantics: random
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    # DRY (reference llama-sampler.cpp llama_sampler_dry)
    dry_multiplier: float = 0.0  # 0 = disabled
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1  # -1 = whole context window
    dry_sequence_breakers: tuple[int, ...] = ()
    # XTC (exclude-top-choices)
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    # top-n-sigma (0 = disabled)
    top_n_sigma: float = 0.0
    # dynamic temperature (temp-ext): effective temp in [temp-delta, temp+delta]
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    # mirostat: 0 = off, 1 = v1, 2 = v2
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # token id → additive bias
    logit_bias: dict[int, float] = field(default_factory=dict)

    @property
    def greedy(self) -> bool:
        return self.temp <= 0 and self.mirostat == 0


# ---------------------------------------------------------------------------
# individual sampler transforms (logits in, logits out; -inf = masked)


def apply_logit_bias(logits: np.ndarray, bias: dict[int, float]) -> np.ndarray:
    for tid, b in bias.items():
        if 0 <= tid < logits.size:
            logits[tid] += b
    return logits


def apply_penalties(
    logits: np.ndarray,
    prev: Sequence[int],
    last_n: int,
    repeat: float,
    freq: float,
    present: float,
) -> np.ndarray:
    """≡ llama_sampler_penalties (llama-sampler.cpp)."""
    if not last_n or (repeat == 1.0 and not freq and not present):
        return logits
    recent = np.asarray(prev[-last_n:] if last_n > 0 else prev, dtype=np.int64)
    if recent.size == 0:
        return logits
    ids, counts = np.unique(recent, return_counts=True)
    vals = logits[ids]
    if repeat != 1.0:
        vals = np.where(vals <= 0, vals * repeat, vals / repeat)
    vals -= freq * counts + present * (counts > 0)
    logits[ids] = vals
    return logits


def apply_dry(
    logits: np.ndarray,
    prev: Sequence[int],
    multiplier: float,
    base: float,
    allowed_length: int,
    penalty_last_n: int,
    breakers: Sequence[int],
) -> np.ndarray:
    """DRY repetition penalty (≡ llama_sampler_dry, llama-sampler.cpp).

    For each candidate token z: if context ends with a sequence s and
    s + [z] already occurred in the window, the repeat would extend a match
    of length L; penalize z by multiplier * base^(L - allowed_length) when
    L >= allowed_length.
    """
    if multiplier <= 0 or not prev:
        return logits
    ctx = list(prev if penalty_last_n < 0 else prev[-penalty_last_n:])
    n = len(ctx)
    if n < allowed_length:
        return logits
    breaker_set = set(breakers)
    # match_len[z] = longest suffix of ctx that, followed by z, appears in ctx
    match_len: dict[int, int] = {}
    # scan all earlier positions i where extending gives candidate ctx-continuation
    # standard O(n^2) suffix-match (window is <= a few k tokens on host)
    for i in range(n - 1):
        # length of common suffix between ctx[:i+1] and ctx (full)
        l = 0
        while (
            l < i + 1
            and l < n
            and ctx[i - l] == ctx[n - 1 - l]
            and ctx[i - l] not in breaker_set
        ):
            l += 1
        if l == 0:
            continue
        z = ctx[i + 1]
        if z in breaker_set:
            continue
        if l > match_len.get(z, 0):
            match_len[z] = l
    # clamp the exponent so long repeats don't overflow to inf
    # (≡ llama_sampler_dry's max_exponent guard)
    max_exponent = 0.0
    if base > 1.0 and multiplier > 0:
        max_exponent = np.log(np.finfo(np.float32).max / multiplier) / np.log(base)
    for z, l in match_len.items():
        if l >= allowed_length and 0 <= z < logits.size:
            exp = float(l - allowed_length)
            if max_exponent > 0:
                exp = min(exp, max_exponent)
            logits[z] -= multiplier * (base ** exp)
    return logits


def apply_top_k(logits: np.ndarray, k: int) -> np.ndarray:
    if 0 < k < logits.size:
        kth = np.partition(logits, -k)[-k]
        logits[logits < kth] = -np.inf
    return logits


def apply_top_n_sigma(logits: np.ndarray, n_sigma: float) -> np.ndarray:
    """≡ llama_sampler_top_n_sigma: keep logits within n*std of the max."""
    if n_sigma <= 0:
        return logits
    finite = logits[np.isfinite(logits)]
    if finite.size < 2:
        return logits
    sigma = float(finite.std())
    logits[logits < finite.max() - n_sigma * sigma] = -np.inf
    return logits


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - np.max(logits[np.isfinite(logits)], initial=0.0)
    p = np.exp(np.where(np.isfinite(z), z, -np.inf))
    return p / p.sum()


def apply_typical(logits: np.ndarray, typ_p: float) -> np.ndarray:
    """Locally-typical sampling (≡ llama_sampler_typical)."""
    if typ_p >= 1.0:
        return logits
    probs = _softmax(logits)
    nz = probs > 0
    ent = -np.sum(probs[nz] * np.log(probs[nz]))
    shifted = np.abs(-np.log(np.where(nz, probs, 1.0)) - ent)
    shifted[~nz] = np.inf
    order = np.argsort(shifted, kind="stable")
    csum = np.cumsum(probs[order])
    cutoff = int(np.searchsorted(csum, typ_p)) + 1
    keep = order[:cutoff]
    out = np.full_like(logits, -np.inf)
    out[keep] = logits[keep]
    return out


def apply_top_p(logits: np.ndarray, top_p: float) -> np.ndarray:
    if not (0 < top_p < 1.0):
        return logits
    probs = _softmax(logits)
    order = np.argsort(-probs, kind="stable")
    csum = np.cumsum(probs[order])
    cutoff = int(np.searchsorted(csum, top_p)) + 1
    drop = order[cutoff:]
    logits[drop] = -np.inf
    return logits


def apply_min_p(logits: np.ndarray, min_p: float) -> np.ndarray:
    if min_p <= 0:
        return logits
    probs = _softmax(logits)
    logits[probs < min_p * probs.max()] = -np.inf
    return logits


def apply_xtc(
    logits: np.ndarray, probability: float, threshold: float, rng: np.random.Generator
) -> np.ndarray:
    """Exclude-top-choices (≡ llama_sampler_xtc): with given probability,
    remove every token above the probability threshold except the last
    (least-probable) such token."""
    if probability <= 0 or threshold > 0.5 or rng.random() >= probability:
        return logits
    probs = _softmax(logits)
    above = np.flatnonzero(probs >= threshold)
    if above.size < 2:
        return logits
    keep_last = above[np.argmin(probs[above])]
    mask = above[above != keep_last]
    logits[mask] = -np.inf
    return logits


def apply_temp(logits: np.ndarray, temp: float) -> np.ndarray:
    return logits / max(temp, 1e-6)


def apply_temp_ext(
    logits: np.ndarray, temp: float, delta: float, exponent: float
) -> np.ndarray:
    """Dynamic temperature (≡ llama_sampler_temp_ext): entropy-scaled temp in
    [temp-delta, temp+delta]."""
    if delta <= 0:
        return apply_temp(logits, temp)
    lo, hi = max(temp - delta, 0.0), temp + delta
    probs = _softmax(logits)
    nz = probs > 0
    if nz.sum() <= 1:
        return logits
    ent = -np.sum(probs[nz] * np.log(probs[nz]))
    max_ent = np.log(float(nz.sum()))
    norm_ent = ent / max_ent if max_ent > 0 else 0.0
    dyn = lo + (hi - lo) * (norm_ent**exponent)
    return apply_temp(logits, dyn)


# ---------------------------------------------------------------------------


@dataclass
class Sampler:
    """Stateful sampler chain (≡ common_sampler: chain + prev-token ring).

    constraint_fn, if set, is called with the logits array before the final
    draw and must mask disallowed tokens to -inf (grammar hook); accept() is
    forwarded to constraint_accept.
    """

    params: SamplerParams = field(default_factory=SamplerParams)
    constraint_fn: Callable[[np.ndarray], np.ndarray] | None = None
    constraint_accept: Callable[[int], None] | None = None

    def __post_init__(self):
        seed = self.params.seed
        if seed == 0xFFFFFFFF:
            seed = np.random.SeedSequence().entropy & 0xFFFFFFFF
        self.rng = np.random.default_rng(seed)
        self.prev: list[int] = []
        # mirostat state
        self._mu: float | None = None

    def accept(self, token: int):
        self.prev.append(token)
        if self.constraint_accept is not None:
            self.constraint_accept(token)

    def reset(self):
        self.prev.clear()
        self._mu = None

    # -- draw helpers

    def _dist(self, logits: np.ndarray) -> int:
        probs = _softmax(logits)
        return int(self.rng.choice(probs.size, p=probs))

    def _mirostat(self, logits: np.ndarray) -> int:
        p = self.params
        logits = apply_temp(logits, p.temp if p.temp > 0 else 1.0)
        if self._mu is None:
            self._mu = 2.0 * p.mirostat_tau
        probs = _softmax(logits)
        if p.mirostat == 1:
            # v1: estimate s_hat from top-100 Zipf fit, compute k
            m = min(100, probs.size)
            order = np.argsort(-probs, kind="stable")[:m]
            ps = probs[order]
            num = den = 0.0
            for i in range(m - 1):
                t_i = np.log((i + 2) / (i + 1))
                b_i = np.log(ps[i] / max(ps[i + 1], 1e-30))
                num += t_i * b_i
                den += t_i * t_i
            s_hat = num / max(den, 1e-30)
            eps = s_hat - 1.0
            n = probs.size
            k = int(
                ((eps * (2.0**self._mu)) / (1 - float(n) ** (-eps))) ** (1.0 / s_hat)
            )
            k = max(1, min(k, n))
            masked = logits.copy()
            apply_top_k(masked, k)
        else:
            # v2: truncate tokens with surprise > mu
            surprise = -np.log2(np.maximum(probs, 1e-30))
            masked = np.where(surprise > self._mu, -np.inf, logits)
            if not np.isfinite(masked).any():
                masked = logits
        tok = self._dist(masked)
        observed = -np.log2(max(float(probs[tok]), 1e-30))
        self._mu -= self.params.mirostat_eta * (observed - self.params.mirostat_tau)
        return tok

    def sample(self, logits: np.ndarray) -> int:
        p = self.params
        logits = np.asarray(logits, dtype=np.float32).copy()

        if p.logit_bias:
            logits = apply_logit_bias(logits, p.logit_bias)
        logits = apply_penalties(
            logits, self.prev, p.penalty_last_n, p.penalty_repeat, p.penalty_freq,
            p.penalty_present,
        )
        if p.dry_multiplier > 0:
            logits = apply_dry(
                logits, self.prev, p.dry_multiplier, p.dry_base,
                p.dry_allowed_length, p.dry_penalty_last_n,
                p.dry_sequence_breakers,
            )
        if self.constraint_fn is not None:
            logits = self.constraint_fn(logits)

        if p.mirostat:
            return self._mirostat(logits)

        if p.greedy:
            return int(np.argmax(logits))

        logits = apply_top_n_sigma(logits, p.top_n_sigma)
        logits = apply_top_k(logits, p.top_k)
        logits = apply_typical(logits, p.typical_p)
        logits = apply_top_p(logits, p.top_p)
        logits = apply_min_p(logits, p.min_p)
        logits = apply_xtc(logits, p.xtc_probability, p.xtc_threshold, self.rng)
        logits = apply_temp_ext(logits, p.temp, p.dynatemp_range, p.dynatemp_exponent)
        return self._dist(logits)


def argmax_exact(sampler: Sampler) -> bool:
    """Whether `sampler` picks the argmax of the logits it is given: greedy,
    and no transform on the host that could move the argmax (bias,
    penalties, DRY, a grammar). Then the argmax computed on the device is
    its pick, and only ids need to come back."""
    p = sampler.params
    return (p.greedy
            and not p.logit_bias
            and p.penalty_repeat == 1.0
            and p.penalty_freq == 0.0
            and p.penalty_present == 0.0
            and p.dry_multiplier == 0.0
            and sampler.constraint_fn is None)
