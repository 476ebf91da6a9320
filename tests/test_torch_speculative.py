"""Port parity of speculative decoding: tpullm_torch's speculators
(runtime/speculative.py), n-gram caches (runtime/ngram_cache.py),
generate_speculative on Engine's verify graph, BatchEngine.verify_batch,
the speculative Scheduler, the cli's -md / --spec-ngram and
tpullm-torch-lookup, each against the JAX package's, both on the CPU on the
same `tiny` and `tiny-moe` synthetic GGUFs (the JAX engines through their
device repack, the load the port mirrors).

The speculators and the caches are pure Python on both sides: their
proposals and state are held equal, exactly, on hypothesis-drawn token
streams (a small alphabet, so n-grams repeat; context rewrites in the
middle, as a context shift makes). The generation cases compare token ids
exactly, and `SpecStats` field by field; logits are held to NMSE ≤ 1e-3
(the bound of tests/test_torch_batch_engine.py: the plain versions round
where the kernels do, the f32 sums run in another order).

The tiny models are chaotic: a prompt is one on which no discrete decision
flips between the packages, stated with it. The tiny dense model's greedy
ids are one token over and over, so n-gram drafts are all accepted there;
tiny-moe's vary, and drafts are rejected. Sampled draws are compared on the
tiny dense model and on one tiny-moe prompt and seed whose temp-0.8 draws
agree between the packages (its flat distributions put most seeds' draws
within the packages' bf16 differences of a boundary)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime import ngram_cache as jngram
from tpullm.runtime import sampling as jsampling
from tpullm.runtime import speculative as jspec
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.server.scheduler import GenRequest as JGenRequest
from tpullm.server.scheduler import Scheduler as JScheduler
from tpullm.tools import cli as jcli
from tpullm.tools import lookup as jlookup

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import ngram_cache, sampling, speculative
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.server.scheduler import GenRequest, Scheduler
from tpullm_torch.tools import cli, lookup

NMSE_BOUND = 1e-3
MAX_SEQ = 128
TIMEOUT = 120  # seconds: any one scheduler queue read
# greedy prompts on which no decision flips between the packages
PROMPTS = {"tiny": "the quick brown fox", "tiny-moe": "hello world"}
MOE_PROMPT_2 = "a lazy dog and a quick brown fox jumped over the world"
# tiny-moe's temp-0.8 draws agree between the packages on this prompt at seed 1
MOE_SAMPLED = ("the lazy dog", 1)
# tiny-moe prompts whose 24 greedy tokens agree between the packages' batched
# engines, three at once (a repetitive one first)
SCHED_PROMPTS = ("the dog the dog the dog the dog", "world hello world hello", "the lazy dog")
SPEC_NAMES = ("ngram_simple", "ngram_mod", "ngram_cache", "draft")


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    """The JAX engines load through the JAX package's device repack."""
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return {shape: str(make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0))
            for shape in ("tiny", "tiny-moe")}


@pytest.fixture(scope="module")
def engines(ggufs):
    """(port target, port draft, JAX target, JAX draft) per model, made
    once (the JAX programs compile per shape); each test resets them."""
    made = {}

    def get(shape):
        if shape not in made:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TPULLM_DEVICE_REPACK", "1")
                made[shape] = (Engine(ggufs[shape], device="cpu", max_seq=MAX_SEQ),
                               Engine(ggufs[shape], device="cpu", max_seq=MAX_SEQ),
                               JEngine(ggufs[shape], max_seq=MAX_SEQ, kv_dtype=jnp.bfloat16),
                               JEngine(ggufs[shape], max_seq=MAX_SEQ, kv_dtype=jnp.bfloat16))
        for e in made[shape]:
            e.reset()
        return made[shape]
    return get


# -- the speculators ---------------------------------------------------------------

def _state(spec) -> tuple:
    """Everything a speculator keeps between calls."""
    name = type(spec).__name__
    if name == "NgramSpeculator":
        return spec.history, spec.maps
    if name == "NgramModSpeculator":
        return spec.history, spec.keys, spec.vals
    if name == "NgramMapSpeculator":
        return spec.history, spec.map, spec._last_key, spec._last_val
    return (spec.history, spec.context.grams,
            spec.dynamic.grams if spec.dynamic is not None else None)


def _pair(name: str, corpus: list[int]):
    """The port's and the JAX package's speculator `name`, made alike; the
    lookup speculator with a dynamic cache and a static one built from
    `corpus`."""
    def make(spec_mod, cache_mod):
        if name == "ngram_simple":
            return spec_mod.NgramSpeculator(n=3, n_draft=5)
        if name == "ngram_simple n_min 2":
            return spec_mod.NgramSpeculator(n=4, n_draft=6, n_min=2)
        if name == "ngram_mod collisions":  # 7 buckets: n-grams collide and overwrite
            return spec_mod.NgramModSpeculator(n=2, n_draft=5, size=7)
        if name == "ngram_mod":
            return spec_mod.NgramModSpeculator(n=3, n_draft=5)
        if name == "ngram_map_k":
            return spec_mod.NgramMapSpeculator(size_ngram=2, size_mgram=3, max_values=1,
                                               min_hits=1)
        if name == "ngram_map_k4v":
            return spec_mod.NgramMapSpeculator(size_ngram=2, size_mgram=3, max_values=4)
        static = cache_mod.NgramCache()
        static.update(corpus)
        return cache_mod.NgramCacheSpeculator(n_draft=4, dynamic=cache_mod.NgramCache(),
                                              static=static)
    return make(speculative, ngram_cache), make(jspec, jngram)


STREAM = st.lists(st.integers(0, 5), min_size=2, max_size=48)
# a round: (tokens the context grows by, draft budget, position rewritten
# in the middle of the context (−1: none), its new token, the accepted
# count fed back)
ROUNDS = st.lists(st.tuples(st.integers(1, 7), st.integers(0, 6), st.integers(-1, 40),
                            st.integers(0, 5), st.integers(0, 6)), min_size=1, max_size=10)


@pytest.mark.parametrize("name", ["ngram_simple", "ngram_simple n_min 2", "ngram_mod",
                                  "ngram_mod collisions", "ngram_map_k", "ngram_map_k4v",
                                  "ngram_cache"])
@settings(max_examples=40, deadline=None)
@given(stream=STREAM, rounds=ROUNDS)
def test_speculator_as_jax(name, stream, rounds):
    """Rounds of resync (the context grown, or rewritten in the middle: the
    divergence _align_history handles), propose and, for the map
    speculator, accept feedback: the same proposals and the same state as
    the JAX speculator after every round."""
    port, ref = _pair(name, stream[::-1])
    ctx, pos = stream[:1], 1
    for grow, budget, at, tok, accepted in rounds:
        ctx = ctx + [stream[(pos + i) % len(stream)] for i in range(grow)]
        pos += grow
        if 0 <= at < len(ctx) - 1:
            ctx[at] = tok
        port.resync(list(ctx))
        ref.resync(list(ctx))
        got, want = port.propose(ctx[-1], budget), ref.propose(ctx[-1], budget)
        assert got == want
        if hasattr(ref, "accept"):
            port.accept(min(accepted, len(got)))
            ref.accept(min(accepted, len(want)))
        assert _state(port) == _state(ref)


@settings(max_examples=100, deadline=None)
@given(history=STREAM, want=STREAM)
def test_align_history_as_jax(history, want):
    a, b = list(history), list(history)
    assert speculative._align_history(a, want) == jspec._align_history(b, want)
    assert a == b


def test_make_speculator_names_and_errors(engines):
    te, _, je, _ = engines("tiny")
    for name in ("ngram_simple", "ngram_map_k", "ngram_map_k4v", "ngram_mod", "ngram_cache"):
        got, want = speculative.make_speculator(name, n_draft=3), jspec.make_speculator(
            name, n_draft=3)
        assert type(got).__name__ == type(want).__name__
        assert {k: v for k, v in vars(got).items() if k not in ("context", "static", "dynamic")} \
            == {k: v for k, v in vars(want).items() if k not in ("context", "static", "dynamic")}
    got = speculative.make_speculator("draft", n_draft=3, engine=te)
    assert isinstance(got, speculative.DraftModelSpeculator) and got.engine is te
    assert got.n_draft == 3
    for name, kw in (("draft", {}), ("medusa", {})):
        with pytest.raises(ValueError) as a:
            speculative.make_speculator(name, **kw)
        with pytest.raises(ValueError) as b:
            jspec.make_speculator(name, **kw)
        assert str(a.value) == str(b.value)


# -- the n-gram caches ---------------------------------------------------------------

def _grams(rng, n: int) -> list[int]:
    return [int(t) for t in rng.integers(0, 9, n)]


def test_ngram_cache_update_merge_and_npz_both_ways(tmp_path):
    """update (whole and the last nnew tokens), merge and the counts equal
    the JAX cache's; a file saved by either package loads in the other to
    the same grams, with the same arrays in it."""
    rng = np.random.default_rng(0)
    toks, more = _grams(rng, 300), _grams(rng, 80)
    a, b = ngram_cache.NgramCache(), jngram.NgramCache()
    for c in (a, b):
        c.update(toks)
        c.update(toks + more, nnew=len(more))
    assert a.grams == b.grams
    a2, b2 = ngram_cache.NgramCache(2, 3), jngram.NgramCache(2, 3)
    a2.update(more)
    b2.update(more)
    a.merge(a2)
    b.merge(b2)
    assert a.grams == b.grams
    assert (a.n_grams(), a.n_observations()) == (b.n_grams(), b.n_observations())
    a.save(tmp_path / "port.npz")
    b.save(tmp_path / "jax.npz")
    assert jngram.NgramCache.load(tmp_path / "port.npz").grams == a.grams
    assert ngram_cache.NgramCache.load(tmp_path / "jax.npz").grams == b.grams
    assert ngram_cache.NgramCache.load(tmp_path / "port.npz").grams == a.grams
    pa, pb = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(pa.files) == sorted(pb.files)
    for k in pa.files:
        assert np.array_equal(pa[k], pb[k])


def test_ngram_votes_and_draft_token_as_jax():
    """_vote, _vote_cross and draft_token over random distributions and
    tiered caches: the same pick (or None) as the JAX package's, at every
    gram size and threshold table."""
    rng = np.random.default_rng(1)
    tables = [(ngram_cache._MIN_SAMPLE_LAX, ngram_cache._MIN_PERCENT_LAX),
              (ngram_cache._MIN_SAMPLE_STRICT, ngram_cache._MIN_PERCENT_STRICT)]
    for _ in range(300):
        part = {int(t): int(c) for t, c in zip(rng.integers(0, 6, 4), rng.integers(1, 6, 4))}
        static = {int(t): int(c) for t, c in zip(rng.integers(0, 6, 2), rng.integers(0, 3, 2))}
        size = int(rng.integers(1, 5))
        for ms, mp in tables:
            assert ngram_cache._vote(part, size, ms, mp) == jngram._vote(part, size, ms, mp)
            assert ngram_cache._vote_cross(part, static, size, ms, mp) == \
                jngram._vote_cross(part, static, size, ms, mp)
    corpus = _grams(rng, 400)
    caches = []
    for mod in (ngram_cache, jngram):
        ctx, dyn, sta = mod.NgramCache(), mod.NgramCache(), mod.NgramCache()
        ctx.update(corpus[:150])
        dyn.update(corpus[100:300])
        sta.update(corpus)
        caches.append((ctx, dyn, sta))
    for i in range(200):
        hist = corpus[i:i + int(rng.integers(0, 6))]
        for tiers in ((0,), (0, 1), (0, 2), (0, 1, 2)):
            args = [[c[j] if j in tiers else None for j in range(3)] for c in caches]
            assert ngram_cache.draft_token(args[0][0], hist, args[0][1], args[0][2]) == \
                jngram.draft_token(args[1][0], hist, args[1][1], args[1][2])


# -- generate_speculative ---------------------------------------------------------------

def _speculators(name, engines_, n_draft=4):
    te, td, je, jd = engines_
    return (speculative.make_speculator(name, n_draft=n_draft, engine=td),
            jspec.make_speculator(name, n_draft=n_draft, engine=jd))


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("shape,prompt", [("tiny", PROMPTS["tiny"]),
                                          ("tiny-moe", PROMPTS["tiny-moe"]),
                                          ("tiny-moe", MOE_PROMPT_2)],
                         ids=["tiny", "tiny-moe", "tiny-moe-2"])
def test_generate_speculative_greedy_as_jax(engines, shape, prompt, name):
    """Greedy, 32 tokens: the ids and every SpecStats field equal the JAX
    package's (draft = the target's own file for `draft`), and the ids
    equal the port's plain greedy generate_tokens."""
    eng = engines(shape)
    te, je = eng[0], eng[2]
    ids = te.tokenizer.tokenize(prompt, add_special=True)
    plain = list(te.generate_tokens(ids, 32))
    te.reset()
    port_spec, jax_spec = _speculators(name, eng)
    got, gs = speculative.generate_speculative(te, port_spec, ids, 32)
    want, ws = jspec.generate_speculative(je, jax_spec, ids, 32)
    assert got == want == plain and len(got) == 32
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    assert gs.n_rounds > 0 and gs.n_generated == 32
    if name == "draft":  # the target drafting for itself
        assert gs.accept_rate > 0.9
    # the target's cache holds the accepted prefix only
    assert te.n_past == je.n_past


@pytest.mark.parametrize("shape,prompt,seed,name", [
    *[("tiny", PROMPTS["tiny"], 3, name) for name in SPEC_NAMES],
    ("tiny-moe", *MOE_SAMPLED, "ngram_simple")])
def test_generate_speculative_sampled_as_jax(engines, shape, prompt, seed, name):
    """temp 0.8 from one seed: the same ids and SpecStats as the JAX
    package's (every verified row goes through the host Sampler)."""
    eng = engines(shape)
    te, je = eng[0], eng[2]
    ids = te.tokenizer.tokenize(prompt, add_special=True)
    port_spec, jax_spec = _speculators(name, eng)
    got, gs = speculative.generate_speculative(
        te, port_spec, ids, 24, sampling.Sampler(sampling.SamplerParams(temp=0.8, seed=seed)))
    want, ws = jspec.generate_speculative(
        je, jax_spec, ids, 24, jsampling.Sampler(jsampling.SamplerParams(temp=0.8, seed=seed)))
    assert got == want and len(got) == 24
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)


def test_verify_logits_are_prefill_all_logits(engines):
    """The verify graph's step (run eagerly on the CPU) computes
    prefill_all_logits' numbers at every bucket it takes (8 and 16 rows),
    bit for bit; verify_ids are their argmax; both advance n_past by the
    tokens fed, as prefill_all_logits does."""
    te = engines("tiny-moe")[0]
    ids = te.tokenizer.tokenize(MOE_PROMPT_2, add_special=True)
    for tail in ([300, 301, 17], [5] * 9, list(range(40, 56))):
        te.reset()
        te.prefill(ids)
        want = te.prefill_all_logits(tail)
        te.n_past -= len(tail)
        got = te.verify_logits(tail)
        assert te.n_past == len(ids) + len(tail)
        te.n_past -= len(tail)
        assert np.array_equal(got, want)
        assert te.verify_ids(tail) == [int(i) for i in np.argmax(want, axis=-1)]
    assert sorted(te._verify_runners) == [8, 16]


def test_feed_matches_prefill(engines):
    """Engine.feed of one token (the logits graph), of a few (the verify
    graph) and of a prompt's worth (eager prefill) leaves the cache as a
    prefill of the same tokens does: the next decode_step's logits within
    the NMSE bound, and n_past advanced."""
    te, td = engines("tiny-moe")[:2]
    ids = te.tokenizer.tokenize(MOE_PROMPT_2, add_special=True)
    for tail in ([300], [300, 301, 17], list(range(30, 50))):
        te.reset()
        td.reset()
        te.prefill(ids + tail)
        td.prefill(ids)
        td.feed(tail)
        assert td.n_past == te.n_past
        assert _nmse(td.decode_step(7), te.decode_step(7)) <= NMSE_BOUND


def test_draft_speculator_caps_at_the_context_end(engines):
    """Near max_seq a draft proposes only what its cache has room for, as
    the JAX speculator does, and nothing at the end."""
    _, td, _, jd = engines("tiny")
    port, ref = speculative.DraftModelSpeculator(td, 5), jspec.DraftModelSpeculator(jd, 5)
    ctx = list(range(1, MAX_SEQ))  # the cache then holds MAX_SEQ − 2 rows: room for one
    for spec in (port, ref):
        spec.resync(ctx)
    got, want = port.propose(ctx[-1], 8), ref.propose(ctx[-1], 8)
    assert got == want and len(got) == 1 and td.n_past == jd.n_past == MAX_SEQ - 1
    ctx = list(range(1, MAX_SEQ + 1))
    for spec in (port, ref):
        spec.resync(ctx)
    assert port.propose(ctx[-1], 8) == ref.propose(ctx[-1], 8) == []


# -- BatchEngine.verify_batch ----------------------------------------------------------

def _batch(path, kv, jax=False):
    kw = dict(n_slots=3, max_seq=MAX_SEQ, prefill_chunk=32, mode="dense")
    if jax:
        return JBatchEngine(path, kv_dtype=jnp.bfloat16 if kv == "bf16" else kv, **kw)
    return BatchEngine(path, device="cpu", kv_dtype=torch.bfloat16 if kv == "bf16" else kv,
                       **kw)


def _cache_arrays(eng) -> list[torch.Tensor]:
    c = eng.cache
    return [t.clone() for t in ((c.k, c.v) if hasattr(c, "k") else (c.k_q, c.k_s, c.v_q, c.v_s))]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_verify_batch_as_jax(ggufs, kv):
    """Slots 0 and 2 prefilled to different offsets, slot 1 idle; one
    verify of 5 rows a slot (slot 0: a token and three drafts, slot 2: one
    token, the rest padded): each slot's logits [5, V] within the NMSE
    bound of the JAX verify_batch's, verify_batch_greedy their argmax, no
    n_past advanced; the idle slot's cache bytes untouched and no rows for
    it. Then each slot rewound to its offset (no-op: verify never
    advances) and decoded twice: the logits equal, bit for bit, those of an
    engine that never verified (the stale rows past the offset are
    overwritten before any query attends them; q8's scales are per row)."""
    te, je = _batch(ggufs["tiny-moe"], kv), _batch(ggufs["tiny-moe"], kv, jax=True)
    fresh = _batch(ggufs["tiny-moe"], kv)
    ids = {0: te.tokenizer.tokenize(MOE_PROMPT_2, add_special=True),
           2: te.tokenizer.tokenize(PROMPTS["tiny-moe"], add_special=True)}
    for e in (te, je, fresh):
        e.prefill_slots(ids)
    seqs = {0: [300, 301, 17, 42], 2: [5]}
    before = [t[:, 1].clone() for t in _cache_arrays(te)]
    got, want = te.verify_batch(seqs, 5), je.verify_batch(seqs, 5)
    assert set(got) == set(want) == {0, 2}
    for s in seqs:
        assert got[s].shape == want[s].shape == (5, te.hp.n_vocab)
        assert _nmse(got[s], want[s]) <= NMSE_BOUND, s
    assert list(te.n_past) == list(je.n_past) == list(fresh.n_past)
    assert all(torch.equal(a[:, 1], b) for a, b in zip(_cache_arrays(te), before))
    greedy = te.verify_batch_greedy(seqs, 5)
    assert greedy == {s: [int(i) for i in np.argmax(got[s], axis=-1)] for s in seqs}
    for s in seqs:
        te.rewind(s, int(fresh.n_past[s]))
    for feed in ({0: 300, 2: 5}, {0: 301, 2: 6}):
        a, b = te.decode_batch(feed), fresh.decode_batch(feed)
        for s in feed:
            assert np.array_equal(a[s], b[s]), s


def test_verify_batch_refuses_overflow_and_empty_rows(ggufs):
    te = _batch(ggufs["tiny"], "bf16")
    te.prefill_slot(0, list(range(1, MAX_SEQ - 3)))
    with pytest.raises(ValueError, match="verify"):
        te.verify_batch({0: [1, 2]}, 5)
    with pytest.raises(ValueError, match="verify"):
        te.verify_batch({1: []}, 2)
    with pytest.raises(ValueError, match="verify"):
        te.verify_batch({1: [1, 2, 3]}, 2)


# -- the speculative Scheduler -----------------------------------------------------------

def _drain(req, timeout=TIMEOUT):
    toks = []
    while True:
        ev = req.out.get(timeout=timeout)
        if ev[0] == "token":
            toks.append(ev[1])
        else:
            return toks, ev[1], ev[2]


def _serve(sched, prompts, n, temp=0.0, seed=0, stop=(), jax=False):
    """Every prompt submitted before the scheduler starts (so they share
    rounds and steps), run to their ends; [(ids, reason, predicted_n)]."""
    req_cls = JGenRequest if jax else GenRequest
    params = (jsampling if jax else sampling).SamplerParams(temp=temp, seed=seed)
    reqs = [sched.submit(req_cls(prompt_ids=p, max_tokens=n, sampling=params, stop=list(stop)))
            for p in prompts]
    sched.start()
    try:
        out = [_drain(r) for r in reqs]
    finally:
        sched.stop()
    assert not sched._thread.is_alive()
    return [(toks, reason, stats["predicted_n"]) for toks, reason, stats in out]


def _sched_pair(ggufs, shape, draft=False, **kw):
    kw_e = dict(n_slots=3, max_seq=MAX_SEQ, prefill_chunk=32, mode="dense")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        jt = JBatchEngine(ggufs[shape], **kw_e)
        jd = JBatchEngine(ggufs[shape], **kw_e) if draft else None
    pt = BatchEngine(ggufs[shape], device="cpu", **kw_e)
    pd = BatchEngine(ggufs[shape], device="cpu", **kw_e) if draft else None
    return Scheduler(pt, draft_engine=pd, **kw), JScheduler(jt, draft_engine=jd, **kw)


@pytest.mark.parametrize("spec_type", ["ngram_simple", "ngram_mod"])
def test_scheduler_ngram_speculation_as_jax(ggufs, spec_type):
    """tests/test_server.py's case against the JAX scheduler: three greedy
    requests at once (a repetitive prompt, and two others) with
    speculation give the plain scheduler's ids, the JAX speculative
    scheduler's ids, and its drafted and accepted counts."""
    tok = BatchEngine(ggufs["tiny-moe"], device="cpu", n_slots=1, max_seq=MAX_SEQ).tokenizer
    prompts = [tok.tokenize(p, add_special=True) for p in SCHED_PROMPTS]
    plain = _serve(_sched_pair(ggufs, "tiny-moe")[0], prompts, 24)
    port, ref = _sched_pair(ggufs, "tiny-moe", spec_type=spec_type, n_draft=4)
    got, want = _serve(port, prompts, 24), _serve(ref, prompts, 24, jax=True)
    assert got == want == plain
    assert all(reason in ("stop", "length") for _, reason, _ in got)
    assert (port.n_spec_drafted, port.n_spec_accepted) == (ref.n_spec_drafted,
                                                           ref.n_spec_accepted)
    assert port.n_spec_drafted > 0 and port.n_tokens_generated == ref.n_tokens_generated


def test_scheduler_draft_model_speculation_as_jax(ggufs):
    """Draft = target (a second BatchEngine on the same file): three
    concurrent greedy requests equal the plain scheduler's and the JAX
    speculative scheduler's ids, with acceptance above 0.9; the draft's
    catch-up rides one verify step with the pending tokens."""
    tok = BatchEngine(ggufs["tiny-moe"], device="cpu", n_slots=1, max_seq=MAX_SEQ).tokenizer
    prompts = [tok.tokenize(p, add_special=True)
               for p in (SCHED_PROMPTS[2], SCHED_PROMPTS[1], SCHED_PROMPTS[2])]
    plain = _serve(_sched_pair(ggufs, "tiny-moe")[0], prompts, 16)
    port, ref = _sched_pair(ggufs, "tiny-moe", draft=True, n_draft=4)
    assert port.spec_type == "draft"
    got, want = _serve(port, prompts, 16), _serve(ref, prompts, 16, jax=True)
    assert got == want == plain
    assert port.n_spec_drafted > 0 and port.n_spec_accepted / port.n_spec_drafted > 0.9
    assert ref.n_spec_accepted / ref.n_spec_drafted > 0.9
    assert sorted(port.draft_engine._verify_runners) == [(3, 5)]


def test_scheduler_speculation_sampling_and_stop_as_jax(ggufs):
    """tests/test_server.py's case: ngram_cache speculation under temp-0.9
    sampling on the tiny dense model gives the JAX scheduler's events
    within max_tokens; and a stop string met inside an accept run (greedy
    tiny-moe, ngram_simple) ends the request where the plain scheduler and
    the JAX speculative scheduler end it."""
    port, ref = _sched_pair(ggufs, "tiny", spec_type="ngram_cache", n_draft=3)
    ids = [port.engine.tokenizer.tokenize("hello world hello world", add_special=True)]
    got = _serve(port, ids, 10, temp=0.9, seed=3)
    assert got == _serve(ref, ids, 10, temp=0.9, seed=3, jax=True)
    toks, reason, n = got[0]
    assert reason in ("stop", "length") and len(toks) == n <= 10
    port, ref = _sched_pair(ggufs, "tiny-moe", spec_type="ngram_simple", n_draft=4)
    tok = port.engine.tokenizer
    ids = [tok.tokenize(SCHED_PROMPTS[0], add_special=True)]
    plain_s = _sched_pair(ggufs, "tiny-moe")[0]
    full = _serve(plain_s, ids, 24)[0][0]
    at = next(i for i in range(8, 24) if full[i] not in full[:i])  # a piece first met late
    stop = [tok.detokenize(full[at:at + 2])]
    plain = _serve(_sched_pair(ggufs, "tiny-moe")[0], ids, 24, stop=stop)
    got = _serve(port, ids, 24, stop=stop)
    assert got == _serve(ref, ids, 24, stop=stop, jax=True) == plain
    assert got[0][1] == "stop" and len(got[0][0]) < 24 and port.n_spec_accepted > 0


def test_scheduler_speculation_near_the_context_end_as_jax(ggufs):
    """Long prompts (tiny dense model): slots within n_draft + 2 rows of
    max_seq decode plainly beside the verify step (`no_room`), then shift
    their context (deferred past the accept run), and go on speculating;
    the ids equal the JAX scheduler's and the plain scheduler's."""
    tok = BatchEngine(ggufs["tiny"], device="cpu", n_slots=1, max_seq=MAX_SEQ).tokenizer
    base = tok.tokenize(PROMPTS["tiny"], add_special=True) * 30
    prompts = [base[:100], base[:30]]
    plain_s = _sched_pair(ggufs, "tiny")[0]
    plain = _serve(plain_s, prompts, 40)
    port, ref = _sched_pair(ggufs, "tiny", spec_type="ngram_simple", n_draft=4)
    got, want = _serve(port, prompts, 40), _serve(ref, prompts, 40, jax=True)
    assert got == want == plain
    assert port.n_context_shifts == ref.n_context_shifts == plain_s.n_context_shifts > 0
    assert port.n_spec_accepted == ref.n_spec_accepted > 0


def test_scheduler_precompile_captures_verify_widths(ggufs):
    """precompile makes the decode step of every width and, with
    speculation, the verify step of n_draft + 1 rows at every width, for
    the target and the draft."""
    port, _ = _sched_pair(ggufs, "tiny", draft=True, n_draft=2)
    port.precompile(background=False)
    for eng in (port.engine, port.draft_engine):
        assert sorted(eng._runners) == [1, 2, 3]
        assert sorted(eng._verify_runners) == [(1, 3), (2, 3), (3, 3)]
    with pytest.raises(ValueError, match="draft_engine"):
        Scheduler(port.engine, spec_type="draft")


# -- the cli and tpullm-torch-lookup --------------------------------------------------

def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
@pytest.mark.parametrize("flags", [["-md", None], ["--spec-ngram"]], ids=["md", "spec-ngram"])
def test_cli_speculative_as_jax(ggufs, shape, flags):
    """tpullm-torch -md (the target's own file as the draft) and
    --spec-ngram, greedy: stdout equal to the JAX cli's, and the
    `speculative:` line of -v equal too."""
    flags = [ggufs[shape] if f is None else f for f in flags]
    argv = ["-m", ggufs[shape], "-p", PROMPTS[shape], "-n", "16", "-c", "64", "--temp", "0",
            "--draft-max", "3", "-v", *flags]
    rc, got, err = _run(cli.main, argv + ["--device", "cpu"])
    rc_j, want, err_j = _run(jcli.main, argv)
    assert rc == rc_j == 0 and got == want and got.startswith(PROMPTS[shape])
    line = [x for x in err.splitlines() if x.startswith("speculative:")]
    assert line and line == [x for x in err_j.splitlines() if x.startswith("speculative:")]


def test_lookup_tool_as_jax(ggufs, tmp_path):
    """tpullm-torch-lookup create, merge, stats and run against the JAX
    tool: the same stdout, caches that load across the packages to the
    same grams, and the same accept-rate line of a run with the static
    and dynamic caches (the dynamic one updated the same)."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the quick brown fox jumps over the lazy dog hello world " * 20)
    m = ggufs["tiny-moe"]
    outs = {}
    for name, main in (("port", lookup.main), ("jax", jlookup.main)):
        d = tmp_path / name
        d.mkdir()
        rc1, c_out, _ = _run(main, ["create", "-m", m, "-f", str(corpus), "-o", str(d / "s.npz")])
        rc2, m_out, _ = _run(main, ["merge", str(d / "s.npz"), str(d / "s.npz"), "-o",
                                    str(d / "m.npz")])
        rc3, s_out, _ = _run(main, ["stats", str(d / "m.npz")])
        jngram.NgramCache().save(d / "dyn.npz")
        run = ["run", "-m", m, "-p", MOE_PROMPT_2, "-n", "16", "-c", "64", "--static",
               str(d / "s.npz"), "--dynamic", str(d / "dyn.npz"), "--update-dynamic"]
        rc4, r_out, r_err = _run(main, run + (["--device", "cpu"] if name == "port" else []))
        assert rc1 == rc2 == rc3 == rc4 == 0
        outs[name] = (c_out.replace(str(d), ""), m_out.replace(str(d), ""), s_out, r_out,
                      r_err.strip().splitlines()[-1])
    assert outs["port"] == outs["jax"]
    assert "n_drafted=" in outs["port"][4]
    for f in ("s.npz", "m.npz", "dyn.npz"):
        assert jngram.NgramCache.load(tmp_path / "port" / f).grams == \
            ngram_cache.NgramCache.load(tmp_path / "jax" / f).grams


def test_server_metrics_count_speculation(ggufs):
    """make_app with spec_type: a completion through HTTP, then /metrics
    reports the drafted and accepted counters and their rate."""
    import http.client
    import json

    from tpullm_torch.server.api import make_app, serve

    app, sched = make_app(ggufs["tiny"], spec_type="ngram_simple", n_draft=4, device="cpu",
                          n_slots=2, max_seq=MAX_SEQ, mode="dense")
    httpd = serve(app, "127.0.0.1", 0)
    out = []
    try:
        for method, path, body in (("POST", "/v1/completions", {"prompt": PROMPTS["tiny"],
                                                                "max_tokens": 16,
                                                                "temperature": 0}),
                                   ("GET", "/metrics", None)):
            c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=TIMEOUT)
            try:
                c.request(method, path, None if body is None else json.dumps(body),
                          {"Content-Type": "application/json"})
                r = c.getresponse()
                out.append((r.status, r.read().decode()))
            finally:
                c.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    assert out[0][0] == out[1][0] == 200
    assert json.loads(out[0][1])["usage"]["completion_tokens"] == 16
    metrics = dict(line.split() for line in out[1][1].splitlines() if not line.startswith("#"))
    assert int(metrics["tpullm_spec_tokens_drafted_total"]) == sched.n_spec_drafted > 0
    assert int(metrics["tpullm_spec_tokens_accepted_total"]) == sched.n_spec_accepted > 0
    assert float(metrics["tpullm_spec_accept_rate"]) > 0


@pytest.mark.parametrize("entry", ["cli -md", "cli --spec-ngram", "lookup run", "server"])
def test_speculative_entry_points_default_to_the_card(ggufs, entry):
    """Without --device the new entry points run on the card: here, with
    none, they raise rather than fall back to the CPU."""
    from tpullm_torch.server import __main__ as srv_main

    m = ggufs["tiny"]
    argv = {"cli -md": (cli.main, ["-m", m, "-p", "x", "-n", "2", "-md", m]),
            "cli --spec-ngram": (cli.main, ["-m", m, "-p", "x", "-n", "2", "--spec-ngram"]),
            "lookup run": (lookup.main, ["run", "-m", m, "-p", "x", "-n", "2"]),
            "server": (srv_main.main, ["-m", m, "--spec-type", "ngram_simple"])}[entry]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised by tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(*argv)
