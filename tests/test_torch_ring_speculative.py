"""Port parity of speculative decoding on the iSWA ring cache
(runtime/kvcache.py SWACache under runtime/graph.py VerifyRunner and
BatchRunner, runtime/speculative.py, the speculative Scheduler) against
the JAX package's ring, both on the CPU, on the synthetic tiny gemma3
(models/synth.py "tiny-gemma3": 6 layers, five of them sliding-window
layers of window 16, tests/test_swa_cache.py's model at the port's
widths).

Every engine here is sized so that the ring wraps: a prefill chunk of 16
at max_seq 256 gives a ring of R = 128 slots (`max_rows` 113), and the
prompts run past 128 positions. The JAX engines get the same ring
(`SWACache.new(..., max_chunk=16)` with prefill_cap 16).

Tolerances: dense f32 weights and an f32 cache make the packages' graphs
the same f32 arithmetic in another order: logits within NMSE 1e-6
(F32_NMSE); against the port's own full cache (swa_full) rtol/atol 1e-4
(RTOL, ATOL: the ring's layers run attention_reference, the full cache's
flash's plain version, whose f32 sums differ in order, as
tests/test_torch_gemma.py states); the bf16 serving engines of the
Scheduler cases compare ids exactly. The tiny gemma's greedy ids are one
token over and over, so draft-model drafts are all accepted; n-gram drafts
that continue the prompt's n-grams are rejected, and so is `Contrarian`'s
wrong token in every round; the rollback case is built by hand."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime import kvcache as jkv
from tpullm.runtime import sampling as jsampling
from tpullm.runtime import speculative as jspec
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.server.scheduler import GenRequest as JGenRequest
from tpullm.server.scheduler import Scheduler as JScheduler

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import kvcache, sampling, speculative
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.server.scheduler import GenRequest, Scheduler

F32_NMSE = 1e-6
RTOL = ATOL = 1e-4
MAX_SEQ = 256
CHUNK = 16  # the prefill chunk the ring is sized for: R = 128
TIMEOUT = 120


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, 380, size=n)]


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_spec")
    return make_synthetic_llama_gguf(d / "tiny-gemma3.gguf", shape="tiny-gemma3", seed=0)


def _ring(path, **kw) -> Engine:
    """The port's Engine on dense f32 weights, its ring sized for chunks of
    CHUNK (R = 128 at MAX_SEQ)."""
    eng = Engine(path, device="cpu", mode="dense", dtype=torch.float32,
                 kv_dtype=torch.float32, max_seq=MAX_SEQ, **kw)
    if not kw.get("swa_full"):
        eng.prefill_cap = CHUNK
        eng.new_cache()
        assert isinstance(eng.cache, kvcache.SWACache) and eng.cache.ring_len == 128
    return eng


def _jring(path) -> JEngine:
    """The JAX Engine with the same ring, loaded through the JAX package's
    device repack (module fixtures are made before `device_repack` runs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        eng = JEngine(path, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                      max_seq=MAX_SEQ)
    eng.prefill_cap = CHUNK
    eng.cache = jkv.SWACache.new(eng.hp, 1, MAX_SEQ, jnp.float32, max_chunk=CHUNK)
    return eng


@pytest.fixture(scope="module")
def engines(path):
    """(port ring, port swa_full, JAX ring), made once; each test resets."""
    return _ring(path), _ring(path, swa_full=True), _jring(path)


def _reset(*engs):
    for e in engs:
        e.reset()


@pytest.mark.parametrize("n", [2, 5, 16, 40])
def test_ring_verify_logits_match_jax(engines, n):
    """After a 150-token prompt (the ring wrapped), verify_logits of n
    tokens equal the JAX ring engine's prefill_all_logits (its verify) and
    the port's full cache; n = 40 is wider than the prefill cap and goes
    through prefill_all_logits in chunks of it, as the JAX package
    verifies; verify_ids are the rows' argmax."""
    te, full, je = engines
    _reset(te, full, je)
    prompt, seq = _ids(150, 1), _ids(n, 2)
    for e in (te, full, je):
        e.prefill(prompt)
    got = te.verify_logits(seq)
    want = je.prefill_all_logits(seq)
    assert got.shape == want.shape == (n, te.hp.n_vocab) and te.n_past == je.n_past == 150 + n
    assert _nmse(got, want) <= F32_NMSE
    np.testing.assert_allclose(got, full.verify_logits(seq), rtol=RTOL, atol=ATOL)
    te.n_past -= n
    assert te.verify_ids(seq) == [int(i) for i in np.argmax(got, axis=-1)]


class Contrarian:
    """A speculator whose drafts are the target's greedy token but one:
    every round proposes `k` tokens, the second replaced by a wrong id, so
    a round accepts one draft and rejects the rest."""

    def __init__(self, token: int, k: int = 4):
        self.token, self.k = token, k

    def resync(self, ctx):
        pass

    def propose(self, cur, max_tokens):
        out = [self.token] * min(self.k, max_tokens)
        if len(out) > 1:
            out[1] = 7
        return out


@pytest.mark.parametrize("name", ["ngram_simple", "draft", "contrarian"])
def test_generate_speculative_on_the_ring_as_jax(engines, path, name):
    """Greedy speculation on the ring, 48 tokens after a 140-token prompt
    that repeats (so n-grams draft): the ids and every SpecStats field
    equal the JAX package's on its ring, and equal plain greedy decoding
    on the port's ring; `draft` drafts with a second engine on its own
    ring; `contrarian` rejects drafts in every round. The target's cache
    holds the accepted prefix only."""
    te, _, je = engines
    _reset(te, je)
    prompt = (_ids(35, 3) * 4)[:140]
    plain = list(te.generate_tokens(prompt, 48))
    te.reset()
    if name == "draft":
        port_spec = speculative.DraftModelSpeculator(_ring(path), n_draft=4)
        jax_spec = jspec.DraftModelSpeculator(_jring(path), n_draft=4)
    elif name == "contrarian":
        port_spec = jax_spec = Contrarian(plain[0])
    else:
        port_spec = speculative.make_speculator(name, n_draft=4)
        jax_spec = jspec.make_speculator(name, n_draft=4)
    got, gs = speculative.generate_speculative(te, port_spec, prompt, 48, stop_on_eog=False)
    want, ws = jspec.generate_speculative(je, jax_spec, prompt, 48, stop_on_eog=False)
    assert got == want == plain and len(got) == 48
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    assert te.n_past == je.n_past and te.n_past + 1 > 128 + CHUNK  # the ring wrapped
    if name == "draft":  # the target's own weights draft
        assert gs.n_accepted == gs.n_drafted > 0
    else:  # the prompt's n-grams and the contrarian's wrong id are rejected
        assert 0 < gs.n_accepted < gs.n_drafted


def test_ring_rollback_verify_reexecute(engines, path):
    """tests/test_swa_cache.py's rollback case through the verify path on a
    wrapped ring: a verify of 6 tokens, 2 accepted (n_past rewound by 4), a
    verify of 4 other tokens at the rewound offset, then two decode steps:
    every row equals an engine that never saw the rejected tokens (bit for
    bit: the same forwards at the same offsets) and the JAX ring engine's
    (F32_NMSE); the rejected rows' positions left in the ring are all
    overwritten by then."""
    te, _, je = engines
    _reset(te, je)
    fresh = _ring(path)
    prompt, drafts, other = _ids(140, 4), _ids(6, 5), _ids(4, 6)
    for e in (te, je, fresh):
        e.prefill(prompt)
    te.verify_logits(drafts)
    je.prefill_all_logits(drafts)
    te.n_past -= 4
    je.n_past -= 4
    sp = te.cache.slot_pos[0].tolist()
    assert max(sp) == 147 and sp[147 % 128] == 147  # the verify bucket of 8 rows
    fresh.verify_logits(drafts[:2])
    rows = [te.verify_logits(other)]
    want = [je.prefill_all_logits(other)]
    ref = [fresh.verify_logits(other)]
    for t in (30, 31):
        rows.append(te.decode_step(t))
        want.append(je.decode_step(t))
        ref.append(fresh.decode_step(t))
    for a, b, c in zip(rows, want, ref):
        np.testing.assert_array_equal(a, c)
        assert _nmse(a, b) <= F32_NMSE
    assert te.cache.slot_pos.tolist() == fresh.cache.slot_pos.tolist()


def _batch(path, jax=False, **kw):
    kw = dict(n_slots=2, max_seq=MAX_SEQ, prefill_chunk=CHUNK, mode="dense", **kw)
    if jax:
        return JBatchEngine(path, dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    return BatchEngine(path, device="cpu", dtype=torch.float32, kv_dtype=torch.float32, **kw)


def test_verify_batch_on_the_ring_matches_engine(engines, path):
    """BatchEngine.verify_batch on the ring (two slots past 128 positions;
    slot 1 idle in the second step, its ring rows untouched): each slot's
    rows equal Engine.verify_logits on the same history and the JAX
    BatchEngine's (F32_NMSE); after a rejected draft (rewind) the next
    verify at the rewound offset matches again, and ring_holds still
    holds the window (the prompt-cache rule of `ring_holds`)."""
    te = engines[0]
    be, jbe = _batch(path), _batch(path, jax=True)
    assert isinstance(be.cache, kvcache.SWACache) and be.cache.ring_len == 128
    hist = {0: _ids(150, 7), 1: _ids(133, 8)}
    for b in (be, jbe):
        b.prefill_slots(hist)
    for seqs, keep in (({0: _ids(4, 9), 1: _ids(3, 10)}, {0: 1, 1: 3}),
                       ({0: _ids(4, 11)}, {0: 4})):
        idle = be.cache.slot_pos[1].clone()
        got, want = be.verify_batch(seqs, 4), jbe.verify_batch(seqs, 4)
        if 1 not in seqs:
            assert torch.equal(be.cache.slot_pos[1], idle)
        for slot, seq in seqs.items():
            te.reset()
            te.prefill(hist[slot])
            ref = te.verify_logits(seq)
            assert _nmse(got[slot][:len(seq)], ref) <= F32_NMSE
            assert _nmse(got[slot][:len(seq)], want[slot][:len(seq)]) <= F32_NMSE
            hist[slot] += seq[:keep[slot]]
            for b in (be, jbe):
                b.rewind(slot, len(hist[slot]))
    assert be.n_past.tolist() == [155, 136]
    assert be.ring_holds(0, 155) and be.ring_holds(1, 136)
    assert not be.ring_holds(0, 20)


def test_verify_wider_than_the_ring_is_refused(path):
    """A verify forward wider than the ring's max_rows (R − window + 1 =
    113) is refused, never clamped: BatchEngine.verify_step and
    Engine.verify_runner raise; an Engine's verify of more tokens than its
    prefill cap goes through its chunks instead (the test above)."""
    be = _batch(path)
    assert be.cache.max_rows == 113
    with pytest.raises(ValueError, match="exceeds its 113 rows"):
        be.verify_batch({0: [5, 6]}, 128)
    eng = _ring(path)
    with pytest.raises(ValueError, match="exceeds its 113 rows"):
        eng.verify_runner(128)
    assert eng.verify_runner(16).rows == 16


def _drain(req, timeout=TIMEOUT):
    toks = []
    while True:
        ev = req.out.get(timeout=timeout)
        if ev[0] == "token":
            toks.append(ev[1])
        else:
            return toks, ev[1]


def _serve(sched, prompts, n, jax=False):
    req_cls = JGenRequest if jax else GenRequest
    params = (jsampling if jax else sampling).SamplerParams(temp=0.0)
    reqs = [sched.submit(req_cls(prompt_ids=p, max_tokens=n, sampling=params))
            for p in prompts]
    sched.start()
    try:
        return [_drain(r) for r in reqs]
    finally:
        sched.stop()


def _sched_pair(path, draft=False, **kw):
    kw_e = dict(n_slots=3, max_seq=MAX_SEQ, prefill_chunk=CHUNK, mode="dense")
    jt = JBatchEngine(path, **kw_e)
    jd = JBatchEngine(path, **kw_e) if draft else None
    pt = BatchEngine(path, device="cpu", **kw_e)
    pd = BatchEngine(path, device="cpu", **kw_e) if draft else None
    assert isinstance(pt.cache, kvcache.SWACache) and pt.cache.ring_len == 128
    return Scheduler(pt, draft_engine=pd, **kw), JScheduler(jt, draft_engine=jd, **kw)


@pytest.mark.parametrize("spec", ["ngram_simple", "draft"])
def test_speculative_scheduler_on_the_ring_as_jax(path, spec):
    """The speculative Scheduler on ring BatchEngines (bf16, 3 slots):
    three greedy requests of 20 tokens after prompts of 120–140 tokens (the
    rings wrap) give the plain scheduler's ids and the JAX speculative
    scheduler's, with its drafted and accepted counts; `draft` drafts with
    a second BatchEngine on its own ring."""
    prompts = [(_ids(30, 12) * 5)[:140], _ids(120, 13), (_ids(20, 14) * 7)[:130]]
    plain = _serve(_sched_pair(path)[0], prompts, 20)
    kw = dict(draft=True) if spec == "draft" else dict(spec_type=spec)
    port, ref = _sched_pair(path, n_draft=4, **kw)
    got, want = _serve(port, prompts, 20), _serve(ref, prompts, 20, jax=True)
    assert got == want == plain and all(len(t) == 20 for t, _ in got)
    assert (port.n_spec_drafted, port.n_spec_accepted) == (ref.n_spec_drafted,
                                                           ref.n_spec_accepted)
    assert port.n_spec_drafted > 0
