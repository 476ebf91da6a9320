"""Port parity of the recurrent-state archs against the JAX package, both on
the CPU: mamba and falcon-mamba (models/mamba.py, mamba1), mamba2, and the
hybrids jamba, nemotron_h, granitehybrid, nemotron_h_moe and falcon-h1
(models/jamba.py) on runtime/recurrent.py's RecurrentCache and jamba's
HybridCache, through Engine, BatchEngine and the scheduler's rules.

The files are the port's synthetic tiny shapes (models/synth.py) at
Q4_K_M, one a name. Tolerances: in the "dense" weight mode with f32
activations and an f32 cache both packages compute the same f32 arithmetic
in another order (the doubling scan against jax.lax.associative_scan):
NMSE ≤ 1e-6 (the runs here land near 1e-13). Packed planes, bf16
activations and a bf16 K/V store: NMSE ≤ 1e-3 (tests/test_torch_slice.py's
bound), the JAX side on its device repack (`TPULLM_DEVICE_REPACK=1`). The
conv and the two scans as functions: NMSE ≤ 1e-10 (f32 both, another order
of the same products). Prompts of 13 tokens (the ladder's 8 + 1 × 5: few
JAX compiles) on every name, 600 (512, 32, 32, 8, 8, 8) on tiny-mamba2 and
tiny-jamba.

The JAX Engine's reset leaves a recurrent state as it is (it marks only a
ring empty), so the pairs here zero the JAX cache on reset; the port's
reset zeroes its own."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bloom import jax_device_load
from test_torch_llama_aliases import assert_hparams_match
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models import mamba as jmamba
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.runtime.speculative import DraftModelSpeculator as JDraft
from tpullm.runtime.speculative import generate_speculative as jgenerate_speculative

from tpullm_torch.convert import params_from_jax
from tpullm_torch.models import jamba, mamba
from tpullm_torch.models.registry import _REGISTRY, get_arch
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.runtime import state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine, recurrent_chunks
from tpullm_torch.runtime.fit import fit_params
from tpullm_torch.runtime.recurrent import RecurrentCache
from tpullm_torch.runtime.speculative import (DraftModelSpeculator, NgramSpeculator,
                                              generate_speculative)
from tpullm_torch.server.scheduler import GenRequest, Scheduler

F32_NMSE = 1e-6  # dense f32 weights and cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and K/V
FN_NMSE = 1e-10  # the conv and the scans as functions, f32 both
NAMES = {"tiny-mamba": "mamba", "tiny-falcon-mamba": "falcon-mamba", "tiny-mamba2": "mamba2",
         "tiny-jamba": "jamba", "tiny-nemotron-h": "nemotron_h",
         "tiny-granite-h": "granitehybrid", "tiny-nemotron-h-moe": "nemotron_h_moe",
         "tiny-falcon-h1": "falcon-h1"}
SHAPE_NAMES = tuple(NAMES)
MAX_SEQ = 64
LONG = 600  # tokens of the long prompt: the ladder's 512, 32, 32, 8, 8, 8
LONG_SEQ = 640


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 370) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


def _zero_jax(je) -> None:
    """The JAX engine's reset, and its recurrent state zeroed (its reset
    leaves the state as it is)."""
    je.reset()
    je.cache = jax.tree_util.tree_map(jnp.zeros_like, je.cache)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("recurrent")
    return {s: str(make_synthetic_llama_gguf(d / f"{s}.gguf", shape=s, seed=0))
            for s in SHAPE_NAMES}


@pytest.fixture(scope="module")
def engines(files):
    """get(shape, dense, max_seq) → a reset (port, JAX) Engine pair, each
    made once: dense f32 weights and cache, or the packed file with a bf16
    store."""
    made = {}
    with jax_device_load():
        def get(shape, dense, max_seq=MAX_SEQ):
            key = (shape, dense, max_seq)
            if key not in made:
                path = files[shape]
                made[key] = (
                    (Engine(path, device="cpu", max_seq=max_seq, mode="dense",
                            dtype=torch.float32, kv_dtype=torch.float32),
                     JEngine(path, max_seq=max_seq, mode="dense", dtype=jnp.float32,
                             kv_dtype=jnp.float32)) if dense
                    else (Engine(path, device="cpu", max_seq=max_seq),
                          JEngine(path, max_seq=max_seq, kv_dtype=jnp.bfloat16)))
            te, je = made[key]
            te.reset()
            _zero_jax(je)
            return te, je
        yield get


def _spy_forward(monkeypatch, eng, key=lambda tokens: int(tokens.shape[1])) -> list:
    """key(tokens) (the row count) of every forward `eng` runs from here on."""
    rows = []
    fwd = eng.arch.forward

    def spied(hp, params, tokens, *a, **kw):
        rows.append(key(tokens))
        return fwd(hp, params, tokens, *a, **kw)

    monkeypatch.setattr(eng, "arch", dataclasses.replace(eng.arch, forward=spied))
    return rows


# ---------------------------------------------------------------------------
# the registry, hparams and the synthetic shapes
# ---------------------------------------------------------------------------

def test_registry_maps_the_recurrent_archs():
    """mamba (falcon-mamba) and mamba2 on models/mamba.py with the
    RecurrentCache; jamba (nemotron_h, granitehybrid, nemotron_h_moe) and
    falcon-h1 on models/jamba.py with the HybridCache; all recurrent; 64
    names."""
    for arch in ("mamba", "falcon-mamba", "mamba2"):
        spec = get_arch(arch)
        assert (spec.build_params, spec.forward, spec.make_cache, spec.recurrent) == \
            (mamba.build_params, mamba.forward, RecurrentCache.new, True)
    for arch in ("jamba", "nemotron_h", "granitehybrid", "nemotron_h_moe", "falcon-h1"):
        spec = get_arch(arch)
        fwd = jamba.forward_falcon_h1 if arch == "falcon-h1" else jamba.forward
        assert (spec.build_params, spec.forward, spec.make_cache, spec.recurrent) == \
            (jamba.build_params, fwd, jamba.HybridCache.new, True)
    assert not get_arch("llama").recurrent
    assert len(_REGISTRY) == 64


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_hparams_match_jax(files, shape):
    """Every HParams field equals the JAX package's, the SSM fields and the
    per-layer arrays among them (0 KV heads on a mixer layer; nemotron-h's
    FFN widths 0 but on its FFN-only layer), the scalars the maxima."""
    hp = assert_hparams_match(files[shape])
    assert hp.arch == NAMES[shape] and hp.ssm_d_conv == 4 and hp.ssm_d_inner == 512
    assert hp.ssm_dt_b_c_rms == (hp.arch == "falcon-mamba")
    kinds = jamba.layer_kinds(hp) if hp.arch not in ("mamba", "falcon-mamba", "mamba2") \
        else None
    if hp.arch in ("jamba", "nemotron_h", "granitehybrid", "nemotron_h_moe"):
        assert hp.n_head_kv == max(hp.n_head_kv_arr) == 2 and 0 in hp.n_head_kv_arr
        assert any(a for a, _ in kinds) and any(m for _, m in kinds)
    if hp.arch == "nemotron_h":
        assert hp.n_ff_arr == (0, 0, 512, 0) and kinds[2] == (False, False)
    if hp.arch == "granitehybrid":
        assert (hp.embd_scale, hp.logit_scale, hp.attn_scale) == (12.0, 6.0, 0.015625)
        assert not hp.rope_finetuned
    if hp.arch == "falcon-h1":
        assert kinds == ((True, True),) * 2 and hp.rope.style == "neox"


@pytest.mark.parametrize("shape,want", [
    ("falcon-mamba-7b", dict(n_layer=64, n_embd=4096, n_vocab=65024, ssm=(8192, 16, 256, 0, 4))),
    ("mamba-codestral-7b", dict(n_layer=64, n_embd=4096, n_vocab=32768,
                                ssm=(8192, 128, 128, 8, 4))),
    ("jamba-mini-1.5", dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8, n_ff=14336,
                            n_expert=16, n_expert_used=2, n_vocab=65536,
                            ssm=(8192, 16, 256, 0, 4))),
    ("granite-4.0-h-tiny", dict(n_layer=40, n_embd=1536, n_head=12, n_head_kv=4, n_expert=64,
                                n_expert_used=6, n_ff_exp=512, n_ff_shexp=1024,
                                n_vocab=100352, ssm=(3072, 128, 48, 1, 4))),
    ("nemotron-h-8b", dict(n_layer=52, n_embd=4096, n_head=32, n_head_kv=8, n_ff=21504,
                           n_vocab=131072, ssm=(8192, 128, 128, 8, 4)))])
def test_published_shapes(shape, want):
    """The published widths; every quantized 2-D tensor's K a multiple of
    256 and its N of 4 (qmm's rule: no dequantize route, no fallback
    type), the 1-D tensors and the conv kernels F32; 8 layers sized
    without drawing, holding the pattern's kinds."""
    cfg = SHAPES[shape]
    assert {k: cfg[k] for k in want} == want
    assert len(cfg["pattern"]) == len(cfg["ffn"]) == cfg["n_layer"]
    w = synthetic_writer("unused.gguf", shape=shape, n_layer=8)
    for r in w._tensors:
        if r.ggml_type.name == "F32":
            assert len(r.shape) == 1 or "conv1d" in r.name or r.name.endswith(
                ("ssm_a", "ffn_gate_inp.weight", "output.weight", "token_embd.weight")), r.name
        elif "_exps" not in r.name:
            assert r.shape[0] % 256 == 0 and r.shape[1] % 4 == 0, (r.name, r.shape)
    names = {r.name for r in w._tensors}
    if shape == "jamba-mini-1.5":  # one whole period: attention at 4, experts on odd layers
        assert "blk.4.attn_q.weight" in names and "blk.3.attn_q.weight" not in names
        assert "blk.1.ffn_up_exps.weight" in names and "blk.2.ffn_up.weight" in names
        assert "blk.0.ssm_dt_norm.weight" in names
    if shape == "granite-4.0-h-tiny":
        assert "blk.5.attn_q.weight" in names and "blk.0.ffn_gate_shexp.weight" in names
        assert "output.weight" not in names
    if shape == "nemotron-h-8b":
        assert "blk.7.attn_q.weight" in names and "blk.1.ffn_up.weight" in names
        assert "blk.1.ffn_gate.weight" not in names


# ---------------------------------------------------------------------------
# the conv and the scans against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 13, 40])
def test_causal_conv_matches_jax(T):
    """The k-tap shifted sum over a nonzero cached tail: the output and the
    new tail."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 48)).astype(np.float32)
    st = rng.standard_normal((2, 48, 3)).astype(np.float32)
    w, b = rng.standard_normal((48, 4)).astype(np.float32), rng.standard_normal(48).astype(
        np.float32)
    y, tail = mamba.causal_conv(*(torch.from_numpy(a) for a in (x, st, w, b)))
    jy, jtail = jmamba._causal_conv(*(jnp.asarray(a) for a in (x, st, w, b)))
    assert _nmse(y.numpy(), np.asarray(jy)) <= FN_NMSE
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("T", [1, 13, 40])
def test_selective_scan_matches_jax(T):
    """The mamba1 scan from a nonzero state: y and the last state."""
    rng = np.random.default_rng(10 + T)
    B, D, S = 2, 32, 16
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dt = np.exp(rng.uniform(-6, 0, (B, T, D))).astype(np.float32)
    A = -np.tile(np.arange(1.0, S + 1.0), (D, 1)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, S)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, D, S)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, h0)
    y, h = mamba.selective_scan(*(torch.from_numpy(a) for a in args))
    jy, jh = jmamba._selective_scan(*(jnp.asarray(a) for a in args))
    assert _nmse(y.numpy(), np.asarray(jy)) <= FN_NMSE
    assert _nmse(h.numpy(), np.asarray(jh)) <= FN_NMSE


@pytest.mark.parametrize("T", [1, 13, 40])
def test_ssd_scan_matches_jax(T):
    """The Mamba-2 scan (per-head decay, B/C shared by 2 groups) from a
    nonzero state: y and the last state."""
    rng = np.random.default_rng(20 + T)
    B, H, hd, G, S = 2, 4, 8, 2, 16
    x = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    dt = np.exp(rng.uniform(-6, 0, (B, T, H))).astype(np.float32)
    A = -rng.uniform(1, 16, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, G, S)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, H, hd, S)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, h0)
    y, h = mamba.ssd_scan(*(torch.from_numpy(a) for a in args), G)
    jy, jh = jmamba._ssd_scan(*(jnp.asarray(a) for a in args), G)
    assert _nmse(y.numpy(), np.asarray(jy)) <= FN_NMSE
    assert _nmse(h.numpy(), np.asarray(jh)) <= FN_NMSE


def test_recurrent_chunks_follow_the_jax_ladder():
    """Pieces of the prefill cap, each cut greedily by (512, 128, 32, 8, 1)."""
    assert recurrent_chunks(600, 4096) == [512, 32, 32, 8, 8, 8]
    assert recurrent_chunks(13, 64) == [8, 1, 1, 1, 1, 1]
    assert recurrent_chunks(1200, 1024) == [512, 512, 128, 32, 8, 8]
    assert recurrent_chunks(100, 64) == [32, 32, 32, 1, 1, 1, 1]


# ---------------------------------------------------------------------------
# the forwards against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_dense_logits_match_jax(engines, shape, monkeypatch):
    """Dense f32: a 13-token prompt (forwards of 8, 1, 1, 1, 1, 1 rows: no
    pad row) and three decode steps within F32_NMSE."""
    te, je = engines(shape, True)
    rows = _spy_forward(monkeypatch, te)
    prompt = _ids(13, 13)
    errs = [_nmse(te.prefill(prompt), je.prefill(prompt))]
    assert rows == [8, 1, 1, 1, 1, 1]
    for tok in (7, 200, 33):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= F32_NMSE, errs


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_packed_logits_and_greedy_ids_match_jax(engines, shape):
    """Q4_K_M planes, bf16: a 13-token prompt and three decode steps within
    NMSE_BOUND; the greedy ids of the port's decode graph step (chunks of
    4) equal the JAX Engine's greedy loop."""
    te, je = engines(shape, False)
    prompt = _ids(13, 31)
    errs = [_nmse(te.prefill(prompt), je.prefill(prompt))]
    for tok in (100, 17, 301):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= NMSE_BOUND, errs
    te.reset()
    _zero_jax(je)
    got = te.generate_tokens_device(prompt, 12, chunk=4, stop_on_eog=False)
    assert got == list(je.generate_tokens(prompt, 12, stop_on_eog=False))


@pytest.mark.parametrize("shape", ["tiny-mamba2", "tiny-jamba"])
def test_600_token_prompt_matches_jax(engines, shape, monkeypatch):
    """Dense f32, 600 tokens: the forwards run 512, 32, 32, 8, 8, 8 rows
    (the JAX ladder's edges, no pad row), the last logits and two decode
    steps within F32_NMSE."""
    te, je = engines(shape, True, LONG_SEQ)
    rows = _spy_forward(monkeypatch, te)
    prompt = _ids(LONG, 6)
    errs = [_nmse(te.prefill(prompt), je.prefill(prompt))]
    assert rows == [512, 32, 32, 8, 8, 8] and te.n_past == LONG
    for tok in (9, 99):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= F32_NMSE, errs


@pytest.mark.parametrize("shape", ["tiny-mamba", "tiny-mamba2", "tiny-jamba", "tiny-falcon-h1"])
def test_decode_matches_prefill(engines, shape):
    """Dense f32, the port alone: every row of prefill_all_logits (one
    forward of 13 exact rows) equals a 5-token prefill's logits and the
    decode steps after it, the logits graph's and the decode graph's
    greedy steps alike."""
    te, _ = engines(shape, True)
    toks = _ids(13, 44)
    every = te.prefill_all_logits(toks)
    te.reset()
    got = [te.prefill(toks[:5])]
    got += [te.decode_step(t) for t in toks[5:]]
    assert _nmse(np.stack(got), every[4:]) <= F32_NMSE
    te.reset()
    ids = te.generate_tokens_device(toks, 6, chunk=3, stop_on_eog=False)
    te.reset()
    want, logits = [], te.prefill(toks)
    for _ in range(6):
        want.append(int(np.argmax(logits)))
        logits = te.decode_step(want[-1])
    assert ids == want


def test_reset_and_new_cache_zero_the_state(engines):
    """After a prompt the state is nonzero; reset zeroes it in place (the
    same buffers: the graphs stay valid), new_cache makes a zero one."""
    te, _ = engines("tiny-jamba", True)
    te.prefill(_ids(9, 3))
    conv, ssm = te.cache.conv, te.cache.ssm
    assert ssm.abs().sum() > 0 and conv.abs().sum() > 0
    te.reset()
    assert te.cache.ssm is ssm and not ssm.any() and not conv.any()
    te.prefill(_ids(9, 3))
    te.new_cache()
    assert te.cache.ssm is not ssm and not te.cache.ssm.any() and te.n_past == 0


# ---------------------------------------------------------------------------
# BatchEngine: idle and freed slots, the scheduler's rules
# ---------------------------------------------------------------------------

def _batch_rows(eng, long: bool = False) -> list:
    """Slots 0 and 1 prefilled (one after another), decode steps of both and
    of one (the other idle), slot 1 freed and admitted again."""
    rows = []
    got = eng.prefill_slots({0: _ids(LONG if long else 13, 4), 1: _ids(9, 5)})
    rows += [got[0], got[1]]
    for feed in ({0: 101, 1: 102}, {0: 103}, {1: 104}):
        got = eng.decode_batch(feed)
        rows += [got[s] for s in feed]
    eng.free_slot(1)
    rows.append(eng.prefill_slots({1: _ids(9, 6)})[1])
    return rows


@pytest.mark.parametrize("shape,long", [("tiny-mamba", False), ("tiny-jamba", True),
                                        ("tiny-granite-h", False)])
def test_batch_engine_matches_jax(files, shape, long):
    """A 2-slot BatchEngine against the JAX BatchEngine on dense f32 weights
    and cache: every row within F32_NMSE (tiny-jamba with a 600-token prompt
    in slot 0: the port's chunks 512, 32, 32, 8, 8, 8, the JAX package's
    512, 88); can_shift false in both."""
    max_seq = LONG_SEQ if long else MAX_SEQ
    kw = dict(n_slots=2, max_seq=max_seq, prefill_chunk=512, mode="dense")
    te = BatchEngine(files[shape], device="cpu", dtype=torch.float32, kv_dtype=torch.float32,
                     **kw)
    with jax_device_load():
        je = JBatchEngine(files[shape], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert te.can_shift is je.can_shift is False
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te, long), _batch_rows(je, long))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs


@pytest.mark.parametrize("shape", ["tiny-mamba2", "tiny-nemotron-h"])
def test_idle_slot_keeps_its_state_and_a_freed_slot_reads_zero(files, shape, monkeypatch):
    """Packed, 3 slots: slot 1's conv/ssm state (and, on the hybrid, its
    K/V rows) is bit-for-bit the same after slot 0's prefill and decode
    steps and after slot 2's; a freed slot's state reads zero; prefill
    rounds never run two slots jointly: a round of two slots is one
    forward of one row a slot, each at its exact length, and the idle
    slots run no layer."""
    eng = BatchEngine(files[shape], device="cpu", n_slots=3, max_seq=MAX_SEQ)
    eng.prefill_slots({1: _ids(11, 8)})
    cache = eng.cache
    before = [a[:, 1].clone() for a in (cache.conv, cache.ssm)]
    kv = [a[:, 1].clone() for a in (getattr(cache, "k", None), getattr(cache, "v", None))
          if a is not None]
    eng.prefill_slots({0: _ids(13, 9), 2: _ids(5, 10)})
    eng.decode_batch({0: 11, 2: 12})
    eng.decode_batch_greedy({0: 13})
    after = [a[:, 1] for a in (cache.conv, cache.ssm)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, b[:, 1]) for a, b in zip(kv, (getattr(cache, "k", None),
                                                            getattr(cache, "v", None))))
    assert cache.ssm[:, 0].abs().sum() > 0
    eng.free_slot(0)
    assert not cache.conv[:, 0].any() and not cache.ssm[:, 0].any()
    assert torch.equal(cache.ssm[:, 1], before[1])
    shapes = _spy_forward(monkeypatch, eng, key=lambda tokens: tuple(tokens.shape))
    eng.prefill_slots_round({0: _ids(4, 1), 2: _ids(3, 1)})
    assert shapes == [(1, 4), (1, 3)]
    assert torch.equal(cache.ssm[:, 1], before[1])


def test_scheduler_reuses_a_prefix_only_where_it_extends_the_state(files, tmp_path):
    """The JAX rules: a slot's cached prefix counts only where the new
    prompt extends every token its state absorbed (n_common == n_past);
    then only the tail is fed, and the logits equal a fresh prefill's;
    otherwise the slot starts from zero. Speculation on a recurrent target
    is switched off (its draft engine dropped), and a recurrent draft of a
    KV-cache target is refused."""
    eng = BatchEngine(files["tiny-mamba"], device="cpu", n_slots=2, max_seq=MAX_SEQ,
                      mode="dense", dtype=torch.float32, kv_dtype=torch.float32)
    sched = Scheduler(eng, spec_type="ngram_simple")
    assert sched.spec_type is None
    assert Scheduler(eng, draft_engine=eng).draft_engine is None
    target = BatchEngine(make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny"),
                         device="cpu", n_slots=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        Scheduler(target, draft_engine=eng)
    slot, first = sched.slots[0], _ids(10, 12)
    eng.prefill_slot(0, first)
    slot.tokens = first + [77]  # the last sampled token, never decoded back in
    longer = first + [77, 5, 6]
    tail = sched._prepare_admit(slot, GenRequest(longer))
    assert tail == [77, 5, 6] and int(eng.n_past[0]) == 10
    got = eng.prefill_slot(0, tail)
    fresh = BatchEngine(eng.model, n_slots=1, max_seq=MAX_SEQ, mode="dense",
                        dtype=torch.float32, kv_dtype=torch.float32)
    assert _nmse(got, fresh.prefill_slot(0, longer)) <= F32_NMSE
    slot.tokens = longer
    shorter = first[:6] + [9, 9]
    tail = sched._prepare_admit(slot, GenRequest(shorter))
    assert tail == shorter and int(eng.n_past[0]) == 0
    assert not eng.cache.ssm[:, 0].any()


# ---------------------------------------------------------------------------
# the refusals: speculation and state files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["tiny-mamba", "tiny-jamba"])
def test_speculation_and_state_files_are_refused(engines, files, shape, tmp_path):
    """generate_speculative on a recurrent target, a recurrent draft model,
    the verify graph, BatchEngine.verify_step, and state files both ways
    raise a ValueError that names ROADMAP.md §3."""
    te, _ = engines(shape, False)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        generate_speculative(te, NgramSpeculator(n_draft=4), _ids(9, 1), 8)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        DraftModelSpeculator(te)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        te.verify_logits([1, 2, 3])
    te.prefill(_ids(9, 1))
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        state.save_state(te, tmp_path / "s.npz")
    np.savez(tmp_path / "other.npz", magic=state.MAGIC)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        state.load_state(te, tmp_path / "other.npz")
    be = BatchEngine(te.model, n_slots=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        be.verify_step({0: [1, 2]}, 3)
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        state.save_slot_state(be, 0, tmp_path / "slot.npz")


def test_cli_refuses_a_prompt_cache_before_generating(files, tmp_path, capsys):
    """The cli with --prompt-cache on a recurrent model exits with the
    ROADMAP.md §3 message before it prints or generates anything, and
    writes no file."""
    from tpullm_torch.tools import cli

    session = tmp_path / "session.npz"
    with pytest.raises(SystemExit, match="ROADMAP.md §3"):
        cli.main(["-m", files["tiny-mamba"], "-p", "the the", "-n", "4", "--temp", "0",
                  "--device", "cpu", "-c", str(MAX_SEQ), "--prompt-cache", str(session)])
    assert capsys.readouterr().out == "" and not session.exists()


@pytest.mark.parametrize("shape", ["tiny-mamba", "tiny-jamba"])
def test_embeddings_run_one_row_from_a_zero_state(engines, shape, monkeypatch):
    """Pooled embeddings of a 13-token prompt (dense f32): Engine's and a
    2-slot BatchEngine's (slot 1 holding another prompt) against the JAX
    Engine's from a zero state, within F32_NMSE. The BatchEngine's is one
    forward of one row; slot 1's state is kept bit for bit and slot 0's
    reads zero after."""
    te, je = engines(shape, True)
    prompt = _ids(13, 21)
    ref = je.embed_tokens(prompt)
    got = te.embed_tokens(prompt)
    be = BatchEngine(te.model, n_slots=2, max_seq=MAX_SEQ, mode="dense", dtype=torch.float32,
                     kv_dtype=torch.float32)
    be.prefill_slot(1, _ids(9, 22))
    keep = [a[:, 1].clone() for a in (be.cache.conv, be.cache.ssm)]
    shapes = _spy_forward(monkeypatch, be, key=lambda tokens: tuple(tokens.shape))
    emb = be.embed_tokens(0, prompt)
    assert shapes == [(1, 13)] and int(be.n_past[0]) == 0
    assert all(torch.equal(a, b[:, 1]) for a, b in zip(keep, (be.cache.conv, be.cache.ssm)))
    assert not be.cache.conv[:, 0].any() and not be.cache.ssm[:, 0].any()
    errs = [_nmse(got, ref), _nmse(emb, ref)]
    assert max(errs) <= F32_NMSE, errs


def test_jax_speculation_leaves_rejected_drafts_in_the_state(engines, tmp_path):
    """The JAX package's generate_speculative rewinds n_past alone: on
    tiny-mamba (dense f32), with a tiny llama draft whose drafts it
    rejects, its state at the end is not the state of the tokens it kept
    (a fresh prefill of them), while its plain greedy loop's is. That is
    why the port refuses speculation on recurrent state (ROADMAP.md §3,
    "Speculation on recurrent state"). The tiny model's greedy ids repeat
    one token, so the ids agree; the state shows the fault."""
    _, je = engines("tiny-mamba", True)
    with jax_device_load():
        draft = JEngine(make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny"),
                        max_seq=MAX_SEQ, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32)
    prompt = _ids(9, 0)

    def state_against_fresh(out):
        """NMSE of the engine's state against a fresh prefill of the tokens
        its n_past counts."""
        got, fed = np.asarray(je.cache.ssm), (prompt + out)[:je.n_past]
        _zero_jax(je)
        je.prefill(fed)
        return _nmse(got, np.asarray(je.cache.ssm))

    out, stats = jgenerate_speculative(je, JDraft(draft, n_draft=3), prompt, 16,
                                       stop_on_eog=False)
    assert stats.n_drafted > stats.n_accepted  # drafts were rejected
    assert state_against_fresh(out) > 1e-4
    _zero_jax(je)
    assert state_against_fresh(list(je.generate_tokens(prompt, 16, stop_on_eog=False))) <= \
        FN_NMSE


# ---------------------------------------------------------------------------
# the JAX trees carried across, the fit and the cache's report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["tiny-falcon-mamba", "tiny-jamba", "tiny-nemotron-h-moe"])
def test_params_from_jax_carries_the_trees(engines, shape):
    """The JAX Engine's packed tree (conv_w, conv_b, A_log, D, dt_bias, the
    dt/B/C norms, ssm_norm, exp_probs_b, the shared experts) carried across
    gives the port's own logits within NMSE_BOUND."""
    te, je = engines(shape, False)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    own = te.params
    try:
        prompt = _ids(9, 15)
        want = te.prefill(prompt)
        te.params = tree
        te.reset()
        assert _nmse(te.prefill(prompt), want) <= NMSE_BOUND
    finally:
        te.params = own
        te.reset()


def test_fit_and_report_count_the_state(files):
    """fit_params takes the state once a slot (RecurrentCache: no bytes a
    position; HybridCache: K/V of its attention layer only) and Engine's
    report names it."""
    res = fit_params(files["tiny-mamba"], want_seq=4096, want_slots=2, hbm_bytes=8 << 20)
    # 2 layers × (conv 512 × 3 + ssm 512 × 16) f32
    assert (res.kv_bytes_per_token, res.state_bytes_per_slot) == (0, 2 * 4 * 512 * 19)
    assert res.max_seq == 4096 and res.n_slots == 2
    res = fit_params(files["tiny-jamba"], want_seq=4096, hbm_bytes=64 << 20)
    assert res.kv_bytes_per_token == 2 * 2 * 64 * 2  # one attention layer of 4: K and V bf16
    assert res.state_bytes_per_slot == 3 * 4 * 512 * 19
    eng = Engine(files["tiny-jamba"], device="cpu", max_seq=MAX_SEQ, kv_dtype="q8_0")
    assert eng.cache.k.dtype == torch.bfloat16  # the JAX rule for a named type
    assert "HybridCache bfloat16 (512 B a position, 116736 B of f32 state" in eng.report()
