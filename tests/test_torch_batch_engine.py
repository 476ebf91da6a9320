"""Port parity of runtime/batch_engine.py: the port's BatchEngine against
the JAX package's on the same tiny synthetic GGUF (n_slots 3, max_seq 128,
prefill chunk 32, as tests/test_server.py builds it), both on the CPU, in
weight modes dense and quant: per-slot logits with mixed and idle offsets,
greedy ids, joint against sequential prefill, slot isolation, idle slots'
cache bytes for every cache type, the joint round near the context end,
shift_slot, slot state files across the packages, embeddings, and the
batched decode step that the card captures (no value read back). The JAX
side loads through its device repack (`TPULLM_DEVICE_REPACK=1`, the load
the port mirrors; its host load dequantizes the embedding in f32, the port
through bf16 scales, which alone moves the tiny model's logits by an NMSE
of ≈ 0.1 on some tokens).

Logits are held to NMSE ≤ 1e-3 (the bound of tests/test_torch_slice.py: the
plain versions round where the kernels do, but the f32 sums run in another
order). The tiny models' greedy ids are one token over and over (the head
favours it), so the ids checks are weak by themselves; the logits carry
the comparison."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime import state as jstate
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.kvcache import KVCache

NMSE_BOUND = 1e-3
SLOTS, MAX_SEQ, CHUNK = 3, 128, 32
PROMPTS = {0: "the quick brown fox jumps over the lazy dog", 2: "hello world"}
# the tiny MoE's prompts: no routing decision flips between the packages on
# them (its margins go down to 1e-3)
MOE_PROMPTS = {0: "hello world", 2: "the quick brown fox"}
# teacher-forced decode inputs, a step a row: None leaves the slot idle
FEED = [{0: 300, 2: 301}, {0: 302}, {2: 303}, {0: 304, 2: 305}]
HOST_READS = ("_local_scalar_dense", "nonzero", "unique", "item")


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    return {"tiny": make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0),
            "tiny-1l": make_synthetic_llama_gguf(d / "tiny1l.gguf", shape="tiny", seed=0,
                                                 n_layer=1),
            "tiny-moe": make_synthetic_llama_gguf(d / "tiny-moe.gguf", shape="tiny-moe",
                                                  seed=0)}


def _jax(path, **kw):
    """The JAX BatchEngine, loaded through its device repack."""
    kw = {"n_slots": SLOTS, "max_seq": MAX_SEQ, "prefill_chunk": CHUNK, "mode": "dense", **kw}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        return JBatchEngine(path, **kw)


@pytest.fixture(scope="module")
def jax_engines(paths):
    """The JAX BatchEngine per (model, weight mode), each made once (its
    programs compile per shape); its slots are freed by each test."""
    made = {}

    def get(shape, mode="dense"):
        if (shape, mode) not in made:
            made[shape, mode] = _jax(paths[shape], mode=mode)
        return _fresh_jax(made[shape, mode])
    return get


def _fresh_jax(je):
    for s in range(je.n_slots):
        je.free_slot(s)
    return je


def _port(path, mode="dense", **kw):
    kw = {"n_slots": SLOTS, "max_seq": MAX_SEQ, "prefill_chunk": CHUNK, **kw}
    return BatchEngine(path, device="cpu", mode=mode, **kw)


@pytest.mark.parametrize("shape,mode", [("tiny", "dense"), ("tiny", "quant"),
                                        ("tiny-moe", "quant")])
def test_decode_batch_logits_match_jax(paths, jax_engines, shape, mode):
    """A joint prefill of slots 0 and 2 (slot 1 idle), then teacher-forced
    batched steps with mixed offsets and idle slots (FEED): every fed
    slot's logits within the NMSE bound of the JAX engine's, and the greedy
    step's ids equal to the JAX greedy step's. The MoE's joint prefill
    (3 × 16 rows) takes the all-experts regime, its decode steps (3 rows)
    the gather regime."""
    te, je = _port(paths[shape], mode), jax_engines(shape, mode)
    prompts = MOE_PROMPTS if shape == "tiny-moe" else PROMPTS
    ids = {s: te.tokenizer.tokenize(p, add_special=True) for s, p in prompts.items()}
    got, ref = te.prefill_slots(ids), je.prefill_slots(ids)
    for s in ids:
        assert _nmse(got[s], ref[s]) <= NMSE_BOUND, s
    for step, feed in enumerate(FEED):
        got, ref = te.decode_batch(feed), je.decode_batch(feed)
        assert set(got) == set(feed)
        for s in feed:
            assert _nmse(got[s], ref[s]) <= NMSE_BOUND, (step, s)
    assert list(te.n_past) == list(je.n_past)
    feed = {0: 306, 1: 307, 2: 308}
    te.prefill_slot(1, [1, 5, 9])
    je.prefill_slot(1, [1, 5, 9])
    assert te.decode_batch_greedy(feed) == je.decode_batch_greedy(feed)


def test_decode_batch_greedy_is_the_logits_argmax(paths):
    """The ids-only step's ids are the argmax of the logits step's rows on
    the same state (two engines, one greedy and one not)."""
    a, b = _port(paths["tiny"]), _port(paths["tiny"])
    for e in (a, b):
        e.prefill_slots({0: [1, 5, 9, 2, 7], 1: [3, 8, 4]})
    feed = {0: 11, 1: 12}
    ref = {s: int(np.argmax(r)) for s, r in a.decode_batch(feed).items()}
    assert b.decode_batch_greedy(feed) == ref


def test_step_width_follows_the_highest_slot(paths):
    """A decode step runs over the first max(slot) + 1 slots (a runner per
    width): slot 0 alone takes the width-1 step, whose logits equal the
    full-width step's row 0 on the same state (NMSE ≤ 1e-10: the same
    function, products of another row count); the slots past the width
    keep their cache bytes."""
    a, b = _port(paths["tiny"]), _port(paths["tiny"])
    for e in (a, b):
        e.prefill_slots({0: [1, 5, 9, 2, 7], 2: [3, 8, 4]})
    got = a.decode_batch({0: 11})[0]
    assert list(a._runners) == [1]
    before = b.cache.k[:, 1:].clone()
    with torch.inference_mode():
        full = b.runner(SLOTS)
        full.run(b._inputs({0: 11}, SLOTS))
    assert _nmse(got, full.logits[0].numpy()) <= 1e-10
    assert torch.equal(b.cache.k[:, 1:], before)
    a.decode_batch_greedy({0: 12, 2: 13})
    assert set(a._runners) == {1, 3}


def test_joint_prefill_equals_sequential(paths):
    """Joint rounds (prefill chunk 4: three rounds, slots dropping out)
    give each slot's sequential prefill, and the caches agree after: one
    decode step per slot (allclose at the JAX test's 2e-4)."""
    prompts = {0: [1, 5, 9, 2, 7, 11, 4], 1: [3, 8, 4], 2: [6, 2, 9, 9, 1]}
    a, b = _port(paths["tiny"], prefill_chunk=4), _port(paths["tiny"], prefill_chunk=4)
    ref = {s: a.prefill_slot(s, toks) for s, toks in prompts.items()}
    got = b.prefill_slots(prompts)
    for s in prompts:
        np.testing.assert_allclose(got[s], ref[s], rtol=2e-4, atol=2e-4)
        assert b.n_past[s] == a.n_past[s] == len(prompts[s])
    feed = {s: int(np.argmax(ref[s])) for s in prompts}
    da, db = a.decode_batch(feed), b.decode_batch(feed)
    for s in prompts:
        np.testing.assert_allclose(db[s], da[s], rtol=2e-4, atol=2e-4)


def test_slot_isolation(paths):
    """Decoding in one slot leaves another's state as it was: slot 0's next
    logits equal a fresh engine's."""
    e = _port(paths["tiny"])
    t1 = e.tokenizer.tokenize("the quick", add_special=True)
    t2 = e.tokenizer.tokenize("hello world over the", add_special=True)
    e.prefill_slot(0, t1)
    e.prefill_slot(1, t2)
    for tok in (5, 9, 12):
        e.decode_batch({1: tok})
    out = e.decode_batch({0: 4})[0]
    f = _port(paths["tiny"])
    f.prefill_slot(0, t1)
    np.testing.assert_array_equal(out, f.decode_batch({0: 4})[0])


def _tensors(cache):
    return [cache.k, cache.v] if isinstance(cache, KVCache) else \
        [cache.k_q, cache.v_q, cache.k_s, cache.v_s]


@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8_0"])
def test_idle_slots_cache_bytes_unchanged(paths, kv):
    """A joint prefill round and batched decode steps with slots 1 and 2
    idle (offset −1) leave those slots' cache bytes as they were (filled
    with noise first, so a stray write would show), and write slot 0's
    rows up to its bucket."""
    e = _port(paths["tiny"], kv_dtype=kv)
    g = torch.Generator().manual_seed(0)
    for t in _tensors(e.cache):
        t.copy_((torch.rand(t.shape, generator=g) * 100 - 50).to(t.dtype))
    before = [t.clone() for t in _tensors(e.cache)]
    e.prefill_slots_round({0: [1, 5, 9, 2, 7]})
    e.decode_batch({0: 11})
    e.decode_batch_greedy({0: 12})
    for t, b in zip(_tensors(e.cache), before):
        assert torch.equal(t[:, 1:], b[:, 1:])
        assert not torch.equal(t[:, 0, :, :7], b[:, 0, :, :7])
        assert torch.equal(t[:, 0, :, 8:], b[:, 0, :, 8:])  # the bucket of 8 and no further


def test_joint_round_mixed_offsets_near_context_end(paths, jax_engines):
    """JAX test_joint_round_mixed_offsets_near_context_end on the port (f32
    weights and cache): a 1-token tail at offset 29 of a 32-slot cache
    shares a joint round (bucket 16) with a 16-token chunk; each slot gets
    its sequential prefill's logits, the caches agree after, and the JAX
    engine's joint round gives the same logits."""
    def fresh():
        return _port(paths["tiny"], n_slots=2, max_seq=32, dtype=torch.float32,
                     kv_dtype=torch.float32, prefill_chunk=16)

    long_toks, head = list(range(3, 19)), list(range(3, 32))
    a = fresh()
    a.prefill_slot(0, head)
    ref0, ref1 = a.prefill_slot(0, [40]), a.prefill_slot(1, long_toks)
    b = fresh()
    b.prefill_slot(0, head)
    got = b.prefill_slots({0: [40], 1: long_toks})
    np.testing.assert_allclose(got[0], ref0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1], ref1, rtol=2e-4, atol=2e-4)
    feed = {0: int(np.argmax(ref0)), 1: int(np.argmax(ref1))}
    da, db = a.decode_batch(feed), b.decode_batch(feed)
    for s in (0, 1):
        np.testing.assert_allclose(db[s], da[s], rtol=2e-4, atol=2e-4)
    je = _jax(paths["tiny"], n_slots=2, max_seq=32, dtype=jnp.float32, kv_dtype=jnp.float32,
              prefill_chunk=16)
    je.prefill_slot(0, head)
    jref = je.prefill_slots({0: [40], 1: long_toks})
    for s in (0, 1):
        assert _nmse(got[s], jref[s]) <= NMSE_BOUND


def _shift_case(eng):
    """Slot 0: a prompt, then its middle dropped by shift_slot (the last 4
    rows moved to rows 4..7, K turned by the delta), n_past 8; returns the
    prompt."""
    toks = eng.tokenizer.tokenize("the quick brown fox jumps over the lazy dog",
                                  add_special=True)
    eng.prefill_slot(0, toks)
    S = eng.max_seq
    idx, delta = np.arange(S, dtype=np.int32), np.zeros(S, dtype=np.int32)
    src = len(toks) - 4
    idx[4:8] = np.arange(src, src + 4)
    delta[4:8] = 4 - src
    eng.shift_slot(0, idx, delta)
    eng.rewind(0, 8)
    return toks


@pytest.mark.parametrize("kv", ["f32", "q8_0"])
def test_shift_slot_matches_jax(paths, kv):
    """shift_slot on the one-layer model (f32 weights): the moved and
    turned rows and the next logits equal the JAX engine's after the same
    shift (NMSE), and, as the JAX test shows, the shifted slot gives the
    logits of the compacted sequence prefilled directly (one layer: each
    row depends on its own token only)."""
    te = _port(paths["tiny-1l"], n_slots=2, dtype=torch.float32, kv_dtype=kv)
    je = _jax(paths["tiny-1l"], n_slots=2, dtype=jnp.float32,
              kv_dtype=jnp.float32 if kv == "f32" else "q8_0")
    assert te.can_shift and je.can_shift
    toks = _shift_case(te)
    _shift_case(je)
    if kv == "f32":
        assert _nmse(te.cache.k[:, 0, :, :8].numpy(), np.asarray(je.cache.k[:, 0, :, :8])) <= 1e-6
    else:
        k = te.cache.k_q[:, 0, :, :8].float() * te.cache.k_s[:, 0, :, :8, None]
        jk = np.asarray(je.cache.k_q[:, 0, :, :8], np.float32) * \
            np.asarray(je.cache.k_s[:, 0, :, :8])[..., None]
        assert _nmse(k.numpy(), jk) <= 1e-4
    out = te.decode_batch({0: 7})[0]
    assert _nmse(out, je.decode_batch({0: 7})[0]) <= NMSE_BOUND
    te.prefill_slot(1, toks[:4] + toks[-4:])
    np.testing.assert_allclose(out, te.decode_batch({1: 7})[1], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_slot_state_files_across_packages(paths, jax_engines, tmp_path, direction):
    """A slot saved by one package restores into another slot of the
    other's engine, in place: the same tokens and n_past, and the next
    decode logits of the saver's (NMSE)."""
    te, je = _port(paths["tiny"]), jax_engines("tiny")
    ids = te.tokenizer.tokenize(PROMPTS[0], add_special=True)
    path = tmp_path / "slot.npz"
    if direction == "jax to port":
        saver, loader, save, load = je, te, jstate.save_slot_state, state.load_slot_state
    else:
        saver, loader, save, load = te, je, state.save_slot_state, jstate.load_slot_state
    saver.prefill_slot(2, ids)
    save(saver, 2, path, tokens=ids)
    want = saver.decode_batch({2: 300})[2]
    k_ptr = te.cache.k.data_ptr()
    assert load(loader, 1, path) == ids and int(loader.n_past[1]) == len(ids)
    assert _nmse(loader.decode_batch({1: 300})[1], want) <= NMSE_BOUND
    assert te.cache.k.data_ptr() == k_ptr


def test_slot_state_refuses_q8(paths, tmp_path):
    e = _port(paths["tiny"], kv_dtype="q8_0")
    with pytest.raises(ValueError, match="dense KV cache"):
        state.save_slot_state(e, 0, tmp_path / "q.npz")


def test_embed_tokens_match_jax(paths, jax_engines):
    """The pooled embedding of a slot (mean, L2-normalised): the JAX
    engine's within NMSE, and the slot's n_past 0 after."""
    te, je = _port(paths["tiny"]), jax_engines("tiny")
    ids = te.tokenizer.tokenize("embedding probe", add_special=True)
    got, ref = te.embed_tokens(1, ids), je.embed_tokens(1, ids)
    assert got.shape == (te.hp.n_embd,) and _nmse(got, ref) <= NMSE_BOUND
    assert te.n_past[1] == 0


class _Calls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("width", [1, SLOTS])
def test_batched_step_reads_nothing_back(paths, kv, width):
    """One step of the batched runner (what the card captures as a graph)
    at a width below the slot count (a view of the first slots' cache) and
    at the full width, with slots idle and active: no aten call that reads
    a value back to the host."""
    e = _port(paths["tiny"], kv_dtype=kv)
    e.prefill_slots({0: [1, 5, 9], 2: [3, 8]})
    runner = e.runner(width)
    runner.inputs.copy_(e._inputs({0: 11, 2: 12} if width == SLOTS else {0: 11}, width))
    with torch.inference_mode(), _Calls() as mode:
        runner.step()
    assert len(mode.calls) > 100
    assert not [c for c in mode.calls if any(h in c for h in HOST_READS)]


def test_batched_bench_rows_match_the_jax_tool(paths, capsys, monkeypatch):
    """tpullm-torch-batched-bench on the CPU: the JAX tool's grid of rows
    and their keys for the same arguments, every rate positive, and the
    decode step of every width made before the first timed case."""
    import json

    from tpullm.tools.batched_bench import main as jax_main

    from tpullm_torch.tools import batched_bench

    argv = ["-m", str(paths["tiny-1l"]), "-npp", "8", "-ntg", "4", "-npl", "1,2", "-c", "64",
            "--mode", "dense", "-o", "json"]
    widths = []
    run_case = batched_bench.run_case

    def spy(eng, pp, tg, b):
        widths.append(sorted(eng._runners))
        return run_case(eng, pp, tg, b)

    monkeypatch.setattr(batched_bench, "run_case", spy)
    assert batched_bench.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert [(r["pp"], r["tg"], r["b"]) for r in got] == [(r["pp"], r["tg"], r["b"])
                                                         for r in want] == [(8, 4, 1), (8, 4, 2)]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert all(r["pp_ts"] > 0 and r["tg_ts"] > 0 for r in got)
    assert widths == [[1, 2], [1, 2]]


def test_not_ported_paths_raise(paths):
    e = _port(paths["tiny"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md 1.3.7"):
        e.prefill_slot_embeddings(0, np.zeros((1, e.hp.n_embd)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md 1.3.9"):
        BatchEngine(paths["tiny"], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="context overflow"):
        e.prefill_slot(0, [1] * (MAX_SEQ + 1))


# -- idle rows (offset −1) in the flash plain versions --------------------------

@pytest.mark.parametrize("kv", ["bf16", "q8"])
@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("plain", ["flash_reference", "flash_split_reference",
                                   "flash_prefill_reference"])
def test_flash_plain_versions_at_idle_offsets_match_pallas(plain, T, kv):
    """B = 4 with offsets (−1, 19, −1, 40): each plain version of the flash
    kernels against the JAX Pallas kernel (interpret mode) at NMSE ≤ 1e-5
    (tests/test_torch_flash.py's bound), every row finite, and an idle
    row's first query (position −1: no visible key) exactly 0, the safe-l
    result (tpullm/ops/pallas/flash.py:157).

    The JAX kernel gives 0 there at T = 1 only (no key tile is visited).
    At T > 1 it visits the first tile for the idle row's later queries,
    and its mask writes NEG_INF = −1e30 rather than −inf, so a query that
    sees no key of the tile takes p = exp(−1e30 − (−1e30)) = 1 for each
    of its 64 keys: the mean of the tile's V rows. That row belongs to an
    idle slot, whose outputs nothing reads (ROADMAP.md §3), so it is left
    out of the comparison and its JAX value checked to be that mean."""
    from tpullm.ops.pallas import flash as jflash
    from tpullm.runtime.kvcache import QuantKVCache as JQuantKVCache

    from tpullm_torch.ops.kernels import flash

    B, H, Hkv, D, S = 4, 4, 2, 64, 64
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    off = np.asarray((-1, 19, -1, 40), np.int32)
    scale = D ** -0.5
    qb = jnp.asarray(q, jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    if kv == "q8":
        k_q, k_s = JQuantKVCache._quantize(jnp.asarray(k, jnp.bfloat16))
        v_q, v_s = JQuantKVCache._quantize(jnp.asarray(v, jnp.bfloat16))
        ref = jflash.flash_attention_q8(qb, k_q, k_s, v_q, v_s, jnp.asarray(off), scale)
        kvt = [torch.from_numpy(np.asarray(a).copy()) for a in (k_q, v_q)]
        kw = dict(k_scale=torch.from_numpy(np.asarray(k_s).copy()),
                  v_scale=torch.from_numpy(np.asarray(v_s).copy()))
    else:
        ref = jflash.flash_attention(qb, jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16), jnp.asarray(off), scale)
        kvt = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        kw = {}
    extra = {"n_sm": 4} if plain == "flash_split_reference" else {}
    got = getattr(flash, plain)(tq, *kvt, torch.from_numpy(off), scale, **kw, **extra)
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    assert not got[[0, 2], 0].any()
    if T > 1:
        vf = kvt[1].float() * kw["v_scale"][..., None] if kv == "q8" else kvt[1].float()
        tile_mean = vf[[0, 2], :, :64].mean(dim=2).repeat_interleave(H // Hkv, dim=1)
        np.testing.assert_allclose(ref[[0, 2], 0], tile_mean.numpy(), atol=1e-2)
        got[[0, 2], 0] = ref[[0, 2], 0]
    assert _nmse(got, ref) <= 1e-5


def test_shared_model_feeds_engines_and_batch_engines(paths):
    """runtime/model.py Model: loaded once, an Engine and a BatchEngine made
    from it share its params (the same tensors, no second load) and compute
    what engines loaded from the path compute, bit for bit; an engine that
    asks for another weight mode, dtype or device, or an override_kv, is
    refused; the JAX package's BatchEngine on the same file agrees."""
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.model import Model

    path = paths["tiny"]
    model = Model(path, device="cpu", mode="dense", dtype=torch.float32)
    eng = Engine(model, max_seq=64, kv_dtype=torch.float32)
    be = BatchEngine(model, n_slots=2, max_seq=64, kv_dtype=torch.float32)
    assert eng.params is be.params is model.params and eng.tokenizer is model.tokenizer
    assert eng.device == be.device == torch.device("cpu")
    own = Engine(path, device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
                 kv_dtype=torch.float32)
    ids = list(range(5, 35))
    want = own.prefill(ids)
    assert np.array_equal(eng.prefill(ids), want)
    got = be.prefill_slots({1: ids})[1]
    je = JBatchEngine(path, n_slots=2, max_seq=64, mode="dense", dtype=jnp.float32,
                      kv_dtype=jnp.float32)
    assert _nmse(got, je.prefill_slots({1: ids})[1]) <= 1e-6
    assert _nmse(got, want) <= 1e-6
    with pytest.raises(ValueError, match="load a separate Model"):
        Engine(model, mode="quant")
    with pytest.raises(ValueError, match="override_kv"):
        Engine(model, override_kv={"general.name": "x"})
    with pytest.raises(ValueError, match="device"):
        BatchEngine(model, device="meta")
