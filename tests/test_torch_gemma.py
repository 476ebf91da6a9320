"""Port parity of the Gemma family (models/gemma.py, registered as gemma3,
gemma2 and gemma) and of the iSWA ring cache (runtime/kvcache.py SWACache)
against the JAX package, both on the CPU, on the synthetic tiny gemma GGUFs
(models/synth.py "tiny-gemma3", "tiny-gemma2", "tiny-gemma": 6 layers, 2
heads of head dim 256 on one KV head, a window of 16; gemma3 has one global
layer of six, gemma2 three, gemma none).

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: logits within NMSE 1e-6
(forward level), and rtol/atol 1e-4 against the port's own full cache (the
ring's layers run attention_reference's softmax, the full cache's flash's
plain version, whose f32 sums differ in order by up to 3e-5 on logits of
4 after six layers; tests/test_swa_cache.py holds the JAX ring, whose two
paths are one function, to 1e-5). Packed weights, bf16
activations and a bf16 or q8 cache: NMSE ≤ 1e-3 (the bound of
tests/test_torch_slice.py; the packages round where each other rounds but
sum in another order). The JAX side loads through its device repack
(`TPULLM_DEVICE_REPACK=1`, the load the port mirrors). The tiny gemmas'
greedy ids are one token over and over (the head favours it), so the ids
checks are weak by themselves and the logits carry the comparison.

The cases of tests/test_swa_cache.py each have a counterpart here, on the
port's ring against its own full cache; the ring that wraps is R = 128 at
forward level (`SWACache.new(…, max_len=256, max_chunk=16)`) and R = 1152
in the Engine (its chunk is min(1024, max_seq) at max_seq 1280)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.models import gemma as jgemma
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm.runtime import kvcache as jkv
from tpullm.runtime import state as jstate
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models import gemma
from tpullm_torch.models.hparams import hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import kvcache, state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

ARCHS = ("gemma3", "gemma2", "gemma")
F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 or q8 cache
RTOL = ATOL = 1e-4  # the port's ring against its own full cache


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, 380, size=n)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma")
    return {arch: make_synthetic_llama_gguf(d / f"tiny-{arch}.gguf", shape=f"tiny-{arch}",
                                            seed=0) for arch in ARCHS}


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


def _f32(path, **kw):
    """The port's Engine on dense f32 weights and an f32 cache."""
    return Engine(path, device="cpu", mode="dense", dtype=torch.float32,
                  kv_dtype=torch.float32, **kw)


def _jf32(path, **kw):
    return JEngine(path, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32, **kw)


# ---------------------------------------------------------------------------
# hparams and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_hparams_match_jax(paths, arch):
    """Every field the port's HParams holds equals the JAX package's; the
    gemma mapping: neox RoPE, √n_embd embedding scale, the swa pattern and
    the SWA RoPE base per arch, gemma2's softcaps, head dims from
    key_length / value_length."""
    hp = hparams_from_gguf(GGUFReader(paths[arch]))
    jhp = jhparams(JReader(paths[arch]))
    for name in hp.__dataclass_fields__:
        got, want = getattr(hp, name), getattr(jhp, name)
        if name == "rope":
            for f in got.__dataclass_fields__:
                assert getattr(got, f) == getattr(want, f), f"rope.{f}"
        else:
            assert got == want, name
    assert hp.rope.style == "neox" and hp.embd_scale == 16.0 and hp.head_dim == 256
    assert [hp.is_swa(i) for i in range(6)] == [jhp.is_swa(i) for i in range(6)]
    assert sum(hp.is_swa(i) for i in range(6)) == {"gemma3": 5, "gemma2": 3, "gemma": 0}[arch]
    assert (hp.softcap_attn, hp.softcap_final) == ((50.0, 30.0) if arch == "gemma2"
                                                   else (0.0, 0.0))


def test_registry_holds_the_gemma_archs():
    assert get_arch("gemma3") is get_arch("gemma2") and get_arch("gemma3").iswa
    assert get_arch("gemma").forward is gemma.forward and not get_arch("gemma").iswa
    assert not get_arch("llama").iswa
    with pytest.raises(NotImplementedError, match="not ported"):
        get_arch("gemma3n")


# ---------------------------------------------------------------------------
# forward against the JAX package
# ---------------------------------------------------------------------------

def _params(path, mode: str, dtype):
    """(hp, port params, JAX hp, JAX params) from one GGUF."""
    r = GGUFReader(path)
    hp = hparams_from_gguf(r)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jr = JReader(path)
    jhp = jhparams(jr)
    return hp, gemma.build_params(r, hp, "cpu", tdt, mode), jhp, \
        jgemma.build_params(jr, jhp, mode=mode, dtype=jdt)


def _caches(hp, jhp, kind: str, dtype: str):
    """A port cache and the JAX one of the same kind at max_len 256 (the
    ring: max_chunk 16, so R = 128)."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    if kind == "ring":
        return (kvcache.SWACache.new(hp, 1, 256, tdt, max_chunk=16),
                jkv.SWACache.new(jhp, 1, 256, jdt, max_chunk=16))
    if kind == "q8":
        return kvcache.QuantKVCache.new(hp, 1, 256), jkv.QuantKVCache.new(jhp, 1, 256)
    return kvcache.KVCache.new(hp, 1, 256, tdt), jkv.KVCache.new(jhp, 1, 256, jdt)


def _run_both(hp, params, jhp, jparams, cache, jcache, chunks: list[list[int]],
              decode: list[int]) -> list[float]:
    """Chunks fed in turn (prefill: every row's logits), then one token a
    step; the NMSE of each forward's logits, port against JAX."""
    errs, n = [], 0
    for toks in [*chunks, *[[t] for t in decode]]:
        T = len(toks)
        pos = np.arange(n, n + T, dtype=np.int32)[None]
        with torch.inference_mode():
            got, cache = gemma.forward(hp, params, torch.tensor([toks]),
                                       torch.from_numpy(pos), cache, n)
        want, jcache = jgemma.forward(jhp, jparams, jnp.asarray([toks]), jnp.asarray(pos),
                                      jcache, n)
        errs.append(_nmse(got.numpy(), np.asarray(want)))
        n += T
    return errs


@pytest.mark.parametrize("kind,arch", [(kind, arch) for kind in ("full", "ring", "q8")
                                       for arch in ARCHS if (kind, arch) != ("ring", "gemma")])
def test_forward_matches_jax_f32(paths, arch, kind):
    """gemma.forward against tpullm.models.gemma.forward on dense f32
    weights: a full cache (every layer through flash's plain version, the
    SWA layers windowed: the swa_full path), the ring (R = 128, 200 tokens in
    chunks of 16: it wraps; the SWA layers through attention_ring) and q8
    (the swa_full path on int8 codes); prefill chunks and decode steps
    (gemma v1 has no window, so no ring)."""
    hp, params, jhp, jparams = _params(paths[arch], "dense", "f32")
    cache, jcache = _caches(hp, jhp, kind, "f32")
    ids = _ids(200, 1)
    chunks = [ids[i:i + 16] for i in range(0, 200, 16)] if kind == "ring" else [ids[:40]]
    errs = _run_both(hp, params, jhp, jparams, cache, jcache, chunks, [7, 9, 300, 11])
    bound = 1e-4 if kind == "q8" else F32_NMSE  # q8: a code may round the other way
    assert max(errs) <= bound, errs
    if kind == "ring":
        assert cache.ring_len == 128 and int(cache.slot_pos.max()) == 203


@pytest.mark.parametrize("arch", ["gemma3", "gemma2"])
@pytest.mark.parametrize("kind", ["full", "ring", "q8"])
def test_forward_matches_jax_packed(paths, arch, kind):
    """The same on the packed planes (the kernels' plain versions), bf16
    activations and a bf16 or q8 cache: NMSE ≤ 1e-3."""
    hp, params, jhp, jparams = _params(paths[arch], "auto", "bf16")
    cache, jcache = _caches(hp, jhp, kind, "bf16")
    ids = _ids(150, 2)
    chunks = [ids[i:i + 16] for i in range(0, 150, 16)] if kind == "ring" else [ids[:40]]
    errs = _run_both(hp, params, jhp, jparams, cache, jcache, chunks, [7, 9, 300])
    assert max(errs) <= NMSE_BOUND, errs


def test_forward_per_slot_offsets_on_the_ring(paths):
    """Per-slot offsets on a 2-row ring (−1 idle): each fed row's logits
    equal a single-row ring's at the same offset, and the idle row's ring
    rows and slot positions stay as they were."""
    hp, params, _, _ = _params(paths["gemma3"], "dense", "f32")
    ring = kvcache.SWACache.new(hp, 2, 256, torch.float32, max_chunk=16)
    one = kvcache.SWACache.new(hp, 1, 256, torch.float32, max_chunk=16)
    ids = _ids(48, 3)
    with torch.inference_mode():
        for i in range(0, 48, 16):
            toks = torch.tensor([ids[i:i + 16]] * 2)
            pos = torch.arange(i, i + 16, dtype=torch.int32)[None].expand(2, 16)
            off = torch.tensor([i, -1], dtype=torch.int32)
            before = ring.swa_k[:, 1].clone(), ring.slot_pos[1].clone()
            got, ring = gemma.forward(hp, params, toks, pos.contiguous(), ring, off)
            want, one = gemma.forward(hp, params, toks[:1], pos[:1].contiguous(), one, i)
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6, atol=1e-6)
            assert torch.equal(ring.swa_k[:, 1], before[0])
            assert torch.equal(ring.slot_pos[1], before[1])
    assert torch.equal(ring.slot_pos[0], one.slot_pos[0])


# ---------------------------------------------------------------------------
# Engine against the JAX Engine, across the window and the ring's wrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swa_full", [False, True], ids=["ring", "swa_full"])
def test_engine_greedy_across_the_window(paths, swa_full):
    """Engine against the JAX Engine on packed weights and a bf16 cache,
    max_seq 1280: the ring is R = round_up(15 + 1024, 128) = 1152, its
    prefill runs in chunks of 1024; a 1100-token prompt and 120 greedy
    tokens take the generation to position 1220, past the ring's wrap. The
    logits of the prompt, the ids, and decode_step's logits after a reset
    and a 1200-token prompt (two chunks, wrapped)."""
    path = paths["gemma3"]
    te = Engine(path, device="cpu", max_seq=1280, swa_full=swa_full)
    je = JEngine(path, max_seq=1280, kv_dtype=jnp.bfloat16, swa_full=swa_full)
    assert isinstance(te.cache, kvcache.SWACache) != swa_full
    assert isinstance(je.cache, jkv.SWACache) != swa_full
    if not swa_full:
        assert te.cache.ring_len == je.cache.ring_len == 1152 and te.prefill_cap == 1024
    prompt = _ids(1100, 4)
    got = te.generate_tokens_device(prompt, 120, stop_on_eog=False)
    want = je.generate_tokens_device(prompt, 120, stop_on_eog=False)
    assert got == want and len(got) == 120 and te.n_past > 1152
    te.reset()
    je.reset()
    long = _ids(1200, 5)
    errs = [_nmse(te.prefill(long), je.prefill(long))]
    for t in (7, 9, 300):
        errs.append(_nmse(te.decode_step(t), je.decode_step(t)))
    assert max(errs) <= NMSE_BOUND, errs


# ---------------------------------------------------------------------------
# the cases of tests/test_swa_cache.py on the port's ring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring_full(paths):
    """The port's ring and swa_full Engines, dense f32, max_seq 128."""
    return (_f32(paths["gemma3"], max_seq=128), _f32(paths["gemma3"], max_seq=128, swa_full=True))


def test_ring_cache_engaged(ring_full, paths):
    """The ring for gemma3 and gemma2 on a dense cache; a full cache with
    swa_full, on q8, for gemma (v1: no window) and at max_seq ≤ window."""
    ring, full = ring_full
    assert isinstance(ring.cache, kvcache.SWACache)
    assert not isinstance(full.cache, kvcache.SWACache)
    assert ring.cache.ring_len <= ring.max_seq and ring.prefill_cap == 128
    assert [s for s, _ in ring.cache.layer_map] == [True] * 5 + [False]
    assert isinstance(Engine(paths["gemma2"], device="cpu", max_seq=64).cache,
                      kvcache.SWACache)
    for path, kw in ((paths["gemma3"], dict(kv_dtype="q8_0")), (paths["gemma"], {}),
                     (paths["gemma3"], dict(max_seq=16))):
        eng = Engine(path, device="cpu", **{"max_seq": 64, **kw})
        assert not isinstance(eng.cache, kvcache.SWACache) and not eng.ring


def test_ring_matches_full_prefill_and_decode(ring_full):
    ring, full = ring_full
    ring.reset()
    full.reset()
    toks = _ids(40, 0)
    np.testing.assert_allclose(ring.prefill(toks), full.prefill(toks), rtol=RTOL, atol=ATOL)
    for t in (3, 7, 11, 19):
        np.testing.assert_allclose(ring.decode_step(t), full.decode_step(t), rtol=RTOL,
                                   atol=ATOL)


def test_ring_chunked_prefill_matches(ring_full):
    """A prefill cap of 16: the 100-token prompt wraps the ring many times."""
    ring, full = ring_full
    ring.reset()
    full.reset()
    cap = ring.prefill_cap
    ring.prefill_cap = 16
    try:
        toks = _ids(100, 1)
        np.testing.assert_allclose(ring.prefill(toks), full.prefill(toks), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(ring.decode_step(9), full.decode_step(9), rtol=RTOL,
                                   atol=ATOL)
    finally:
        ring.prefill_cap = cap


def test_ring_all_logits_chunked(ring_full):
    ring, full = ring_full
    ring.reset()
    full.reset()
    cap = ring.prefill_cap
    ring.prefill_cap = 32
    try:
        toks = _ids(80, 2)
        lr, lf = ring.prefill_all_logits(toks), full.prefill_all_logits(toks)
        assert lr.shape == lf.shape == (80, lf.shape[1])
        np.testing.assert_allclose(lr, lf, rtol=RTOL, atol=ATOL)
    finally:
        ring.prefill_cap = cap


def test_ring_reset_isolates_conversations(ring_full):
    """After a 40-token prompt, reset marks every ring slot empty (in
    place: the same tensor), so a new 4-token prompt attends none of it."""
    ring, full = ring_full
    ring.reset()
    full.reset()
    ring.prefill(list(range(5, 45)))
    slot_pos = ring.cache.slot_pos
    ring.reset()
    full.reset()
    assert ring.cache.slot_pos is slot_pos and int(slot_pos.max()) == -1
    toks = [7, 9, 11, 13]
    np.testing.assert_allclose(ring.prefill(toks), full.prefill(toks), rtol=RTOL, atol=ATOL)


def test_ring_rollback_reexecute(ring_full):
    """n_past rewound by 2 and other tokens decoded: the ring slots are
    overwritten (speculative-style rollback)."""
    ring, full = ring_full
    ring.reset()
    full.reset()
    ring.prefill([5, 6, 7, 8])
    full.prefill([5, 6, 7, 8])
    for t in (20, 21, 22):
        ring.decode_step(t)
        full.decode_step(t)
    ring.n_past -= 2
    full.n_past -= 2
    for t in (30, 31):
        lr, lf = ring.decode_step(t), full.decode_step(t)
    np.testing.assert_allclose(lr, lf, rtol=RTOL, atol=ATOL)


def test_ring_memory_smaller(tmp_path):
    """At max_seq 8192 the five SWA layers allocate ring_len < 8192 / 4 rows,
    under twice the one full layer's."""
    path = make_synthetic_llama_gguf(tmp_path / "g.gguf", shape="tiny-gemma3", seed=0, n_layer=6)
    eng = Engine(path, device="cpu", mode="dense", max_seq=8192)
    c = eng.cache
    assert isinstance(c, kvcache.SWACache)
    assert c.ring_len < 8192 / 4 and c.ring_len == kvcache.ring_len(16, 1024, 8192) == 1152
    assert c.swa_k.numel() + c.swa_v.numel() < 2 * (c.full_k.numel() + c.full_v.numel())


def test_ring_state_save_load(ring_full, paths, tmp_path):
    """A state file of the ring engine restores into another (the ring and
    its slot positions in place) and the continuation's logits are the
    saver's."""
    ring, _ = ring_full
    toks = _ids(30, 3)
    ring.reset()
    ring.prefill(toks)
    p = tmp_path / "state.npz"
    state.save_state(ring, p, tokens=toks)
    expect = [ring.decode_step(7), ring.decode_step(8)]
    other = _f32(paths["gemma3"], max_seq=128)
    slot_pos = other.cache.slot_pos
    assert state.load_state(other, p) == toks and other.n_past == 30
    assert other.cache.slot_pos is slot_pos
    got = [other.decode_step(7), other.decode_step(8)]
    np.testing.assert_allclose(got[0], expect[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], expect[1], rtol=RTOL, atol=ATOL)
    full = _f32(paths["gemma3"], max_seq=128, swa_full=True)
    with pytest.raises(ValueError, match="iSWA"):
        state.load_state(full, p)
    small = _f32(paths["gemma3"], max_seq=64)  # R = 64
    with pytest.raises(ValueError, match="geometry"):
        state.load_state(small, p)


def test_ring_device_generation_chunked(ring_full):
    """generate_tokens_device with a prompt longer than the prefill cap
    (chunked on the host, the decode on the DecodeRunner's buffers): the
    ids of the full cache."""
    ring, full = ring_full
    cap = ring.prefill_cap
    ring.prefill_cap = 16
    try:
        for e in ring_full:
            e.reset()
        prompt = _ids(40, 4)
        got = ring.generate_tokens_device(prompt, 40, stop_on_eog=False, chunk=8)
        want = full.generate_tokens_device(prompt, 40, stop_on_eog=False, chunk=8)
        assert got == want and len(got) == 40
    finally:
        ring.prefill_cap = cap


def test_joint_prefill_on_swa_serving_engine(paths):
    """prefill_slots (a joint round of two slots) over the ring reproduces
    sequential per-slot prefills, and the decode step after it."""
    prompts = {0: list(range(3, 30)), 1: list(range(5, 14))}

    def fresh():
        return BatchEngine(paths["gemma3"], device="cpu", n_slots=2, max_seq=64, mode="dense",
                           dtype=torch.float32, kv_dtype=torch.float32, prefill_chunk=16)

    eng_a, eng_b = fresh(), fresh()
    assert isinstance(eng_a.cache, kvcache.SWACache) and eng_a.cache.ring_len == 64
    ref = {s: eng_a.prefill_slot(s, t) for s, t in prompts.items()}
    got = eng_b.prefill_slots(prompts)
    for s in prompts:
        np.testing.assert_allclose(got[s], ref[s], rtol=2e-4, atol=2e-4)
    feed = {s: int(np.argmax(ref[s])) for s in prompts}
    da, db = eng_a.decode_batch(feed), eng_b.decode_batch(feed)
    for s in prompts:
        np.testing.assert_allclose(db[s], da[s], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# state files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_ring_state_files_cross_packages(paths, tmp_path, direction):
    """A ring engine's state file (max_seq 1280: R = 1152, a 1200-token
    prefix that wraps it) saved by one package restores in the other, and
    the continuation's logits agree with the saver's own."""
    te, je = _f32(paths["gemma3"], max_seq=1280), _jf32(paths["gemma3"], max_seq=1280)
    assert te.cache.ring_len == je.cache.ring_len == 1152
    saver, loader = (je, te) if direction == "jax to port" else (te, je)
    save, load = ((jstate.save_state, state.load_state) if direction == "jax to port"
                  else (state.save_state, jstate.load_state))
    toks = _ids(1200, 6)
    saver.prefill(toks)
    p = str(tmp_path / "state.npz")
    save(saver, p, tokens=toks)
    want = [saver.decode_step(t) for t in (7, 8, 300)]
    assert load(loader, p) == toks and loader.n_past == 1200
    got = [loader.decode_step(t) for t in (7, 8, 300)]
    assert max(_nmse(g, w) for g, w in zip(got, want)) <= F32_NMSE


# ---------------------------------------------------------------------------
# BatchEngine against the JAX BatchEngine
# ---------------------------------------------------------------------------

_BATCH_KW = dict(n_slots=3, max_seq=128, prefill_chunk=32)
_READMIT = (9, 9)  # the re-admitted slot's prompt: _ids(9, seed 9)


def _batch_ring_rows(eng) -> tuple[list, list]:
    """BatchEngine on the ring (3 slots, max_seq 128, chunk 32: R = 128): a
    joint prefill of slots 0 and 2, teacher-forced decode steps with an
    idle slot, slot 2 freed and re-admitted with a 9-token prompt, two
    steps after it. (rows before the free, rows after it) as (slot, logits)."""
    before, after = [], []
    got = eng.prefill_slots({0: _ids(70, 7), 2: _ids(20, 8)})
    before += [(s, got[s]) for s in (0, 2)]
    for feed in ({0: 300, 2: 301}, {0: 302}, {2: 303}, {0: 304, 2: 305}):
        got = eng.decode_batch(feed)
        before += [(s, got[s]) for s in feed]
    eng.free_slot(2)
    after.append((2, eng.prefill_slots({2: _ids(*_READMIT)})[2]))
    for feed in ({0: 306, 2: 307}, {2: 308}):
        got = eng.decode_batch(feed)
        after += [(s, got[s]) for s in feed]
    return before, after


def _fresh_slot_rows(eng) -> list:
    """Slot 2 of a fresh engine fed as _batch_ring_rows re-admits it."""
    rows = [eng.prefill_slots({2: _ids(*_READMIT)})[2]]
    return rows + [eng.decode_batch({2: t})[2] for t in (307, 308)]


def test_batch_engine_on_the_ring_matches_jax(paths):
    """BatchEngine on the ring against the JAX BatchEngine on dense f32
    weights and an f32 cache (_batch_ring_rows: a joint prefill, steps with
    an idle slot, a freed slot re-admitted with another prompt, its ring
    marked empty so the new request attends nothing of the old one): every
    row's logits within F32_NMSE, the rings' slot positions equal, and the
    re-admitted slot's rows equal to a fresh engine's bit for bit."""
    kw = dict(_BATCH_KW, mode="dense")
    te = BatchEngine(paths["gemma3"], device="cpu", dtype=torch.float32,
                     kv_dtype=torch.float32, **kw)
    je = JBatchEngine(paths["gemma3"], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert isinstance(te.cache, kvcache.SWACache) and te.cache.ring_len == 128
    got, want = _batch_ring_rows(te), _batch_ring_rows(je)
    np.testing.assert_array_equal(te.cache.slot_pos.numpy(), np.asarray(je.cache.slot_pos))
    errs = [_nmse(a, b) for (_, a), (_, b) in zip(got[0] + got[1], want[0] + want[1])]
    assert max(errs) <= F32_NMSE, errs
    fresh = _fresh_slot_rows(BatchEngine(paths["gemma3"], device="cpu", dtype=torch.float32,
                                         kv_dtype=torch.float32, **kw))
    for a, b in zip([r for s, r in got[1] if s == 2], fresh):
        np.testing.assert_array_equal(a, b)


def test_batch_engine_on_the_ring_matches_jax_packed(paths):
    """The same run on packed weights and a bf16 cache: the rows before the
    free and slot 0's after it within NMSE_BOUND of the JAX BatchEngine; the
    re-admitted slot's rows equal to a fresh engine's bit for bit (no state
    of the freed slot's tenant reaches them). Those rows are held against
    the JAX package in f32 (the test above): in bf16 the first decode step
    after the 9-token prompt reads NMSE 1.14e-2 between the packages, on
    fresh engines alike (1.14e-7 in f32): its third layer multiplies the
    packages' hidden-state NMSE by ≈ 500 in bf16 and ≈ 4600 in f32
    (tests/torch_gemma_readmit.py; PERF.md §7)."""
    te = BatchEngine(paths["gemma3"], device="cpu", **_BATCH_KW)
    je = JBatchEngine(paths["gemma3"], kv_dtype=jnp.bfloat16, **_BATCH_KW)
    got, want = _batch_ring_rows(te), _batch_ring_rows(je)
    np.testing.assert_array_equal(te.cache.slot_pos.numpy(), np.asarray(je.cache.slot_pos))
    pairs = list(zip(got[0], want[0])) + [(a, b) for a, b in zip(got[1], want[1]) if a[0] == 0]
    errs = [_nmse(a, b) for (_, a), (_, b) in pairs]
    assert len(errs) == 9 and max(errs) <= NMSE_BOUND, errs
    fresh = _fresh_slot_rows(BatchEngine(paths["gemma3"], device="cpu", **_BATCH_KW))
    for a, b in zip([r for s, r in got[1] if s == 2], fresh):
        np.testing.assert_array_equal(a, b)


def test_ring_holds_the_window(paths):
    """Prompt-cache reuse needs the window before the reused prefix in the
    ring: after 200 tokens in a slot of R = 128 (positions 72..199 left), a
    prefix of 190 is held, one of 80 is not (its window was overwritten),
    and a freed slot holds nothing."""
    be = BatchEngine(paths["gemma3"], device="cpu", n_slots=2, max_seq=256, prefill_chunk=16,
                     mode="dense", dtype=torch.float32, kv_dtype=torch.float32)
    assert be.cache.ring_len == 128
    be.prefill_slot(0, _ids(200, 10))
    assert be.ring_holds(0, 190) and be.ring_holds(0, 200)
    assert not be.ring_holds(0, 80) and be.ring_holds(1, 0)
    be.free_slot(0)
    assert not be.ring_holds(0, 20)


def test_speculative_refused_on_the_ring(paths):
    """Speculative verification on a ring cache, once refused (ROADMAP
    1.4.1), runs: greedy n-gram speculation gives the ring's plain greedy
    ids and the swa_full engine's speculative ids; verify_logits on the
    ring equal swa_full's (RTOL/ATOL); BatchEngine.verify_batch on the ring
    equals Engine.verify_logits. What stays refused is a verify wider than
    the ring's max_rows (tests/test_torch_ring_speculative.py holds the
    ring against the JAX package's)."""
    from tpullm_torch.runtime.speculative import NgramSpeculator, generate_speculative

    eng = _f32(paths["gemma3"], max_seq=128)
    full = _f32(paths["gemma3"], max_seq=128, swa_full=True)
    prompt = _ids(10, 11) * 2
    plain = list(eng.generate_tokens(prompt, 8))
    eng.reset()
    out, stats = generate_speculative(eng, NgramSpeculator(n_draft=3), prompt, 8,
                                      stop_on_eog=False)
    want, _ = generate_speculative(full, NgramSpeculator(n_draft=3), prompt, 8,
                                   stop_on_eog=False)
    assert out == plain == want and stats.n_drafted > 0
    got = eng.verify_logits([5, 6, 7])
    np.testing.assert_allclose(got, full.verify_logits([5, 6, 7]), rtol=RTOL, atol=ATOL)
    be = BatchEngine(paths["gemma3"], device="cpu", n_slots=2, max_seq=128, mode="dense",
                     dtype=torch.float32, kv_dtype=torch.float32)
    eng.reset()
    eng.prefill(prompt)
    be.prefill_slot(0, prompt)
    rows = be.verify_batch({0: [5, 6]}, 3)[0]
    np.testing.assert_allclose(rows[:2], eng.verify_logits([5, 6]), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="exceeds its"):
        BatchEngine(paths["gemma3"], device="cpu", n_slots=2, max_seq=256,
                    prefill_chunk=16).verify_batch({0: [5, 6]}, 128)


# ---------------------------------------------------------------------------
# the cli's --swa-full, the synthetic files, the embedding load, params_from_jax
# ---------------------------------------------------------------------------

def _cli(main, argv) -> tuple[int, str]:
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("swa", [[], ["--swa-full"]], ids=["ring", "swa_full"])
def test_cli_swa_full_as_jax(paths, swa):
    """tpullm-torch's completion on tiny gemma3, with and without
    --swa-full, prints the JAX cli's stdout (greedy, 12 tokens)."""
    from tpullm.tools import cli as jcli

    from tpullm_torch.tools import cli

    argv = ["-m", paths["gemma3"], "-p", "the quick brown fox", "-n", "12", "--temp", "0",
            "-c", "128", "--no-display-prompt", *swa]
    rc, got = _cli(cli.main, argv + ["--device", "cpu"])
    rc_j, want = _cli(jcli.main, argv)
    assert rc == rc_j == 0 and got == want and got.strip()


@pytest.mark.parametrize("shape", ["tiny-gemma3", "tiny-gemma2", "tiny-gemma", "gemma-3-4b"])
def test_synthetic_gemma_files(tmp_path, shape):
    """The gemma shapes' metadata and tensors: key/value lengths, the
    post-norms (gemma2, gemma3), the q/k norms (gemma3), no output.weight
    (the tied head), token_embd at the output's type (Q6_K at Q4_K_M) and
    llama.cpp's Q4_K_M attn_v / ffn_down rule; gemma-3-4b is checked on its
    writer (its payloads not drawn)."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.models.synth import SHAPES, preset_type, synthetic_writer

    cfg = SHAPES[shape]
    arch, n_layer = cfg["arch"], cfg["n_layer"]
    if shape == "gemma-3-4b":  # the writer's records: its payloads are not drawn
        w = synthetic_writer(tmp_path / "g.gguf", shape=shape)
        md = {key: value for key, _, value in w._kv}
        types = {rec.name: rec.ggml_type for rec in w._tensors}
        assert md["gemma3.rope.scaling.type"] == "linear" and md["gemma3.rope.scaling.factor"] == 8
        assert md["gemma3.vocab_size"] == 262144 and md["gemma3.attention.sliding_window"] == 1024
    else:
        r = GGUFReader(make_synthetic_llama_gguf(tmp_path / "g.gguf", shape=shape))
        md = r.metadata
        types = {name: info.ggml_type for name, info in r.tensors.items()}
    assert md[f"{arch}.attention.key_length"] == md[f"{arch}.attention.value_length"] == 256
    assert "output.weight" not in types and types["token_embd.weight"] == GGMLType.Q6_K
    assert ("blk.0.post_attention_norm.weight" in types) == (arch != "gemma")
    assert ("blk.0.attn_q_norm.weight" in types) == (arch == "gemma3")
    for i in range(n_layer):
        for kind in ("attn_v", "ffn_down", "attn_q"):
            assert types[f"blk.{i}.{kind}.weight"] == preset_type("Q4_K_M", kind, i, n_layer)
    assert preset_type("Q4_K_M", "token_embd", 0, 6, tied=True) == GGMLType.Q6_K
    assert preset_type("Q4_K_M", "token_embd", 0, 6) == GGMLType.Q4_K


@pytest.mark.parametrize("ftype", ["Q4_K_M", "IQ2_XXS", "Q4_0"])
def test_load_embedding_in_chunks(tmp_path, monkeypatch, ftype):
    """load_embedding's row chunks (EMBEDDING_CHUNK_ROWS) give the table of
    one pass bit for bit (a k-quant, a codebook and a legacy table)."""
    from tpullm_torch.models import weights

    info = GGUFReader(make_synthetic_llama_gguf(tmp_path / "t.gguf", shape="tiny",
                                                ftype=ftype)).tensors["token_embd.weight"]
    monkeypatch.setattr(weights, "EMBEDDING_CHUNK_ROWS", info.shape[1])
    whole = weights.load_embedding(info, "cpu")
    for rows in (1, 100, 384):
        monkeypatch.setattr(weights, "EMBEDDING_CHUNK_ROWS", rows)
        assert torch.equal(weights.load_embedding(info, "cpu"), whole)


def test_params_from_jax_carries_the_gemma_tree(paths):
    """The JAX gemma Engine's param tree (post-norms, q/k norms, fused
    QKV / gate+up where a layer's types agree, the tied head's None),
    carried across: the port's own load's logits."""
    import jax

    from tpullm_torch.convert import params_from_jax

    je = JEngine(paths["gemma3"], max_seq=64, kv_dtype=jnp.bfloat16)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    layer = tree["layers"][0]
    assert tree["output"] is None
    for key in ("attn_post_norm", "ffn_post_norm", "q_norm", "k_norm"):
        assert isinstance(layer[key], torch.Tensor), key
    carried = Engine(paths["gemma3"], device="cpu", max_seq=64)
    own = Engine(paths["gemma3"], device="cpu", max_seq=64)
    carried.params = tree
    ids = _ids(20, 12)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
    assert _nmse(carried.decode_step(300), own.decode_step(300)) <= NMSE_BOUND
