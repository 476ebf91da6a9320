"""Port parity of three MoE families against the JAX package, both on the
CPU: olmoe (the qwen-moe graph: full-projection q/k norms, softmax top-8
of 64 not renormalised), phimoe (models/phi3.py build_params_moe /
forward_moe: sparsemixer routing, LayerNorms with biases, a biased head)
and llama4 (models/llama4.py: chunked attention, NoPE layers with the
attention temperature, sigmoid top-1 experts weighted before the FFN, a
shared expert, a dense layer).

The files are the port's synthetic tiny-olmoe, tiny-phimoe and
tiny-llama4 at Q4_K_M. Tolerances: in the "dense" weight mode with f32
activations and an f32 cache both packages compute the same f32
arithmetic in another order: NMSE ≤ 1e-6 (the runs here land near 1e-12).
Packed planes, bf16 activations and a bf16 cache: NMSE ≤ 1e-3
(tests/test_torch_slice.py's bound), the JAX side on its device repack
(`TPULLM_DEVICE_REPACK=1`). route_sparsemixer: the same ids and weights
within NMSE 1e-12 (the same f32 operations). The prompts of this file flip
no routing decision between the packages (the greedy ids are equal)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bloom import jax_device_load
from test_torch_llama_aliases import assert_hparams_match
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models import llama4 as jllama4
from tpullm.ops.moe import route_sparsemixer as jroute_sparsemixer
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.runtime.kvcache import KVCache as JKVCache

from tpullm_torch.convert import params_from_jax
from tpullm_torch.models import llama4, phi3, qwen_moe
from tpullm_torch.models.registry import _REGISTRY, get_arch
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.ops import moe
from tpullm_torch.ops.moe import route_sparsemixer
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.runtime.kvcache import KVCache

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache
ROUTE_NMSE = 1e-12  # route_sparsemixer: the same f32 operations
SHAPE_NAMES = ("tiny-olmoe", "tiny-phimoe", "tiny-llama4")
MAX_SEQ = 64
# (length, seed) of the greedy prompts: on these no decision flips between the
# packages. Sparsemixer's band is a step: with seed 3 a router logit of
# tiny-phimoe's layer 1 lies 0.0019 (relative) from the band's edge at the 4th
# decode step, the packages' bf16 activations put it on either side, and the
# logits part by NMSE 4.8e-3 there (5e-5 elsewhere); half the seeds part so
GREEDY_PROMPTS = ((24, 4), (7, 4))


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 370) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """get(shape, dense) → a reset (port, JAX) Engine pair, each made once:
    dense f32 weights and cache, or the packed file with a bf16 cache;
    get.files[shape] the GGUF."""
    d = tmp_path_factory.mktemp("moe_families")
    files = {s: str(make_synthetic_llama_gguf(d / f"{s}.gguf", shape=s, seed=0))
             for s in SHAPE_NAMES}
    made = {}
    with jax_device_load():
        def get(shape, dense):
            if (shape, dense) not in made:
                path = files[shape]
                made[shape, dense] = (
                    (Engine(path, device="cpu", max_seq=MAX_SEQ, mode="dense",
                            dtype=torch.float32, kv_dtype=torch.float32),
                     JEngine(path, max_seq=MAX_SEQ, mode="dense", dtype=jnp.float32,
                             kv_dtype=jnp.float32)) if dense
                    else (Engine(path, device="cpu", max_seq=MAX_SEQ),
                          JEngine(path, max_seq=MAX_SEQ, kv_dtype=jnp.bfloat16)))
            te, je = made[shape, dense]
            te.reset()
            je.reset()
            return te, je
        get.files = files
        yield get


def _counted(monkeypatch) -> dict:
    """Calls of the two MoE regimes and of the chunked layers' dense route."""
    calls = {"dense": 0, "gather": 0, "chunked": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(moe, "_moe_dense", counted("dense", moe._moe_dense))
    monkeypatch.setattr(moe, "_moe_gather", counted("gather", moe._moe_gather))
    monkeypatch.setattr(llama4, "attention_chunked",
                        counted("chunked", llama4.attention_chunked))
    return calls


# ---------------------------------------------------------------------------
# the registry, hparams and the synthetic shapes
# ---------------------------------------------------------------------------

def test_registry_maps_the_three_families():
    """olmoe rides the qwen-moe graph, phimoe phi3's MoE loader and
    forward, llama4 its own; none takes the ring or a cache of its own; 64
    names."""
    for arch, build, fwd in (("olmoe", qwen_moe.build_params, qwen_moe.forward),
                             ("phimoe", phi3.build_params_moe, phi3.forward_moe),
                             ("llama4", llama4.build_params, llama4.forward)):
        spec = get_arch(arch)
        assert (spec.build_params, spec.forward, spec.iswa, spec.make_cache) == \
            (build, fwd, False, None)
    assert not qwen_moe.norm_weights_policy(type("HP", (), dict(arch="olmoe",
                                                                expert_weights_norm=False)))
    assert len(_REGISTRY) == 64


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_hparams_match_jax(engines, shape):
    """Every HParams field equals the JAX package's: NEOX RoPE for olmoe and
    phimoe, adjacent pairs for llama4; llama4's chunked-layer pattern 4
    without a key (is_swa false on layer 3 only)."""
    hp = assert_hparams_match(engines.files[shape])
    assert hp.rope.style == ("norm" if hp.arch == "llama4" else "neox")
    if hp.arch == "llama4":
        assert hp.swa_pattern == 4 and hp.sliding_window == 16
        assert [hp.is_swa(i) for i in range(4)] == [True, True, True, False]


@pytest.mark.parametrize("shape,want", [
    ("olmoe-1b-7b", dict(n_layer=16, n_embd=2048, n_head=16, n_head_kv=16, n_ff=1024,
                         n_expert=64, n_expert_used=8, n_vocab=50304)),
    ("phi-3.5-moe", dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8, n_ff=6400,
                         n_expert=16, n_expert_used=2, n_vocab=32064)),
    ("llama-4-scout", dict(n_layer=48, n_embd=5120, n_head=40, n_head_kv=8, n_ff_exp=8192,
                           n_ff_shexp=8192, n_expert=16, n_expert_used=1, n_vocab=202048,
                           sliding_window=8192, rope_base=500000.0))])
def test_published_shapes(shape, want):
    """The published widths; every quantized tensor's K a multiple of 256
    (no fallback type, no dequantize route); 2 layers sized without drawing."""
    cfg = SHAPES[shape]
    assert {k: cfg[k] for k in want} == want and cfg["n_ctx"] == 4096
    w = synthetic_writer("unused.gguf", shape=shape, n_layer=2)
    assert all(r.shape[0] % 256 == 0 for r in w._tensors if r.ggml_type.name != "F32")
    names = {r.name for r in w._tensors}
    if shape == "phi-3.5-moe":
        assert {"blk.0.attn_norm.bias", "blk.1.ffn_norm.bias", "output_norm.bias",
                "output.bias", "blk.0.attn_q.bias", "blk.0.attn_output.bias"} <= names
    if shape == "llama-4-scout":
        assert "blk.0.ffn_down_shexp.weight" in names
        assert "blk.0.ffn_gate_inp_shexp.weight" not in names
    if shape == "olmoe-1b-7b":
        q_norm = next(r for r in w._tensors if r.name == "blk.0.attn_q_norm.weight")
        assert q_norm.shape == (2048,)


# ---------------------------------------------------------------------------
# route_sparsemixer
# ---------------------------------------------------------------------------

def _band_logits() -> np.ndarray:
    """Rows built into PhiMoE's 2·0.01 band and just outside it: two maxima
    within the band (relative gap 0.005), a second maximum just outside
    (0.025), ties at the maximum and in round 2, negative logits (the
    band's factor |s|), all equal, a third logit inside the second round's
    band only."""
    rows = np.full((8, 16), -3.0, np.float32)
    rows[0, 3], rows[0, 9] = 2.0, 1.99
    rows[1, 3], rows[1, 9] = 2.0, 1.95
    rows[2, 5], rows[2, 11] = 1.5, 1.5
    rows[3, 7], rows[3, 2], rows[3, 12] = 3.0, 1.0, 1.0
    rows[4] = -np.linspace(0.5, 0.52, 16, dtype=np.float32)
    rows[5] = 0.25
    rows[6, 0], rows[6, 1], rows[6, 2] = 2.0, 1.2, 1.19
    rows[7, 15], rows[7, 14], rows[7, 13] = 0.1, 0.099, 0.0975
    return rows


@pytest.mark.parametrize("case", ["seeded", "band"])
def test_route_sparsemixer_matches_jax(case):
    """The JAX package's route_sparsemixer: the same expert ids and weights
    within ROUTE_NMSE, on seeded logits and on logits built into and just
    outside the band, with ties (argmax's first index)."""
    logits = (np.random.default_rng(11).standard_normal((64, 16)).astype(np.float32)
              if case == "seeded" else _band_logits())
    w, idx = route_sparsemixer(torch.from_numpy(logits))
    jw, jidx = jroute_sparsemixer(jnp.asarray(logits))
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _nmse(w.numpy(), np.asarray(jw)) <= ROUTE_NMSE
    if case == "band":
        got = idx.numpy()
        assert got[2].tolist() == [5, 11] and got[5].tolist() == [0, 1]  # ties
        assert w[1, 0] > w[0, 0]  # the second maximum outside the band is dropped


# ---------------------------------------------------------------------------
# the forwards against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_dense_logits_match_jax_in_both_regimes(engines, shape, monkeypatch):
    """Dense f32: every row of a 12-token prompt (a bucket of 16: the
    gather regime) and of a 40-token one (every expert on every token),
    three decode steps after each, within F32_NMSE; llama4's chunked layers
    take the dense chunk route (the cache, 64 slots, holds 4 chunks of 16)."""
    calls = _counted(monkeypatch)
    te, je = engines(shape, True)
    n_moe = sum(layer.get("router") is not None for layer in te.params["layers"])
    errs = []
    for n, regime in ((12, "gather"), (40, "dense")):
        te.reset()
        je.reset()
        before = dict(calls)
        prompt = _ids(n, n)
        errs.append(_nmse(te.prefill_all_logits(prompt), je.prefill_all_logits(prompt)))
        assert calls[regime] - before[regime] == n_moe, (n, calls)
        for tok in (7, 200, 33):
            errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= F32_NMSE, errs
    assert calls["chunked"] == (3 * 8 if shape == "tiny-llama4" else 0), calls


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_packed_logits_and_greedy_ids_match_jax(engines, shape):
    """Q4_K_M planes: a 30-token prompt (every expert) and a 9-token one
    (the gather), three decode steps each, within NMSE_BOUND; the greedy
    ids of the decode graph's step (two chunks and a tail) equal the JAX
    Engine's, after a stack-regime and a gather-regime prompt."""
    te, je = engines(shape, False)
    errs = []
    for n in (30, 9):
        prompt = _ids(n, n)
        te.reset()
        je.reset()
        errs.append(_nmse(te.prefill(prompt), je.prefill(prompt)))
        for tok in (100, 17, 301):
            errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= NMSE_BOUND, errs
    for n, seed in GREEDY_PROMPTS:
        prompt = _ids(n, seed)
        te.reset()
        je.reset()
        got = te.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
        assert got == je.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)


def _batch_rows(eng) -> list:
    """Slots 0 and 1 prefilled jointly (their own offsets from then on),
    decode steps of both and of one, slot 1 freed and admitted again."""
    rows = []
    got = eng.prefill_slots({0: _ids(30, 4), 1: _ids(11, 5)})
    rows += [got[0], got[1]]
    for feed in ({0: 101, 1: 102}, {0: 103}, {1: 104}):
        got = eng.decode_batch(feed)
        rows += [got[s] for s in feed]
    eng.free_slot(1)
    rows.append(eng.prefill_slots({1: _ids(9, 6)})[1])
    return rows


@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_batch_engine_matches_jax(engines, shape):
    """A 2-slot BatchEngine (per-slot offsets, −1 for a slot left out of a
    step) against the JAX BatchEngine on dense f32 weights and cache: every
    row within F32_NMSE; can_shift is the JAX rule (true for the three:
    the JAX shift re-rotates every layer's keys, llama4's NoPE layers'
    too, and the port follows it)."""
    kw = dict(n_slots=2, max_seq=MAX_SEQ, prefill_chunk=16, mode="dense")
    path = engines.files[shape]
    te = BatchEngine(path, device="cpu", dtype=torch.float32, kv_dtype=torch.float32, **kw)
    with jax_device_load():
        je = JBatchEngine(path, dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert te.can_shift == je.can_shift is True
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te), _batch_rows(je))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs


@pytest.mark.parametrize("shape", ["tiny-phimoe", "tiny-llama4"])
def test_params_from_jax_carries_the_trees(engines, shape):
    """The JAX Engine's packed tree carried across (phimoe's norm biases,
    q/k/v and o biases, output_norm_b and output_b; llama4's shared expert
    and its dense layer) gives the port's own logits within NMSE_BOUND."""
    te, je = engines(shape, False)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    if shape == "tiny-phimoe":
        assert tree["output_b"] is not None and tree["output_norm_b"] is not None
        assert tree["layers"][0]["ffn_norm_b"] is not None
    else:
        assert tree["layers"][1].get("router") is None
        assert tree["layers"][0]["w_down_shexp"] is not None
    own = te.params
    try:
        for n in (20, 9):
            prompt = _ids(n, 10 + n)
            te.params = own
            te.reset()
            want = te.prefill(prompt)
            te.params = tree
            te.reset()
            assert _nmse(te.prefill(prompt), want) <= NMSE_BOUND
    finally:
        te.params = own
        te.reset()


# ---------------------------------------------------------------------------
# llama4's chunks and its temperature
# ---------------------------------------------------------------------------

def test_llama4_flash_route_equals_the_chunk_route(engines, monkeypatch):
    """At a chunk of 64 a cache of 64 slots holds one chunk: the chunked
    layers take the flash kernel (its plain version here) under the causal
    mask; a cache of 128 slots takes the dense chunk route. Below position
    64 both compute the same function: a 40-token prompt's rows and two
    decode steps within F32_NMSE."""
    calls = _counted(monkeypatch)
    te, _ = engines("tiny-llama4", True)
    hp = dataclasses.replace(te.hp, sliding_window=64)
    toks = _ids(40, 21)
    out = {}
    for n_slots in (64, 128):
        cache = KVCache.new(hp, 1, n_slots, torch.float32)
        before = calls["chunked"]
        rows = []
        with torch.inference_mode():
            for off, chunk in ((0, toks), (40, [17]), (41, [230])):
                t = torch.tensor([chunk])
                pos = torch.arange(off, off + len(chunk))[None]
                logits, cache = llama4.forward(hp, te.params, t, pos, cache, off)
                rows.append(logits[0].numpy())
        out[n_slots] = np.concatenate(rows)
        assert calls["chunked"] - before == (0 if n_slots == 64 else 3 * 3), calls
    assert _nmse(out[64], out[128]) <= F32_NMSE


def test_llama4_crosses_the_chunk_boundary_and_the_temperature_floor(engines):
    """A 12-token prefill at offset 8188 of an 8256-slot cache at Scout's
    chunk of 8192 (its first 8188 slots random keys and values, the same in
    both packages): positions 8188..8199 cross the chunk boundary at 8192
    (the chunked layers drop chunk 0's keys) and the NoPE layer's
    temperature leaves 1.0 at 8191. Every row within F32_NMSE of the JAX
    forward; the temperature equals the JAX package's."""
    te, je = engines("tiny-llama4", True)
    hp = dataclasses.replace(te.hp, sliding_window=8192)
    jhp = dataclasses.replace(je.hp, sliding_window=8192)
    S, off, T = 8256, 8188, 12
    rng = np.random.default_rng(5)
    shape = (hp.n_layer, 1, hp.n_head_kv, S, hp.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k[:, :, :, off:], v[:, :, :, off:] = 0.0, 0.0
    toks, pos = np.array([_ids(T, 8)], np.int32), np.arange(off, off + T, dtype=np.int32)[None]
    temp = llama4.attn_temperature(torch.from_numpy(pos))[0, :, 0, 0].numpy()
    assert temp[2] == 1.0 and temp[3] > 1.0  # positions 8190 and 8191
    np.testing.assert_allclose(temp, np.log(np.floor((pos[0] + 1.0) / 8192) + 1) * 0.1 + 1,
                               rtol=1e-7)
    with torch.inference_mode():
        got, _ = llama4.forward(hp, te.params, torch.from_numpy(toks).long(),
                                torch.from_numpy(pos).long(),
                                KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
                                off)
    want, _ = jllama4.forward(jhp, je.params, jnp.asarray(toks), jnp.asarray(pos),
                              JKVCache(jnp.asarray(k), jnp.asarray(v)), off)
    assert _nmse(got.numpy(), np.asarray(want)) <= F32_NMSE
