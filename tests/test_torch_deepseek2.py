"""Port parity of the deepseek2 family (models/deepseek2.py: MLA, shared
experts, V2- and V3-style routing), the MLA latent cache
(runtime/kvcache.py MLACache), its state files, and the flash kernel's
plain versions at Dk ≠ Dv, against the JAX package, both on the CPU.

Two fixtures: the JAX package's own (tpullm/models/testing.py
make_tiny_deepseek2_gguf: q LoRA, sigmoid gating with exp_probs_b, scale 2,
renormalised; f32 tensors; latent 24 + 8, so the attention is at
(Dk, Dv) = (32, 24)) and the port's synthetic "tiny-deepseek2" (q direct,
softmax top-2 not renormalised, one shared expert; packed Q4_K_M; latent
512 + 64, the kernel's (576, 512); 16 heads on the latent's one KV head).

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: logits within NMSE 1e-6.
Packed weights, bf16 activations and a bf16 latent: NMSE ≤ 1e-3 (the
bound of tests/test_torch_slice.py). The plain flash versions against the
JAX Pallas kernel in interpret mode: NMSE ≤ 1e-5, as tests/test_torch_flash.py
holds them (f32 sums in another order, the bf16 output rounding). The JAX
side loads through its device repack (`TPULLM_DEVICE_REPACK=1`, the load
the port mirrors)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.gguf.writer import GGUFWriter as JWriter
from tpullm.models import deepseek2 as jds
from tpullm.models import weights as jweights
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm.models.registry import get_arch as jget_arch
from tpullm.models.testing import make_tiny_deepseek2_gguf
from tpullm.ops import moe as jmoe
from tpullm.ops.pallas import flash as jflash
from tpullm.runtime import kvcache as jkv
from tpullm.runtime import speculative as jspec
from tpullm.runtime import state as jstate
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models import deepseek2, weights
from tpullm_torch.models.hparams import hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import (SHAPES, make_synthetic_llama_gguf, preset_type,
                                       random_packed, synthetic_writer)
from tpullm_torch.ops import moe
from tpullm_torch.ops.kernels import flash
from tpullm_torch.runtime import kvcache, speculative, state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 latent
FLASH_NMSE = 1e-5  # plain flash versions against the Pallas kernel (interpret mode)


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 250) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("deepseek2")
    return {"jax": make_tiny_deepseek2_gguf(str(d / "jax-tiny-ds2.gguf")),
            "tiny": make_synthetic_llama_gguf(d / "tiny-deepseek2.gguf", shape="tiny-deepseek2",
                                              seed=0)}


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


# ---------------------------------------------------------------------------
# hparams, the registry and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["jax", "tiny"])
def test_hparams_match_jax(paths, name):
    """Every field of the port's HParams equals the JAX package's: the MLA
    ranks, the dense lead, the shared experts and the routing keys."""
    hp = hparams_from_gguf(GGUFReader(paths[name]))
    jhp = jhparams(JReader(paths[name]))
    for field in hp.__dataclass_fields__:
        got, want = getattr(hp, field), getattr(jhp, field)
        if field == "rope":
            for f in got.__dataclass_fields__:
                assert getattr(got, f) == getattr(want, f), f"rope.{f}"
        else:
            assert got == want, field
    assert hp.rope.style == "norm"
    if name == "jax":
        assert (hp.n_lora_q, hp.n_lora_kv, hp.expert_gating_func, hp.expert_weights_norm,
                hp.expert_weights_scale) == (24, 24, "sigmoid", True, 2.0)
    else:
        assert (hp.n_lora_q, hp.n_lora_kv, hp.rope.dims, hp.n_expert_shared,
                hp.n_layer_dense_lead, hp.expert_gating_func) == (0, 512, 64, 1, 1, "softmax")


def test_registry_and_cache_kinds(paths, monkeypatch):
    """deepseek2 brings its cache: the bf16 latent [L, B, 1, S, kvr + n_rot]
    (for every named type, as the JAX package rules; a torch dtype as asked);
    TPULLM_MLA=0 the decompressed form's per-head cache. Engine.report
    names the latent's dtype."""
    spec = get_arch("deepseek2")
    assert spec.forward is deepseek2.forward and spec.make_cache is deepseek2.make_cache
    hp = hparams_from_gguf(GGUFReader(paths["tiny"]))
    for kv, want in ((torch.bfloat16, torch.bfloat16), ("q8_0", torch.bfloat16),
                     ("f16", torch.bfloat16), (torch.float32, torch.float32)):
        c = deepseek2.make_cache(hp, 2, 64, kv)
        assert isinstance(c, kvcache.MLACache) and c.c.dtype == want
        assert tuple(c.c.shape) == (3, 2, 1, 64, 576) and c.kvr == 512
    eng = Engine(paths["tiny"], device="cpu", max_seq=64, kv_dtype="q8_0")
    assert isinstance(eng.cache, kvcache.MLACache)
    assert "MLACache bfloat16 (3456 B a position)" in eng.report()
    monkeypatch.setenv("TPULLM_MLA", "0")
    c = deepseek2.make_cache(hp, 1, 64, torch.bfloat16)
    assert isinstance(c, kvcache.KVCache) and tuple(c.k.shape) == (3, 1, 16, 64, 96)
    assert tuple(c.v.shape) == (3, 1, 16, 64, 32)


def _arrays(cache) -> dict:
    """A cache's kind and its arrays' (dtype, shape), either package's."""
    out = {"kind": type(cache).__name__}
    for name, v in vars(cache).items():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            out[name] = (str(v.dtype).removeprefix("torch."), tuple(v.shape))
    return out


MLA_KV = {"f16": ("f16", "f16"), "bf16": ("bf16", "bf16"), "f32": ("f32", "f32"),
          "q8_0": ("q8_0", "q8_0"), "dtype-bf16": (torch.bfloat16, jnp.bfloat16),
          "dtype-f16": (torch.float16, jnp.float16), "dtype-f32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("kv", list(MLA_KV))
@pytest.mark.parametrize("form", ["absorbed", "decompressed", "decompressed-mla-keys"])
def test_mla_cache_types_as_jax(paths, monkeypatch, form, kv):
    """deepseek2.make_cache against the JAX package's `_mla_cache`
    (tpullm/models/registry.py) for every named cache type and dtype, in
    both forms: the same kind, and every array of the same dtype and
    shape. Absorbed, and decompressed with the *_mla keys (per-head dims
    of 40 / 24 set on both packages' hparams), every name gives bf16;
    decompressed without them kvcache.make_cache maps the names (q8_0: the
    quantized cache); a dtype is kept."""
    monkeypatch.setenv("TPULLM_MLA", "1" if form == "absorbed" else "0")
    hp = hparams_from_gguf(GGUFReader(paths["tiny"]))
    jhp = jhparams(JReader(paths["tiny"]))
    if form == "decompressed-mla-keys":
        hp = dataclasses.replace(hp, head_dim_k_mla=40, head_dim_v_mla=24)
        jhp = dataclasses.replace(jhp, head_dim_k_mla=40, head_dim_v_mla=24)
    tkv, jkv_ = MLA_KV[kv]
    got = _arrays(deepseek2.make_cache(hp, 2, 64, tkv))
    want = _arrays(jget_arch("deepseek2").make_cache(jhp, 2, 64, jkv_))
    assert got == want
    if form != "decompressed" and isinstance(tkv, str):
        assert {v[0] for k, v in got.items() if k != "kind"} == {"bfloat16"}


def test_mla_cache_writes_and_views():
    """kv() gives k and v = k[..., :kvr], a view; update writes in place at
    a host int, a 0-d device tensor (T = 1) and per-slot offsets (−1 leaves
    the slot as it was); first_slots is a view."""
    c = kvcache.MLACache.new(2, 3, 16, 6, 2, torch.float32)
    k, v = c.kv(1)
    assert flash.is_latent(k, v) and v.data_ptr() == k.data_ptr() and v.shape[-1] == 6
    new = torch.arange(3 * 4 * 8, dtype=torch.float32).reshape(3, 1, 4, 8)
    c.update(1, new, None, 5)
    assert torch.equal(c.c[1, :, :, 5:9], new) and not c.c[0].any()
    c.update(0, new[:, :, :1], None, torch.tensor(2, dtype=torch.int32))
    assert torch.equal(c.c[0, :, :, 2], new[:, :, 0])
    before = c.c[1, 1].clone()
    c.update(1, new[:, :, :2] + 1000, None, torch.tensor([0, -1, 14], dtype=torch.int32))
    assert torch.equal(c.c[1, 0, :, 0:2], new[0, :, :2] + 1000)
    assert torch.equal(c.c[1, 1], before)
    assert torch.equal(c.c[1, 2, :, 14:16], new[2, :, :2] + 1000)
    view = c.first_slots(2)
    view.update(0, new[:2, :, :1] * 0 - 1, None, 0)
    assert (c.c[0, :2, :, 0] == -1).all() and view.batch == 2 and view.max_len == 16


# ---------------------------------------------------------------------------
# forward against the JAX package
# ---------------------------------------------------------------------------

def _params(path, mode: str, dtype: str):
    r, jr = GGUFReader(path), JReader(path)
    hp, jhp = hparams_from_gguf(r), jhparams(jr)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    return (hp, deepseek2.build_params(r, hp, "cpu", tdt, mode), tdt, jhp,
            jds.build_params(jr, jhp, mode=mode, dtype=jdt), jdt)


def _run(hp, params, cache, feeds) -> list[np.ndarray]:
    """Each chunk of `feeds` fed in turn: every row's logits."""
    out, n = [], 0
    for toks in feeds:
        pos = torch.arange(n, n + len(toks), dtype=torch.int32)[None]
        with torch.inference_mode():
            logits, cache = deepseek2.forward(hp, params, torch.tensor([toks]), pos, cache, n)
        out.append(logits[0].float().numpy())
        n += len(toks)
    return out


def _jrun(jhp, jparams, jcache, feeds) -> list[np.ndarray]:
    out, n = [], 0
    for toks in feeds:
        pos = jnp.arange(n, n + len(toks), dtype=jnp.int32)[None]
        logits, jcache = jds.forward(jhp, jparams, jnp.asarray([toks]), pos, jcache, n)
        out.append(np.asarray(logits[0], np.float32))
        n += len(toks)
    return out


FEEDS = [_ids(20, 0), [7], [9], [100], _ids(9, 1)]


@pytest.mark.parametrize("form", ["absorbed", "decompressed"])
@pytest.mark.parametrize("name", ["jax", "tiny"])
def test_forward_matches_jax_f32(paths, name, form, monkeypatch):
    """deepseek2.forward against the JAX package's on dense f32 weights and
    an f32 cache: the absorbed form on MLACache and (TPULLM_MLA=0) the
    decompressed one on a per-head KVCache; a prefill, three decode steps
    and a second chunk; every row's logits within F32_NMSE."""
    if form == "decompressed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    hp, params, tdt, jhp, jparams, jdt = _params(paths[name], "dense", "f32")
    cache = deepseek2.make_cache(hp, 1, 64, tdt)
    jcache = jget_arch("deepseek2").make_cache(jhp, 1, 64, jdt)
    assert isinstance(cache, kvcache.MLACache) == (form == "absorbed")
    assert isinstance(jcache, jkv.MLACache) == (form == "absorbed")
    errs = [_nmse(a, b) for a, b in zip(_run(hp, params, cache, FEEDS),
                                        _jrun(jhp, jparams, jcache, FEEDS))]
    assert max(errs) <= F32_NMSE, errs


def test_forward_matches_jax_packed(paths):
    """The same on tiny-deepseek2's packed planes (the kernels' plain
    versions), bf16 activations and a bf16 latent: NMSE ≤ NMSE_BOUND."""
    hp, params, tdt, jhp, jparams, jdt = _params(paths["tiny"], "auto", "bf16")
    assert isinstance(params["layers"][1]["w_gate_exps"], weights.QuantExpertStack)
    cache = deepseek2.make_cache(hp, 1, 64, tdt)
    jcache = jget_arch("deepseek2").make_cache(jhp, 1, 64, jdt)
    errs = [_nmse(a, b) for a, b in zip(_run(hp, params, cache, FEEDS),
                                        _jrun(jhp, jparams, jcache, FEEDS))]
    assert max(errs) <= NMSE_BOUND, errs


@pytest.mark.parametrize("name", ["jax", "tiny"])
def test_absorbed_matches_decompressed(paths, name, monkeypatch):
    """The port's two forms on the same dense f32 weights: wk_b and wv_b
    applied around the latent attention give the decompressed MHA's
    logits (the products reassociated): within F32_NMSE."""
    hp, params, tdt, _, _, _ = _params(paths[name], "dense", "f32")
    absorbed = _run(hp, params, deepseek2.make_cache(hp, 1, 64, tdt), FEEDS)
    monkeypatch.setenv("TPULLM_MLA", "0")
    hp, params, tdt, _, _, _ = _params(paths[name], "dense", "f32")
    plain = _run(hp, params, deepseek2.make_cache(hp, 1, 64, tdt), FEEDS)
    assert max(_nmse(a, b) for a, b in zip(absorbed, plain)) <= F32_NMSE


def test_decode_after_prefill_matches_one_prefill(paths):
    """A prefill of 20 tokens then 9 decode steps gives, row for row, the
    logits of one 29-token prefill (f32)."""
    hp, params, tdt, _, _, _ = _params(paths["tiny"], "dense", "f32")
    toks = _ids(29, 2)
    steps = _run(hp, params, deepseek2.make_cache(hp, 1, 64, tdt),
                 [toks[:20]] + [[t] for t in toks[20:]])
    one = _run(hp, params, deepseek2.make_cache(hp, 1, 64, tdt), [toks])[0]
    got = np.concatenate(steps, axis=0)
    assert _nmse(got, one) <= F32_NMSE


# ---------------------------------------------------------------------------
# Engine, BatchEngine, state files and speculative decoding against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(paths):
    """The port's and the JAX package's Engines on tiny-deepseek2, packed
    weights, a bf16 latent."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        return (Engine(paths["tiny"], device="cpu", max_seq=128),
                JEngine(paths["tiny"], max_seq=128, kv_dtype=jnp.bfloat16))


def test_engine_greedy_as_jax(engines):
    """Greedy ids of the decode graph's step (generate_tokens_device, two
    chunks and a tail) and of the host loop equal the JAX Engine's, and the
    prompt's logits agree within NMSE_BOUND."""
    te, je = engines
    assert isinstance(te.cache, kvcache.MLACache) and isinstance(je.cache, jkv.MLACache)
    prompt = _ids(24, 3)
    te.reset()
    je.reset()
    assert _nmse(te.prefill(prompt), je.prefill(prompt)) <= NMSE_BOUND
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    want = je.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    assert got == want and len(got) == 20
    te.reset()
    assert list(te.generate_tokens(prompt, 20, stop_on_eog=False)) == got


def _batch_rows(eng) -> list:
    """A joint prefill of slots 0 and 2 (slot 1 idle), decode steps with an
    idle slot, slot 2 freed and re-admitted: each fed row's logits."""
    rows = []
    got = eng.prefill_slots({0: _ids(30, 4), 2: _ids(11, 5)})
    rows += [got[0], got[2]]
    for feed in ({0: 101, 2: 102}, {0: 103}, {2: 104}, {0: 105, 2: 106}):
        got = eng.decode_batch(feed)
        rows += [got[s] for s in feed]
    eng.free_slot(2)
    rows.append(eng.prefill_slots({2: _ids(9, 6)})[2])
    rows += list(eng.decode_batch({0: 107, 2: 108}).values())
    return rows


def test_batch_engine_matches_jax(paths):
    """BatchEngine on the latent (per-slot offsets, −1 for the idle slots)
    against the JAX BatchEngine on dense f32 weights and an f32 latent:
    every row within F32_NMSE; the idle slot's latent rows stay zero."""
    kw = dict(n_slots=3, max_seq=64, prefill_chunk=16, mode="dense")
    te = BatchEngine(paths["tiny"], device="cpu", dtype=torch.float32, kv_dtype=torch.float32,
                     **kw)
    je = JBatchEngine(paths["tiny"], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert isinstance(te.cache, kvcache.MLACache) and isinstance(je.cache, jkv.MLACache)
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te), _batch_rows(je))]
    assert len(errs) == 11 and max(errs) <= F32_NMSE, errs
    assert not te.cache.c[:, 1].any()


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_mla_state_files_cross_packages(engines, tmp_path, direction):
    """An MLA state file (the latent rows, `mla_kvr`) saved by one package
    restores in the other; the continuation's greedy ids are the saver's."""
    te, je = engines
    saver, loader = (je, te) if direction == "jax to port" else (te, je)
    save, load = ((jstate.save_state, state.load_state) if direction == "jax to port"
                  else (state.save_state, jstate.load_state))
    prompt = _ids(33, 7)
    saver.reset()
    first = int(np.argmax(saver.prefill(prompt)))
    p = str(tmp_path / "mla-state.npz")
    save(saver, p, tokens=prompt)
    with np.load(p) as z:
        assert int(z["mla_kvr"]) == 512 and z["k"].shape == (3, 1, 33, 576)

    def cont(eng):
        out = [first]
        for _ in range(6):
            out.append(int(np.argmax(eng.decode_step(out[-1]))))
        return out

    want = cont(saver)
    loader.reset()
    assert load(loader, p) == prompt and loader.n_past == 33
    assert cont(loader) == want


def test_mla_state_mismatch_raises(paths, tmp_path, monkeypatch):
    """An MLA file restores only into an MLACache engine, and the
    decompressed form's file (TPULLM_MLA=0, the same model) not into one."""
    mla = Engine(paths["tiny"], device="cpu", max_seq=64)
    monkeypatch.setenv("TPULLM_MLA", "0")
    plain = Engine(paths["tiny"], device="cpu", max_seq=64)
    assert isinstance(plain.cache, kvcache.KVCache)
    for eng, name in ((mla, "mla.npz"), (plain, "plain.npz")):
        eng.prefill(_ids(5, 8))
        state.save_state(eng, str(tmp_path / name))
    with pytest.raises(ValueError, match="MLA state file"):
        state.load_state(plain, str(tmp_path / "mla.npz"))
    with pytest.raises(ValueError, match="MLA state file"):
        state.load_state(mla, str(tmp_path / "plain.npz"))


def test_generate_speculative_ngram_as_jax(engines):
    """generate_speculative with the n-gram speculator (the verify graph's
    per-slot write into the latent), greedy: the ids equal the JAX
    package's and the port's plain greedy generation."""
    te, je = engines
    prompt = _ids(12, 9) * 3
    te.reset()
    plain = list(te.generate_tokens(prompt, 24, stop_on_eog=False))
    te.reset()
    je.reset()
    got, gs = speculative.generate_speculative(
        te, speculative.make_speculator("ngram_simple", n_draft=4), prompt, 24)
    want, ws = jspec.generate_speculative(
        je, jspec.make_speculator("ngram_simple", n_draft=4), prompt, 24)
    assert got == want == plain and len(got) == 24
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws) and gs.n_rounds > 0


def test_params_from_jax_carries_the_deepseek2_tree(paths):
    """The JAX Engine's deepseek2 tree (wk_b / wv_b, the shared experts, the
    router, expert stacks) carried across gives the port's own logits."""
    from tpullm_torch.convert import params_from_jax

    je = JEngine(paths["tiny"], max_seq=64, kv_dtype=jnp.bfloat16)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    layer = tree["layers"][1]
    assert tuple(layer["wk_b"].shape) == (16, 32, 512) and layer["wkv_b"] is None
    carried = Engine(paths["tiny"], device="cpu", max_seq=64)
    own = Engine(paths["tiny"], device="cpu", max_seq=64)
    carried.params = tree
    ids = _ids(20, 10)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
    assert _nmse(carried.decode_step(100), own.decode_step(100)) <= NMSE_BOUND


# ---------------------------------------------------------------------------
# the plain flash versions at Dk ≠ Dv, V a prefix of K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(576, 512), (32, 24)], ids=["576-512", "32-24"])
@pytest.mark.parametrize("T,offsets", [(1, (0, 70)), (8, (3, 40)), (24, (0, 50))],
                         ids=["decode", "verify", "prefill"])
def test_flash_plain_versions_latent(dims, T, offsets):
    """flash_reference, flash_split_reference and flash_prefill_reference
    with v = k[..., :Dv] (the MLA latent, one KV head, 16 heads) against
    the JAX Pallas kernel in interpret mode on the same bf16 inputs."""
    Dk, Dv = dims
    B, H, S = 2, 16, 128
    rng = np.random.default_rng(Dk + T)
    q = rng.standard_normal((B, T, H, Dk)).astype(np.float32)
    c = rng.standard_normal((B, 1, S, Dk)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    scale = 192 ** -0.5
    jc = jnp.asarray(c, jnp.bfloat16)
    ref = np.asarray(jflash.flash_attention(jnp.asarray(q, jnp.bfloat16), jc, jc[..., :Dv],
                                            jnp.asarray(off), scale), np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tc = torch.from_numpy(c).to(torch.bfloat16)
    tv = tc[..., :Dv]
    assert flash.is_latent(tc, tv)
    toff = torch.from_numpy(off)
    for fn in (flash.flash_reference, flash.flash_split_reference,
               flash.flash_prefill_reference):
        got = fn(tq, tc, tv, toff, scale)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, H, Dv)
        assert _nmse(got.float().numpy(), ref) <= FLASH_NMSE, fn.__name__


def test_flash_takes_the_latent_form_only_at_576_512_bf16():
    """The kernel's latent form: (576, 512) (and MiniCPM3's (288, 256)) on a
    bf16 cache; f16 and f32 latents and other widths go to the counted
    dense route. The decompressed form's (192, 128) takes the dense
    kernels at Dk ≠ Dv; (112, 112) stays refused."""
    assert flash.takes(576, 512, True, torch.bfloat16)
    assert flash.takes(288, 256, True, torch.bfloat16)
    assert not flash.takes(576, 512, True, torch.float16)
    assert not flash.takes(576, 512, True, torch.float32)
    assert not flash.takes(32, 24, True, torch.bfloat16)
    assert flash.takes(192, 128) and flash.takes(128, 128) and not flash.takes(112, 112)
    assert flash.dims_key(576, 512) == "d576v512" and "bf16.d576v512.decode" in flash.LAUNCHES
    k = torch.zeros(1, 1, 8, 576)
    assert flash.is_latent(k, k[..., :512]) and not flash.is_latent(k, k[..., :512].clone())


# ---------------------------------------------------------------------------
# routing and the expert stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gating,norm,scale", [("softmax", False, 1.0), ("sigmoid", True, 2.5)])
def test_route_ties_and_select_bias_as_jax(gating, norm, scale):
    """route's experts and weights equal the JAX package's under a
    selection bias with exact ties in probs + bias (the lower expert id
    first, as jax.lax.top_k orders them) and without one."""
    logits = np.zeros((6, 8), np.float32)
    logits[1] = [0.5, 0.5, 0.5, 0.1, 0.1, 0.5, 0.2, 0.2]
    logits[2:] = np.random.default_rng(11).standard_normal((4, 8))
    bias = np.array([0.0, 0.25, 0.0, 0.0, 0.25, 0.0, 0.0, 0.0], np.float32)
    for b in (None, bias):
        w, i = moe.route(torch.from_numpy(logits), 3, gating, norm, scale,
                         None if b is None else torch.from_numpy(b))
        jw, ji = jmoe.route(jnp.asarray(logits), 3, gating, norm, scale,
                            None if b is None else jnp.asarray(b))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gtype", ["Q5_0", "Q8_0"])
def test_load_expert_stack_k1408_dense_as_jax(tmp_path, gtype, monkeypatch):
    """A stack of experts at K = 1408 (DeepSeek-V2-Lite's down experts, at
    the recipe's fallback types) is dense at load in both packages, with
    equal values; a stack at K = 256 stays packed in both."""
    gt = GGMLType[gtype]
    rng = np.random.default_rng(12)
    path = str(tmp_path / "stacks.gguf")
    w = JWriter(path, architecture="llama")
    for name, n_in in (("down_exps", 1408), ("gate_exps", 256)):
        raw = random_packed(rng, gt, 3 * 128 * n_in, scale=0.01)
        w.add_packed_tensor(f"blk.0.ffn_{name}.weight", (n_in, 128, 3), gt, raw.tobytes())
    w.write()
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "0")
    jt, tt = JReader(path).tensors, GGUFReader(path).tensors
    jw = jweights.load_expert_stack(jt["blk.0.ffn_down_exps.weight"], dtype=jnp.float32)
    tw = weights.load_expert_stack(tt["blk.0.ffn_down_exps.weight"], "cpu", torch.float32)
    assert isinstance(tw, torch.Tensor) and not hasattr(jw, "planes")
    assert tuple(tw.shape) == tuple(jw.shape) == (3, 1408, 128)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert isinstance(weights.load_expert_stack(tt["blk.0.ffn_gate_exps.weight"], "cpu"),
                      weights.QuantExpertStack)
    assert hasattr(jweights.load_expert_stack(jt["blk.0.ffn_gate_exps.weight"]), "planes")


# ---------------------------------------------------------------------------
# the synthetic files
# ---------------------------------------------------------------------------

def test_synthetic_deepseek_v2_lite_recipe():
    """DeepSeek-V2-Lite at Q4_K_M: its published widths, YaRN as llama.cpp's
    converter writes it, the recipe's types (the K = 1408 down experts and
    the K = 10944 dense down at their fallbacks: Q5_0, or Q8_0 on the
    use_more_bits layers), about 10.4 GB of payload; written lazily, so
    the file is sized without being drawn."""
    cfg = SHAPES["deepseek-v2-lite"]
    assert (cfg["n_layer"], cfg["n_embd"], cfg["n_head"], cfg["kv_lora"], cfg["n_expert"],
            cfg["n_expert_used"], cfg["n_ff_exp"], cfg["n_ff"]) == \
        (27, 2048, 16, 512, 64, 6, 1408, 10944)
    w = synthetic_writer("unused.gguf", shape="deepseek-v2-lite")
    assert 10.2e9 < w.payload_bytes() < 10.6e9
    kv = {k: v for k, _, v in w._kv}
    assert (kv["deepseek2.rope.scaling.type"], kv["deepseek2.rope.scaling.factor"],
            kv["deepseek2.rope.scaling.original_context_length"],
            kv["deepseek2.rope.scaling.yarn_log_multiplier"]) == ("yarn", 40.0, 4096, 0.0707)
    assert (kv["deepseek2.attention.key_length"], kv["deepseek2.attention.value_length"],
            kv["deepseek2.rope.dimension_count"], kv["deepseek2.expert_shared_count"]) == \
        (192, 128, 64, 2)
    more = [i for i in range(27) if preset_type("Q4_K_M", "ffn_down_exps", i, 27, 64,
                                                n_in=1408) == GGMLType.Q8_0]
    assert more == [0, 1, 2, 5, 8, 11, 14, 17, 20, 23, 24, 25, 26]
    assert preset_type("Q4_K_M", "ffn_down_exps", 3, 27, 64, n_in=1408) == GGMLType.Q5_0
    assert preset_type("Q4_K_M", "ffn_down", 0, 27, 64, n_in=10944) == GGMLType.Q8_0
    assert preset_type("Q4_K_M", "ffn_down_shexp", 3, 27, 64, n_in=2816) == GGMLType.Q4_K
    assert preset_type("Q4_K_M", "attn_kv_b", 3, 27, 64, n_in=512) == GGMLType.Q4_K
    assert preset_type("Q4_K_M", "ffn_down", 5, 32, 0, n_in=14336) == GGMLType.Q4_K


def test_synthetic_tiny_deepseek2_file(paths):
    """tiny-deepseek2's tensors carry the names the JAX package reads
    (attn_kv_b fused; no q LoRA, no exp_probs_b) and its YaRN-free rope."""
    r = GGUFReader(paths["tiny"])
    names = set(r.tensors)
    assert {"blk.0.attn_kv_a_mqa.weight", "blk.0.attn_kv_b.weight", "blk.0.ffn_down.weight",
            "blk.1.ffn_gate_shexp.weight", "blk.2.ffn_down_exps.weight"} <= names
    assert not any("attn_k_b" in n or "q_a" in n or "exp_probs_b" in n for n in names)
    assert r.tensors["blk.1.ffn_gate_exps.weight"].shape == (256, 256, 4)


def test_yarn_rope_as_jax(tmp_path):
    """DeepSeek-V2-Lite's YaRN metadata as llama.cpp's converter writes it
    (type yarn, factor 40 on 4096, yarn_log_multiplier 0.0707, no ext
    factor): both packages read the same RopeParams (ext_factor 0, so no
    ramp and no mscale: ROADMAP §3) and give the same cos/sin tables up
    to position 4096."""
    from tpullm.ops import rope as jrope

    from tpullm_torch.gguf.writer import GGUFWriter
    from tpullm_torch.ops import rope

    path = tmp_path / "yarn.gguf"
    w = GGUFWriter(path, architecture="deepseek2")
    kv = {k: v for k, _, v in synthetic_writer("unused.gguf", shape="deepseek-v2-lite")._kv}
    for key in ("block_count", "embedding_length", "attention.head_count",
                "attention.head_count_kv", "attention.key_length", "attention.value_length",
                "attention.kv_lora_rank", "rope.dimension_count", "rope.freq_base",
                "rope.scaling.type", "rope.scaling.factor",
                "rope.scaling.original_context_length", "rope.scaling.yarn_log_multiplier"):
        w.add_kv(f"deepseek2.{key}", kv[f"deepseek2.{key}"])
    w.add_tensor("output_norm.weight", np.ones(8, np.float32))
    w.write()
    hp, jhp = hparams_from_gguf(GGUFReader(path)), jhparams(JReader(str(path)))
    for f in hp.rope.__dataclass_fields__:
        assert getattr(hp.rope, f) == getattr(jhp.rope, f), f
    assert (hp.rope.scaling_type, hp.rope.scale_factor, hp.rope.ext_factor) == ("yarn", 40.0, 0.0)
    pos = np.arange(4096, dtype=np.int32)[None]
    cos, sin = rope.rope_angles(hp.rope, torch.from_numpy(pos))
    jcos, jsin = jrope.rope_angles(jhp.rope, jnp.asarray(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)


def test_server_serves_deepseek2_as_jax(paths):
    """The server's Scheduler on a BatchEngine of tiny-deepseek2 (the
    latent, per-slot offsets, joint rounds) with no change of its own:
    four greedy requests on two slots (two wait for a slot) give the JAX
    scheduler's ids and finish reasons, and an HTTP completion through the
    port's server answers with those ids' text."""
    import http.client
    import json

    from tpullm.runtime.sampling import SamplerParams as JSamplerParams
    from tpullm.server.scheduler import GenRequest as JGenRequest
    from tpullm.server.scheduler import Scheduler as JScheduler

    from tpullm_torch.runtime.sampling import SamplerParams
    from tpullm_torch.server.api import Server, serve
    from tpullm_torch.server.scheduler import GenRequest, Scheduler

    kw = dict(n_slots=2, max_seq=128, prefill_chunk=16)
    te = BatchEngine(paths["tiny"], device="cpu", **kw)
    je = JBatchEngine(paths["tiny"], kv_dtype=jnp.bfloat16, **kw)
    prompts = [_ids(n, 20 + n) for n in (5, 23, 9, 14)]

    def run(sched, cls, params):
        reqs = [cls(prompt_ids=p, max_tokens=8, sampling=params(temp=0.0)) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.start()
        try:
            out = []
            for r in reqs:
                toks = []
                while True:
                    ev = r.out.get(timeout=300)
                    if ev[0] != "token":
                        out.append((toks, ev[1]))
                        break
                    toks.append(ev[1])
            return out
        finally:
            sched.stop()

    got = run(Scheduler(te), GenRequest, SamplerParams)
    assert got == run(JScheduler(je), JGenRequest, JSamplerParams)
    assert all(len(t) == 8 for t, _ in got)
    sched = Scheduler(te)
    sched.start()
    httpd = serve(Server(sched).app, "127.0.0.1", 0)
    try:
        c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        c.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompts[0], "max_tokens": 8, "temperature": 0.0}),
            {"Content-Type": "application/json"})
        r = c.getresponse()
        body = json.loads(r.read().decode())
        c.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    assert r.status == 200
    assert body["choices"][0]["text"] == te.tokenizer.detokenize(got[0][0])
