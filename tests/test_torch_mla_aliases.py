"""Port parity of deepseek2's MLA aliases, `minicpm3` (the MLA graph with
minicpm's embedding, residual and logit multipliers and a q LoRA) and `plm`
(all-dense MLA, q direct, a gateless ReLU² FFN, tied head), and of the
flash kernel's plain versions at their shapes, against the JAX package,
both on the CPU.

Four fixtures: the JAX package's own (tpullm/models/testing.py
make_tiny_deepseek2_gguf(arch="minicpm3", n_dense_lead=10**6): every layer
dense SwiGLU, latent 24 + 8; make_tiny_plm_gguf: latent 24 + 8; f32
tensors) and the port's synthetic "tiny-minicpm3" (MiniCPM3-4B's latent
256 + 32, the kernel's (288, 256), and its heads 96 / 64; 40 heads on the
latent's one KV head, so a decode step is R = 40 query rows) and "tiny-plm"
(PLM-1.8B's latent 512 + 64 and heads 192 / 128), packed Q4_K_M.

Tolerances, as tests/test_torch_deepseek2.py holds them: dense f32 weights
and an f32 cache make the two packages' graphs the same f32 arithmetic in
another order: logits within NMSE 1e-6. Packed weights, bf16 activations
and a bf16 cache: NMSE ≤ 1e-3. The plain flash versions against the JAX
Pallas kernel in interpret mode: NMSE ≤ 1e-5 (f32 sums in another order,
the bf16 output rounding). The JAX side loads through its device repack
(`TPULLM_DEVICE_REPACK=1`, the load the port mirrors)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.models import deepseek2 as jds
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm.models.registry import get_arch as jget_arch
from tpullm.models.testing import make_tiny_deepseek2_gguf, make_tiny_plm_gguf
from tpullm.ops.pallas import flash as jflash
from tpullm.runtime import kvcache as jkv
from tpullm.runtime import state as jstate
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models import deepseek2
from tpullm_torch.models.hparams import hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.ops.kernels import flash
from tpullm_torch.runtime import kvcache, state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 cache
FLASH_NMSE = 1e-5  # plain flash versions against the Pallas kernel (interpret mode)
NAMES = ["jax-minicpm3", "jax-plm", "tiny-minicpm3", "tiny-plm"]
TINY = ["tiny-minicpm3", "tiny-plm"]
ARCH = {"jax-minicpm3": "minicpm3", "jax-plm": "plm", "tiny-minicpm3": "minicpm3",
        "tiny-plm": "plm"}


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 250) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla_aliases")
    return {"jax-minicpm3": make_tiny_deepseek2_gguf(str(d / "jax-minicpm3.gguf"),
                                                     arch="minicpm3", n_dense_lead=10**6),
            "jax-plm": make_tiny_plm_gguf(str(d / "jax-plm.gguf")),
            **{name: str(make_synthetic_llama_gguf(d / f"{name}.gguf", shape=name, seed=0))
               for name in TINY}}


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


# ---------------------------------------------------------------------------
# hparams, the registry and the caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_hparams_match_jax(paths, name):
    """Every field of the port's HParams equals the JAX package's: the MLA
    ranks and dims, minicpm3's multipliers (embedding 12, residual
    1.4/√n_layer, logits 256/n_embd), the RoPE style."""
    hp = hparams_from_gguf(GGUFReader(paths[name]))
    jhp = jhparams(JReader(paths[name]))
    for field in hp.__dataclass_fields__:
        got, want = getattr(hp, field), getattr(jhp, field)
        if field == "rope":
            for f in got.__dataclass_fields__:
                assert getattr(got, f) == getattr(want, f), f"rope.{f}"
        else:
            assert got == want, field
    assert hp.arch == ARCH[name]
    if ARCH[name] == "minicpm3":
        assert (hp.embd_scale, hp.residual_scale, hp.logit_scale, hp.rope.style) == \
            (12.0, 1.4 / hp.n_layer ** 0.5, 256.0 / hp.n_embd, "neox")
    else:
        assert (hp.embd_scale, hp.residual_scale, hp.logit_scale, hp.n_lora_q,
                hp.rope.style) == (1.0, 1.0, 1.0, 0, "norm")
    want = {"jax-minicpm3": (24, 24, 24, 16, 8), "jax-plm": (0, 24, 24, 16, 8),
            "tiny-minicpm3": (256, 256, 96, 64, 32), "tiny-plm": (0, 512, 192, 128, 64)}[name]
    assert (hp.n_lora_q, hp.n_lora_kv, hp.head_dim, hp.head_dim_v, hp.rope.dims) == want
    assert (hp.head_dim_k_mla, hp.head_dim_v_mla) == (0, 0)


@pytest.mark.parametrize("name", TINY)
def test_registry_and_cache_kinds(paths, name, monkeypatch):
    """minicpm3 and plm resolve to deepseek2's graph and cache: the bf16
    latent [L, B, 1, S, kvr + n_rot] (288 wide for MiniCPM3, 576 for PLM;
    a q8 request too); TPULLM_MLA=0 the per-head cache, K at head_dim and
    V at head_dim_v, and a q8 request a QuantKVCache of those widths."""
    spec = get_arch(ARCH[name])
    assert spec.forward is deepseek2.forward and spec.make_cache is deepseek2.make_cache
    hp = hparams_from_gguf(GGUFReader(paths[name]))
    dk, dv, heads = {"tiny-minicpm3": (96, 64, 40), "tiny-plm": (192, 128, 4)}[name]
    for kv in (torch.bfloat16, "q8_0"):
        c = deepseek2.make_cache(hp, 2, 64, kv)
        assert isinstance(c, kvcache.MLACache) and c.c.dtype == torch.bfloat16
        assert tuple(c.c.shape) == (2, 2, 1, 64, hp.n_lora_kv + hp.rope.dims)
        k, v = c.kv(0)
        assert flash.is_latent(k, v) and flash.takes(k.shape[-1], v.shape[-1], True, k.dtype)
    monkeypatch.setenv("TPULLM_MLA", "0")
    c = deepseek2.make_cache(hp, 1, 64, torch.bfloat16)
    assert isinstance(c, kvcache.KVCache)
    assert (tuple(c.k.shape), tuple(c.v.shape)) == ((2, 1, heads, 64, dk), (2, 1, heads, 64, dv))
    q = deepseek2.make_cache(hp, 1, 64, "q8_0")
    assert isinstance(q, kvcache.QuantKVCache)
    assert (q.k_q.shape[-1], q.v_q.shape[-1], q.k_s.shape) == (dk, dv, (2, 1, heads, 64))
    assert flash.takes(dk, dv)


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


def _against_jax(path, arch, mode, dtype):
    hp, params, tdt, jhp, jparams, jdt = _params(path, mode, dtype)
    cache = deepseek2.make_cache(hp, 1, 64, tdt)
    jcache = jget_arch(arch).make_cache(jhp, 1, 64, jdt)
    assert isinstance(cache, kvcache.MLACache) == isinstance(jcache, jkv.MLACache)
    return [_nmse(a, b) for a, b in zip(_run(hp, params, cache, FEEDS),
                                        _jrun(jhp, jparams, jcache, FEEDS))], params


@pytest.mark.parametrize("form", ["absorbed", "decompressed"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_f32(paths, name, form, monkeypatch):
    """deepseek2.forward on minicpm3 and plm against the JAX package's on
    dense f32 weights and an f32 cache, in both forms (TPULLM_MLA=0: the
    decompressed one); a prefill, three decode steps and a second chunk;
    every row's logits within F32_NMSE. plm's layers have no gate (the
    ReLU² branch)."""
    if form == "decompressed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    errs, params = _against_jax(paths[name], ARCH[name], "dense", "f32")
    assert max(errs) <= F32_NMSE, errs
    layer = params["layers"][0]
    assert (layer["w_gate"] is None) == (ARCH[name] == "plm") and layer.get("router") is None
    assert (layer["wkv_b"] is None) == (form == "absorbed")


@pytest.mark.parametrize("form", ["absorbed", "decompressed"])
@pytest.mark.parametrize("name", TINY)
def test_forward_matches_jax_packed(paths, name, form, monkeypatch):
    """The same on the tiny shapes' packed planes (the kernels' plain
    versions), bf16 activations and a bf16 cache: NMSE ≤ NMSE_BOUND."""
    if form == "decompressed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    errs, _ = _against_jax(paths[name], ARCH[name], "auto", "bf16")
    assert max(errs) <= NMSE_BOUND, errs


@pytest.mark.parametrize("name", NAMES)
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


# ---------------------------------------------------------------------------
# Engine, BatchEngine, state files and params_from_jax against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=TINY)
def engines(request, paths):
    """The port's and the JAX package's Engines on a tiny shape, packed
    weights, a bf16 latent."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        return (request.param, Engine(paths[request.param], device="cpu", max_seq=128),
                JEngine(paths[request.param], max_seq=128, kv_dtype=jnp.bfloat16))


def test_engine_greedy_as_jax(engines):
    """Greedy ids of the decode graph's step (generate_tokens_device, two
    chunks and a tail) and of the host loop equal the JAX Engine's, and the
    prompt's logits agree within NMSE_BOUND."""
    _, te, je = engines
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


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_mla_state_files_cross_packages(engines, tmp_path, direction):
    """An MLA state file (the latent rows, `mla_kvr` 256 or 512) saved by
    one package restores in the other; the continuation's greedy ids are
    the saver's."""
    name, te, je = engines
    saver, loader = (je, te) if direction == "jax to port" else (te, je)
    save, load = ((jstate.save_state, state.load_state) if direction == "jax to port"
                  else (state.save_state, jstate.load_state))
    prompt = _ids(33, 7)
    saver.reset()
    first = int(np.argmax(saver.prefill(prompt)))
    p = str(tmp_path / "mla-state.npz")
    save(saver, p, tokens=prompt)
    kvr, width = {"tiny-minicpm3": (256, 288), "tiny-plm": (512, 576)}[name]
    with np.load(p) as z:
        assert int(z["mla_kvr"]) == kvr and z["k"].shape == (2, 1, 33, width)

    def cont(eng):
        out = [first]
        for _ in range(6):
            out.append(int(np.argmax(eng.decode_step(out[-1]))))
        return out

    want = cont(saver)
    loader.reset()
    assert load(loader, p) == prompt and loader.n_past == 33
    assert cont(loader) == want


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


@pytest.mark.parametrize("form", ["absorbed", "decompressed"])
@pytest.mark.parametrize("name", TINY)
def test_batch_engine_matches_jax(paths, name, form, monkeypatch):
    """BatchEngine (per-slot offsets, −1 for the idle slots) against the JAX
    BatchEngine on dense f32 weights and an f32 cache, the latent and
    (TPULLM_MLA=0) the per-head cache: every row within F32_NMSE; the idle
    slot's rows stay zero."""
    if form == "decompressed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    kw = dict(n_slots=3, max_seq=64, prefill_chunk=16, mode="dense")
    te = BatchEngine(paths[name], device="cpu", dtype=torch.float32, kv_dtype=torch.float32,
                     **kw)
    je = JBatchEngine(paths[name], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert isinstance(te.cache, kvcache.MLACache) == (form == "absorbed")
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te), _batch_rows(je))]
    assert len(errs) == 11 and max(errs) <= F32_NMSE, errs
    idle = te.cache.c[:, 1] if form == "absorbed" else te.cache.k[:, 1]
    assert not idle.any()


@pytest.mark.parametrize("form", ["absorbed", "decompressed"])
@pytest.mark.parametrize("name", TINY)
def test_params_from_jax_carries_the_tree(paths, name, form, monkeypatch):
    """The JAX Engine's minicpm3 / plm tree (wk_b / wv_b absorbed, or wkv_b;
    the q LoRA; plm's gateless dense layers) carried across gives the
    port's own logits."""
    from tpullm_torch.convert import params_from_jax

    if form == "decompressed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    je = JEngine(paths[name], max_seq=64, kv_dtype=jnp.bfloat16)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    layer = tree["layers"][1]
    assert (layer["wkv_b"] is None) == (form == "absorbed")
    if form == "absorbed":
        want = {"tiny-minicpm3": (40, 64, 256), "tiny-plm": (4, 128, 512)}[name]
        assert tuple(layer["wk_b"].shape) == want
    carried = Engine(paths[name], device="cpu", max_seq=64)
    own = Engine(paths[name], device="cpu", max_seq=64)
    carried.params = tree
    ids = _ids(20, 10)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
    assert _nmse(carried.decode_step(100), own.decode_step(100)) <= NMSE_BOUND


# ---------------------------------------------------------------------------
# the plain flash versions at the new shapes against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,offsets", [(1, (0, 70)), (2, (3, 40)), (9, (0, 50))],
                         ids=["decode-R40", "R80", "prefill"])
def test_flash_plain_versions_latent_288(T, offsets):
    """flash_reference, flash_split_reference (the decode regime's split
    plan: at R = 40 the latent form's row groups, which change no row's
    order) and flash_prefill_reference with v = k[..., :256], MiniCPM3's
    latent (288, 256) under 40 heads on one KV head, against the JAX
    Pallas kernel in interpret mode on the same bf16 inputs."""
    Dk, Dv, B, H, S = 288, 256, 2, 40, 128
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, T, H, Dk)).astype(np.float32)
    c = rng.standard_normal((B, 1, S, Dk)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    scale = 96 ** -0.5
    jc = jnp.asarray(c, jnp.bfloat16)
    ref = np.asarray(jflash.flash_attention(jnp.asarray(q, jnp.bfloat16), jc, jc[..., :Dv],
                                            jnp.asarray(off), scale), np.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tc = torch.from_numpy(c).to(torch.bfloat16)
    tv = tc[..., :Dv]
    assert flash.is_latent(tc, tv)
    assert flash.regime(T, H, 1, latent=True) == ("decode" if T * H <= 64 else "prefill")
    toff = torch.from_numpy(off)
    for fn in (flash.flash_reference, flash.flash_split_reference,
               flash.flash_prefill_reference):
        kw = {"p_terms": 2} if fn is flash.flash_split_reference else {}
        got = fn(tq, tc, tv, toff, scale, **kw)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, H, Dv)
        assert _nmse(got.float().numpy(), ref) <= FLASH_NMSE, fn.__name__


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("dims", [(192, 128), (96, 64)], ids=["192-128", "96-64"])
@pytest.mark.parametrize("T,offsets", [(1, (0, 70)), (4, (3, 40)), (24, (0, 50))],
                         ids=["decode", "verify", "prefill"])
def test_flash_plain_versions_dkdv(dims, T, offsets, q8):
    """The three plain versions at separate K [.., Dk] and V [.., Dv] (the
    decompressed MLA form of PLM / DeepSeek-V2 and of MiniCPM3), 8 heads on
    2 KV heads, bf16 or int8 + scales, against the JAX Pallas kernel in
    interpret mode."""
    Dk, Dv = dims
    B, H, Hkv, S = 2, 8, 2, 128
    rng = np.random.default_rng(Dk + T)
    q = rng.standard_normal((B, T, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dk)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dv)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    scale = Dk ** -0.5
    tq = torch.from_numpy(q).to(torch.bfloat16)
    if q8:
        k_q, k_s = kvcache.QuantKVCache._quantize(torch.from_numpy(k))
        v_q, v_s = kvcache.QuantKVCache._quantize(torch.from_numpy(v))
        ref = np.asarray(jflash.flash_attention_q8(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k_q.numpy()), jnp.asarray(k_s.numpy()),
            jnp.asarray(v_q.numpy()), jnp.asarray(v_s.numpy()), jnp.asarray(off), scale),
            np.float32)
        args, kw = (tq, k_q, v_q, torch.from_numpy(off), scale), dict(k_scale=k_s, v_scale=v_s)
    else:
        ref = np.asarray(jflash.flash_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.asarray(off), scale), np.float32)
        args, kw = (tq, torch.from_numpy(k).to(torch.bfloat16),
                    torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(off), scale), {}
    for fn in (flash.flash_reference, flash.flash_split_reference,
               flash.flash_prefill_reference):
        got = fn(*args, **kw)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, H, Dv)
        assert _nmse(got.float().numpy(), ref) <= FLASH_NMSE, fn.__name__


@pytest.mark.parametrize("d,dv,latent,dtype,want", [
    (288, 256, True, torch.bfloat16, True), (576, 512, True, torch.bfloat16, True),
    (288, 256, True, torch.float16, False), (288, 256, False, torch.bfloat16, False),
    (192, 128, False, torch.bfloat16, True), (96, 64, False, torch.bfloat16, True),
    (112, 112, False, torch.bfloat16, False), (128, 96, False, torch.bfloat16, False),
    (192, 128, True, torch.bfloat16, False)])
def test_flash_takes_the_new_shapes(d, dv, latent, dtype, want):
    """The kernel takes the latent (288, 256) on bf16 and Dk ≠ Dv at (192,
    128) and (96, 64) (any cache format: `takes` reads no dtype there); the
    f16 latent and other pairs stay on the counted dense route."""
    assert flash.takes(d, dv, latent, dtype) is want


def test_regimes_and_launch_keys():
    """The latent form's decode regime runs to LATENT_DECODE_ROWS = 64
    query rows (MiniCPM3's R = 40 at T = 1; V2-Lite's verify at T = 2–4),
    the dense kernels' to 16, and a decode token's to DECODE_MAX_ROWS = 80
    (in row groups, as the latent's); LAUNCHES has a key a format, pair and
    regime; the kernel source's constant matches."""
    from pathlib import Path
    import re

    assert flash.regime(1, 40, 1, latent=True) == "decode"
    assert flash.regime(1, 40, 1) == "decode" and flash.regime(2, 40, 1) == "prefill"
    assert [flash.regime(t, 16, 1, latent=True) for t in (1, 2, 4, 5)] == \
        ["decode", "decode", "decode", "prefill"]
    assert flash.regime(2, 40, 1, latent=True) == "prefill"
    for fmt in flash.FORMATS:
        for key in ("d192v128", "d96v64"):
            assert {f"{fmt}.{key}.decode", f"{fmt}.{key}.prefill"} <= set(flash.LAUNCHES)
    assert {"bf16.d288v256.decode", "bf16.d288v256.prefill"} <= set(flash.LAUNCHES)
    assert not any(k.startswith(("f16.d288", "q8.d288")) for k in flash.LAUNCHES)
    src = (Path(flash.__file__).resolve().parents[2] / "csrc" / "flash.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kLatentDecodeRows"]) == flash.LATENT_DECODE_ROWS
    assert flash._library(192, 128) == flash._library(96, 64) == "flash_dkdv"
    assert flash._library(96, 96) == "flash_narrow" and flash._library(128, 128) == "flash"


def test_cpu_call_at_dkdv_takes_the_plain_version():
    """On the CPU a (192, 128) call is flash_reference and launches nothing."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 3, 4, 192)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4, 16, 192)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 4, 16, 128)).astype(np.float32))
    off = torch.tensor([5], dtype=torch.int32)
    before = dict(flash.LAUNCHES)
    got = flash.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), off, 0.1)
    assert torch.equal(got, flash.flash_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                  off, 0.1))
    assert got.shape == (1, 3, 4, 128) and flash.LAUNCHES == before


# ---------------------------------------------------------------------------
# the synthetic files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["minicpm3-4b", "plm-1.8b"])
def test_synthetic_full_width_recipes(shape):
    """MiniCPM3-4B and PLM-1.8B at Q4_K_M: their published widths, the keys
    the converter writes (per-head key/value lengths, no *_mla keys, no
    expert keys), every linear's K a multiple of 256 (the packed planes),
    PLM's head tied; written lazily, so the file is sized without being
    drawn."""
    cfg = SHAPES[shape]
    w = synthetic_writer("unused.gguf", shape=shape)
    kv = {k: v for k, _, v in w._kv}
    arch = cfg["arch"]
    want = {"minicpm3-4b": (62, 2560, 40, 40, 6400, 73448, 96, 64, 32, 256, 768),
            "plm-1.8b": (32, 2048, 16, 16, 8192, 151936, 192, 128, 64, 512, None)}[shape]
    assert (kv[f"{arch}.block_count"], kv[f"{arch}.embedding_length"],
            kv[f"{arch}.attention.head_count"], kv[f"{arch}.attention.head_count_kv"],
            kv[f"{arch}.feed_forward_length"], kv[f"{arch}.vocab_size"],
            kv[f"{arch}.attention.key_length"], kv[f"{arch}.attention.value_length"],
            kv[f"{arch}.rope.dimension_count"], kv[f"{arch}.attention.kv_lora_rank"],
            kv.get(f"{arch}.attention.q_lora_rank")) == want
    assert not any("_mla" in k or "expert" in k or "leading_dense" in k for k in kv)
    names = {t.name for t in w._tensors}
    assert ("output.weight" in names) == (shape == "minicpm3-4b")
    assert ("blk.0.ffn_gate.weight" in names) == (shape == "minicpm3-4b")
    assert ("blk.0.attn_q_a.weight" in names) == (shape == "minicpm3-4b")
    size = {"minicpm3-4b": (2.0e9, 2.8e9), "plm-1.8b": (1.0e9, 1.5e9)}[shape]
    assert size[0] < w.payload_bytes() < size[1], w.payload_bytes()


@pytest.mark.parametrize("name", TINY)
def test_synthetic_tiny_files(paths, name):
    """The tiny shapes' tensors carry the names the JAX package reads and
    widths the packed kernels take (K a multiple of 256): tiny-minicpm3's q
    LoRA and SwiGLU, tiny-plm's direct q, gateless FFN and tied head."""
    r = GGUFReader(paths[name])
    t = r.tensors
    for info in t.values():
        if len(info.shape) == 2 and info.ggml_type not in (GGMLType.F32, GGMLType.F16):
            assert info.shape[0] % 256 == 0, info.name
    if name == "tiny-minicpm3":
        assert t["blk.0.attn_q_b.weight"].shape == (256, 40 * 96)
        assert t["blk.0.attn_kv_a_mqa.weight"].shape == (256, 288)
        assert t["blk.0.attn_kv_b.weight"].shape == (256, 40 * 128)
        assert "output.weight" in t and "blk.1.ffn_gate.weight" in t
    else:
        assert t["blk.0.attn_q.weight"].shape == (256, 4 * 192)
        assert t["blk.0.attn_kv_a_mqa.weight"].shape == (256, 576)
        assert "output.weight" not in t and "blk.1.ffn_gate.weight" not in t
        assert t["token_embd.weight"].ggml_type == GGMLType.Q6_K
