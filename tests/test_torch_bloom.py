"""Port parity of the ALiBi family (models/bloom.py: bloom, mpt, jais)
against the JAX package, both on the CPU.

Dense f32: tpullm/models/testing.py make_tiny_bloom_gguf for each arch
(bloom's token_embd_norm and biases; mpt's learned positions, clamp_kqv,
full-width q/k LayerNorms and tied head; jais' SiLU gate and 1/head_dim
scale): every row of a prompt's logits and decode steps within NMSE 1e-5
(the same f32 arithmetic in another order; the runs here land near
1e-13). Packed: the port's synthetic tiny-bloom, tiny-mpt (every mpt
option) and tiny-jais at Q4_K_M, bf16 activations and cache: NMSE 1e-3
(tests/test_torch_llama_aliases.py), the JAX side on its device repack
(`TPULLM_DEVICE_REPACK=1`). The ALiBi bias at every offset form: per-slot
offsets with an idle slot in BatchEngine, verify rows at an offset, and a
prompt resumed on a cache that holds its prefix.

tests/test_torch_gpt2.py imports this file's engines and helpers."""


import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.testing import make_tiny_bloom_gguf, make_tiny_gpt2_gguf
from tpullm.ops.attention import alibi_slopes as jalibi_slopes
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models import bloom
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.models.weights import FusedLinear
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-5  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache
PROMPT = [1, 5, 9, 12, 7, 3, 44, 80, 100, 22, 11]
GREEDY_PROMPT = [1, 40, 41, 42, 43]
MAX_SEQ = 64

DENSE = {"bloom": dict(arch="bloom"), "mpt": dict(arch="mpt"), "jais": dict(arch="jais")}
PACKED = ("tiny-bloom", "tiny-mpt", "tiny-jais")
# the JAX package's dense f32 test files of gpt2 (tests/test_torch_gpt2.py)
GPT2_DENSE = {"gpt2": dict(arch="gpt2", n_ctx=32), "starcoder": dict(arch="starcoder", n_ctx=32)}


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 280) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


def make_file(d, case: str) -> str:
    """The GGUF of `case`: a JAX test file (dense f32 runs) or a port shape."""
    if case in DENSE:
        return make_tiny_bloom_gguf(str(d / f"{case}.gguf"), **DENSE[case])
    if case in GPT2_DENSE:
        return make_tiny_gpt2_gguf(str(d / f"{case}.gguf"), **GPT2_DENSE[case])
    return str(make_synthetic_llama_gguf(d / f"{case}.gguf", shape=case, seed=0))


def engine_pair(path: str, dense: bool, max_seq: int = MAX_SEQ):
    """(port Engine, JAX Engine) on the CPU: dense f32 weights and cache,
    or the packed file at its default bf16."""
    if dense:
        return (Engine(path, device="cpu", max_seq=max_seq, mode="dense", dtype=torch.float32,
                       kv_dtype=torch.float32),
                JEngine(path, max_seq=max_seq, mode="dense", dtype=jnp.float32,
                        kv_dtype=jnp.float32))
    return Engine(path, device="cpu", max_seq=max_seq), JEngine(path, max_seq=max_seq)


def engine_getter(d, dense_cases):
    """get(case) → a reset (port, JAX) Engine pair, each made at first use;
    get.files[case] the case's GGUF. Call it inside `jax_device_load`."""
    made, files = {}, {}

    def get(case):
        if case not in made:
            files[case] = make_file(d, case)
            made[case] = engine_pair(files[case], case in dense_cases)
        te, je = made[case]
        te.reset()
        je.n_past = 0
        return te, je
    get.files = files
    get.path = lambda case: files.get(case) or files.setdefault(case, make_file(d, case))
    return get


def batch_rows(eng) -> list:
    """A joint prefill of slots 0 and 2 (slot 1 idle), decode steps with an
    idle slot, slot 2 freed and admitted again: each fed row's logits."""
    rows = []
    got = eng.prefill_slots({0: _ids(30, 4), 2: _ids(11, 5)})
    rows += [got[0], got[2]]
    for feed in ({0: 101, 2: 102}, {0: 103}, {2: 104}):
        got = eng.decode_batch(feed)
        rows += [got[s] for s in feed]
    eng.free_slot(2)
    rows.append(eng.prefill_slots({2: _ids(9, 6)})[2])
    return rows


def check_batch_engine(path: str) -> None:
    """BatchEngine (per-slot offsets, −1 for the idle slot) against the JAX
    BatchEngine on dense f32 weights and cache, every row within F32_NMSE;
    the idle slot's cache rows stay zero; the joint round's first slot
    equals the single-stream Engine's prefill; can_shift is the JAX rule."""
    kw = dict(n_slots=3, max_seq=MAX_SEQ, prefill_chunk=16, mode="dense")
    te = BatchEngine(path, device="cpu", dtype=torch.float32, kv_dtype=torch.float32, **kw)
    je = JBatchEngine(path, dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    assert te.can_shift == je.can_shift
    got = batch_rows(te)
    errs = [_nmse(a, b) for a, b in zip(got, batch_rows(je))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs
    assert not te.cache.k[:, 1].any()
    single = Engine(path, device="cpu", max_seq=MAX_SEQ, mode="dense", dtype=torch.float32,
                    kv_dtype=torch.float32)
    assert _nmse(got[0], single.prefill(_ids(30, 4))) <= F32_NMSE


def check_offsets(te, je, bound: float) -> None:
    """The attention at an offset: a prompt resumed on a cache that holds
    its prefix (the last logits), then verify rows at that offset (every
    row), against the JAX Engine's chunked prefill and prefill_all_logits."""
    head, tail, rows = _ids(20, 7), _ids(13, 8), _ids(5, 9)
    te.prefill(head)
    je.prefill(head)
    assert _nmse(te.prefill(tail), je.prefill(tail)) <= bound
    assert _nmse(te.verify_logits(rows), je.prefill_all_logits(rows)) <= bound
    assert te.n_past == je.n_past == 38


@contextlib.contextmanager
def jax_device_load():
    """TPULLM_DEVICE_REPACK=1 (the JAX load the port mirrors) until the
    block ends: a module fixture's engines, then the environment as it was
    for the test files after it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        yield


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    with jax_device_load():
        yield engine_getter(tmp_path_factory.mktemp("bloom"), DENSE)


def test_registry_maps_the_alibi_family():
    for arch in ("bloom", "mpt", "jais"):
        spec = get_arch(arch)
        assert (spec.build_params, spec.forward, spec.iswa, spec.make_cache) == \
            (bloom.build_params, bloom.forward, False, None)


@pytest.mark.parametrize("case", [*DENSE, *PACKED])
def test_hparams_and_slopes_match_jax(engines, case):
    """max_alibi_bias (8 without a key for bloom, the file's for mpt and
    jais), clamp_kqv, the LayerNorm epsilon; the slopes made once at load,
    on the engine's device, equal to the JAX package's."""
    te, je = engines(case)
    assert te.hp.max_alibi_bias == je.hp.max_alibi_bias == 8.0
    assert te.hp.clamp_kqv == je.hp.clamp_kqv
    assert te.hp.rms_eps == je.hp.rms_eps
    slopes = te.params["alibi_slopes"]
    assert slopes.device == te.device and slopes.dtype == torch.float32
    np.testing.assert_array_equal(slopes.numpy(),
                                  np.asarray(jalibi_slopes(je.hp.n_head, je.hp.max_alibi_bias)))


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_logits_and_decode_steps_match_jax(engines, case):
    """Every row of an 11-token prompt, then three decode steps (the
    logits graph), within F32_NMSE of the JAX Engine."""
    te, je = engines(case)
    assert _nmse(te.prefill_all_logits(PROMPT), je.prefill_all_logits(PROMPT)) <= F32_NMSE
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= F32_NMSE


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_bias_at_offsets_matches_jax(engines, case):
    te, je = engines(case)
    check_offsets(te, je, F32_NMSE)


@pytest.mark.parametrize("case", PACKED)
def test_packed_logits_decode_and_greedy_ids_match_jax(engines, case):
    """The packed models: the prompt's last logits and three decode steps
    within NMSE_BOUND, then GREEDY_PROMPT's greedy ids on the decode graph
    (chunks of 4) equal to the JAX device generation's."""
    te, je = engines(case)
    assert _nmse(te.prefill(PROMPT), je.prefill(PROMPT)) <= NMSE_BOUND
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= NMSE_BOUND
    te.reset()
    je.n_past = 0
    got = te.generate_tokens_device(GREEDY_PROMPT, 10, temp=0.0, stop_on_eog=False, chunk=4)
    want = je.generate_tokens_device(GREEDY_PROMPT, 10, temp=0.0, stop_on_eog=False, chunk=4)
    assert got == want


@pytest.mark.parametrize("case", PACKED)
def test_packed_bias_at_offsets_matches_jax(engines, case):
    te, je = engines(case)
    check_offsets(te, je, NMSE_BOUND)


@pytest.mark.parametrize("case", list(DENSE))
def test_batch_engine_matches_jax(engines, case):
    engines(case)
    check_batch_engine(engines.files[case])


def test_fused_qkv_loads_as_one_linear(engines):
    """attn_qkv is one linear inside a FusedLinear of (q, k, v); jais'
    gate and up, of one type, fuse into one plane stream on a plain
    engine."""
    te, _ = engines("tiny-jais")
    layer = te.params["layers"][0]
    assert isinstance(layer["wqkv"], FusedLinear) and layer["wqkv"].splits == (256, 256, 256)
    assert isinstance(layer.get("wgu"), FusedLinear) and layer["w_gate"] is None


def test_synthetic_bloom_7b1_recipe():
    """BLOOM-7B1 at Q4_K_M: the tied embedding at the head's Q6_K, attn_qkv
    at the recipe's Q5_K, token_embd_norm with its bias, no output.weight,
    no RoPE keys (ALiBi 8 comes without a key)."""
    w = synthetic_writer("/nonexistent/bloom-7b1.gguf", "bloom-7b1", n_layer=3)
    types = {t.name: t.ggml_type for t in w._tensors}
    shapes = {t.name: t.shape for t in w._tensors}
    assert types["token_embd.weight"] == GGMLType.Q6_K and "output.weight" not in types
    assert shapes["token_embd.weight"] == (4096, 250880)
    assert {"token_embd_norm.weight", "token_embd_norm.bias", "output_norm.bias"} <= set(types)
    assert types["blk.0.attn_qkv.weight"] == GGMLType.Q5_K
    assert shapes["blk.0.attn_qkv.weight"] == (4096, 3 * 4096)
    assert shapes["blk.0.ffn_up.weight"] == (4096, 16384)
    keys = {k for k, _, _ in w._kv}
    assert not any(".rope." in k for k in keys) and "bloom.attention.max_alibi_bias" not in keys


def test_synthetic_mpt_7b_recipe():
    """MPT-7B: no biases anywhere, ALiBi 8 from its key, tied, no position
    table and no q/k norms (mpt-7b has neither)."""
    w = synthetic_writer("/nonexistent/mpt-7b.gguf", "mpt-7b", n_layer=2)
    names = {t.name for t in w._tensors}
    assert not any(n.endswith(".bias") for n in names)
    assert "output.weight" not in names and "position_embd.weight" not in names
    assert not any("q_norm" in n for n in names)
    kv = {k: v for k, _, v in w._kv}
    assert kv["mpt.attention.max_alibi_bias"] == 8.0 and kv["mpt.vocab_size"] == 50432
