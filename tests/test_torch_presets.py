"""Port parity for the llama.cpp presets beyond Q4_K_M: the tiny synthetic
llama at Q2_K (with a bf16 and a q8 KV cache), Q3_K_M, IQ4_NL, IQ4_XS and
the legacy Q4_0, Q4_1, Q5_0 and Q5_1, and the tiny 8-expert MoE at
MXFP4_MOE, served by the JAX package's Engine and by tpullm_torch's Engine
(on the CPU), and the weights carried across from the JAX parameter tree.
One file: the JAX Engine's compiles dominate, and beside the other
JAX-heavy test files a second worker compiling at once slows them all.

The JAX Engine loads through its device path (TPULLM_DEVICE_REPACK=1:
packed upload, bf16 scale planes, the embedding table dequantized from
them), the load the port mirrors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.convert import params_from_jax
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.models.weights import DenseLinear, FusedLinear, QuantExpertStack
from tpullm_torch.runtime.engine import Engine

PROMPT = "the quick brown fox jumps over the lazy dog"
# teacher-forced decode inputs: a varied token stream, not the model's own
CONTINUATION = "hello world, a lazy brown dog jumped"
STEPS = 16
# The legacy-scaled tiny model has attention scores up to ≈960, where one
# bf16 ulp of q or k (from f32 differences far below the tolerance, e.g. in
# RoPE) moves a score by ≈3. At Q3_K_M on PROMPT that decides decode step 13
# of CONTINUATION (a top-2 score margin of 0.66: logits NMSE 2e-3 there,
# ≤1e-4 at every other step) and the greedy ids part at step 7. On this
# 29-token prompt every step agrees within 2e-5 and so do the greedy ids.
PROMPTS = {"Q3_K_M": "hello world the quick brown fox"}
# 49 tokens (bucket 64): the all-experts regime at prefill, the gather
# regime at decode. On PROMPT the packages' router logits, which differ by
# their f32 sums, flip a top-2 decision during CONTINUATION's decode steps
# (teacher-forced logits NMSE 0.26 from there on) and on "the lazy dog jumps
# over the quick brown fox hello world" in the prefill; on this prompt no
# step differs by more than 1.7e-4 and the greedy ids agree.
MOE_PROMPT = "a lazy dog and a quick brown fox jumped over the world"
LEGACY = ["Q4_0", "Q4_1", "Q5_0", "Q5_1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU Engine on one intra-op thread for the module (the
    count restored after). The tier-1 run holds several such files at once
    on its workers, and with a thread per core each their busy-waiting
    thread pools slowed them about tenfold (this file, test_torch_slice.py
    and test_torch_iq_presets.py on three workers of an 8-core host: 838 s,
    against 84 s on one thread each). One thread also keeps the order of the
    f32 sums the same on every host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def make_engines(path, kv: str = "bf16"):
    """The JAX Engine (device-path load) and the port's, on one GGUF."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        je = JEngine(path, max_seq=256, kv_dtype=jnp.bfloat16 if kv == "bf16" else "q8_0")
    return je, Engine(path, device="cpu", max_seq=256,
                      kv_dtype=torch.bfloat16 if kv == "bf16" else "q8_0")


def teacher_forced_errors(je, te, prompt: str) -> list[float]:
    """Logits NMSE of the prefill of `prompt` and of STEPS decode steps fed
    CONTINUATION's tokens."""
    ids = te.tokenizer.tokenize(prompt, add_special=True)
    assert ids == je.tokenizer.tokenize(prompt, add_special=True)
    feed = te.tokenizer.tokenize(CONTINUATION, add_special=False)[:STEPS]
    assert len(feed) == STEPS
    je.reset()
    te.reset()
    errs = [nmse(te.prefill(ids), je.prefill(ids))]
    for tok in feed:
        errs.append(nmse(te.decode_step(tok), je.decode_step(tok)))
    return errs


def greedy_ids(je, te, prompt: str) -> tuple[list[int], list[int]]:
    """STEPS free-running greedy ids of `prompt`: the JAX Engine's by the
    argmax of its prefill and decode_step logits, each id fed back (the
    programs the teacher-forced test compiled; its temp=0 sampler takes the
    same argmax), the port's from generate_tokens_device."""
    ids = te.tokenizer.tokenize(prompt, add_special=True)
    je.reset()
    te.reset()
    ref = [int(np.argmax(je.prefill(ids)))]
    while len(ref) < STEPS:
        ref.append(int(np.argmax(je.decode_step(ref[-1]))))
    return ref, te.generate_tokens_device(ids, STEPS, temp=0.0)


def carried_planes_equal(own: dict, tree: dict, keys: tuple[str, ...]) -> None:
    """The carried-across params hold the port's own modules bit for bit."""
    for lo, lc in zip(own["layers"], tree["layers"]):
        for key in keys:
            a, b = lo.get(key), lc.get(key)
            assert (a is None) == (b is None), key
            if a is None:
                continue
            assert type(a) is type(b), key
            if isinstance(a, FusedLinear):
                assert a.splits == b.splits, key
                a, b = a.base, b.base
            if isinstance(a, DenseLinear):
                assert torch.equal(a.w, b.w), key
                continue
            assert a.gtype == b.gtype and sorted(a.planes) == sorted(b.planes), key
            for nm in a.planes:
                assert torch.equal(a.planes[nm], b.planes[nm]), (key, nm)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both Engines per (preset, KV cache), built once for the module."""
    return engine_cache(tmp_path_factory.mktemp("presets"), "tiny")


def engine_cache(root, shape: str):
    """get(ftype, kv) → (JAX Engine, port Engine), built once each;
    get.path(ftype) → the GGUF of `shape` at that preset."""
    cache = {}

    def path(ftype: str):
        p = root / f"{shape}-{ftype}.gguf"
        if not p.exists():
            make_synthetic_llama_gguf(p, shape=shape, seed=0, ftype=ftype)
        return p

    def get(ftype: str, kv: str = "bf16"):
        if (ftype, kv) not in cache:
            cache[ftype, kv] = make_engines(path(ftype), kv)
        return cache[ftype, kv]
    get.path = path
    return get


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return engine_cache(tmp_path_factory.mktemp("mxfp4"), "tiny-moe")


CASES = [("Q2_K", "bf16"), ("Q2_K", "q8_0"), ("Q3_K_M", "bf16"), ("IQ4_NL", "bf16"),
         ("IQ4_XS", "bf16"), *[(f, "bf16") for f in LEGACY]]


@pytest.mark.parametrize("ftype,kv", CASES)
def test_teacher_forced_logits_match_jax(engines, ftype, kv):
    """Per-step logits NMSE ≤ 1e-3 (the Q4_K_M tests' bound): the plain
    versions round where the Pallas kernels do; the f32 sums run in another
    order."""
    errs = teacher_forced_errors(*engines(ftype, kv), PROMPTS.get(ftype, PROMPT))
    assert max(errs) <= 1e-3, errs


@pytest.mark.parametrize("ftype,kv", CASES)
def test_free_running_greedy_ids_match_jax(engines, ftype, kv):
    ref, got = greedy_ids(*engines(ftype, kv), PROMPTS.get(ftype, PROMPT))
    assert len(got) == STEPS and got == ref


def test_q2_k_leaves_qkv_unfused_and_fuses_gate_up(engines):
    """Q2_K wq/wk beside a Q4_K wv keep QKV unfused; gate and up, both Q2_K,
    fuse; wo and down are Q3_K, the head Q6_K; the JAX package fuses alike."""
    je, te = engines("Q2_K")
    for layer, jlayer in zip(te.params["layers"], je.params["layers"]):
        assert layer.get("wqkv") is None and jlayer.get("wqkv") is None
        assert layer["wq"].gtype == layer["wk"].gtype == GGMLType.Q2_K
        assert layer["wv"].gtype == GGMLType.Q4_K
        assert isinstance(layer["wgu"], FusedLinear) and layer["w_gate"] is None
        assert layer["wgu"].base.gtype == GGMLType.Q2_K and jlayer.get("wgu") is not None
        assert layer["wo"].gtype == layer["w_down"].gtype == GGMLType.Q3_K
    assert te.params["output"].gtype == GGMLType.Q6_K


def test_params_from_jax_carries_q2_k_planes(engines):
    """The JAX Engine's Q2_K tree, carried across: bit-equal planes (the
    2-bit `qs`, the Q3_K `qh` bit plane, the Q2_K `minus`) and the logits
    of the port's own load."""
    je, te = engines("Q2_K")
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    carried_planes_equal(te.params, tree, ("wqkv", "wq", "wk", "wv", "wo", "wgu", "w_gate",
                                           "w_up", "w_down"))
    assert sorted(tree["layers"][0]["wo"].planes) == ["qh", "qs", "scale"]
    assert sorted(tree["layers"][0]["wq"].planes) == ["minus", "qs", "scale"]
    carried = Engine(engines.path("Q2_K"), device="cpu", max_seq=64)
    carried.params = tree
    own = Engine(engines.path("Q2_K"), device="cpu", max_seq=64)
    ids = own.tokenizer.tokenize(PROMPT, add_special=True)
    assert nmse(carried.prefill(ids), own.prefill(ids)) <= 1e-3
    assert nmse(carried.decode_step(300), own.decode_step(300)) <= 1e-3


def test_legacy_presets_fuse_qkv_and_gate_up(engines):
    """One type for every linear of a layer: QKV and gate+up fuse."""
    for ftype in LEGACY:
        _, te = engines(ftype)
        for layer in te.params["layers"]:
            assert layer["wqkv"].base.gtype == layer["wgu"].base.gtype == GGMLType[ftype]


def test_mxfp4_moe_teacher_forced_logits_match_jax(moe):
    ids = moe("MXFP4_MOE")[1].tokenizer.tokenize(MOE_PROMPT, add_special=True)
    assert len(ids) > 16  # the prefill takes the all-experts regime
    errs = teacher_forced_errors(*moe("MXFP4_MOE"), MOE_PROMPT)
    assert max(errs) <= 1e-3, errs


def test_mxfp4_moe_free_running_greedy_ids_match_jax(moe):
    ref, got = greedy_ids(*moe("MXFP4_MOE"), MOE_PROMPT)
    assert len(got) == STEPS and got == ref


def test_mxfp4_moe_layers(moe):
    """MXFP4 expert stacks, Q8_0 everywhere else: QKV and gate+up of the
    attention fuse (all Q8_0), the router stays dense."""
    _, te = moe("MXFP4_MOE")
    for layer in te.params["layers"]:
        assert layer["wqkv"].base.gtype == layer["wo"].gtype == GGMLType.Q8_0
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert isinstance(layer[key], QuantExpertStack)
            assert layer[key].gtype == GGMLType.MXFP4 and layer[key].n_expert == 8
            assert sorted(layer[key].planes) == ["qs", "scale"]
    assert te.params["output"].gtype == GGMLType.Q8_0


def test_params_from_jax_carries_mxfp4_expert_stacks(moe):
    """The JAX Engine's MXFP4_MOE tree, carried across: MXFP4 expert stacks
    and Q8_0 linears bit for bit, and the logits of the port's own load."""
    je, te = moe("MXFP4_MOE")
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    carried_planes_equal(te.params, tree, ("wqkv", "wq", "wk", "wv", "wo", "router",
                                           "w_gate_exps", "w_up_exps", "w_down_exps"))
    carried = Engine(moe.path("MXFP4_MOE"), device="cpu", max_seq=64)
    carried.params = tree
    own = Engine(moe.path("MXFP4_MOE"), device="cpu", max_seq=64)
    ids = own.tokenizer.tokenize(MOE_PROMPT, add_special=True)
    assert nmse(carried.prefill(ids), own.prefill(ids)) <= 1e-3
    assert nmse(carried.decode_step(300), own.decode_step(300)) <= 1e-3
