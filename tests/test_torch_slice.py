"""Port parity for the slices as a whole: the tiny synthetic Q4_K_M llama
and the tiny 8-expert MoE (`tiny-moe`, the Mixtral recipe) served by the
JAX package's Engine and by tpullm_torch's Engine (on the CPU), with a bf16
and a q8 KV cache, plus the weights carried across from the JAX parameter
tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.convert import params_from_jax
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.models.weights import (DenseLinear, FusedLinear, QuantExpertStack,
                                         QuantLinear)
from tpullm_torch.ops import moe
from tpullm_torch.runtime.engine import Engine

PROMPT = "the quick brown fox jumps over the lazy dog"
# teacher-forced decode inputs: a varied token stream, not the model's own
CONTINUATION = "hello world, a lazy brown dog jumped"
STEPS = 16
# PROMPT is 43 tokens, more than the 16 of the MoE gather regime: its prefill
# (bucket 64) takes the all-experts regime, the decode steps the gather regime
MOE_PROMPT = PROMPT
# 52 tokens (bucket 64), on which no routing decision flips between the
# packages (test_tiny_moe_routing_agrees_with_jax); on PROMPT the greedy ids
# part at step 14 on an exact tie of the JAX package's bf16 head logits
# (tokens 307 and 202 at 2.71875), which the two packages break differently
MOE_GREEDY_PROMPT = "the lazy dog jumps over the quick brown fox hello world"


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("tiny") / "tiny.gguf",
                                     shape="tiny", seed=0)


@pytest.fixture(scope="module")
def tiny_moe_gguf(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("tiny_moe") / "tiny-moe.gguf",
                                     shape="tiny-moe", seed=0)


def _engines(path, kv):
    jkv = jnp.bfloat16 if kv == "bf16" else "q8_0"
    tkv = torch.bfloat16 if kv == "bf16" else "q8_0"
    return (JEngine(path, max_seq=256, kv_dtype=jkv),
            Engine(path, device="cpu", max_seq=256, kv_dtype=tkv))


def test_tiny_model_exercises_both_linear_layouts(tiny_gguf):
    """Layer 1 is a use_more_bits layer (Q6_K attn_v and ffn_down), so its
    QKV stays unfused; layer 0 fuses QKV and gate+up."""
    e = Engine(tiny_gguf, device="cpu", max_seq=64)
    l0, l1 = e.params["layers"]
    assert isinstance(l0["wqkv"], FusedLinear) and l0["wq"] is None
    assert l1.get("wqkv") is None and l1["wv"].gtype == GGMLType.Q6_K
    assert isinstance(l1["wgu"], FusedLinear) and l1["w_down"].gtype == GGMLType.Q6_K
    assert isinstance(e.params["output"], QuantLinear) and e.params["output"].gtype == GGMLType.Q6_K


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_teacher_forced_logits_match_jax(tiny_gguf, kv):
    """Per-step logits NMSE ≤ 1e-3: the kernels' plain versions round where
    the Pallas kernels do, but the embedding table dequantizes through bf16
    scales here (the JAX package's CPU load dequantizes it on the host in
    f32) and the f32 sums run in another order."""
    je, te = _engines(tiny_gguf, kv)
    ids = te.tokenizer.tokenize(PROMPT, add_special=True)
    assert ids == je.tokenizer.tokenize(PROMPT, add_special=True)
    feed = te.tokenizer.tokenize(CONTINUATION, add_special=False)[:STEPS]
    assert len(feed) == STEPS
    errs = [_nmse(te.prefill(ids), je.prefill(ids))]
    for tok in feed:
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= 1e-3, errs


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_free_running_greedy_ids_match_jax(tiny_gguf, kv):
    je, te = _engines(tiny_gguf, kv)
    ids = te.tokenizer.tokenize(PROMPT, add_special=True)
    ref = je.generate_tokens_device(ids, STEPS, temp=0.0)
    got = te.generate_tokens_device(ids, STEPS, temp=0.0)
    assert len(got) == STEPS and got == ref
    # greedy is deterministic from a reset engine
    te.reset()
    assert te.generate_tokens_device(ids, STEPS, temp=0.0) == got
    text = te.generate(PROMPT, max_new_tokens=4)
    assert isinstance(text, str)


def test_params_from_jax_gives_the_same_logits(tiny_gguf):
    """The JAX Engine's fused tree, carried across, holds bit-equal planes
    and gives the logits of the port's own GGUF load (NMSE ≤ 1e-3, the
    embedding table's dequantization being the one difference)."""
    je = JEngine(tiny_gguf, max_seq=64)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    own = Engine(tiny_gguf, device="cpu", max_seq=64)
    carried = Engine(tiny_gguf, device="cpu", max_seq=64)
    carried.params = tree

    for lo, lc in zip(own.params["layers"], tree["layers"]):
        for key in ("wqkv", "wq", "wk", "wv", "wo", "wgu", "w_gate", "w_up", "w_down"):
            a, b = lo.get(key), lc.get(key)
            assert (a is None) == (b is None), key
            if a is None:
                continue
            if isinstance(a, FusedLinear):
                assert a.splits == b.splits
                a, b = a.base, b.base
            assert a.gtype == b.gtype and sorted(a.planes) == sorted(b.planes)
            for nm in a.planes:
                assert torch.equal(a.planes[nm], b.planes[nm]), (key, nm)
    ids = own.tokenizer.tokenize(PROMPT, add_special=True)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= 1e-3
    tok = 300
    assert _nmse(carried.decode_step(tok), own.decode_step(tok)) <= 1e-3


def _moe_engines(path, monkeypatch):
    """Both Engines on the tiny MoE model, the JAX one loading through its
    device path (TPULLM_DEVICE_REPACK=1: packed upload, bf16 scale planes,
    the embedding table dequantized from them), which is the load the port
    mirrors. With the JAX package's host load instead, the embedding
    dequantizes with f32 scales, which moves layer-0 router logits by up to
    0.058 and flips top-2 decisions of PROMPT's prefill."""
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")
    return _engines(path, "bf16")


def _planes_equal(a, b, key):
    assert type(a) is type(b), key
    if isinstance(a, DenseLinear):
        assert torch.equal(a.w, b.w), key
        return
    assert a.gtype == b.gtype and sorted(a.planes) == sorted(b.planes), key
    for nm in a.planes:
        assert torch.equal(a.planes[nm], b.planes[nm]), (key, nm)


def test_tiny_moe_takes_the_8_expert_recipe_and_stays_packed(tiny_moe_gguf):
    """Q8_0 wk/wv beside a Q4_K wq keep QKV unfused; wo is Q5_K; the router
    is a dense linear; the expert stacks stay packed, Q6_K down on layer 1
    (a use_more_bits layer)."""
    e = Engine(tiny_moe_gguf, device="cpu", max_seq=64)
    assert (e.hp.n_expert, e.hp.n_expert_used) == (8, 2)
    for i, layer in enumerate(e.params["layers"]):
        assert layer.get("wqkv") is None and layer["wq"].gtype == GGMLType.Q4_K
        assert layer["wk"].gtype == layer["wv"].gtype == GGMLType.Q8_0
        assert layer["wo"].gtype == GGMLType.Q5_K
        assert isinstance(layer["router"], DenseLinear) and layer["router"].w.shape == (256, 8)
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert isinstance(layer[key], QuantExpertStack) and layer[key].n_expert == 8
        down = GGMLType.Q6_K if i == 1 else GGMLType.Q4_K
        assert layer["w_gate_exps"].gtype == GGMLType.Q4_K and layer["w_down_exps"].gtype == down


def test_tiny_moe_teacher_forced_logits_match_jax(tiny_moe_gguf, monkeypatch):
    """Per-step logits NMSE ≤ 1e-3 with a bf16 KV cache, the prefill in the
    all-experts regime and the decode steps in the gather regime; no routing
    decision flips (see _moe_engines)."""
    calls = {"dense": 0, "gather": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(moe, "_moe_dense", counted("dense", moe._moe_dense))
    monkeypatch.setattr(moe, "_moe_gather", counted("gather", moe._moe_gather))
    je, te = _moe_engines(tiny_moe_gguf, monkeypatch)
    ids = te.tokenizer.tokenize(MOE_PROMPT, add_special=True)
    assert ids == je.tokenizer.tokenize(MOE_PROMPT, add_special=True) and len(ids) > 16
    feed = te.tokenizer.tokenize(CONTINUATION, add_special=False)[:STEPS]
    errs = [_nmse(te.prefill(ids), je.prefill(ids))]
    assert calls == {"dense": 2, "gather": 0}  # one prefill, two MoE layers
    for tok in feed:
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert calls == {"dense": 2, "gather": 2 * STEPS}
    assert max(errs) <= 1e-3, errs


def test_tiny_moe_free_running_greedy_ids_match_jax(tiny_moe_gguf, monkeypatch):
    je, te = _moe_engines(tiny_moe_gguf, monkeypatch)
    ids = te.tokenizer.tokenize(MOE_GREEDY_PROMPT, add_special=True)
    assert len(ids) > 16
    ref = je.generate_tokens_device(ids, STEPS, temp=0.0)
    got = te.generate_tokens_device(ids, STEPS, temp=0.0)
    assert len(got) == STEPS and got == ref
    te.reset()
    assert te.generate_tokens_device(ids, STEPS, temp=0.0) == got


def test_tiny_moe_routing_agrees_with_jax(tiny_moe_gguf, monkeypatch):
    """Every top-2 decision of MOE_GREEDY_PROMPT's prefill and of 15 decode
    steps along the greedy ids is the same set of experts in both packages.

    The packages' router logits differ by up to ≈0.004 (f32 sums over hs
    that differ in the last bf16 bits), so a decision whose 2nd and 3rd
    logits lie closer than that can flip. On "hello world, a lazy brown dog
    jumped" the first flip is in the prefill, layer 0, row 15: the JAX
    package picks experts {4, 5}, expert 5 ahead of expert 1 by 0.0014
    (1.0655 against 1.0641), the port {4, 1} (1.0668 against 1.0617); a
    flip at decode step 7 follows and the greedy ids part at step 8."""
    import tpullm.ops.moe as jmoe_mod
    import tpullm_torch.models.llama as tllama

    jrec, trec = [], []
    jroute, troute = jmoe_mod.route, tllama.route

    def jax_route(logits, k, **kw):
        w, i = jroute(logits, k, **kw)
        jax.debug.callback(lambda a: jrec.append(np.asarray(a)), i)
        return w, i

    def port_route(logits, k, **kw):
        w, i = troute(logits, k, **kw)
        trec.append(i.numpy())
        return w, i

    monkeypatch.setattr(jmoe_mod, "route", jax_route)
    monkeypatch.setattr(tllama, "route", port_route)
    jax.clear_caches()  # retrace, so the jitted forward calls jax_route
    je, te = _moe_engines(tiny_moe_gguf, monkeypatch)
    ids = te.tokenizer.tokenize(MOE_GREEDY_PROMPT, add_special=True)
    feed = te.generate_tokens_device(ids, STEPS, temp=0.0)[:-1]
    te.reset()
    trec.clear()
    te.prefill(ids)
    je.prefill(ids)
    for tok in feed:
        te.decode_step(tok)
        je.decode_step(tok)
    jax.effects_barrier()
    n_layer = te.hp.n_layer
    assert len(jrec) == len(trec) == n_layer * (1 + len(feed))
    for c, (a, b) in enumerate(zip(jrec, trec)):
        rows = len(ids) if c < n_layer else 1  # the prefill's padding rows aside
        assert np.array_equal(np.sort(a[:rows], 1), np.sort(b[:rows], 1)), (c, a[:rows], b[:rows])


def test_params_from_jax_carries_expert_stacks(tiny_moe_gguf):
    """The JAX tree of the MoE model, carried across: routers and expert
    stacks hold the port's own planes bit for bit, and the logits agree
    with the port's own load (NMSE ≤ 1e-3, the embedding table's
    dequantization being the one difference)."""
    je = JEngine(tiny_moe_gguf, max_seq=64)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    own = Engine(tiny_moe_gguf, device="cpu", max_seq=64)
    carried = Engine(tiny_moe_gguf, device="cpu", max_seq=64)
    carried.params = tree
    for lo, lc in zip(own.params["layers"], tree["layers"]):
        for key in ("wq", "wk", "wv", "wo", "router", "w_gate_exps", "w_up_exps",
                    "w_down_exps"):
            _planes_equal(lo[key], lc[key], key)
        assert lc["w_down_exps"].n_expert == 8
    ids = own.tokenizer.tokenize(MOE_PROMPT, add_special=True)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= 1e-3
    assert _nmse(carried.decode_step(300), own.decode_step(300)) <= 1e-3
