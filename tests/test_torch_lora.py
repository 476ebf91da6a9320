"""Port parity of LoRA adapters (tpullm_torch/models/lora.py, Engine's
`lora`, the shared Model's fusion rules, GET /lora-adapters and
convert.params_from_jax of a wrapped tree) against the JAX package's
(tpullm/models/lora.py, its Engine and server), both on the CPU.

Two models: the JAX package's fixture (tests/test_lora_state.py's
make_tiny_llama_gguf: 2 layers, n_embd 64, f32 tensors) on dense f32
weights, and the port's synthetic "tiny" at Q4_K_M (packed planes on the
qmm kernels' plain versions; the JAX side through its device repack, the
load the port mirrors). The adapters are rank 4 on every projection the
adapters target (attn_q/k/v/output, ffn_gate/up/down of every layer) and
the head, drawn from a seed (N(0, 0.05²) on the f32 model, N(0, 2²) on
the packed one, whose logits are ≈ 600: either moves the logits from the
base engine's by NMSE > 1e-2, far above the tolerances).

Tolerances: dense f32 weights, f32 factors and an f32 cache make the
packages' graphs the same f32 arithmetic in another order: logits within
NMSE 1e-6 (F32_NMSE); packed weights, bf16 activations and factors and a
bf16 cache: NMSE ≤ 1e-3 (NMSE_BOUND, the bound of
tests/test_torch_slice.py); greedy ids exactly, on prompts on which no
decision flips between the packages. merge_lora_dense is numpy on both
sides: equal to 1e-6 relative."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from test_torch_server import _jax_http, _port_http
from tpullm.gguf import GGUFReader as JReader
from tpullm.models import lora as jlora
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.server.scheduler import Scheduler as JScheduler

from tpullm_torch.convert import params_from_jax
from tpullm_torch.models import lora
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.models.weights import FusedLinear, QuantLinear
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.runtime.model import Model
from tpullm_torch.server.api import Server
from tpullm_torch.server.scheduler import Scheduler

F32_NMSE = 1e-6
NMSE_BOUND = 1e-3
STEMS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")
PROMPT = "the quick brown fox"  # no greedy decision flips between the packages


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    base = make_tiny_llama_gguf(d / "base.gguf", n_embd=64, n_head=4, n_head_kv=2,
                                n_ff=128, n_layer=2)
    tiny = make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0)
    out = {"f32": base, "packed": tiny}
    for name, p, std in (("f32", base, 0.05), ("packed", tiny, 2.0)):
        out[name + "-adapter"] = _adapter(d / f"{name}-adapter.gguf", p, seed=3, std=std)
    return out


def _adapter(path, model, rank=4, alpha=8.0, seed=3, std=0.05, names=None) -> str:
    """A rank-`rank` adapter on every targeted projection of `model` and
    its head, factors N(0, std²) from `seed`, written by the port."""
    rng = np.random.default_rng(seed)
    r = JReader(model)
    names = names or [n for n in r.tensors if n.split(".")[-2] in STEMS] + ["output.weight"]
    tensors = {}
    for name in names:
        n_out, n_in = r.tensors[name].shape[1], r.tensors[name].shape[0]
        tensors[name] = (rng.standard_normal((rank, n_in)).astype(np.float32) * std,
                         rng.standard_normal((n_out, rank)).astype(np.float32) * std)
    return lora.save_lora_gguf(path, tensors, alpha=alpha)


def _engines(paths, kind: str, **kw):
    """The port's and the JAX Engine on `kind`'s model ("f32": dense f32
    weights and cache; "packed": Q4_K_M planes, bf16 cache)."""
    if kind == "f32":
        return (Engine(paths["f32"], device="cpu", mode="dense", dtype=torch.float32,
                       kv_dtype=torch.float32, max_seq=64, **kw),
                JEngine(paths["f32"], mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                        max_seq=64, **kw))
    return (Engine(paths["packed"], device="cpu", max_seq=64, **kw),
            JEngine(paths["packed"], max_seq=64, **kw))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lora_gguf_round_trip_across_packages(tmp_path, paths, writer):
    """An adapter written by either package loads in both with the same
    alpha, names and factors; scale = user · alpha / rank; a control
    vector file is not an adapter."""
    rng = np.random.default_rng(0)
    tensors = {"blk.0.attn_q.weight": (rng.standard_normal((4, 64)).astype(np.float32),
                                       rng.standard_normal((64, 4)).astype(np.float32)),
               "output.weight": (rng.standard_normal((4, 64)).astype(np.float32),
                                 rng.standard_normal((300, 4)).astype(np.float32))}
    save = lora.save_lora_gguf if writer == "port" else jlora.save_lora_gguf
    path = save(tmp_path / "a.gguf", tensors, alpha=8.0)
    got, want = lora.load_lora_gguf(path), jlora.load_lora_gguf(path)
    assert got.alpha == want.alpha == 8.0 and set(got.tensors) == set(want.tensors) == set(tensors)
    for name, (a, b) in tensors.items():
        np.testing.assert_array_equal(got.tensors[name][0], a)
        np.testing.assert_array_equal(got.tensors[name][1], want.tensors[name][1])
    assert got.scale_for("blk.0.attn_q.weight", 0.5) == want.scale_for(
        "blk.0.attn_q.weight", 0.5) == pytest.approx(0.5 * 8.0 / 4)
    from tpullm_torch.tools.cvector import save_control_vector

    with pytest.raises(ValueError, match="not a LoRA adapter"):
        lora.load_lora_gguf(save_control_vector(tmp_path / "cv.gguf", np.ones((1, 4))))


@pytest.mark.parametrize("kind", ["f32", "packed"])
def test_engine_lora_matches_jax(paths, kind):
    """Engine(lora=[(adapter, 0.75)]) against the JAX Engine: every
    position's logits of the prompt (prefill_all_logits), three decode
    steps, and 12 greedy ids on the device path (the port's decode graph's
    step) against the JAX host loop; the adapter moves the logits away from
    the base engine's; at scale 0 it is the base engine."""
    bound = F32_NMSE if kind == "f32" else NMSE_BOUND
    ad = [(paths[kind + "-adapter"], 0.75)]
    te, je = _engines(paths, kind, lora=ad)
    base, _ = _engines(paths, kind)
    ids = te.tokenizer.tokenize(PROMPT, add_special=True)
    got = te.prefill_all_logits(ids)
    assert _nmse(got, je.prefill_all_logits(ids)) <= bound
    for t in (5, 9, 200):
        assert _nmse(te.decode_step(t), je.decode_step(t)) <= bound
    assert _nmse(got, base.prefill_all_logits(ids)) > 1e-2  # the adapter acts
    te.reset()
    je.reset()
    assert te.generate_tokens_device(ids, 12, temp=0.0, chunk=4) == list(je.generate_tokens(
        ids, 12))
    layer = te.params["layers"][0]
    assert isinstance(layer["wq"], lora.LoraLinear) and layer.get("wqkv") is None
    if kind == "packed":
        assert isinstance(layer["wq"].base, QuantLinear)
        assert layer["wq"].a_t.dtype == torch.bfloat16
    zero, _ = _engines(paths, kind, lora=[(paths[kind + "-adapter"], 0.0)])
    base.reset()
    np.testing.assert_array_equal(zero.prefill_all_logits(ids), base.prefill_all_logits(ids))
    assert te.lora_info == je.lora_info == [(paths[kind + "-adapter"], 0.75)]
    assert "lora " in te.report()


def test_lora_linear_is_the_merged_weight(paths):
    """merge_lora_dense equals the JAX one (numpy both sides), and a
    LoraLinear over a dense base computes x @ mergedᵀ (the export-lora
    check of tests/test_lora_state.py) within 1e-5."""
    ad = lora.load_lora_gguf(paths["f32-adapter"])
    name = "blk.1.ffn_down.weight"
    a, b = ad.tensors[name]
    w = np.array(JReader(paths["f32"]).tensors[name].to_numpy(), dtype=np.float32)
    scale = ad.scale_for(name, 0.5)
    got = lora.merge_lora_dense(w, a, b, scale)
    np.testing.assert_allclose(got, jlora.merge_lora_dense(w, a, b, scale), rtol=1e-6)
    from tpullm_torch.models.weights import DenseLinear

    lin = lora.LoraLinear(DenseLinear(torch.from_numpy(w.T.copy())),
                          torch.from_numpy(a.T.copy()), torch.from_numpy(b.T.copy()), scale)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, w.shape[1]))
                         .astype(np.float32))
    np.testing.assert_allclose(lin(x).numpy(), x.numpy() @ got.T, rtol=1e-5, atol=1e-5)


def test_shared_model_fusion_rules(paths):
    """The JAX package's rules on a shared Model: an adapter engine on an
    unfused Model wraps a copy of the tree's structure (the Model's
    modules untouched, its tensors shared); a plain engine fuses the Model
    once, in place; an adapter or control-vector engine then raises; an
    engine's own load fuses unless it has an adapter (control vectors
    alone fuse, as the JAX Engine's own load does)."""
    from tpullm_torch.tools.cvector import save_control_vector

    model = Model(paths["packed"], device="cpu")
    assert not model.is_fused and model.params["layers"][0]["wq"] is not None
    wq = model.params["layers"][0]["wq"]
    eng = Engine(model, max_seq=64, lora=[(paths["packed-adapter"], 1.0)])
    assert model.params["layers"][0]["wq"] is wq and not model.is_fused
    assert eng.params["layers"][0]["wq"].base is wq and eng.params is not model.params
    plain = Engine(model, max_seq=64)
    assert model.is_fused and plain.params is model.params
    assert isinstance(model.params["layers"][0]["wqkv"], FusedLinear)
    assert model.params["layers"][0]["wq"] is None and eng.params["layers"][0]["wq"].base is wq
    cv = save_control_vector(paths["packed"] + ".cv.gguf", np.ones((2, 256), np.float32))
    for kw in (dict(lora=[(paths["packed-adapter"], 1.0)]), dict(control_vectors=[(cv, 1.0)])):
        with pytest.raises(ValueError, match="already fused"):
            Engine(model, max_seq=64, **kw)
    own = Engine(paths["packed"], device="cpu", max_seq=64,
                 lora=[(paths["packed-adapter"], 1.0)])
    assert own.params["layers"][0].get("wqkv") is None
    own_cv = Engine(paths["packed"], device="cpu", max_seq=64, control_vectors=[(cv, 1.0)])
    assert isinstance(own_cv.params["layers"][0]["wqkv"], FusedLinear)
    assert "cvec" in own_cv.params
    ids = list(range(5, 25))
    assert _nmse(eng.prefill_all_logits(ids), own.prefill_all_logits(ids)) == 0.0


@pytest.mark.parametrize("options", ["lora+cvec", "cvec"])
def test_adapter_engine_leaves_its_own_model_plain(paths, options):
    """An Engine that loads its own Model with an adapter and control
    vectors (unfused), or with control vectors alone (fused, as the JAX
    Engine's own load), adds them to its own copy of the tree: a plain
    Engine and a plain BatchEngine built on `engine.model` afterwards
    compute the logits of engines loaded from the path without either
    (equal), and the options' engine still computes its own, which differ
    from the plain ones (NMSE > 1e-2). The f32 model: its residual stream
    is of the vector's size."""
    from tpullm_torch.tools.cvector import save_control_vector

    cv = save_control_vector(paths["f32"] + ".cv2.gguf", np.random.default_rng(4)
                             .standard_normal((2, 64)).astype(np.float32))
    kw = dict(control_vectors=[(cv, 1.0)])
    if options == "lora+cvec":
        kw["lora"] = [(paths["f32-adapter"], 1.0)]
    dense = dict(device="cpu", mode="dense", dtype=torch.float32, max_seq=64)
    eng = Engine(paths["f32"], kv_dtype=torch.float32, **dense, **kw)
    ids = list(range(5, 25))
    before = eng.prefill_all_logits(ids)
    assert "cvec" not in eng.model.params and "cvec" in eng.params
    assert not any(isinstance(m, lora.LoraLinear) for layer in eng.model.params["layers"]
                   for m in layer.values())
    plain = Engine(eng.model, max_seq=64, kv_dtype=torch.float32)
    ref = Engine(paths["f32"], kv_dtype=torch.float32, **dense)
    want = ref.prefill_all_logits(ids)
    assert _nmse(plain.prefill_all_logits(ids), want) == 0.0
    be = BatchEngine(eng.model, device="cpu", n_slots=1, max_seq=64, dtype=torch.float32)
    be_ref = BatchEngine(paths["f32"], n_slots=1, **dense)
    assert _nmse(be.prefill_slots({0: ids})[0], be_ref.prefill_slots({0: ids})[0]) == 0.0
    eng.reset()
    after = eng.prefill_all_logits(ids)
    assert _nmse(after, before) == 0.0 and _nmse(after, want) > 1e-2


@pytest.mark.parametrize("case", ["no base weight", "misshapen"])
def test_lora_that_does_not_fit_raises(paths, tmp_path, case):
    """An adapter tensor with no matching base weight, or whose factors do
    not fit the base's shape, raises at load: never skipped."""
    if case == "no base weight":
        path = lora.save_lora_gguf(tmp_path / "x.gguf", {"blk.7.attn_q.weight": (
            np.ones((2, 64), np.float32), np.ones((64, 2), np.float32))})
        match = "no matching base weight"
    else:
        path = lora.save_lora_gguf(tmp_path / "x.gguf", {"blk.0.attn_q.weight": (
            np.ones((2, 32), np.float32), np.ones((64, 2), np.float32))})
        match = "do not fit"
    with pytest.raises(ValueError, match=match):
        Engine(paths["f32"], device="cpu", mode="dense", dtype=torch.float32, max_seq=64,
               lora=[(path, 1.0)])


class _EngineScheduler:
    """A scheduler stand-in whose engine is a single-stream Engine (the
    route reads only `engine.lora_info`)."""

    def __init__(self, engine):
        self.engine = engine


def test_lora_adapters_route_as_jax(paths):
    """GET /lora-adapters answers as the JAX server's: [{"id", "path",
    "scale"}] from the engine's lora_info for an Engine with an adapter,
    [] for a BatchEngine, which has none."""
    ad = paths["f32-adapter"]
    te, je = _engines(paths, "f32", lora=[(ad, 0.5)])
    req = [("GET", "/lora-adapters", None)]
    got = _port_http(Server(_EngineScheduler(te)).app, req)
    want = _jax_http(_EngineScheduler(je), req)
    assert got[0][0] == want[0][0] == 200
    assert json.loads(got[0][2]) == json.loads(want[0][2]) == [
        {"id": 0, "path": ad, "scale": 0.5}]
    be = BatchEngine(paths["f32"], device="cpu", n_slots=1, max_seq=64, mode="dense")
    jbe = JBatchEngine(paths["f32"], n_slots=1, max_seq=64, mode="dense")
    got = _port_http(Server(Scheduler(be)).app, req)
    want = _jax_http(JScheduler(jbe), req)
    assert got[0][0] == want[0][0] == 200 and json.loads(got[0][2]) == json.loads(
        want[0][2]) == []


def test_params_from_jax_carries_lora_and_cvec(paths, tmp_path):
    """A JAX Engine's tree with LoRA wrappers and control vectors, carried
    over by convert.params_from_jax (left unfused, as an adapter engine
    is), computes the port Engine's logits (F32_NMSE) through the port's
    forward."""
    from tpullm_torch.tools.cvector import save_control_vector

    cv = save_control_vector(tmp_path / "cv.gguf", np.random.default_rng(2).standard_normal(
        (2, 64)).astype(np.float32) * 0.1)
    kw = dict(lora=[(paths["f32-adapter"], 1.0)], control_vectors=[(cv, 0.5)])
    te, je = _engines(paths, "f32", **kw)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    assert isinstance(params["layers"][1]["w_down"], lora.LoraLinear)
    assert params["layers"][0].get("wqkv") is None and params["cvec"].shape == (2, 64)
    ids = list(range(5, 21))
    want = te.prefill_all_logits(ids)
    te.reset()
    te.params = params
    assert _nmse(te.prefill_all_logits(ids), want) <= F32_NMSE


def test_engine_report_names_adapters(paths):
    """Engine.report names each adapter with its scale."""
    te, _ = _engines(paths, "f32", lora=[(paths["f32-adapter"], 0.5)])
    assert te.report().endswith(f"| lora {paths['f32-adapter']} ×0.5")
