"""Port parity of the qwen-moe graph (models/qwen_moe.py: arch `qwen3moe`
and its 11 aliases) against the JAX package, both on the CPU.

Two kinds of fixture:
  * for each arch, the JAX package's tiny MoE file with the knobs of
    tests/test_moe.py (make_tiny_moe_gguf: f32 tensors, 4 experts top-2,
    shared experts gated or not, dense lead layers, exp_probs_b,
    post_attention_norm); bailingmoe2's file adds full-projection qk norms,
    sigmoid gating scaled by 2.5 and a trailing NextN layer, exaone-moe's
    per-head qk norms and sigmoid gating (rewritten here from the JAX
    package's file);
  * the port's synthetic `tiny-qwen3moe` (per-head qk norms, 16 experts
    top-4 renormalised, K = 256 experts, q wider than n_embd) and
    `tiny-qwen2moe` (q/k/v biases, a sigmoid-gated shared expert) at
    Q4_K_M on Qwen's BPE.

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: logits within NMSE 1e-6.
Packed weights, bf16 activations and a bf16 cache: NMSE ≤ 1e-3 (the bound
of tests/test_torch_slice.py). The JAX side loads through its device
repack (`TPULLM_DEVICE_REPACK=1`, the load the port mirrors)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_llama_aliases import assert_hparams_match, full_qk_norms, rewrite_gguf
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.testing import make_tiny_moe_gguf
from tpullm.runtime import speculative as jspec
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models import qwen_moe
from tpullm_torch.models.hparams import QWEN_MOE_ALIASES
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.models.weights import DenseLinear, QuantExpertStack, QuantLinear
from tpullm_torch.ops import moe
from tpullm_torch.runtime import speculative
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache

# arch → (the shared expert's width, make_tiny_moe_gguf's knobs), tests/test_moe.py's
MOE_FILES = {
    "qwen3moe": (0, {}),
    "qwen2moe": (48, {}),
    "deepseek": (48, dict(gated_shexp=False, n_dense_lead=1, expert_weights_scale=2.0)),
    "granitemoe": (48, dict(gated_shexp=False)),
    "ernie4_5-moe": (48, dict(gated_shexp=False, n_dense_lead=1, with_probs_bias=True)),
    "hunyuan-moe": (48, dict(gated_shexp=False)),
    "minimax-m2": (0, dict(with_probs_bias=True)),
    "dots1": (48, dict(gated_shexp=False, n_dense_lead=1, with_probs_bias=True)),
    "bailingmoe": (48, dict(gated_shexp=False)),
    "glm4moe": (48, dict(gated_shexp=False, n_dense_lead=1, with_probs_bias=True,
                         ffn_norm_name="post_attention_norm")),
    "bailingmoe2": (48, dict(gated_shexp=False, n_dense_lead=1, with_probs_bias=True,
                             n_layer=3)),
    "exaone-moe": (48, dict(gated_shexp=False, n_dense_lead=1, with_probs_bias=True)),
}
ARCHS = list(MOE_FILES)
PACKED = ["tiny-qwen3moe", "tiny-qwen2moe"]


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 280) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


def _options(arch: str, path: str, d) -> str:
    """bailingmoe2's and exaone-moe's own options, written into a copy of
    the JAX package's file (its widths: 4 heads over 2 KV heads of 16)."""
    if arch == "bailingmoe2":  # full-projection qk norms, the NextN layer 2
        return rewrite_gguf(path, d / "bailingmoe2-opts.gguf", tensors=full_qk_norms(
            3, 64, 32, seed=3), kv={"bailingmoe2.nextn_predict_layers": 1,
                                    "bailingmoe2.expert_gating_func": 2,
                                    "bailingmoe2.expert_weights_scale": 2.5,
                                    "bailingmoe2.expert_weights_norm": True})
    if arch == "exaone-moe":  # per-head qk norms
        norms = {k: v[:16] for k, v in full_qk_norms(2, 16, 16, seed=4).items()}
        return rewrite_gguf(path, d / "exaone-moe-opts.gguf", tensors=norms,
                            kv={"exaone-moe.expert_gating_func": 2,
                                "exaone-moe.expert_weights_norm": True})
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen_moe")
    out = {}
    for arch, (shexp, kw) in MOE_FILES.items():
        path = make_tiny_moe_gguf(str(d / f"{arch}.gguf"), arch=arch, n_ff_shexp=shexp, **kw)
        out[arch] = _options(arch, path, d)
    for shape in PACKED:
        out[shape] = make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0)
    return out


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


# ---------------------------------------------------------------------------
# hparams, the registry and the files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ARCHS + PACKED)
def test_hparams_match_jax(files, case):
    """Every HParams field equals the JAX package's: the NEOX style of
    qwen2moe, qwen3moe, dots1, hunyuan-moe, minimax-m2, bailingmoe2,
    glm4moe and exaone-moe, hunyuan-moe's post-RoPE qk norms, the NextN
    layers, the gating and its scale."""
    hp = assert_hparams_match(files[case])
    neox = hp.arch in ("qwen2moe", "qwen3moe", "dots1", "hunyuan-moe", "minimax-m2",
                       "bailingmoe2", "glm4moe", "exaone-moe")
    assert hp.rope.style == ("neox" if neox else "norm")
    assert hp.qk_norm_post_rope == (hp.arch == "hunyuan-moe")
    if hp.arch == "bailingmoe2":
        assert (hp.nextn_layers, hp.expert_gating_func, hp.expert_weights_scale) == \
            (1, "sigmoid", 2.5)


def test_registry_maps_the_qwen_moe_archs():
    """qwen3moe and its 11 aliases run qwen_moe.forward, and so does
    qwen3vlmoe (its M-RoPE sections read: tests/test_torch_llama_options.py);
    the renormalising archs are the JAX package's."""
    assert len(QWEN_MOE_ALIASES) == 11 and set(QWEN_MOE_ALIASES) | {"qwen3moe"} == set(ARCHS)
    for arch in (*ARCHS, "qwen3vlmoe"):
        spec = get_arch(arch)
        assert spec.forward is qwen_moe.forward and spec.make_cache is None
    from tpullm.models.qwen_moe import norm_weights_policy as jpolicy

    for arch in ARCHS:
        hp = type("HP", (), dict(arch=arch, expert_weights_norm=False))
        assert qwen_moe.norm_weights_policy(hp) == jpolicy(hp), arch


def test_build_params_takes_the_options(files):
    """The param tree: dense lead layers, exp_probs_b, the shared expert
    with its gate vector where the file has one, the NextN layer left
    out, post_attention_norm in the ffn_norm slot."""
    def load(case):
        e = Engine(files[case], device="cpu", max_seq=32, mode="dense", dtype=torch.float32)
        return e.params["layers"]

    l = load("qwen2moe")
    assert tuple(l[0]["shexp_gate_inp"].shape) == (64,) and l[0]["router"] is not None
    l = load("bailingmoe2")
    assert len(l) == 2 and l[0].get("router") is None and l[1]["exp_probs_b"] is not None
    assert tuple(l[1]["q_norm"].shape) == (64,) and "shexp_gate_inp" not in l[1]
    assert load("glm4moe")[1]["ffn_norm"] is not None


# ---------------------------------------------------------------------------
# forward against the JAX package
# ---------------------------------------------------------------------------

def _dense_f32(path, max_seq=96):
    return (Engine(path, device="cpu", max_seq=max_seq, mode="dense", dtype=torch.float32,
                   kv_dtype=torch.float32),
            JEngine(path, max_seq=max_seq, mode="dense", dtype=jnp.float32,
                    kv_dtype=jnp.float32))


def _counted(monkeypatch) -> dict:
    calls = {"dense": 0, "gather": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(moe, "_moe_dense", counted("dense", moe._moe_dense))
    monkeypatch.setattr(moe, "_moe_gather", counted("gather", moe._moe_gather))
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_in_both_regimes(files, arch, monkeypatch):
    """Dense f32 weights and cache: every row of a 12-token prompt (a
    bucket of 16: the gather regime) and of a 40-token prompt (a bucket of
    64: every expert on every token) and three decode steps (gather) within
    F32_NMSE of the JAX Engine's."""
    calls = _counted(monkeypatch)
    te, je = _dense_f32(files[arch])
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(files, arch):
    """A prefill of 20 tokens then 9 decode steps give, row for row, the
    logits of one 29-token prefill (f32, the port alone)."""
    te = Engine(files[arch], device="cpu", max_seq=96, mode="dense", dtype=torch.float32,
                kv_dtype=torch.float32)
    toks = _ids(29, 2)
    one = te.prefill_all_logits(toks)
    te.reset()
    rows = [te.prefill_all_logits(toks[:20])]
    rows += [te.decode_step(t)[None] for t in toks[20:]]
    assert _nmse(np.concatenate(rows), one) <= F32_NMSE


# ---------------------------------------------------------------------------
# the packed shapes: Engine, the decode graphs, routing, BatchEngine,
# speculation, convert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(files):
    """The port's and the JAX package's Engines on tiny-qwen3moe and
    tiny-qwen2moe (Q4_K_M, bf16 cache)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        return {s: (Engine(files[s], device="cpu", max_seq=128),
                    JEngine(files[s], max_seq=128, kv_dtype=jnp.bfloat16))
                for s in PACKED}


def test_tiny_qwen3moe_is_packed_at_its_widths(packed):
    """tiny-qwen3moe: 16 packed experts of K = 256 (down) and 256 (gate,
    up), Q6_K down on layer 1, q 512 wide over n_embd 256, the router dense."""
    e = packed["tiny-qwen3moe"][0]
    assert (e.hp.n_expert, e.hp.n_expert_used, e.hp.head_dim, e.hp.n_ff_exp) == (16, 4, 128, 256)
    for i, layer in enumerate(e.params["layers"]):
        assert isinstance(layer["router"], DenseLinear)
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert isinstance(layer[key], QuantExpertStack) and layer[key].n_expert == 16
        assert layer["w_down_exps"].gtype == (GGMLType.Q6_K if i == 1 else GGMLType.Q4_K)
        wq = layer["wqkv"].base if layer.get("wqkv") is not None else layer["wq"]
        assert isinstance(wq, QuantLinear) and wq.n_in == 256


@pytest.mark.parametrize("shape", PACKED)
def test_packed_logits_and_greedy_ids_match_jax(packed, shape, monkeypatch):
    """Q4_K_M planes: a 30-token prompt (every expert) and a 9-token one
    (gather), three decode steps each: logits within NMSE_BOUND; greedy ids
    of the decode graph's step (two chunks and a tail) equal the JAX
    Engine's and the host loop's (decode_step)."""
    calls = _counted(monkeypatch)
    te, je = packed[shape]
    errs = []
    for n in (30, 9):
        prompt = _ids(n, n, hi=370)
        te.reset()
        je.reset()
        errs.append(_nmse(te.prefill(prompt), je.prefill(prompt)))
        for tok in (100, 17, 301):
            errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert calls["dense"] == 2 and calls["gather"] == 2 * 7, calls
    assert max(errs) <= NMSE_BOUND, errs
    prompt = _ids(24, 3, hi=370)
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    assert got == je.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    te.reset()
    assert list(te.generate_tokens(prompt, 20, stop_on_eog=False)) == got


def test_tiny_qwen3moe_routing_agrees_with_jax(packed, monkeypatch):
    """Every top-4 decision of a 24-token prompt's prefill (every expert)
    and of 12 decode steps (gather) along the greedy ids is the same set of
    experts in both packages. Over the prompts of this file no decision
    flips: the packages' router logits differ by f32 sums over hs that
    differ in the last bf16 bits, well inside the margins of these rows."""
    import tpullm.models.qwen_moe as jqwen_moe

    jrec, trec = [], []
    jroute, troute = jqwen_moe.route, qwen_moe.route

    def jax_route(logits, k, **kw):
        w, i = jroute(logits, k, **kw)
        jax.debug.callback(lambda a: jrec.append(np.asarray(a)), i)
        return w, i

    def port_route(logits, k, **kw):
        w, i = troute(logits, k, **kw)
        trec.append(i.numpy())
        return w, i

    monkeypatch.setattr(jqwen_moe, "route", jax_route)
    monkeypatch.setattr(qwen_moe, "route", port_route)
    te, je = packed["tiny-qwen3moe"]
    prompt = _ids(24, 3, hi=370)
    te.reset()
    feed = te.generate_tokens_device(prompt, 13, chunk=4, stop_on_eog=False)[:-1]
    jax.clear_caches()  # retrace, so the jitted forward calls jax_route
    try:
        te.reset()
        je.reset()
        trec.clear()
        te.prefill(prompt)
        je.prefill(prompt)
        for tok in feed:
            te.decode_step(tok)
            je.decode_step(tok)
        jax.effects_barrier()
    finally:
        jax.clear_caches()  # later tests trace the JAX package's own route
    n_layer = te.hp.n_layer
    assert len(jrec) == len(trec) == n_layer * (1 + len(feed))
    for c, (a, b) in enumerate(zip(jrec, trec)):
        rows = len(prompt) if c < n_layer else 1  # the prefill's padding rows aside
        assert np.array_equal(np.sort(a[:rows], 1), np.sort(b[:rows], 1)), (c, a[:rows], b[:rows])


def _batch_rows(eng) -> list:
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


@pytest.mark.parametrize("case", ["tiny-qwen3moe", "tiny-qwen2moe", "bailingmoe2"])
def test_batch_engine_matches_jax(files, case):
    """BatchEngine (per-slot offsets, −1 for the idle slot; the joint round
    through every expert, the batched steps through the gather) against the
    JAX BatchEngine on dense f32 weights and cache: every row within
    F32_NMSE; the idle slot's cache rows stay zero."""
    kw = dict(n_slots=3, max_seq=64, prefill_chunk=16, mode="dense")
    te = BatchEngine(files[case], device="cpu", dtype=torch.float32, kv_dtype=torch.float32, **kw)
    je = JBatchEngine(files[case], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te), _batch_rows(je))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs
    assert not te.cache.k[:, 1].any()


def test_generate_speculative_ngram_as_jax(packed):
    """generate_speculative with the n-gram speculator on tiny-qwen3moe (the
    verify graph's forward: a 5-row bucket through the gather), greedy: the
    ids equal the JAX package's and the port's plain greedy generation."""
    te, je = packed["tiny-qwen3moe"]
    prompt = _ids(12, 9, hi=370) * 3
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


@pytest.mark.parametrize("case", ["tiny-qwen3moe", "tiny-qwen2moe", "dots1"])
def test_params_from_jax_carries_the_qwen_moe_tree(files, case):
    """The JAX Engine's qwen-moe tree carried across (shexp_gate_inp a
    tensor, the shared experts linears, dense lead layers, exp_probs_b, the
    expert stacks) gives the port's own logits within NMSE_BOUND."""
    from tpullm_torch.convert import params_from_jax

    dense = case == "dots1"
    kw = dict(mode="dense", dtype=torch.float32, kv_dtype=torch.float32) if dense else {}
    jkw = dict(mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32) if dense else \
        dict(kv_dtype=jnp.bfloat16)
    je = JEngine(files[case], max_seq=64, **jkw)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    layers = tree["layers"]
    if case == "tiny-qwen2moe":
        assert isinstance(layers[0]["shexp_gate_inp"], torch.Tensor)
        assert isinstance(layers[0]["w_gate_shexp"], QuantLinear)
    if case == "dots1":
        assert layers[0].get("router") is None and layers[0]["w_down"] is not None
        assert isinstance(layers[1]["exp_probs_b"], torch.Tensor)
    own = Engine(files[case], device="cpu", max_seq=64, **kw)
    carried = Engine(files[case], device="cpu", max_seq=64, **kw)
    carried.params = tree
    for n in (20, 9):
        own.reset()
        carried.reset()
        ids = _ids(n, 10 + n)
        assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
        assert _nmse(carried.decode_step(100), own.decode_step(100)) <= NMSE_BOUND


# ---------------------------------------------------------------------------
# the full-width shapes
# ---------------------------------------------------------------------------

def test_synthetic_qwen3_30b_a3b_recipe():
    """Qwen3-30B-A3B at Q4_K_M: its published widths, q wider than n_embd
    (key_length written), every K a multiple of 256 (no fallback type),
    about 17–19 GB of payload; written lazily, so sized without drawing."""
    cfg = SHAPES["qwen3-30b-a3b"]
    assert (cfg["n_layer"], cfg["n_embd"], cfg["n_head"], cfg["n_head_kv"], cfg["head_dim"],
            cfg["n_expert"], cfg["n_expert_used"], cfg["n_ff_exp"], cfg["n_vocab"]) == \
        (48, 2048, 32, 4, 128, 128, 8, 768, 151936)
    w = synthetic_writer("unused.gguf", shape="qwen3-30b-a3b")
    assert 17e9 < w.payload_bytes() < 19e9
    kv = {k: v for k, _, v in w._kv}
    assert (kv["qwen3moe.attention.key_length"], kv["qwen3moe.expert_feed_forward_length"],
            kv["tokenizer.ggml.pre"], kv["qwen3moe.rope.freq_base"]) == \
        (128, 768, "qwen2", 1000000.0)
    types = {r.name: r.ggml_type for r in w._tensors}
    assert {t for n, t in types.items() if n.endswith("_exps.weight")} == \
        {GGMLType.Q4_K, GGMLType.Q6_K}
    assert all(r.shape[0] % 256 == 0 for r in w._tensors if r.ggml_type != GGMLType.F32)


def test_synthetic_qwen2_5_7b_recipe():
    """Qwen2.5-7B at Q4_K_M: 28 heads over 4 (a GQA group of 7), q/k/v
    biases, every K a multiple of 256."""
    w = synthetic_writer("unused.gguf", shape="qwen2.5-7b", n_layer=2)
    names = {r.name: r for r in w._tensors}
    assert names["blk.1.attn_k.bias"].shape == (512,)
    assert names["blk.0.ffn_down.weight"].shape == (18944, 3584)
    assert all(r.shape[0] % 256 == 0 for r in w._tensors if r.ggml_type != GGMLType.F32)
    hp_kv = {k: v for k, _, v in w._kv}
    assert (hp_kv["qwen2.attention.head_count"], hp_kv["qwen2.attention.head_count_kv"],
            hp_kv["qwen2.vocab_size"]) == (28, 4, 152064)
    assert "qwen2.attention.key_length" not in hp_kv
