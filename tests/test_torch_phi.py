"""Port parity of the Phi families and Qwen (v1) (models/phi3.py,
models/phi2.py, models/qwen.py), against the JAX package, both on the CPU.

Files: the port's synthetic `tiny-phi3` (fused attn_qkv and gate|up, head
dim 96, a window of 16 below the prompts), `tiny-phi2` (fused qkv with a
bias, LayerNorm biases, head dim 80 with 32 rotary dims, a biased head) and
`tiny-qwen` (fused qkv with a bias), at Q4_K_M (every K a multiple of 256:
the packed K-quant planes, attn_qkv at Q5_K); beside them the JAX package's
own f32 test files (tpullm/models/testing.py make_tiny_phi3_gguf,
make_tiny_phi2_gguf, make_tiny_qwen_gguf).

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: logits within NMSE 1e-6.
Packed weights, bf16 activations and a bf16 or q8 cache: NMSE ≤ 1e-3 (the
bound of tests/test_torch_slice.py). The JAX side loads through its device
repack (`TPULLM_DEVICE_REPACK=1`, the load the port mirrors). The tiny
synthetic models' greedy ids repeat one token (as the tiny gemmas' do);
their logits carry the parity."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_llama_aliases import assert_hparams_match
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tools import _run
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.models import phi2 as jphi2
from tpullm.models import phi3 as jphi3
from tpullm.models import qwen as jqwen
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm.models.testing import make_tiny_phi2_gguf, make_tiny_phi3_gguf, make_tiny_qwen_gguf
from tpullm.ops import norms as jnorms
from tpullm.runtime import speculative as jspec
from tpullm.runtime import state as jstate
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine
from tpullm.tools import cli as jcli

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models import llama, phi2, phi3, qwen
from tpullm_torch.models.hparams import hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.models.weights import DenseLinear, FusedLinear, QuantLinear
from tpullm_torch.ops import norms
from tpullm_torch.runtime import speculative, state
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tools import cli

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations, a bf16 or q8 cache
SHAPES = ("tiny-phi3", "tiny-phi2", "tiny-qwen")
JAX_FILES = ("jax-phi3", "jax-phi2", "jax-qwen")
ARCH = {"tiny-phi3": "phi3", "tiny-phi2": "phi2", "tiny-qwen": "qwen"}
JAX_BUILD = {"phi3": jphi3.build_params, "phi2": jphi2.build_params, "qwen": jqwen.build_params}
PROMPT_LEN = 40  # past tiny-phi3's window of 16


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 370) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


def _np(x) -> np.ndarray:
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("phi")
    out = {s: make_synthetic_llama_gguf(d / f"{s}.gguf", shape=s, seed=0) for s in SHAPES}
    out["jax-phi3"] = make_tiny_phi3_gguf(str(d / "jax-phi3.gguf"), seed=1)
    out["jax-phi2"] = make_tiny_phi2_gguf(str(d / "jax-phi2.gguf"), seed=1)
    out["jax-qwen"] = make_tiny_qwen_gguf(str(d / "jax-qwen.gguf"), seed=1)
    return out


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


class _Cache(dict):
    """Engines made once a module, by key."""

    def get_or(self, key, make):
        if key not in self:
            self[key] = make()
        return self[key]


@pytest.fixture(scope="module")
def engines():
    return _Cache()


def _dense_f32(engines, path):
    return engines.get_or(("dense", path), lambda: (
        Engine(path, device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
               kv_dtype=torch.float32),
        JEngine(path, max_seq=64, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32)))


def _packed(engines, path, kv: str):
    def make():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TPULLM_DEVICE_REPACK", "1")
            return (Engine(path, device="cpu", max_seq=96, kv_dtype=kv),
                    JEngine(path, max_seq=96, kv_dtype=jnp.bfloat16 if kv == "bf16" else kv))
    return engines.get_or(("packed", path, kv), make)


# ---------------------------------------------------------------------------
# hparams, the registry, the weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SHAPES + JAX_FILES)
def test_hparams_match_jax(files, case):
    """Every HParams field equals the JAX package's: rope.dims 32 of 80 for
    tiny-phi2 (n_rot < head_dim), its LayerNorm ε as rms_eps, phi3's
    window with swa_pattern 1 (no iSWA interleave: llama.forward passes the
    window to every layer), NEOX RoPE for all three."""
    hp = assert_hparams_match(files[case])
    assert hp.rope.style == "neox" and hp.swa_pattern == 1
    if case == "tiny-phi2":
        assert (hp.head_dim, hp.rope.dims, hp.rms_eps) == (80, 32, pytest.approx(1e-5))
    if case == "tiny-phi3":
        assert (hp.head_dim, hp.sliding_window) == (96, 16)


def test_registry_maps_phi_and_qwen():
    """phi3 and qwen run the llama forward on their own loaders, phi2 its
    own forward (phimoe: tests/test_torch_moe_families.py); gpt-oss, which
    no kernel takes yet (K = 2880), is refused."""
    for arch, build, fwd in (("phi3", phi3.build_params, llama.forward),
                             ("qwen", qwen.build_params, llama.forward),
                             ("phi2", phi2.build_params, phi2.forward)):
        spec = get_arch(arch)
        assert (spec.build_params, spec.forward, spec.iswa, spec.make_cache) == \
            (build, fwd, False, None)
    with pytest.raises(NotImplementedError, match="is not ported"):
        get_arch("gpt-oss")


def _split(fused, i: int):
    """Output span i of a FusedLinear of DenseLinear as [n_in, n_out]."""
    w, splits = fused.base.w, fused.splits
    start = sum(splits[:i])
    return w[:, start:start + splits[i]]


@pytest.mark.parametrize("shape", SHAPES)
def test_dense_weights_are_the_jax_split(files, shape):
    """In the "dense" weight mode the fused tensors' spans are the JAX
    package's row-sliced wq / wk / wv (and phi3's w_gate / w_up) bit for
    bit, and qwen's and phi2's bias spans its bq / bk / bv; the other
    linears and phi2's LayerNorm weights and biases equal too."""
    path = files[shape]
    r, jr = GGUFReader(path), JReader(str(path))
    hp, jhp = hparams_from_gguf(r), jhparams(jr)
    arch = ARCH[shape]
    got = get_arch(arch).build_params(r, hp, "cpu", torch.bfloat16, "dense")
    want = JAX_BUILD[arch](jr, jhp, mode="dense", dtype=jnp.bfloat16)
    for layer, jlayer in zip(got["layers"], want["layers"]):
        assert isinstance(layer["wqkv"], FusedLinear) and \
            isinstance(layer["wqkv"].base, DenseLinear)
        for i, key in enumerate(("wq", "wk", "wv")):
            assert np.array_equal(_np(_split(layer["wqkv"], i)), _np(jlayer[key].w)), key
        pairs = [("wo", "wo"), ("w_down", "w_down")]
        if arch == "phi3":
            for i, key in enumerate(("w_gate", "w_up")):
                assert np.array_equal(_np(_split(layer["wgu"], i)), _np(jlayer[key].w)), key
        else:
            pairs.append(("w_up", "w_up"))
        for a, b in pairs:
            assert np.array_equal(_np(layer[a].w), _np(jlayer[b].w)), a
        vectors = {"qwen": ("bq", "bk", "bv"),
                   "phi2": ("bq", "bk", "bv", "attn_norm", "attn_norm_b", "bo", "b_up",
                            "b_down")}.get(arch, ("attn_norm", "ffn_norm"))
        for key in vectors:
            assert np.array_equal(_np(layer[key]), _np(jlayer[key])), key
    extra = ("output_norm_b", "output_b") if arch == "phi2" else ()
    for key in ("output_norm", *extra):
        assert np.array_equal(_np(got[key]), _np(want[key])), key
    assert np.array_equal(_np(got["output"].w), _np(want["output"].w))


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_tensors_load_as_one_plane_stream(files, shape):
    """Packed: attn_qkv (Q5_K at Q4_K_M) is one QuantLinear inside a
    FusedLinear of splits (n_q, n_kv, n_kv), phi3's ffn_up one of (n_ff,
    n_ff); Engine keeps them fused (no wq / w_gate left)."""
    eng = Engine(files[shape], device="cpu", max_seq=32)
    hp = eng.hp
    n_q, n_kv = hp.n_head * hp.head_dim, hp.n_head_kv * hp.head_dim
    for layer in eng.params["layers"]:
        wqkv = layer["wqkv"]
        assert isinstance(wqkv.base, QuantLinear) and wqkv.base.gtype == GGMLType.Q5_K
        assert wqkv.splits == (n_q, n_kv, n_kv) and layer.get("wq") is None
        if ARCH[shape] != "phi2":
            assert layer["wgu"].splits == (hp.n_ff, hp.n_ff) and layer.get("w_gate") is None


def test_layer_norm_matches_jax():
    """tpullm/ops/norms.py layer_norm, with and without the bias, bf16 in
    and out (f32 inside)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(96).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for bias in (b, None):
        got = norms.layer_norm(xt, torch.from_numpy(w), None if bias is None else
                               torch.from_numpy(bias), 1e-5)
        want = jnorms.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                 None if bias is None else jnp.asarray(bias), 1e-5)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), _np(want))


# ---------------------------------------------------------------------------
# the forward against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SHAPES + JAX_FILES)
def test_dense_f32_logits_and_greedy_ids_match_jax(files, engines, case):
    """Dense f32 weights and cache: every row of a 40-token prompt (past
    tiny-phi3's window) and three decode steps within F32_NMSE of the JAX
    Engine's; the decode graph's greedy ids over two chunks and a tail
    equal."""
    te, je = _dense_f32(engines, files[case])
    prompt = _ids(PROMPT_LEN, 0, hi=te.hp.n_vocab - 10)
    te.reset()
    je.reset()
    errs = [_nmse(te.prefill_all_logits(prompt), je.prefill_all_logits(prompt))]
    te.reset()
    je.reset()
    te.prefill(prompt)
    je.prefill(prompt)
    for tok in (7, 200, 33):
        tok = tok % te.hp.n_vocab
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= F32_NMSE, errs
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 10, chunk=4, stop_on_eog=False)
    assert got == je.generate_tokens_device(prompt, 10, chunk=4, stop_on_eog=False)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_logits_and_greedy_ids_match_jax(files, engines, shape, kv):
    """Q4_K_M planes on a bf16 or q8 cache: a 40-token prompt's logits and
    three decode steps' within NMSE_BOUND; greedy ids of the decode graph's
    step (two chunks and a tail) equal the JAX Engine's and the host
    loop's."""
    te, je = _packed(engines, files[shape], kv)
    prompt = _ids(PROMPT_LEN, 2)
    te.reset()
    je.reset()
    errs = [_nmse(te.prefill(prompt), je.prefill(prompt))]
    for tok in (100, 17, 301):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= NMSE_BOUND, errs
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    assert got == je.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    te.reset()
    assert list(te.generate_tokens(prompt, 20, stop_on_eog=False)) == got


def test_phi3_passes_its_window_to_every_layer(files, engines, monkeypatch):
    """Every layer's attention of tiny-phi3 (not an iSWA arch: a full cache)
    takes the window of 16 in the prefill of a 40-token prompt and in a
    decode step, so the parity above holds the mask. (The tiny model's
    attention is all but one-hot on a key inside the window, so dropping
    the window does not move its logits: the call is checked instead.)"""
    from tpullm_torch.ops.kernels import flash

    te, _ = _dense_f32(engines, files["tiny-phi3"])
    calls = []
    plain = flash.flash_attention

    def spy(q, k, v, offsets, scale, softcap=0.0, sliding_window=0, *a, **kw):
        calls.append((q.shape[1], sliding_window))
        return plain(q, k, v, offsets, scale, softcap, sliding_window, *a, **kw)

    monkeypatch.setattr(flash, "flash_attention", spy)
    te.reset()
    te.prefill(_ids(PROMPT_LEN, 0))
    te.decode_step(7)
    n = te.hp.n_layer
    assert calls[-n:] == [(1, 16)] * n and all(w == 16 for _, w in calls)
    assert len(calls) == 2 * n and calls[0][0] >= PROMPT_LEN > 16


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_equals_prefill(files, engines, shape):
    """Dense f32: each decode step's logits are the prompt's prefill row at
    that position (the 0-d device offset of the decode step against the
    host offset of the prefill), within F32_NMSE."""
    te, _ = _dense_f32(engines, files[shape])
    prompt = _ids(30, 3)
    te.reset()
    rows = te.prefill_all_logits(prompt)
    te.reset()
    te.prefill(prompt[:12])
    errs = [_nmse(te.decode_step(tok), rows[12 + i]) for i, tok in enumerate(prompt[12:])]
    assert max(errs) <= F32_NMSE, errs


@pytest.mark.parametrize("shape", SHAPES)
def test_params_from_jax_gives_the_same_logits(files, shape):
    """The JAX Engine's tree carried across (q|k|v fused by the JAX Engine
    from its row slices, qwen's and phi2's biases, phi2's LayerNorm biases
    and head bias) gives the port's own logits within NMSE_BOUND."""
    from tpullm_torch.convert import params_from_jax

    je = JEngine(files[shape], max_seq=64, kv_dtype=jnp.bfloat16)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    own = Engine(files[shape], device="cpu", max_seq=64)
    layer = tree["layers"][0]
    assert isinstance(layer["wqkv"], FusedLinear) and isinstance(layer["wqkv"].base, QuantLinear)
    for key, ref in own.params["layers"][0].items():  # the same layout, plane for plane
        if isinstance(ref, FusedLinear):
            for name, plane in ref.base.planes.items():
                assert torch.equal(layer[key].base.planes[name], plane), (key, name)
    if shape == "tiny-phi2":
        for key in ("output_norm_b", "output_b"):
            assert torch.equal(tree[key], own.params[key])
        assert isinstance(layer["attn_norm_b"], torch.Tensor)
    if shape != "tiny-phi3":
        assert torch.equal(layer["bq"], own.params["layers"][0]["bq"])
    carried = Engine(files[shape], device="cpu", max_seq=64)
    carried.params = tree
    ids = _ids(20, 7)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
    assert _nmse(carried.decode_step(100), own.decode_step(100)) <= NMSE_BOUND


# ---------------------------------------------------------------------------
# the runtime on the new forwards: BatchEngine, speculation, state files, cli
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_engine_matches_jax(files, shape):
    """BatchEngine (per-slot offsets, −1 for the idle slot) against the JAX
    BatchEngine on dense f32 weights and cache: every row within F32_NMSE;
    the idle slot's cache rows stay zero; the joint round's first slot
    equals the single-stream Engine's prefill."""
    kw = dict(n_slots=3, max_seq=64, prefill_chunk=16, mode="dense")
    te = BatchEngine(files[shape], device="cpu", dtype=torch.float32, kv_dtype=torch.float32,
                     **kw)
    je = JBatchEngine(files[shape], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    got = _batch_rows(te)
    errs = [_nmse(a, b) for a, b in zip(got, _batch_rows(je))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs
    assert not te.cache.k[:, 1].any()
    single = Engine(files[shape], device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
                    kv_dtype=torch.float32)
    assert _nmse(got[0], single.prefill(_ids(30, 4))) <= F32_NMSE


@pytest.mark.parametrize("shape", SHAPES)
def test_ngram_speculation_as_jax(files, engines, shape):
    """Greedy n-gram speculation (the verify graph's forward at k + 1 rows):
    the ids and every SpecStats field equal the JAX package's, and the ids
    the plain greedy decode's."""
    te, je = _packed(engines, files[shape], "bf16")
    ids = _ids(24, 8)
    te.reset()
    plain = list(te.generate_tokens(ids, 24, stop_on_eog=False))
    te.reset()
    je.reset()
    got, gs = speculative.generate_speculative(
        te, speculative.make_speculator("ngram_simple", n_draft=4), ids, 24, stop_on_eog=False)
    want, ws = jspec.generate_speculative(
        je, jspec.make_speculator("ngram_simple", n_draft=4), ids, 24, stop_on_eog=False)
    assert got == want == plain and len(got) == 24
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws) and gs.n_rounds > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_state_file_round_trip(files, engines, tmp_path, shape):
    """The port saves after a prompt; another port Engine and the JAX Engine
    each restore it (the same tokens and n_past) and continue as the saver
    does."""
    te, je = _packed(engines, files[shape], "bf16")
    ids = _ids(20, 9)
    te.reset()
    first = int(np.argmax(te.prefill(ids)))
    path = tmp_path / "state.npz"
    state.save_state(te, path, tokens=ids)

    def cont(eng) -> list[int]:
        out = [first]
        for _ in range(5):
            out.append(int(np.argmax(eng.decode_step(out[-1]))))
        return out

    want = cont(te)
    other = Engine(files[shape], device="cpu", max_seq=96)
    assert state.load_state(other, path) == ids and other.n_past == len(ids)
    assert cont(other) == want
    je.reset()
    assert jstate.load_state(je, path) == ids and je.n_past == len(ids)
    assert cont(je) == want


@pytest.mark.parametrize("shape", SHAPES)
def test_cli_completion_as_jax(files, shape):
    """The cli's greedy completion on each tiny file (phi2: the `phi-2`
    pre-tokenizer, GPT-2's regex): stdout equal to the JAX cli's."""
    argv = ["-m", str(files[shape]), "-p", "the quick brown fox", "-n", "8", "-c", "64",
            "--temp", "0"]
    rc, got, _ = _run(cli.main, argv + ["--device", "cpu"])
    rc_j, want, _ = _run(jcli.main, argv)
    assert rc == rc_j == 0 and got == want and got.startswith("the quick brown fox")


# ---------------------------------------------------------------------------
# the full-width recipes (written without weights)
# ---------------------------------------------------------------------------

def _recipe(shape: str):
    w = synthetic_writer("unused.gguf", shape=shape, n_layer=2)
    return {r.name: r for r in w._tensors}, {k: v for k, _, v in w._kv}


def test_synthetic_phi3_mini_recipe():
    """Phi-3-mini-4k at Q4_K_M: attn_qkv 3072 → 9216 at Q5_K, ffn_up 3072 →
    16384 (gate | up), the window 2047 with no pattern key, context 4096,
    32 heads of 96, vocab 32064."""
    names, kv = _recipe("phi-3-mini-4k")
    qkv, up = names["blk.0.attn_qkv.weight"], names["blk.1.ffn_up.weight"]
    assert (qkv.shape, qkv.ggml_type) == ((3072, 9216), GGMLType.Q5_K)
    assert (up.shape, up.ggml_type) == ((3072, 16384), GGMLType.Q4_K)
    assert names["blk.0.ffn_down.weight"].shape == (8192, 3072)
    assert names["output.weight"].ggml_type == GGMLType.Q6_K
    assert not any(n.endswith(".bias") for n in names)
    assert (kv["phi3.attention.sliding_window"], kv["phi3.context_length"],
            kv["phi3.attention.head_count"], kv["phi3.vocab_size"]) == (2047, 4096, 32, 32064)
    assert "phi3.attention.sliding_window_pattern" not in kv
    assert all(r.shape[0] % 256 == 0 for r in names.values() if r.ggml_type != GGMLType.F32)


def test_synthetic_phi2_recipe():
    """Phi-2 at Q4_K_M: attn_qkv 2560 → 7680 at Q5_K with its bias,
    LayerNorm biases, up 2560 → 10240, down 10240 → 2560, a biased head
    2560 → 51200; 32 rotary dims of 80, the layer-norm ε key, context 2048,
    GPT-2's BPE with pre "phi-2"."""
    names, kv = _recipe("phi-2")
    assert (names["blk.0.attn_qkv.weight"].shape, names["blk.0.attn_qkv.weight"].ggml_type) == \
        ((2560, 7680), GGMLType.Q5_K)
    assert names["blk.0.attn_qkv.bias"].shape == (7680,)
    for name in ("attn_norm.bias", "attn_output.bias", "ffn_up.bias", "ffn_down.bias"):
        assert f"blk.1.{name}" in names
    assert names["blk.0.ffn_up.weight"].shape == (2560, 10240)
    assert names["blk.0.ffn_down.weight"].shape == (10240, 2560)
    assert names["output.weight"].shape == (2560, 51200) and "output.bias" in names
    assert "output_norm.bias" in names and "blk.0.ffn_norm.weight" not in names
    assert (kv["phi2.rope.dimension_count"], kv["phi2.attention.layer_norm_epsilon"],
            kv["phi2.context_length"], kv["tokenizer.ggml.pre"]) == (32, 1e-5, 2048, "phi-2")
    assert "phi2.attention.layer_norm_rms_epsilon" not in kv


def test_synthetic_qwen_7b_recipe():
    """Qwen-7B at Q4_K_M: attn_qkv 4096 → 12288 at Q5_K with its bias, gate
    and up 4096 → 11008 apart, down at K = 11008 (a multiple of 256), vocab
    151936, ε 1e-6, Qwen's BPE (pre "qwen2")."""
    names, kv = _recipe("qwen-7b")
    assert (names["blk.0.attn_qkv.weight"].shape, names["blk.0.attn_qkv.weight"].ggml_type) == \
        ((4096, 12288), GGMLType.Q5_K)
    assert names["blk.1.attn_qkv.bias"].shape == (12288,)
    assert names["blk.0.ffn_gate.weight"].shape == names["blk.0.ffn_up.weight"].shape == \
        (4096, 11008)
    assert names["blk.0.ffn_down.weight"].shape == (11008, 4096) and 11008 % 256 == 0
    assert (kv["qwen.vocab_size"], kv["qwen.attention.layer_norm_rms_epsilon"],
            kv["tokenizer.ggml.pre"]) == (151936, 1e-6, "qwen2")
