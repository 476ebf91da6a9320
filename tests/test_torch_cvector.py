"""Port parity of control vectors (tpullm_torch/tools/cvector.py: load,
save, the generator and its CLI, tpullm-torch-cvector-generator; Engine's
`control_vectors` and the llama graph's `cvec`) against the JAX package's
(tpullm/tools/cvector.py, its Engine), both on the CPU.

Models: the JAX package's fixture (tests/test_cvector.py's
make_tiny_llama_gguf: 2 layers, n_embd 64, f32 tensors) on dense f32
weights, the port's synthetic "tiny" at Q4_K_M (the JAX side through its
device repack), and the tiny gemma3 for an arch whose graph ignores the
vectors in both packages. The vectors are drawn from a seed, N(0, 0.1²)
a component, but the packed model's: its residual stream is ≈ 2e9 (the
synthetic file's scales), so its vectors are N(0, (5e8)²), enough to move
the logits.

Tolerances: dense f32 weights and cache, logits within NMSE 1e-6
(F32_NMSE, the same arithmetic in another order); packed weights and a
bf16 cache NMSE ≤ 1e-3 (NMSE_BOUND). The generator runs both packages'
dense bf16 Engine (the JAX generator's load): each layer's direction
within NMSE GEN_NMSE = 1e-3 of the JAX one and pointing the same way
(cosine ≥ 0.999), in both methods. Its inputs are differences of bf16
hidden states, so they carry the packages' bf16 rounding differences
(≈ 1e-3 of a state) and no tighter bound holds; the file round trips
are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.runtime.engine import Engine as JEngine
from tpullm.tools import cvector as jcvector

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tools import cvector

F32_NMSE = 1e-6
NMSE_BOUND = 1e-3
GEN_NMSE = 1e-3
POSITIVE = ["the happy dog", "a happy world", "the quick happy fox", "happy happy"]
NEGATIVE = ["the sad dog", "a sad world", "the quick sad fox", "sad sad"]


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("cvector")
    out = {"f32": make_tiny_llama_gguf(d / "m.gguf", n_embd=64, n_head=4, n_head_kv=2,
                                       n_ff=128, n_layer=2),
           "packed": make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0),
           "gemma3": make_synthetic_llama_gguf(d / "g.gguf", shape="tiny-gemma3", seed=0)}
    rng = np.random.default_rng(1)
    for name, (n_layer, n_embd, scale) in {"f32": (2, 64, 0.1), "packed": (2, 256, 5e8),
                                           "gemma3": (6, 1024, 0.1)}.items():
        dirs = (rng.standard_normal((n_layer, n_embd)) * scale).astype(np.float32)
        out[name + "-cv"] = cvector.save_control_vector(d / f"{name}-cv.gguf", dirs)
        half = dirs.copy()
        half[0] = 0.0  # a file without direction.1
        out[name + "-cv2"] = cvector.save_control_vector(d / f"{name}-cv2.gguf", half)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cvec_round_trip_strength_and_missing_layers(tmp_path, writer):
    """tests/test_cvector.py's case across the packages: a file written by
    either loads in both as directions × strength; layers past the file
    and a zero layer (no direction.N written) load as zeros; a file
    without directions raises."""
    dirs = np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32)
    dirs[1] = 0.0
    save = cvector.save_control_vector if writer == "port" else jcvector.save_control_vector
    f = save(tmp_path / "cv.gguf", dirs)
    for n_layer in (3, 4, 2):
        got = cvector.load_control_vector(f, n_layer=n_layer, strength=0.5)
        want = jcvector.load_control_vector(f, n_layer=n_layer, strength=0.5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got[:3], (dirs * 0.5)[:n_layer], rtol=1e-6)
        assert not np.any(got[3:]) and not np.any(got[1])
    empty = cvector.save_control_vector(tmp_path / "e.gguf", np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match="no direction tensors"):
        cvector.load_control_vector(empty, 2)


def _engines(paths, kind, **kw):
    if kind == "f32":
        return (Engine(paths["f32"], device="cpu", mode="dense", dtype=torch.float32,
                       kv_dtype=torch.float32, max_seq=64, **kw),
                JEngine(paths["f32"], mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                        max_seq=64, **kw))
    if kind == "gemma3":
        return (Engine(paths["gemma3"], device="cpu", mode="dense", dtype=torch.float32,
                       kv_dtype=torch.float32, max_seq=64, **kw),
                JEngine(paths["gemma3"], mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                        max_seq=64, **kw))
    return (Engine(paths["packed"], device="cpu", max_seq=64, **kw),
            JEngine(paths["packed"], max_seq=64, **kw))


@pytest.mark.parametrize("kind", ["f32", "packed"])
def test_engine_control_vectors_match_jax(paths, kind):
    """Engine(control_vectors=[two files]) against the JAX Engine: the
    vectors summed over the files (strengths 1 and −0.5), every position's
    logits of a prompt, three decode steps and 12 greedy ids on the device
    path against the JAX host loop; the vectors move the logits from the
    plain engine's; at strength 0 the engine is the plain one."""
    bound = F32_NMSE if kind == "f32" else NMSE_BOUND
    cvs = [(paths[kind + "-cv"], 1.0), (paths[kind + "-cv2"], -0.5)]
    te, je = _engines(paths, kind, control_vectors=cvs)
    np.testing.assert_array_equal(te.params["cvec"].numpy(), np.asarray(je.params["cvec"]))
    plain, _ = _engines(paths, kind)
    ids = list(range(5, 25))
    got = te.prefill_all_logits(ids)
    assert _nmse(got, je.prefill_all_logits(ids)) <= bound
    for t in (5, 9, 200):
        assert _nmse(te.decode_step(t), je.decode_step(t)) <= bound
    assert _nmse(got, plain.prefill_all_logits(ids)) > 1e-2  # the vectors act
    te.reset()
    je.reset()
    assert te.generate_tokens_device(ids, 12, temp=0.0, chunk=4) == list(je.generate_tokens(
        ids, 12))
    zero, _ = _engines(paths, kind, control_vectors=[(paths[kind + "-cv"], 0.0)])
    plain.reset()
    np.testing.assert_array_equal(zero.prefill_all_logits(ids), plain.prefill_all_logits(ids))
    assert f"cvec {paths[kind + '-cv']} ×1" in te.report()


def test_control_vectors_on_another_arch_as_jax(paths):
    """The JAX package adds the vectors in the llama graph only: a gemma3
    Engine given control_vectors loads them into params["cvec"] and
    computes the plain engine's logits, in both packages."""
    te, je = _engines(paths, "gemma3", control_vectors=[(paths["gemma3-cv"], 1.0)])
    plain, jplain = _engines(paths, "gemma3")
    assert te.params["cvec"].shape == (6, 1024) and "cvec" in je.params
    ids = list(range(5, 25))
    got, want = te.prefill_all_logits(ids), je.prefill_all_logits(ids)
    np.testing.assert_array_equal(got, plain.prefill_all_logits(ids))
    np.testing.assert_array_equal(want, jplain.prefill_all_logits(ids))
    assert _nmse(got, want) <= F32_NMSE


def _cos(a, b) -> float:
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("method", ["mean", "pca"])
def test_generate_control_vector_as_jax(paths, method):
    """generate_control_vector on 4 prompt pairs against the JAX one: the
    shape [n_layer, n_embd], every layer's direction within GEN_NMSE and
    at cosine ≥ 0.999 of the JAX one; the per-layer states come from the
    port's llama forward (`layer_states`)."""
    got = cvector.generate_control_vector(paths["f32"], POSITIVE, NEGATIVE, method,
                                          device="cpu")
    want = jcvector.generate_control_vector(paths["f32"], POSITIVE, NEGATIVE, method)
    assert got.shape == want.shape == (2, 64) and np.isfinite(got).all()
    for li in range(2):
        assert _nmse(got[li], want[li]) <= GEN_NMSE, li
        assert _cos(got[li], want[li]) >= 0.999, li


def test_cvector_generator_cli_as_jax(paths, tmp_path):
    """tpullm-torch-cvector-generator's main (--device cpu, --method pca)
    writes a file of the JAX tool's directions (GEN_NMSE) that both
    packages' Engines load; it prints the JAX tool's line."""
    pos, neg = tmp_path / "pos.txt", tmp_path / "neg.txt"
    pos.write_text("\n".join(POSITIVE) + "\n")
    neg.write_text("\n".join(NEGATIVE) + "\n\n")
    out, jout = tmp_path / "cv.gguf", tmp_path / "jcv.gguf"
    argv = ["-m", paths["f32"], "--positive-file", str(pos), "--negative-file", str(neg)]
    assert cvector.main(argv + ["-o", str(out), "--device", "cpu"]) == 0
    assert jcvector.main(argv + ["-o", str(jout)]) == 0
    got = cvector.load_control_vector(out, 2)
    assert _nmse(got, jcvector.load_control_vector(jout, 2)) <= GEN_NMSE
    np.testing.assert_array_equal(got, jcvector.load_control_vector(out, 2))
    eng = Engine(paths["f32"], device="cpu", mode="dense", max_seq=64,
                 control_vectors=[(str(out), 2.0)])
    assert isinstance(eng.generate("the quick", max_new_tokens=4), str)
