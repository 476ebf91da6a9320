"""Port parity of self-extend (Engine's `grp_attn_n`: RoPE positions
slot // grp_attn_n, the cache slots and the causal mask unchanged) against
the JAX package's Engine, both on the CPU, in every path that computes
positions: the eager prefill and prefill_all_logits on the host, the
decode graph's step (generate_tokens_device), the logits step
(decode_step, generate_tokens) and the verify step (verify_logits) on
their device n_past buffers; and the three Engine options at once.

Models: tests/test_model.py's self-extend setting (make_tiny_llama_gguf
with its defaults: 2 layers, n_embd 64, f32 tensors, vocab 287) on dense
f32 weights, and the port's synthetic "tiny" at Q4_K_M (the JAX side
through its device repack). The JAX package's device generation path
computes plain positions (its decode chunk takes n_past as the
position), so the port's device path is held to the JAX host loop,
`generate_tokens`, whose decode steps take the self-extend positions.

Tolerances: dense f32 logits within NMSE 1e-6 (F32_NMSE, the same
arithmetic in another order), packed NMSE ≤ 1e-3 (NMSE_BOUND); greedy
ids exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf import GGUFReader as JReader
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.models import lora
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tools import cvector

F32_NMSE = 1e-6
NMSE_BOUND = 1e-3
TOKS = list(range(3, 19))  # tests/test_model.py's prompt


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("options")
    return {"f32": make_tiny_llama_gguf(d / "m.gguf"),
            "packed": make_synthetic_llama_gguf(d / "tiny.gguf", shape="tiny", seed=0)}


def _engines(paths, kind, **kw):
    if kind == "f32":
        return (Engine(paths["f32"], device="cpu", mode="dense", dtype=torch.float32,
                       kv_dtype=torch.float32, max_seq=64, **kw),
                JEngine(paths["f32"], mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32,
                        max_seq=64, **kw))
    return (Engine(paths["packed"], device="cpu", max_seq=64, **kw),
            JEngine(paths["packed"], max_seq=64, **kw))


@pytest.mark.parametrize("grp", [2, 4])
@pytest.mark.parametrize("kind", ["f32", "packed"])
def test_self_extend_matches_jax(paths, kind, grp):
    """Engine(grp_attn_n) against the JAX Engine: every position's logits of
    the prompt, then four decode steps (the logits graph's step: its
    position n_past // grp computed from the device n_past); the positions
    move the logits from the plain engine's."""
    bound = F32_NMSE if kind == "f32" else NMSE_BOUND
    te, je = _engines(paths, kind, grp_attn_n=grp)
    plain, _ = _engines(paths, kind)
    got = te.prefill_all_logits(TOKS)
    assert _nmse(got, je.prefill_all_logits(TOKS)) <= bound
    assert _nmse(got, plain.prefill_all_logits(TOKS)) > 1e-6
    for t in (5, 9, 11, 200):
        assert _nmse(te.decode_step(t), je.decode_step(t)) <= bound
    assert te.n_past == je.n_past == len(TOKS) + 4
    assert f"self-extend grp_attn_n {grp}" in te.report()


def test_self_extend_is_a_forward_at_divided_positions(paths):
    """tests/test_model.py's manual reference on the port: the logits with
    grp_attn_n 2 equal the plain engine's forward at positions // 2 (cache
    slots dense), bit for bit; rope_positions divides on the device."""
    te, _ = _engines(paths, "f32", grp_attn_n=2)
    got = te.prefill_all_logits(TOKS)
    ref = Engine(paths["f32"], device="cpu", mode="dense", dtype=torch.float32,
                 kv_dtype=torch.float32, max_seq=64)
    toks = ref._padded(TOKS)
    pos = (torch.arange(toks.shape[1], dtype=torch.int32) // 2)[None]
    with torch.inference_mode():
        logits, _ = ref.arch.forward(ref.hp, ref.params, toks, pos, ref.cache, 0)
    np.testing.assert_array_equal(got, logits[0, :len(TOKS)].numpy())
    slots = torch.arange(10, dtype=torch.int32)
    assert te.rope_positions(slots).tolist() == [i // 2 for i in range(10)]
    assert ref.rope_positions(slots) is slots


@pytest.mark.parametrize("kind", ["f32", "packed"])
def test_self_extend_graph_paths_as_jax(paths, kind):
    """The device paths under self-extend: 20 greedy ids of the decode
    graph's step (generate_tokens_device, chunks of 4 crossing group
    boundaries) equal the JAX host loop's and the port's own
    generate_tokens (the logits step); verify_logits of 5 tokens (the
    verify step, positions (n_past + i) // grp on the device) equal the JAX
    prefill_all_logits at that point."""
    bound = F32_NMSE if kind == "f32" else NMSE_BOUND
    te, je = _engines(paths, kind, grp_attn_n=4)
    want = list(je.generate_tokens(TOKS, 20))
    assert te.generate_tokens_device(TOKS, 20, temp=0.0, chunk=4) == want
    te.reset()
    assert list(te.generate_tokens(TOKS, 20)) == want
    te.reset()
    je.reset()
    te.prefill(TOKS)
    je.prefill(TOKS)
    seq = [7, 8, 9, 10, 11]
    assert _nmse(te.verify_logits(seq), je.prefill_all_logits(seq)) <= bound


def test_all_engine_options_at_once_as_jax(paths, tmp_path):
    """An Engine with a LoRA adapter, control vectors and self-extend at
    once against the JAX Engine with the same: logits of the prompt and of
    three decode steps (F32_NMSE), 12 greedy ids."""
    r = JReader(paths["f32"])
    rng = np.random.default_rng(4)
    tensors = {}
    for name in ("blk.0.attn_v.weight", "blk.1.ffn_up.weight"):
        n_out, n_in = r.tensors[name].shape[1], r.tensors[name].shape[0]
        tensors[name] = (rng.standard_normal((4, n_in)).astype(np.float32) * 0.1,
                         rng.standard_normal((n_out, 4)).astype(np.float32) * 0.1)
    ad = lora.save_lora_gguf(tmp_path / "a.gguf", tensors, alpha=4.0)
    cv = cvector.save_control_vector(tmp_path / "cv.gguf",
                                     (rng.standard_normal((2, 64)) * 0.1).astype(np.float32))
    kw = dict(lora=[(ad, 0.5)], control_vectors=[(cv, 0.8)], grp_attn_n=2)
    te, je = _engines(paths, "f32", **kw)
    assert _nmse(te.prefill_all_logits(TOKS), je.prefill_all_logits(TOKS)) <= F32_NMSE
    for t in (5, 9, 11):
        assert _nmse(te.decode_step(t), je.decode_step(t)) <= F32_NMSE
    te.reset()
    je.reset()
    assert te.generate_tokens_device(TOKS, 12, temp=0.0, chunk=4) == list(
        je.generate_tokens(TOKS, 12))
