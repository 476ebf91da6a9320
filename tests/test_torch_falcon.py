"""Port parity of the falcon family (models/falcon.py: falcon, gptneox,
codeshell) against the JAX package, both on the CPU.

Dense f32: tpullm/models/testing.py make_tiny_falcon_gguf at the cases of
tests/test_archs.py (falcon, Falcon-40B's attn_norm_2, gptneox sequential
and parallel with half the head dim rotated, codeshell on gptneox's
sequential graph): every row of a prompt's logits and decode steps within
NMSE 1e-6 (the same f32 arithmetic in another order). Packed: the port's
synthetic tiny-falcon (Falcon-7B's layout, 5 heads of 64 on one KV head,
n_embd 320: the recipe's fallback types) and tiny-gptneox (Pythia's:
partial rotary, biases, parallel residual) at Q4_K_M, bf16 activations and
cache: NMSE 1e-3 (tests/test_torch_llama_aliases.py), the JAX side on its
device repack (`TPULLM_DEVICE_REPACK=1`)."""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.testing import make_tiny_falcon_gguf
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models import falcon
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf, synthetic_writer
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache
PROMPT = [1, 5, 9, 12, 7, 3, 44, 80, 100, 22, 11]
# the greedy check's prompt: one on which no decision flips between the
# packages (the tiny models' top logits can lie within one bf16 step: after
# PROMPT and token 204 tiny-gptneox's top two are 2.781 and 2.766 in the JAX
# package, 2.750 and 2.781 in the port, so their argmax parts)
GREEDY_PROMPT = [1, 40, 41, 42, 43]

DENSE = {
    "falcon": dict(arch="falcon"),
    "falcon-norm2": dict(arch="falcon", norm2=True),
    "gptneox": dict(arch="gptneox", rot_frac=0.5),
    "gptneox-parallel": dict(arch="gptneox", rot_frac=0.5, par_residual=True),
    "codeshell": dict(arch="codeshell", rot_frac=0.5),
}
PACKED = ("tiny-falcon", "tiny-gptneox")


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """One (port, JAX) Engine pair per case, made at first use."""
    d = tmp_path_factory.mktemp("falcon")
    made = {}

    def get(case):
        if case not in made:
            if case in DENSE:
                path = make_tiny_falcon_gguf(str(d / f"{case}.gguf"), **DENSE[case])
                made[case] = (Engine(path, device="cpu", max_seq=64, mode="dense",
                                     dtype=torch.float32, kv_dtype=torch.float32),
                              JEngine(path, max_seq=64, mode="dense", dtype=jnp.float32,
                                      kv_dtype=jnp.float32))
            else:
                path = make_synthetic_llama_gguf(d / f"{case}.gguf", shape=case, seed=0)
                made[case] = (Engine(path, device="cpu", max_seq=64),
                              JEngine(path, max_seq=64))
        te, je = made[case]
        te.reset()
        je.n_past = 0
        return te, je
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")  # the JAX load the port mirrors, for this file
        yield get


def test_registry_maps_the_falcon_family():
    for arch in ("falcon", "gptneox", "codeshell"):
        spec = get_arch(arch)
        assert spec.forward is falcon.forward and spec.build_params is falcon.build_params


@pytest.mark.parametrize("case", [*DENSE, *PACKED])
def test_hparams_match_jax(engines, case):
    te, je = engines(case)
    assert te.hp.par_residual == je.hp.par_residual
    assert te.hp.rms_eps == je.hp.rms_eps
    for field in ("style", "dims", "freq_base"):
        assert getattr(te.hp.rope, field) == getattr(je.hp.rope, field), field


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_logits_and_decode_steps_match_jax(engines, case):
    """Every row of an 11-token prompt, then three decode steps (the
    logits graph), within F32_NMSE of the JAX Engine."""
    te, je = engines(case)
    assert _nmse(te.prefill_all_logits(PROMPT), je.prefill_all_logits(PROMPT)) <= F32_NMSE
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= F32_NMSE


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


def test_falcon_7b_takes_the_recipe_fallback_types():
    """Falcon-7B at Q4_K_M: its n_embd 4544 rows are no whole 256-blocks,
    so every tensor of that K takes llama.cpp's fallback (q|k|v Q5_K → Q5_1,
    Q4_K → Q5_0, the head's Q6_K → Q8_0); ffn_down (K = 18176 = 71·256)
    keeps the recipe's type."""
    w = synthetic_writer("/nonexistent/falcon-7b.gguf", "falcon-7b", n_layer=8)
    types = {t.name: t.ggml_type for t in w._tensors}
    assert types["token_embd.weight"] == GGMLType.Q5_0
    assert types["output.weight"] == GGMLType.Q8_0
    for i in range(8):
        p = f"blk.{i}."
        assert types[p + "attn_qkv.weight"] == GGMLType.Q5_1
        assert types[p + "attn_output.weight"] == types[p + "ffn_up.weight"] == GGMLType.Q5_0
        assert types[p + "ffn_down.weight"] in (GGMLType.Q4_K, GGMLType.Q6_K)
    assert {t.shape for t in w._tensors if t.name.endswith("attn_qkv.weight")} == \
        {(4544, (71 + 2) * 64)}
