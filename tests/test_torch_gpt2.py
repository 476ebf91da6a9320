"""Port parity of gpt2 and starcoder (models/gpt2.py: learned positions,
fused qkv, LayerNorms with biases, the tanh GELU) against the JAX package,
both on the CPU.

Dense f32: tpullm/models/testing.py make_tiny_gpt2_gguf for each arch (a
32-position table): every row within NMSE 1e-5 (the runs land near
1e-13). Packed: the port's tiny-gpt2 (a 64-position table, tied) and
tiny-starcoder (4 heads on one KV head, its own head) at Q4_K_M, bf16:
NMSE 1e-3. Positions past the table are clamped to its last row, as a JAX
gather clamps its index: a prompt whose bucket (and whose own tokens) run
past it, decode steps on the graph past it, BatchEngine and verify rows
past it, all against the JAX package. The engines and helpers are
tests/test_torch_bloom.py's."""

import numpy as np
import pytest
import torch

from test_torch_bloom import (F32_NMSE, GPT2_DENSE, GREEDY_PROMPT, NMSE_BOUND, PROMPT, _ids,
                              _nmse, check_batch_engine, check_offsets, engine_getter,
                              engine_pair, jax_device_load)
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models import bloom, gpt2
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import synthetic_writer

PACKED = ("tiny-gpt2", "tiny-starcoder")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    with jax_device_load():
        yield engine_getter(tmp_path_factory.mktemp("gpt2"), GPT2_DENSE)


def test_registry_maps_gpt2_and_starcoder():
    for arch in ("gpt2", "starcoder"):
        spec = get_arch(arch)
        assert (spec.build_params, spec.forward, spec.iswa, spec.make_cache) == \
            (gpt2.build_params, gpt2.forward, False, None)


@pytest.mark.parametrize("case", [*GPT2_DENSE, *PACKED])
def test_hparams_match_jax(engines, case):
    te, je = engines(case)
    for field in ("n_ctx_train", "n_head", "n_head_kv", "head_dim", "rms_eps",
                  "max_alibi_bias"):
        assert getattr(te.hp, field) == getattr(je.hp, field), field
    assert te.params["pos_embd"].shape[0] == te.hp.n_ctx_train


@pytest.mark.parametrize("case", list(GPT2_DENSE))
def test_dense_logits_and_decode_steps_match_jax(engines, case):
    te, je = engines(case)
    assert _nmse(te.prefill_all_logits(PROMPT), je.prefill_all_logits(PROMPT)) <= F32_NMSE
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= F32_NMSE


@pytest.mark.parametrize("case", list(GPT2_DENSE))
def test_dense_positions_past_the_table_match_jax(engines, case):
    """A 20-token prompt on the 32-position table (its bucket of 32 rows
    ends at the table's end), a resumed prompt and verify rows that run to
    position 38, then decode steps on the logits graph up to position 44:
    every position past 31 reads the table's last row, as in JAX."""
    te, je = engines(case)
    check_offsets(te, je, F32_NMSE)
    for tok in (3, 17, 5, 8, 9, 11):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= F32_NMSE
    assert te.n_past == 44 > te.hp.n_ctx_train


@pytest.mark.parametrize("case", list(GPT2_DENSE))
def test_batch_engine_matches_jax(engines, case):
    """BatchEngine against the JAX BatchEngine; slot 0's 30-token prompt
    and its decode steps run past the 32-position table."""
    engines(case)
    check_batch_engine(engines.files[case])


@pytest.mark.parametrize("case", PACKED)
def test_packed_logits_decode_and_greedy_ids_match_jax(engines, case):
    te, je = engines(case)
    assert _nmse(te.prefill(PROMPT), je.prefill(PROMPT)) <= NMSE_BOUND
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= NMSE_BOUND
    te.reset()
    je.n_past = 0
    got = te.generate_tokens_device(GREEDY_PROMPT, 10, temp=0.0, stop_on_eog=False, chunk=4)
    want = je.generate_tokens_device(GREEDY_PROMPT, 10, temp=0.0, stop_on_eog=False, chunk=4)
    assert got == want


def test_packed_prompt_past_the_table_matches_jax(engines):
    """tiny-gpt2 (64 positions) at max_seq 128: a 70-token prompt (its
    bucket of 128 rows, and six of its own tokens, past the table) and 8
    greedy tokens on the decode graph, ids equal to the JAX package's (a
    prompt on which no decision flips between the packages: after
    _ids(70, 3) the top two logits lie within one bf16 step, 2.906 and 2.891
    in the port, 2.875 and 2.891 in the JAX package)."""
    te, je = engine_pair(engines.path("tiny-gpt2"), dense=False, max_seq=128)
    prompt = _ids(70, 10, hi=370)
    assert _nmse(te.prefill(prompt), je.prefill(prompt)) <= NMSE_BOUND
    te.reset()
    je.n_past = 0
    got = te.generate_tokens_device(prompt, 8, temp=0.0, stop_on_eog=False, chunk=4)
    want = je.generate_tokens_device(prompt, 8, temp=0.0, stop_on_eog=False, chunk=4)
    assert got == want and te.n_past == 78


def test_learned_positions_clamp_to_the_table():
    table = torch.arange(10.0).reshape(5, 2)
    got = bloom.learned_positions(table, torch.tensor([[3, 4, 5, 9]], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), [[[6, 7], [8, 9], [8, 9], [8, 9]]])


def test_synthetic_starcoder_recipe():
    """StarCoder-15.5B: 48 heads on one KV head (q|k|v 6144 + 2·128 rows at
    Q5_K), an 8192 × 6144 f32 position table, biases, its own Q6_K head."""
    w = synthetic_writer("/nonexistent/starcoder.gguf", "starcoder-15b", n_layer=2)
    types = {t.name: t.ggml_type for t in w._tensors}
    shapes = {t.name: t.shape for t in w._tensors}
    assert shapes["blk.0.attn_qkv.weight"] == (6144, 6144 + 2 * 128)
    assert types["blk.0.attn_qkv.weight"] == GGMLType.Q5_K
    assert (types["position_embd.weight"], shapes["position_embd.weight"]) == \
        (GGMLType.F32, (6144, 8192))
    assert types["output.weight"] == GGMLType.Q6_K and types["token_embd.weight"] == GGMLType.Q4_K
    assert "blk.1.ffn_down.bias" in types


def test_synthetic_gpt2_recipe():
    """GPT-2: 1024 positions, vocab 50257 on a tied Q6_K embedding."""
    w = synthetic_writer("/nonexistent/gpt2.gguf", "gpt2")
    types = {t.name: t.ggml_type for t in w._tensors}
    shapes = {t.name: t.shape for t in w._tensors}
    assert shapes["position_embd.weight"] == (768, 1024) and "output.weight" not in types
    assert (types["token_embd.weight"], shapes["token_embd.weight"]) == (GGMLType.Q6_K,
                                                                       (768, 50257))
    assert sum(n.endswith("attn_qkv.weight") for n in types) == 12
