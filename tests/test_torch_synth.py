"""The synthetic models: the Q4_K_M type recipe (dense, and its branch for
8-expert models) and seeded bytes."""

import hashlib

import numpy as np
import pytest

from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.tools.quantize import tensor_type_policy

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, q4_k_m_type


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("s") / "m.gguf",
                                     shape="tiny-moe", seed=0)


def _expected_8_expert(name: str) -> GGMLType:
    """llama_tensor_get_type's Q4_K_M answer for a model with 8 experts
    (src/llama-quant.cpp): Q8_0 attn_k/attn_v, Q5_K attn_output, Q6_K
    ffn_down_exps on the use_more_bits layers (layer 1 of 2), Q6_K head,
    F32 norms and router, Q4_K elsewhere."""
    if name.endswith("norm.weight") or name.endswith("ffn_gate_inp.weight"):
        return GGMLType.F32
    if name == "output.weight":
        return GGMLType.Q6_K
    if name.endswith(("attn_k.weight", "attn_v.weight")):
        return GGMLType.Q8_0
    if name.endswith("attn_output.weight"):
        return GGMLType.Q5_K
    if name == "blk.1.ffn_down_exps.weight":
        return GGMLType.Q6_K
    return GGMLType.Q4_K


def test_tiny_moe_tensors_follow_the_8_expert_q4_k_m_recipe(tiny_moe):
    r = GGUFReader(tiny_moe)
    cfg = SHAPES["tiny-moe"]
    assert r.metadata["llama.expert_count"] == 8 and r.metadata["llama.expert_used_count"] == 2
    for i in range(cfg["n_layer"]):
        for kind in ("ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            assert f"blk.{i}.{kind}.weight" in r.tensors
        assert f"blk.{i}.ffn_gate.weight" not in r.tensors
    for name, info in r.tensors.items():
        assert info.ggml_type == _expected_8_expert(name), name
    n_embd, n_ff = cfg["n_embd"], cfg["n_ff"]
    assert r.tensors["blk.0.ffn_gate_exps.weight"].shape == (n_embd, n_ff, 8)
    assert r.tensors["blk.1.ffn_down_exps.weight"].shape == (n_ff, n_embd, 8)
    assert r.tensors["blk.0.ffn_gate_inp.weight"].shape == (n_embd, 8)


@pytest.mark.parametrize("n_layer", [2, 32])
def test_dense_recipe_matches_the_jax_quantize_policy(n_layer):
    """Without experts the recipe is the JAX package's Q4_K_M policy."""
    for i in range(n_layer):
        for kind in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                     "ffn_down"):
            want = tensor_type_policy(f"blk.{i}.{kind}.weight", JGGMLType.Q4_K, "Q4_K_M",
                                      n_layer)
            assert int(q4_k_m_type(kind, i, n_layer)) == int(want), (i, kind)
    for kind in ("token_embd", "output"):
        want = tensor_type_policy(f"{kind}.weight", JGGMLType.Q4_K, "Q4_K_M", n_layer)
        assert int(q4_k_m_type(kind, 0, n_layer)) == int(want), kind


def test_mixtral_recipe_upgrades_ffn_down_exps_on_use_more_bits_layers():
    types = [q4_k_m_type("ffn_down_exps", i, 32, 8) for i in range(32)]
    assert types.count(GGMLType.Q6_K) == 16 and types[0] == types[31] == GGMLType.Q6_K
    assert {q4_k_m_type(k, 5, 32, 8) for k in ("ffn_gate_exps", "ffn_up_exps", "attn_q")} \
        == {GGMLType.Q4_K}


@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_synth_bytes_come_from_the_seed(tmp_path, shape):
    a = make_synthetic_llama_gguf(tmp_path / "a.gguf", shape=shape, seed=0)
    b = make_synthetic_llama_gguf(tmp_path / "b.gguf", shape=shape, seed=0)
    c = make_synthetic_llama_gguf(tmp_path / "c.gguf", shape=shape, seed=1)
    assert _sha(a) == _sha(b) != _sha(c)


def test_moe_weights_have_unit_scale_activations(tiny_moe):
    """The MoE shapes set block scales so each matrix's RMS is n_in^-1/2."""
    from tpullm_torch.ops import qmatmul

    r = GGUFReader(tiny_moe)
    for name in ("blk.0.attn_q.weight", "blk.0.attn_k.weight", "blk.0.attn_output.weight",
                 "output.weight"):
        info = r.tensors[name]
        n_in, n_out = info.shape
        planes = qmatmul.repack(info.data, info.ggml_type, n_out, n_in, "cpu")
        rms = float(qmatmul.dequant_planes(planes, info.ggml_type, n_out, n_in)
                    .pow(2).mean().sqrt())
        assert 0.8 < rms * n_in ** 0.5 < 1.25, (name, rms)
    router = r.tensors["blk.0.ffn_gate_inp.weight"].to_numpy()
    assert 0.9 < float(np.sqrt((router ** 2).mean())) * router.shape[1] ** 0.5 < 1.1
