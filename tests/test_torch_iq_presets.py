"""Port parity for llama.cpp's i-quant and ternary presets: the tiny
synthetic llama at IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_M, IQ3_XXS, IQ3_M,
TQ1_0 and TQ2_0, and the tiny 8-expert MoE at IQ2_XXS, served by the JAX
package's Engine and by tpullm_torch's Engine (on the CPU). One file, one
module-scoped engine cache: the JAX Engine's compiles dominate.

The JAX Engine loads through its device path (TPULLM_DEVICE_REPACK=1) as
in test_torch_presets.py. None of the nine codebook types is one its device
repack takes, so it repacks their linears on the host (repack_np, bf16 scale
planes on upload; TPULLM_NO_REPACK_CACHE=1 keeps that repack off the disk)
and dequantizes an IQ3_S embedding with its f32 codecs, rounded once to
bf16: the loads the port mirrors."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import (PROMPT, STEPS, carried_planes_equal, greedy_ids,
                                nmse, one_torch_thread, teacher_forced_errors)  # noqa: F401
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.convert import params_from_jax
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import SHAPES, make_synthetic_llama_gguf, preset_type
from tpullm_torch.models.weights import FusedLinear, QuantExpertStack
from tpullm_torch.runtime.engine import Engine

IQ_PRESETS = ("IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ3_XXS", "IQ3_M", "TQ1_0",
              "TQ2_0")
# The tiny model at 2 and 3 bits a weight is as chaotic as at the legacy
# presets (attention scores in the hundreds): one bf16 ulp of a q or k decides
# a near mix now and then. The port against itself, its 2-D linears once
# through qmm_reference and once through qmm_grouped_reference (other rounding
# points, the same function), shows such spikes too: IQ2_XS on PROMPT 1.7e-2
# at one decode step, ≤2e-3 elsewhere. On PROMPT the packages part at IQ2_XS
# (prefill logits NMSE 1.6e-2, ≤7.4e-4 elsewhere), at IQ2_M (decode step 4:
# 4.5e-2) and at IQ3_M (logits within 6e-5, but a near tie parts the free
# greedy ids at step 13). On these prompts every step agrees within 4.5e-4
# and so do the greedy ids.
PROMPTS = {"IQ2_XS": "a quick brown dog jumps over the lazy fox",
           "IQ2_M": "the fox and the dog jumped over the world",
           "IQ3_M": "over the lazy dog the quick brown fox jumps hello"}
# tiny-moe at IQ2_XXS: on MOE_PROMPT a top-2 routing decision flips at decode
# step 12 (NMSE 3.0e-2 from there); on PROMPT (43 tokens, the all-experts
# regime at prefill) every step agrees within 1.6e-4 and so do the greedy ids.
MOE_IQ_PROMPT = PROMPT
# the layer keys of the port's params, by the GGUF kind each loads
KIND = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
        "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down",
        "w_gate_exps": "ffn_gate_exps", "w_up_exps": "ffn_up_exps",
        "w_down_exps": "ffn_down_exps"}


def _make_engines(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        mp.setenv("TPULLM_NO_REPACK_CACHE", "1")
        je = JEngine(path, max_seq=256, kv_dtype=jnp.bfloat16)
    return je, Engine(path, device="cpu", max_seq=256, kv_dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """get(shape, ftype) → (JAX Engine, port Engine), built once each;
    get.path(shape, ftype) → the GGUF."""
    root = tmp_path_factory.mktemp("iq_presets")
    cache = {}

    def path(shape: str, ftype: str):
        p = root / f"{shape}-{ftype}.gguf"
        if not p.exists():
            make_synthetic_llama_gguf(p, shape=shape, seed=0, ftype=ftype)
        return p

    def get(shape: str, ftype: str):
        if (shape, ftype) not in cache:
            cache[shape, ftype] = _make_engines(path(shape, ftype))
        return cache[shape, ftype]
    get.path = path
    return get


def _gtypes(module) -> set[GGMLType]:
    """The types of a layer entry: a fused linear's shared type, or each."""
    return {(module.base if isinstance(module, FusedLinear) else module).gtype}


@pytest.mark.parametrize("ftype", IQ_PRESETS)
def test_teacher_forced_logits_match_jax(engines, ftype):
    """Per-step logits NMSE ≤ 1e-3, the bound of the other presets' tests."""
    errs = teacher_forced_errors(*engines("tiny", ftype), PROMPTS.get(ftype, PROMPT))
    assert max(errs) <= 1e-3, errs


@pytest.mark.parametrize("ftype", IQ_PRESETS)
def test_free_running_greedy_ids_match_jax(engines, ftype):
    ref, got = greedy_ids(*engines("tiny", ftype), PROMPTS.get(ftype, PROMPT))
    assert len(got) == STEPS and got == ref


@pytest.mark.parametrize("ftype", IQ_PRESETS)
def test_layer_types_follow_the_recipe(engines, ftype):
    """Every linear of the port's load has the type preset_type gives it; the
    JAX Engine's tree fuses the same linears."""
    je, te = engines("tiny", ftype)
    n = SHAPES["tiny"]["n_layer"]
    for i, (layer, jlayer) in enumerate(zip(te.params["layers"], je.params["layers"])):
        want_qkv = {preset_type(ftype, k, i, n) for k in ("attn_q", "attn_k", "attn_v")}
        if layer.get("wqkv") is not None:
            assert len(want_qkv) == 1 and _gtypes(layer["wqkv"]) == want_qkv
            assert jlayer.get("wqkv") is not None
        else:
            assert len(want_qkv) > 1 and jlayer.get("wqkv") is None
        assert _gtypes(layer["wgu"]) == {preset_type(ftype, "ffn_gate", i, n)}
        for key in ("wq", "wk", "wv", "wo", "w_down"):
            if layer.get(key) is not None:
                assert layer[key].gtype == preset_type(ftype, KIND[key], i, n), (i, key)
    assert te.params["output"].gtype == preset_type(ftype, "output", 0, n)


@pytest.mark.parametrize("ftype", ["IQ2_M", "IQ3_XXS", "IQ3_M"])
def test_iq3_s_embedding_is_the_jax_engines_bit_for_bit(engines, ftype):
    """The presets whose token_embd is IQ3_S: the port's table (f32-scale
    planes, scale·value rounded once to bf16) is the JAX Engine's (its f32
    codec dequant rounded once to bf16)."""
    je, te = engines("tiny", ftype)
    assert preset_type(ftype, "token_embd", 0, 2) == GGMLType.IQ3_S
    ref = np.asarray(je.params["tok_embd"].astype(jnp.float32))
    got = te.params["tok_embd"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("ftype", ["IQ3_XXS", "IQ1_M", "TQ2_0"])
def test_params_from_jax_carries_iq_planes(engines, ftype):
    """The JAX Engine's tree, carried across: bit-equal codebook planes (a
    half-split IQ3_XXS and its IQ2_S attn_q/attn_k, the 3-bit IQ1_M, the
    2-bit TQ2_0) and the logits of the port's own load."""
    je, te = engines("tiny", ftype)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    carried_planes_equal(te.params, tree, ("wqkv", "wq", "wk", "wv", "wo", "wgu", "w_gate",
                                           "w_up", "w_down"))
    carried = Engine(engines.path("tiny", ftype), device="cpu", max_seq=64)
    carried.params = tree
    own = Engine(engines.path("tiny", ftype), device="cpu", max_seq=64)
    ids = own.tokenizer.tokenize(PROMPT, add_special=True)
    assert nmse(carried.prefill(ids), own.prefill(ids)) <= 1e-3
    assert nmse(carried.decode_step(300), own.decode_step(300)) <= 1e-3


def test_moe_iq2_xxs_teacher_forced_logits_match_jax(engines):
    """tiny-moe at IQ2_XXS: the prefill in the all-experts regime, the
    teacher-forced decode steps in the gather regime."""
    ids = engines("tiny-moe", "IQ2_XXS")[1].tokenizer.tokenize(MOE_IQ_PROMPT, add_special=True)
    assert len(ids) > 16
    errs = teacher_forced_errors(*engines("tiny-moe", "IQ2_XXS"), MOE_IQ_PROMPT)
    assert max(errs) <= 1e-3, errs


def test_moe_iq2_xxs_free_running_greedy_ids_match_jax(engines):
    ref, got = greedy_ids(*engines("tiny-moe", "IQ2_XXS"), MOE_IQ_PROMPT)
    assert len(got) == STEPS and got == ref


def test_moe_iq2_xxs_layers(engines):
    """The 8-expert branch: IQ2_XXS expert stacks and attn_q, Q4_K attn_k and
    attn_v, Q5_K attn_output and head."""
    _, te = engines("tiny-moe", "IQ2_XXS")
    for layer in te.params["layers"]:
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert isinstance(layer[key], QuantExpertStack) and layer[key].n_expert == 8
            assert layer[key].gtype == GGMLType.IQ2_XXS
            assert sorted(layer[key].planes) == ["qh", "qs", "scale"]
        assert layer["wq"].gtype == GGMLType.IQ2_XXS
        assert layer["wk"].gtype == layer["wv"].gtype == GGMLType.Q4_K
        assert layer["wo"].gtype == GGMLType.Q5_K
    assert te.params["output"].gtype == GGMLType.Q5_K
