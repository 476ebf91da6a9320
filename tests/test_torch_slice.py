"""Port parity for the slice as a whole: the tiny synthetic Q4_K_M llama
served by the JAX package's Engine and by tpullm_torch's Engine (on the
CPU), with a bf16 and a q8 KV cache, plus the weights carried across from
the JAX parameter tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.convert import params_from_jax
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.models.weights import FusedLinear, QuantLinear
from tpullm_torch.runtime.engine import Engine

PROMPT = "the quick brown fox jumps over the lazy dog"
# teacher-forced decode inputs: a varied token stream, not the model's own
CONTINUATION = "hello world, a lazy brown dog jumped"
STEPS = 16


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("tiny") / "tiny.gguf",
                                     shape="tiny", seed=0)


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
