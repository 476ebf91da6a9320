"""Port parity: the flash kernel's plain version (tpullm_torch) against the
JAX package's Pallas flash kernels (interpret mode on the CPU), plus the
elementwise ops around attention (RMSNorm, RoPE, the dense reference)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.hparams import RopeParams as JRopeParams
from tpullm.ops import attention as jattn
from tpullm.ops import norms as jnorms
from tpullm.ops import rope as jrope
from tpullm.ops.pallas import flash as jflash
from tpullm.runtime.kvcache import QuantKVCache as JQuantKVCache

from tpullm_torch.models.hparams import RopeParams
from tpullm_torch.ops import attention, norms, rope
from tpullm_torch.ops.kernels import flash


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


# (T, offsets, softcap, window, sinks, alibi)
CASES = [
    (1, (0, 37), 0.0, 0, False, False),
    (8, (5, 40), 0.0, 0, False, False),
    (16, (0, 48), 0.0, 0, False, False),
    (16, (3, 20), 30.0, 0, False, False),
    (8, (30, 50), 0.0, 16, False, False),
    (1, (10, 63), 0.0, 0, True, False),
    (16, (0, 33), 0.0, 0, False, True),
    (8, (12, 21), 20.0, 24, True, True),
]


def _inputs(T, offsets, seed, D=64):
    B, H, Hkv, S = 2, 4, 2, 64
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    sinks = rng.standard_normal(H).astype(np.float32)
    slopes = np.asarray(jattn.alibi_slopes(H, 8.0))
    return q, k, v, np.asarray(offsets, np.int32), sinks, slopes


@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{}-off{}-cap{}-win{}-sink{}-alibi{}".format(*c))
def test_flash_reference_matches_pallas_bf16(case):
    """Both compute in f32 from bf16 inputs and round the output to bf16;
    NMSE ≤ 1e-5 covers the f32 sum order and the bf16 output rounding."""
    T, offsets, softcap, window, use_sinks, use_alibi = case
    q, k, v, off, sinks, slopes = _inputs(T, offsets, seed=T + window)
    scale = 64 ** -0.5
    ref = jflash.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(off), scale, softcap, window,
        sinks=jnp.asarray(sinks) if use_sinks else None,
        alibi_slopes=jnp.asarray(slopes) if use_alibi else None)
    got = flash.flash_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        torch.from_numpy(off), scale, softcap, window,
        sinks=_t(sinks) if use_sinks else None,
        alibi_slopes=_t(slopes) if use_alibi else None)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{}-off{}-cap{}-win{}-sink{}-alibi{}".format(*c))
def test_flash_reference_matches_pallas_q8(case):
    T, offsets, softcap, window, use_sinks, use_alibi = case
    q, k, v, off, sinks, slopes = _inputs(T, offsets, seed=50 + T + window)
    k_q, k_s = JQuantKVCache._quantize(jnp.asarray(k, jnp.bfloat16))
    v_q, v_s = JQuantKVCache._quantize(jnp.asarray(v, jnp.bfloat16))
    scale = 64 ** -0.5
    ref = jflash.flash_attention_q8(
        jnp.asarray(q, jnp.bfloat16), k_q, k_s, v_q, v_s, jnp.asarray(off), scale,
        softcap, window, sinks=jnp.asarray(sinks) if use_sinks else None,
        alibi_slopes=jnp.asarray(slopes) if use_alibi else None)

    def tt(a):
        return torch.from_numpy(np.asarray(a).copy())

    got = flash.flash_attention_q8(
        _t(q, torch.bfloat16), tt(k_q), tt(k_s), tt(v_q), tt(v_s), torch.from_numpy(off),
        scale, softcap, window, sinks=_t(sinks) if use_sinks else None,
        alibi_slopes=_t(slopes) if use_alibi else None)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("fmt", ["bf16", "f16", "f32", "q8"])
@pytest.mark.parametrize("d", [80, 96])
def test_flash_reference_matches_pallas_at_head_dims_80_and_96(d, fmt):
    """The wrapper on CPU tensors (the kernels' plain version) at Phi-2's
    and Phi-3's head dims, on each cache format, GQA 4 / 2, under a window
    of 16, against the JAX Pallas kernel."""
    q, k, v, off, _, _ = _inputs(8, (30, 50), seed=d, D=d)
    scale = d ** -0.5
    jq = jnp.asarray(q, jnp.bfloat16)
    if fmt == "q8":
        k_q, k_s = JQuantKVCache._quantize(jnp.asarray(k, jnp.bfloat16))
        v_q, v_s = JQuantKVCache._quantize(jnp.asarray(v, jnp.bfloat16))
        ref = jflash.flash_attention_q8(jq, k_q, k_s, v_q, v_s, jnp.asarray(off), scale,
                                        sliding_window=16)

        def tt(a):
            return torch.from_numpy(np.asarray(a).copy())

        got = flash.flash_attention_q8(_t(q, torch.bfloat16), tt(k_q), tt(k_s), tt(v_q),
                                       tt(v_s), torch.from_numpy(off), scale, sliding_window=16)
    else:
        jt, tt_ = {"bf16": (jnp.bfloat16, torch.bfloat16), "f16": (jnp.float16, torch.float16),
                   "f32": (jnp.float32, torch.float32)}[fmt]
        ref = jflash.flash_attention(jq, jnp.asarray(k, jt), jnp.asarray(v, jt),
                                     jnp.asarray(off), scale, sliding_window=16)
        got = flash.flash_attention(_t(q, torch.bfloat16), _t(k, tt_), _t(v, tt_),
                                    torch.from_numpy(off), scale, sliding_window=16)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


def test_flash_reference_matches_dense_reference_with_mask():
    q, k, v, off, _, _ = _inputs(16, (0, 20), seed=9)
    T = q.shape[1]
    positions = off[:, None] + np.arange(T)[None]
    mask = attention.causal_mask(torch.from_numpy(positions), k.shape[2],
                                 torch.from_numpy(off + T), 0)
    jmask = jattn.causal_mask(jnp.asarray(positions), k.shape[2], jnp.asarray(off + T))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    dense = attention.attention_reference(_t(q), _t(k), _t(v), mask, 0.125)
    jdense = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jmask, 0.125)
    assert _nmse(dense.numpy(), np.asarray(jdense)) <= 1e-10
    fl = flash.flash_reference(_t(q), _t(k), _t(v), torch.from_numpy(off), 0.125)
    assert _nmse(fl.numpy(), dense.numpy()) <= 1e-10


def test_flash_cpu_tensors_take_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    q, k, v, off, _, _ = _inputs(1, (0, 3), seed=1)
    before = dict(flash.LAUNCHES)
    flash.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                          _t(v, torch.bfloat16), torch.from_numpy(off), 0.125)
    assert flash.LAUNCHES == before


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    w = rng.standard_normal(256).astype(np.float32)
    got = norms.rms_norm(_t(x, torch.bfloat16), _t(w), 1e-5)
    ref = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-5)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("style,scaling", [("norm", "none"), ("neox", "none"),
                                           ("norm", "linear"), ("neox", "yarn")])
def test_rope_matches_jax(style, scaling):
    kw = dict(dims=64, freq_base=500000.0, scaling_type=scaling, scale_factor=4.0,
              orig_ctx=2048, ext_factor=1.0 if scaling == "yarn" else 0.0, style=style)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 4, 64)).astype(np.float32)
    pos = np.arange(100, 106, dtype=np.int32)[None]
    cos, sin = rope.rope_angles(RopeParams(**kw), torch.from_numpy(pos))
    jcos, jsin = jrope.rope_angles(JRopeParams(**kw), jnp.asarray(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)
    got = rope.apply_rope(_t(x, torch.bfloat16), torch.from_numpy(pos), RopeParams(**kw))
    ref = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), JRopeParams(**kw))
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5
