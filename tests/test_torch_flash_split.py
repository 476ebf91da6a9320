"""Port parity: the plain versions of the flash kernels' own orders
(tpullm_torch.ops.kernels.flash) against the JAX package's Pallas flash
kernels (interpret mode on the CPU) and the port's dense flash_reference:
the decode regime's split-KV partials and their merge (flash_split_reference
on the kernel's split plan), the prefill regime's 64-key tiles with p
rounded for the PV product as that kernel rounds it
(flash_prefill_reference), and the split planner itself."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_flash import CASES, _inputs, _nmse, _t
from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.ops import attention as jattn
from tpullm.ops.pallas import flash as jflash
from tpullm.runtime.kvcache import QuantKVCache as JQuantKVCache

from tpullm_torch.ops.kernels import flash

# Both sides compute in f32 from the same bf16 (or int8 + f32 scale) inputs
# and round the output to bf16: NMSE ≤ 1e-5 covers the f32 sum orders and the
# bf16 output rounding (≈ 2^-9 relative), as test_torch_flash.py's bound.
NMSE_BOUND = 1e-5

# (T, offsets, softcap, window, sinks, alibi, S, H, Hkv, n_sm): cases whose
# key ranges span several 64-key splits (n_sm small enough to split them)
SPLIT_CASES = [
    (1, (63, 64), 0.0, 0, False, False, 256, 4, 2, 8),       # kv_len 64, 65: a split boundary
    (1, (62, 127), 0.0, 0, False, False, 256, 4, 2, 8),      # kv_len 63, 128
    (1, (128, 191), 30.0, 0, True, False, 256, 4, 2, 8),     # kv_len 129, 192
    (8, (60, 120), 0.0, 0, False, False, 256, 4, 2, 8),      # T·G = 16; rows 0..3 of batch 0
                                                               # see nothing in split [64, 68)
    (9, (60, 200), 0.0, 0, False, True, 256, 4, 2, 8),       # T·G = 18: the prefill regime
    (4, (300, 480), 0.0, 100, True, True, 512, 4, 2, 8),     # window over several splits
    (16, (70, 400), 20.0, 40, False, False, 512, 2, 2, 8),   # G = 1, T·G = 16, window
    (1, (9, 999), 0.0, 0, True, False, 1024, 4, 2, 132),     # kv_len 10 and 1000 (100×)
    (1, (9, 999), 0.0, 0, False, True, 1024, 8, 1, 4),       # G = 8, few SMs: long splits
]


def _case_inputs(T, offsets, S, H, Hkv, seed, D=64):
    rng = np.random.default_rng(seed)
    B = len(offsets)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    sinks = rng.standard_normal(H).astype(np.float32)
    slopes = np.asarray(jattn.alibi_slopes(H, 8.0))
    return q, k, v, np.asarray(offsets, np.int32), sinks, slopes


@functools.lru_cache(maxsize=None)
def _jax_case(case: tuple, q8: bool):
    """(torch inputs, the JAX Pallas output as f32 numpy) of a case."""
    T, offsets, softcap, window, use_sinks, use_alibi, S, H, Hkv = case
    q, k, v, off, sinks, slopes = _case_inputs(T, offsets, S, H, Hkv, seed=T + S + window)
    scale = q.shape[-1] ** -0.5
    jsinks = jnp.asarray(sinks) if use_sinks else None
    jslopes = jnp.asarray(slopes) if use_alibi else None
    jq = jnp.asarray(q, jnp.bfloat16)
    kw = dict(scale=scale, softcap=softcap, sliding_window=window,
              sinks=_t(sinks) if use_sinks else None,
              alibi_slopes=_t(slopes) if use_alibi else None)
    if q8:
        k_q, k_s = JQuantKVCache._quantize(jnp.asarray(k, jnp.bfloat16))
        v_q, v_s = JQuantKVCache._quantize(jnp.asarray(v, jnp.bfloat16))
        ref = jflash.flash_attention_q8(jq, k_q, k_s, v_q, v_s, jnp.asarray(off), scale,
                                        softcap, window, sinks=jsinks, alibi_slopes=jslopes)

        def tt(a):
            return torch.from_numpy(np.asarray(a).copy())

        args = (_t(q, torch.bfloat16), tt(k_q), tt(v_q), torch.from_numpy(off))
        kw.update(k_scale=tt(k_s), v_scale=tt(v_s))
    else:
        ref = jflash.flash_attention(jq, jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16), jnp.asarray(off), scale,
                                     softcap, window, sinks=jsinks, alibi_slopes=jslopes)
        args = (_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
                torch.from_numpy(off))
    return args, kw, np.asarray(ref, np.float32)


def _all_cases():
    """test_torch_flash.py's CASES (S = 64, H 4, Hkv 2: one split) and
    SPLIT_CASES, each with the n_sm its split plan uses."""
    out = [((*c, 64, 4, 2), 132) for c in CASES]
    out += [(c[:9], c[9]) for c in SPLIT_CASES]
    return out


def _id(c):
    (T, off, cap, win, sk, al, S, H, Hkv), n_sm = c
    return (f"T{T}-off{off[0]}_{off[1]}-S{S}-H{H}_{Hkv}-cap{cap}-win{win}-sink{sk}"
            f"-alibi{al}-sm{n_sm}")


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("case", _all_cases(), ids=_id)
def test_flash_split_reference_matches_pallas_and_dense(case, q8):
    spec, n_sm = case
    args, kw, ref = _jax_case(spec, q8)
    got = flash.flash_split_reference(*args, n_sm=n_sm, **kw)
    dense = flash.flash_reference(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == dense.shape
    assert _nmse(got.float().numpy(), ref) <= NMSE_BOUND
    assert _nmse(got.float().numpy(), dense.float().numpy()) <= NMSE_BOUND


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("case", _all_cases(), ids=_id)
def test_flash_prefill_reference_matches_pallas(case, q8):
    """p carried as hi + lo bf16 terms keeps the prefill regime within the
    f32 kernels' bound."""
    spec, _ = case
    args, kw, ref = _jax_case(spec, q8)
    got = flash.flash_prefill_reference(*args, **kw)
    assert got.dtype == torch.bfloat16
    assert _nmse(got.float().numpy(), ref) <= NMSE_BOUND


# head dims 80 (Phi-2) and 96 (Phi-3), as many KV heads as heads (their
# MHA), every cache format, under a window: (T, offsets, window) in the
# decode regime (T·G = 1, a split plan of two) and the prefill regime
NARROW_CASES = [(1, (63, 200), 100), (40, (0, 150), 48)]
NARROW_FORMATS = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32, "q8": None}
_TORCH_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@functools.lru_cache(maxsize=None)
def _narrow_case(d: int, fmt: str, T: int, offsets: tuple, window: int):
    """(torch args, kwargs, the JAX Pallas output as f32 numpy) at head dim
    d on a cache of `fmt`, S = 256, 4 heads on 4 KV heads."""
    q, k, v, off, _, _ = _case_inputs(T, offsets, 256, 4, 4, seed=d + T + window, D=d)
    scale = d ** -0.5
    jq = jnp.asarray(q, jnp.bfloat16)
    kw = dict(scale=scale, sliding_window=window)
    if fmt == "q8":
        k_q, k_s = JQuantKVCache._quantize(jnp.asarray(k, jnp.bfloat16))
        v_q, v_s = JQuantKVCache._quantize(jnp.asarray(v, jnp.bfloat16))
        ref = jflash.flash_attention_q8(jq, k_q, k_s, v_q, v_s, jnp.asarray(off), scale,
                                        sliding_window=window)

        def tt(a):
            return torch.from_numpy(np.asarray(a).copy())

        args = (_t(q, torch.bfloat16), tt(k_q), tt(v_q), torch.from_numpy(off))
        kw.update(k_scale=tt(k_s), v_scale=tt(v_s))
    else:
        jt = NARROW_FORMATS[fmt]
        ref = jflash.flash_attention(jq, jnp.asarray(k, jt), jnp.asarray(v, jt),
                                     jnp.asarray(off), scale, sliding_window=window)
        args = (_t(q, torch.bfloat16), _t(k, _TORCH_DTYPES[fmt]), _t(v, _TORCH_DTYPES[fmt]),
                torch.from_numpy(off))
    return args, kw, np.asarray(ref, np.float32)


@pytest.mark.parametrize("fmt", list(NARROW_FORMATS))
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("T,offsets,window", NARROW_CASES, ids=["decode", "prefill"])
def test_own_orders_at_head_dims_80_and_96_match_pallas(T, offsets, window, d, fmt):
    """The plain version of the order of the regime a call takes (the split
    plan at T = 1, the 64-key tiles at T = 40), at head dims 80 and 96 on
    each cache format under a window, against the JAX Pallas kernel and the
    port's dense flash_reference."""
    args, kw, ref = _narrow_case(d, fmt, T, offsets, window)
    H, Hkv = args[0].shape[2], args[1].shape[1]
    if flash.regime(T, H, Hkv) == "decode":
        got = flash.flash_split_reference(*args, n_sm=8, **kw)
        assert len(flash.kv_splits(offsets[1], T, 256, window,
                                   flash.max_splits(2, Hkv, 256, 8))) == 2
    else:
        got = flash.flash_prefill_reference(*args, **kw)
    dense = flash.flash_reference(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _nmse(got.float().numpy(), ref) <= NMSE_BOUND
    assert _nmse(got.float().numpy(), dense.float().numpy()) <= NMSE_BOUND


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
def test_prefill_p_rounding_is_the_kernels(q8):
    """In f32 output (no bf16 output rounding to hide it): two bf16 terms of
    p land within 1e-9 NMSE of the f32 dense result, one bf16 term within
    1e-4 and measurably further (bf16's 2^-9 relative step)."""
    args, kw, _ = _jax_case((40, (0, 180), 0.0, 0, True, True, 256, 4, 2), q8)
    q32 = args[0].float()
    dense = flash.flash_reference(q32, *args[1:], **kw).numpy()
    two = flash.flash_prefill_reference(q32, *args[1:], p_terms=2, **kw).numpy()
    one = flash.flash_prefill_reference(q32, *args[1:], p_terms=1, **kw).numpy()
    assert _nmse(two, dense) <= 1e-9
    assert 100 * _nmse(two, dense) < _nmse(one, dense) <= 1e-4


def test_round_p_two_terms_keep_sixteen_bits():
    p = torch.rand(10000, dtype=torch.float64).float() * torch.logspace(-6, 0, 10000)
    two = flash._round_p(p, 2)
    one = flash._round_p(p, 1)
    assert torch.all((two - p).abs() <= p * 2.0 ** -16)
    assert torch.all((one - p).abs() <= p * 2.0 ** -8)
    assert torch.equal(one, p.to(torch.bfloat16).float())


@pytest.mark.parametrize("window", [0, 1, 5, 64, 100, 1000])
@pytest.mark.parametrize("T", [1, 2, 4, 16])
def test_kv_splits_cover_the_key_range_once(T, window):
    """Every plan's splits tile [window start, kv_len) exactly once, in order,
    in whole 64-key tiles but the last, none empty, at most n_max of them."""
    for S in (1, 63, 64, 65, 300, 4096):
        for off in sorted({0, 1, 37, 63, 64, 127, S - T, S // 2}):
            if off < 0 or off + T > S:
                continue
            lo = max(0, off - window + 1) if window else 0
            hi = off + T
            for n_max in (1, 2, 3, 17, 64, 1000):
                sp = flash.kv_splits(off, T, S, window, n_max)
                assert 1 <= len(sp) <= n_max
                assert sp[0][0] == lo and sp[-1][1] == hi
                for (a0, a1), (b0, _) in zip(sp, sp[1:]):
                    assert a1 == b0 and (a1 - a0) % flash.DECODE_TILE == 0
                assert all(k0 < k1 for k0, k1 in sp)
                assert len({k1 - k0 for k0, k1 in sp[:-1]}) <= 1  # equal splits but the last


def test_max_splits_cover_the_card_about_twice():
    for n_sm in (8, 132):
        for B, Hkv in ((1, 8), (2, 8), (4, 2), (64, 8), (1, 1)):
            for S in (64, 300, 4096, 131072):
                n = flash.max_splits(B, Hkv, S, n_sm)
                tiles = -(-S // flash.DECODE_TILE)
                assert 1 <= n <= min(tiles, flash.MAX_SPLITS)
                assert n in (tiles, flash.MAX_SPLITS) or B * Hkv * n >= 2 * n_sm
                assert n == 1 or B * Hkv * (n - 1) < 2 * n_sm
    # chip_smoke.py's decode case: kv_len 38 and 3001 in one call, different counts
    n = flash.max_splits(2, 8, 4096, 132)
    assert len(flash.kv_splits(37, 1, 4096, 0, n)) == 1
    assert len(flash.kv_splits(3000, 1, 4096, 0, n)) == 16


def test_regime_threshold():
    assert flash.regime(1, 32, 8) == "decode"
    assert flash.regime(4, 32, 8) == "decode"  # T·G = 16
    assert flash.regime(5, 32, 8) == "prefill"
    assert flash.regime(8, 32, 8) == "prefill"  # the prefill bucket of 8
    # a decode token up to DECODE_MAX_ROWS in row groups (Falcon-7B: 71 on 1)
    assert flash.regime(1, 32, 1) == flash.regime(1, 71, 1) == flash.regime(1, 80, 1) == \
        "decode"
    assert flash.regime(1, 81, 1) == "prefill"
    assert flash.regime(2, 8, 1) == "decode"  # T·G = 16
    assert flash.regime(3, 8, 1) == flash.regime(2, 71, 1) == "prefill"  # T ≥ 2 above 16


@pytest.mark.parametrize("fmt", ["bf16", "q8"])
@pytest.mark.parametrize("H", [71, 80])
def test_row_groups_split_reference_is_the_unsplit_one(H, fmt):
    """The decode regime's plain version in row groups (each group of 16
    heads on the one KV head alone, as a block of the kernel takes it) is
    the dense flash_reference at R = 71 and 80: B = 2, kv 38 and 210 of S =
    256 on a split plan of up to four, D = 64, with sinks and ALiBi."""
    g = torch.Generator().manual_seed(H)
    B, S, D = 2, 256, 64
    q = torch.randn(B, 1, H, D, generator=g).to(torch.bfloat16)
    k = torch.randn(B, 1, S, D, generator=g).to(torch.bfloat16)
    v = torch.randn(B, 1, S, D, generator=g).to(torch.bfloat16)
    off = torch.tensor([37, 209], dtype=torch.int32)
    sinks = torch.randn(H, generator=g)
    slopes = torch.linspace(0.3, 0.01, H)
    kw = {}
    if fmt == "q8":
        from tpullm_torch.runtime.kvcache import QuantKVCache

        k, k_s = QuantKVCache._quantize(k)
        v, v_s = QuantKVCache._quantize(v)
        kw = dict(k_scale=k_s, v_scale=v_s)
    assert flash.regime(1, H, 1) == "decode"
    dense = flash.flash_reference(q, k, v, off, D ** -0.5, sinks=sinks, alibi_slopes=slopes,
                                  **kw)
    groups = [flash.flash_split_reference(q[:, :, h0:h0 + flash.DECODE_ROWS], k, v, off,
                                          D ** -0.5, sinks=sinks[h0:h0 + flash.DECODE_ROWS],
                                          alibi_slopes=slopes[h0:h0 + flash.DECODE_ROWS],
                                          n_sm=4, **kw)
              for h0 in range(0, H, flash.DECODE_ROWS)]
    assert len(groups) == -(-H // flash.DECODE_ROWS)
    assert len(flash.kv_splits(209, 1, S, 0, flash.max_splits(B, 1, S, 4))) == 4
    got = torch.cat(groups, dim=2)
    assert got.shape == dense.shape
    assert _nmse(got.float().numpy(), dense.float().numpy()) <= 1e-5


def test_kernel_source_constants_match_the_wrapper():
    src = (Path(flash.__file__).resolve().parents[2] / "csrc" / "flash.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kDecodeRows"]) == flash.DECODE_ROWS
    assert int(const["kDecodeMaxRows"]) == flash.DECODE_MAX_ROWS
    assert int(const["kDecTK"]) == flash.DECODE_TILE
    assert int(const["kPreTK"]) == flash.PREFILL_TILE
    assert int(const["kPreBM"]) == flash.PREFILL_ROWS
    assert int(const["kMaxSplits"]) == flash.MAX_SPLITS
    assert "constexpr float kNegInf = -1e30f;" in src and flash.NEG_INF == -1e30


def test_cpu_tensors_take_the_plain_version_in_both_regimes():
    for T in (1, 16):
        q, k, v, off, _, _ = _inputs(T, (0, 3), seed=2)
        before = dict(flash.LAUNCHES)
        got = flash.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                    _t(v, torch.bfloat16), torch.from_numpy(off), 0.125)
        ref = flash.flash_reference(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                    _t(v, torch.bfloat16), torch.from_numpy(off), 0.125)
        assert torch.equal(got, ref)
        assert flash.LAUNCHES == before


# a launch count as the wrapper keeps it: bf16 at D = 256 3 decode and 2
# prefill launches, q8 at D = 128 4 decode launches, f32 at D = 64 1 prefill
_COUNTS = {**dict.fromkeys(flash.LAUNCHES, 0), "bf16.d256.decode": 3, "bf16.d256.prefill": 2,
           "q8.d128.decode": 4, "f32.d64.prefill": 1}


@pytest.mark.parametrize("fmt,regime,want", [
    (None, None, 10), ("bf16", None, 5), (None, "decode", 7), ("q8", "prefill", 0),
    ("f32", "prefill", 1), ("f16", None, 0)])
def test_launch_total_sums_by_format_and_regime(fmt, regime, want):
    """flash.LAUNCHES is keyed by format, head dim and regime; launch_total
    sums the keys of one format and/or one regime (None takes all)."""
    assert set(flash.LAUNCHES) == set(_COUNTS)
    assert flash.launch_total(fmt, regime, counts=_COUNTS) == want


def test_count_summary_names_flash_decode():
    """runtime.graph.count_summary sums each launch_counts() dict by
    COUNT_NAMES and gives flash's decode regime as "flash_decode"; a runner
    never captured (no dicts) launched nothing."""
    from tpullm_torch.runtime.graph import COUNT_NAMES, count_summary

    counts = [{} for _ in COUNT_NAMES]
    counts[COUNT_NAMES.index("flash")] = _COUNTS
    counts[COUNT_NAMES.index("attn_ring_routes")] = {"bf16": 29}
    got = count_summary(counts)
    assert got == {**dict.fromkeys(COUNT_NAMES, 0), "flash": 10, "flash_decode": 7,
                   "attn_ring_routes": 29}
    assert count_summary([]) == {}
