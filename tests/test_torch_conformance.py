"""The port's kernel conformance sweep (tpullm_torch/tools/conformance.py)
against the JAX tool's contract (tpullm/tools/conformance.py): the same
bounds, the same `_nmse`, `_ref_attention` and `summarize` on the same
numpy inputs, and on the CPU (the kernels' plain versions, the sizes the
card runs: ≈ 10 s) a sweep with no failure over every plane format, the
expert kernels and every flash form. A case that raises is recorded and
fails the sweep (exit code 1); on a CUDA tensor a case that launches no
kernel fails."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.ops.attention import _attention_with_sinks_dense
from tpullm.tools import conformance as jconf

from tpullm_torch.ops.kernels import flash
from tpullm_torch.ops.qmatmul import _SCHEMA
from tpullm_torch.tools import conformance as conf


@pytest.fixture(scope="module")
def sweep():
    """The whole sweep on the CPU, its cases kept."""
    cases = []
    log = []
    for fn in (conf.sweep_qmm, conf.sweep_qmoe, conf.sweep_flash):
        cases += fn(torch.device("cpu"), log=log.append)
    return cases, log


def test_bounds_are_the_jax_tools():
    assert (conf.QMM_NMSE_BOUND, conf.FLASH_NMSE_BOUND, conf.FLASH_Q8_NMSE_BOUND) == \
        (jconf.QMM_NMSE_BOUND, jconf.FLASH_NMSE_BOUND, jconf.FLASH_Q8_NMSE_BOUND)


@pytest.mark.parametrize("seed", range(3))
def test_nmse_is_the_jax_tools(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((2, 7, 33)).astype(np.float32)
    assert conf._nmse(a, b) == jconf._nmse(a, b)
    assert conf._nmse(a, np.zeros_like(a)) == jconf._nmse(a, np.zeros_like(a))


@pytest.mark.parametrize("T,H,Hkv,D,Dv", [(1, 8, 2, 128, 128), (5, 4, 4, 64, 64),
                                          (3, 6, 1, 192, 128)])
def test_ref_attention_is_the_jax_tools(T, H, Hkv, D, Dv):
    rng = np.random.default_rng(T)
    q = rng.standard_normal((2, T, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Hkv, 40, D)).astype(np.float32)
    v = rng.standard_normal((2, Hkv, 40, Dv)).astype(np.float32)
    off = np.array([3, 30], np.int32)
    np.testing.assert_array_equal(conf._ref_attention(q, k, v, off, D ** -0.5),
                                  jconf._ref_attention(q, k, v, off, D ** -0.5))


def test_biased_oracle_matches_the_jax_sinks_path_and_flash_reference():
    """_ref_biased with sinks against the JAX package's dense sinks
    attention; with ALiBi slopes against the port's flash_reference."""
    rng = np.random.default_rng(4)
    B, T, H, Hkv, D, S = 1, 8, 8, 2, 64, 48
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    off = np.array([S - T], np.int32)
    sinks = rng.standard_normal(H).astype(np.float32)
    mask = np.arange(S)[None, :] <= (off[0] + np.arange(T))[:, None]
    want = np.asarray(_attention_with_sinks_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask[None]), D ** -0.5,
        jnp.asarray(sinks)), np.float32)
    got = conf._ref_biased(q, k, v, off, D ** -0.5, sinks=sinks)
    assert conf._nmse(got, want) < 1e-10
    slopes = (0.5 ** np.arange(1, H + 1)).astype(np.float32)
    ref = flash.flash_reference(*(torch.from_numpy(a) for a in (q, k, v, off)), D ** -0.5,
                                alibi_slopes=torch.from_numpy(slopes))
    got = conf._ref_biased(q, k, v, off, D ** -0.5, slopes=slopes)
    assert conf._nmse(got, ref.numpy()) < 1e-10


def _cases_for_summaries():
    return [
        {"kernel": "qmm", "type": "Q4_K", "m": 1, "nmse": 1e-6, "ok": True, "t_s": 0.1},
        {"kernel": "qmm", "type": "Q6_K", "m": 16, "nmse": 9e-4, "ok": False, "t_s": 0.1},
        {"kernel": "qmm", "type": "TQ1_0", "status": "unsupported_shape"},
        {"kernel": "flash", "case": "decode", "nmse": 3e-5, "ok": True, "t_s": 0.0},
        {"kernel": "flash_q8", "case": "prefill", "nmse": 4e-3, "ok": True, "t_s": 0.0},
        {"kernel": "flash", "case": "sinks", "ok": False, "error": "boom"},
        {"kernel": "sweep_qmoe", "ok": False, "error": "lost"},
    ]


@pytest.mark.parametrize("n", [0, 1, 4, 7])
def test_summarize_is_the_jax_tools(n):
    cases = _cases_for_summaries()[:n]
    assert conf.summarize(cases) == jconf.summarize(cases)


def test_cpu_sweep_has_no_failure(sweep):
    """Every case ran and passed: 22 formats × 4 row counts, 6 expert
    formats × (gather, stack), flash on 4 formats × 7 head-dim forms × 2
    regimes, the row groups, the latent forms, sinks and ALiBi."""
    cases, log = sweep
    summary = conf.summarize(cases)
    assert not summary["failed"] and not summary["skipped"], summary["failed"][:3]
    assert summary["cases"] == len(cases) == len(log)
    qmm = {(c["type"], c["m"]) for c in cases if c["kernel"] == "qmm"}
    assert qmm == {(t.name, m) for t in _SCHEMA for m in (1, 9, 16, 128)}
    assert sum(c["kernel"].startswith("qmoe") for c in cases) == 12
    dims = {(c["d"], c["dv"]) for c in cases if c.get("case") in ("decode", "prefill")}
    assert dims == {(d, d) for d in flash._HEAD_DIMS} | set(flash.DKDV_DIMS)
    assert {c["rows"] for c in cases if c.get("case") == "row_groups"} == {48, 71, 80}
    assert {(c["d"], c["dv"]) for c in cases if c.get("case", "").startswith("latent")} == \
        set(flash.LATENT_DIMS)
    alibi = [c for c in cases if c.get("case") == "alibi_decode"]
    assert {c["format"] for c in alibi} == set(conf.FLASH_FORMATS)
    assert summary["max_nmse_qmm"] <= conf.QMM_NMSE_BOUND
    assert summary["max_nmse_flash"] <= conf.FLASH_Q8_NMSE_BOUND


def test_alibi_decode_cases_take_the_split_decode_regime():
    """The ALiBi decode case (R = 1, kv 3001) is the decode regime, split
    over many KV splits on the card's 132 SMs."""
    assert flash.regime(1, 8, 8) == "decode"
    assert flash.max_splits(1, 8, 4096, 132) > 8


def test_a_raising_case_fails_the_sweep(monkeypatch):
    """A kernel call that raises is recorded with its error, lands in the
    summary's `failed`, and main's exit code is 1."""
    def boom(*a, **k):
        raise RuntimeError("kernel refused")
    monkeypatch.setattr(conf, "sweep_qmm", lambda dev, log=None: [])
    monkeypatch.setattr(conf, "sweep_qmoe", lambda dev, log=None: [])
    monkeypatch.setattr(flash, "flash_attention", boom)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = conf.main(["--json", "--device", "cpu"])
    summary = json.loads(out.getvalue())
    assert rc == 1 and summary["failed"]
    assert all(c["error"] == "kernel refused" for c in summary["failed"])
    assert set(summary) == set(jconf.summarize([]))


def test_a_case_without_a_launch_fails_on_the_card(monkeypatch):
    """_case on a result that claims the card but moved no launch count."""
    class FakeCuda:
        is_cuda = True
        device = "cuda"

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cases = []
    conf._case(cases, {"kernel": "qmm", "type": "Q4_K"}, 1.0, lambda: FakeCuda(),
               lambda: np.zeros(1), None)
    assert cases == [{"kernel": "qmm", "type": "Q4_K", "ok": False,
                      "error": "no kernel launched on the card"}]
