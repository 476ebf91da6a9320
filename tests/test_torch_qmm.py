"""Port parity: the v2 plane repack and the qmm kernel's plain version
(tpullm_torch) against the JAX package's repack_np/upload_planes and its
Pallas qmm kernel (interpret mode on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.models.weights import QuantLinear as JQuantLinear
from tpullm.ops import qmatmul as jqm
from tpullm.ops.pallas import qmm as jqmm

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import random_packed
from tpullm_torch.models.weights import QuantLinear
from tpullm_torch.ops import qmatmul
from tpullm_torch.ops.kernels import qmm

TYPES = ("Q4_K", "Q6_K", "Q5_K", "Q8_0")


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _blocks(gtype_name, n_out, n_in, seed=0):
    rng = np.random.default_rng(seed)
    raw = random_packed(rng, GGMLType[gtype_name], n_out * n_in)
    return np.frombuffer(raw, dtype=np.uint8)


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("name", TYPES)
def test_repack_planes_bit_equal_to_repack_np(name):
    n_out, n_in = 256, 512
    data = _blocks(name, n_out, n_in)
    ref = jqm.repack_np(data, JGGMLType[name], n_out, n_in)
    got = qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType[name], n_out, n_in)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("name", TYPES)
def test_repack_bf16_planes_equal_upload_planes(name):
    n_out, n_in = 128, 256
    data = _blocks(name, n_out, n_in, seed=1)
    ref = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    got = qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu")
    for k in ("scale", "minus"):
        if k in ref:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_as_np(got[k]), np.asarray(ref[k], np.float32))


@pytest.mark.parametrize("name", TYPES)
def test_dequant_planes_matches_jax(name):
    n_out, n_in = 128, 512
    data = _blocks(name, n_out, n_in, seed=2)
    jplanes = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    ref = jqm.dequant_planes(jplanes, JGGMLType[name], n_out, n_in)
    got = qmatmul.dequant_planes(qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu"),
                                 GGMLType[name], n_out, n_in)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("M", [1, 8, 37])
def test_qmm_reference_matches_pallas_qmm(name, M):
    """Same rounding points as _acc_tile; NMSE ≤ 1e-5 covers the f32 sum
    order, which differs between the two."""
    n_out, n_in = 256, 512
    data = _blocks(name, n_out, n_in, seed=M)
    jplanes = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    rng = np.random.default_rng(100 + M)
    x = rng.standard_normal((M, n_in)).astype(np.float32)
    ref = jqmm.qmatmul(jnp.asarray(x, jnp.bfloat16),
                       JQuantLinear(JGGMLType[name], n_out, n_in, jplanes))
    planes = qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu")
    got = qmm.qmm_reference(torch.from_numpy(x).to(torch.bfloat16), planes,
                            GGMLType[name], n_out, n_in)
    assert got.dtype == torch.bfloat16 and got.shape == (M, n_out)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


def test_quant_linear_cpu_dispatch_is_the_plain_version():
    n_out, n_in = 128, 256
    data = _blocks("Q4_K", n_out, n_in, seed=5)
    planes = qmatmul.repack(data, GGMLType.Q4_K, n_out, n_in, "cpu")
    lin = QuantLinear(GGMLType.Q4_K, n_out, n_in, planes)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, n_in))
                         .astype(np.float32)).to(torch.bfloat16)
    before = dict(qmm.LAUNCHES)
    y = lin(x)
    assert y.shape == (2, 3, n_out)
    ref = qmm.qmm_reference(x.reshape(6, n_in), planes, GGMLType.Q4_K, n_out, n_in)
    assert torch.equal(y.reshape(6, n_out), ref)
    assert qmm.LAUNCHES == before  # the CPU path launches no kernel


@pytest.mark.parametrize("M,K,N,expect_tm", [
    (1, 4096, 6144, 1), (1, 14336, 4096, 1), (7, 4096, 4096, 8),
    (512, 4096, 28672, 16), (512, 4096, 128256, 16)])
def test_qmm_plan_covers_k_exactly(M, K, N, expect_tm):
    tm, split, per = qmm.plan(M, K, N, n_sm=132)
    assert tm == expect_tm
    n_chunks = K // 256
    assert 1 <= split <= n_chunks
    assert split * per >= n_chunks > (split - 1) * per  # every chunk, none twice


def test_qmm_kernel_wrapper_refuses_cpu_tensors():
    planes = qmatmul.repack(_blocks("Q4_K", 128, 256), GGMLType.Q4_K, 128, 256, "cpu")
    with pytest.raises(ValueError):
        qmm.qmm(torch.zeros(1, 256, dtype=torch.bfloat16), planes, GGMLType.Q4_K, 128, 256)
