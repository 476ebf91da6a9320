"""Port parity: the v2 plane repack and the qmm kernel's plain version
(tpullm_torch) against the JAX package's repack_np/upload_planes and its
Pallas qmm kernel (interpret mode on the CPU)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf import constants as jconstants
from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.models.weights import QuantLinear as JQuantLinear
from tpullm.ops import device_repack as jdevice_repack
from tpullm.ops import qmatmul as jqm
from tpullm.ops.pallas import qmm as jqmm
from tpullm.quant import codecs as jcodecs

from tpullm_torch.gguf import constants
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import random_packed
from tpullm_torch.models.weights import QuantLinear
from tpullm_torch.ops import qmatmul
from tpullm_torch.ops.kernels import qmm

# the 13 formats the JAX package repacks on its device
TYPES = ("Q4_K", "Q6_K", "Q5_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4", "IQ4_NL",
         "Q2_K", "Q3_K", "IQ4_XS")


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
    (512, 4096, 28672, qmm.TC_TILE), (512, 4096, 128256, qmm.TC_TILE)])
def test_qmm_plan_covers_k_exactly(M, K, N, expect_tm):
    plan = qmm.plan if M >= qmm.TC_MIN_M else qmm.gemv_plan  # as qmm.qmm picks
    tm, split, per = plan(M, K, N, 132)
    assert tm == expect_tm
    n_chunks = K // 256
    assert 1 <= split <= n_chunks
    assert split * per >= n_chunks > (split - 1) * per  # every chunk, none twice


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 15])
@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                                 (4096, 128256), (256, 4), (1024, 1028), (32768, 512)])
def test_qmm_plan_below_16_rows_fits_one_launch(M, K, N):
    """Below TC_MIN_M rows (the gemv body): every chunk in exactly one split,
    the block's x within GEMV_X_BYTES, and a split output's tiles within the
    counter buffer by which each tile's last block finds itself; with at
    most half a wave of tiles, a split K keeps every block in one wave of
    GEMV_WAVE_BLOCKS blocks an SM unless x's limit asks for more splits, and
    K is split whenever the tiles leave half that wave empty; from a wave of
    tiles on, no split but x's."""
    n_sm = 132
    tm, split, per = qmm.gemv_plan(M, K, N, n_sm)
    assert tm in qmm.GEMV_TMS and tm >= min(M, qmm.GEMV_TMS[-1])
    n_chunks = K // 256
    assert 1 <= split <= n_chunks
    assert split * per >= n_chunks > (split - 1) * per  # every chunk, none twice
    assert tm * per * 256 * 2 <= qmm.GEMV_X_BYTES
    tiles = -(-N // qmm.GEMV_BLOCK_N) * -(-M // tm)
    assert split == 1 or tiles <= qmm._build.COUNTERS
    wave = qmm.GEMV_WAVE_BLOCKS * n_sm
    x_limited = per == qmm.GEMV_X_BYTES // (tm * 512)
    if 2 * tiles <= wave:
        assert split == 1 or tiles * split <= wave or x_limited
        assert split > 1 or n_chunks == 1
    if tiles >= wave:
        assert split == 1 or x_limited


def test_gemv_source_constants_match_the_wrapper():
    csrc = Path(qmm.__file__).resolve().parents[2] / "csrc"
    src = (csrc / "qmm_gemv.cuh").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kGemvBN"]) == qmm.GEMV_BLOCK_N
    assert int(const["kGemvXBytes"]) == qmm.GEMV_X_BYTES
    cases = re.findall(r"TPULLM_GEMV_CASE\((\d+)\)", (csrc / "qmm.cu").read_text())
    assert tuple(int(c) for c in cases) == qmm.GEMV_TMS


def test_gather_source_constants_match_the_wrapper():
    """csrc/qmm_moe.cu's gather: its expert limit is the wrapper's, the row
    tiles (TMX) its launch takes are GEMV_TMS, a tile holds at most TMX
    slots and runs at TM = 1 or TMX."""
    src = (Path(qmm.__file__).resolve().parents[2] / "csrc" / "qmm_moe.cu").read_text()
    assert int(re.search(r"constexpr int kGatherMaxExperts = (\d+);", src).group(1)) == \
        qmm.GATHER_MAX_EXPERTS
    cases = re.findall(r"TPULLM_GATHER_CASE\((\d+)\)", src)
    assert tuple(int(c) for c in cases) == qmm.GEMV_TMS
    assert "min(TMX, count - r0)" in src and "r0 += TMX" in src
    assert sorted(set(re.findall(r"qmm_gemv_body<(\w+), F, false, false, TMX>", src))) == \
        ["1", "TMX"]


def test_counter_buffer_refuses_a_launch_it_cannot_hold():
    """One check of the counter limit, in `_build.counters`: a launch whose
    split groups exceed the buffer is refused before any buffer is made."""
    with pytest.raises(ValueError):
        qmm._build.counters(torch.device("cpu"), 0, qmm._build.COUNTERS + 1)


def test_qmm_kernel_wrapper_refuses_cpu_tensors():
    planes = qmatmul.repack(_blocks("Q4_K", 128, 256), GGMLType.Q4_K, 128, 256, "cpu")
    with pytest.raises(ValueError):
        qmm.qmm(torch.zeros(1, 256, dtype=torch.bfloat16), planes, GGMLType.Q4_K, 128, 256)


def test_the_formats_are_those_the_jax_package_repacks_on_its_device():
    """TYPES are the formats the JAX package repacks on its device; with the
    nine codebook types (tests/test_torch_iq.py), which it repacks on the
    host, they are every row of its schema, and every one has a kernel id."""
    assert {int(t) for t in jdevice_repack.DEVICE_TYPES} == {int(GGMLType[n]) for n in TYPES}
    every = {GGMLType[n] for n in TYPES} | qmatmul.CODEBOOK_TYPES
    assert every == set(qmm._FMT) == set(qmatmul._SCHEMA)
    assert {t.name for t in every} == {t.name for t in jqm._SCHEMA}
    for t in every:
        assert qmatmul._SCHEMA[t] == jqm._SCHEMA[JGGMLType[t.name]], t.name


def test_code_tables_are_copies_of_the_jax_package_constants():
    assert constants.IQ4_NL_VALUES == jconstants.IQ4_NL_VALUES
    assert constants.MXFP4_VALUES == jconstants.MXFP4_VALUES


def test_q3_k_scales_match_the_codec():
    raw = np.random.default_rng(3).integers(0, 256, size=(64, 12), dtype=np.uint8)
    got = qmatmul._q3k_scales(torch.from_numpy(raw))
    np.testing.assert_array_equal(got.numpy(), jcodecs._q3_k_scales(raw).astype(np.int64))


def test_mxfp4_scale_is_exactly_two_to_the_e_minus_128():
    """Every exponent byte, e = 0 and e = 1 (the f32 subnormals 2^-128 and
    2^-127) and e = 255 (2^127) included."""
    e = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = qmatmul._e8m0_half(e).numpy()
    exact = np.array([2.0 ** (v - 128) for v in range(256)], dtype=np.float32)
    np.testing.assert_array_equal(got, exact)
    assert got[0] == np.float32(2.0 ** -128) != 0.0


def _mxfp4_edge_blocks() -> np.ndarray:
    """MXFP4 blocks of a [256, 32·256] weight: row r's blocks hold exponent
    bytes 0..255, every code 1 (value 1 of the table: weight = 2^(e-128))."""
    b = np.full((256, 256, 17), 0x11, dtype=np.uint8)
    b[:, :, 0] = np.arange(256, dtype=np.uint8)[None, :]
    return b.reshape(-1)


def test_mxfp4_edge_exponents_match_the_host_repack_in_bf16():
    """The JAX package's host repack (np.exp2 in f32) is one ulp low at
    e = 255, which its bf16 upload rounds away: the bf16 planes agree at
    every exponent."""
    data = _mxfp4_edge_blocks()
    ref = jqm.upload_planes(jqm.repack_np(data, JGGMLType.MXFP4, 256, 32 * 256))
    got = qmatmul.repack(data, GGMLType.MXFP4, 256, 32 * 256, "cpu")
    np.testing.assert_array_equal(_as_np(got["scale"]), np.asarray(ref["scale"], np.float32))


def test_jax_device_repack_flushes_the_mxfp4_exponent_1():
    """A fault of the JAX package's device repack (device_repack.py
    _decode_blocks_jnp, MXFP4): e = 1 builds the bits (e-1) << 23 = 0, so a
    block whose scale is 2^-127 (an f32 subnormal) decodes to zeros; its
    host repack and the port give 2^-127. Every other exponent agrees."""
    data = _mxfp4_edge_blocks()
    jdev = jdevice_repack.repack_device(data, JGGMLType.MXFP4, 256, 32 * 256)
    got = _as_np(qmatmul.repack(data, GGMLType.MXFP4, 256, 32 * 256, "cpu")["scale"])
    ref = np.asarray(jdev["scale"], np.float32)
    differ = sorted(set(np.nonzero(got != ref)[0] % 256))  # scale rows: block index e
    assert differ == [1]
    assert ref[1, 0] == 0.0 and got[1, 0] == np.float32(2.0 ** -127)


@pytest.mark.parametrize("name", TYPES)
def test_plane_rows_match_the_pallas_tiles(name):
    rows = qmm._plane_rows(GGMLType[name], 2048)
    planes = jqm.repack_np(_blocks(name, 128, 2048), JGGMLType[name], 128, 2048)
    assert sorted(rows) == sorted(planes)
    for k, r in rows.items():
        assert r == jqmm._plane_rows(JGGMLType[name], k, 2048) == planes[k].shape[0], k


def test_kernel_source_formats_and_families_match_the_wrappers():
    """csrc/qmm_body.cuh's QmmFmt ids and TPULLM_QMM_FORMATS families are the
    ones the wrappers pass and bind, and every format's layout traits agree
    with its schema row."""
    src = (Path(qmm.__file__).resolve().parents[2] / "csrc" / "qmm_body.cuh").read_text()
    enum = dict(re.findall(r"\bk(\w+) = (\d+)", src[src.index("enum QmmFmt"):]))
    names = {"Q4K": "Q4_K", "Q6K": "Q6_K", "Q5K": "Q5_K", "Q8_0": "Q8_0", "Q4_0": "Q4_0",
             "Q4_1": "Q4_1", "Q5_0": "Q5_0", "Q5_1": "Q5_1", "MXFP4": "MXFP4",
             "IQ4NL": "IQ4_NL", "Q2K": "Q2_K", "Q3K": "Q3_K", "IQ4XS": "IQ4_XS",
             "IQ2XXS": "IQ2_XXS", "IQ2XS": "IQ2_XS", "IQ2S": "IQ2_S", "IQ3XXS": "IQ3_XXS",
             "IQ3S": "IQ3_S", "IQ1S": "IQ1_S", "IQ1M": "IQ1_M", "TQ1_0": "TQ1_0",
             "TQ2_0": "TQ2_0"}
    assert {names[k]: int(v) for k, v in enum.items()} == {t.name: v for t, v in qmm._FMT.items()}
    families = re.findall(r"TPULLM_QMM_FAMILY == (\d+)\n#define TPULLM_QMM_FORMATS\(X\) (.*)", src)
    got = {names[f]: int(fam) for fam, xs in families for f in re.findall(r"X\(k(\w+)\)", xs)}
    assert got == {t.name: f for t, f in qmm._FAMILY.items()}
    assert sorted(set(got.values())) == list(range(qmm._build.QMM_FAMILIES))
    traits = dict(re.findall(r"QmmFormat<k(\w+)> : QmmTraits<(.*)> \{\}", src))
    assert sorted(traits) == sorted(names) and len(names) == len(qmatmul._SCHEMA) == 22
    tables = {constants.MXFP4_VALUES: "kTableMxfp4", constants.IQ4_NL_VALUES: "kTableIq4nl",
              qmatmul.IQ2_VALUES: "kTableIq2", qmatmul.IQ3XXS_VALUES: "kTableIq3xxs",
              qmatmul.IQ3S_VALUES: "kTableIq3s", qmatmul.IQ1_VALUES: "kTableIq1"}
    for k, args in traits.items():
        layout, U, G, mapping, bias, minus = (a.strip() for a in args.split(","))
        t = GGMLType[names[k]]
        meta = qmatmul._SCHEMA[t]
        assert int(U) == qmatmul.split_unit(t) and int(G) == meta["G"], k
        assert (minus == "true") == qmatmul.has_minus(t), k
        assert int(bias) == (meta.get("bias", 0) if t not in qmatmul.WIDE_TYPES else 0), k
        want = {2: "kCrumb", 3: "kCrumbQh", 4: "kHalf", 5: "kHalfQh", 6: "kWide", 8: "kWide"}
        assert layout == want[meta["bits"]], k
        assert mapping == {None: "kBias" if meta.get("bias") and t not in qmatmul.WIDE_TYPES
                           else "kIdentity", **tables}[meta.get("lut")], k
