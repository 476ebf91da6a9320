"""Port parity for the nine codebook formats (IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S, IQ1_S, IQ1_M, TQ1_0, TQ2_0) and for the group-factored qmm:
the port's repack, plane values and plain versions against the JAX
package's repack_np, codecs and Pallas kernels (interpret mode on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.models.weights import QuantLinear as JQuantLinear
from tpullm.ops import qmatmul as jqm
from tpullm.ops.pallas import qmm as jqmm
from tpullm.quant import iq_codecs as jiq

from tpullm_torch.gguf.constants import TYPE_TRAITS, GGMLType
from tpullm_torch.ops import qmatmul
from tpullm_torch.ops.kernels import qmm
from tpullm_torch.quant import iq_codecs

IQ_TYPES = ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M", "TQ1_0",
            "TQ2_0")
# one format per code layout and map, for the group-factored kernel
GROUPED = ("Q4_K", "Q4_0", "Q6_K", "Q8_0", "IQ4_NL", "Q3_K", "IQ2_XXS", "IQ1_M", "IQ3_S",
           "TQ1_0")


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _assert_bits_equal(got: np.ndarray, ref: np.ndarray) -> None:
    """f32 arrays equal bit for bit, a NaN matching any NaN: the f16 → f32
    conversion of a signalling NaN sets its quiet bit in torch, not in
    numpy."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok].view(np.uint32), ref[ok].view(np.uint32))


def _blocks(name: str, n_out: int, n_in: int, seed: int = 0) -> np.ndarray:
    """Random blocks as the JAX package's codec tests build them (random
    bytes, an f16 d of U(0.001, 2.0); IQ1_M's d nibble by nibble in the top
    nibbles of its scale words), TQ2_0's 2-bit fields in 0..2, and block 3
    with d = 0."""
    tt = TYPE_TRAITS[GGMLType[name]]
    rng = np.random.default_rng(seed)
    nb = n_out * n_in // tt.block_size
    raw = rng.integers(0, 256, size=(nb, tt.type_size), dtype=np.uint8)
    d = rng.uniform(0.001, 2.0, size=nb).astype(np.float16)
    d[3] = 0
    if name == "IQ1_M":
        bits = d.view(np.uint16)
        words = raw[:, 48:56].copy().view("<u2").reshape(nb, 4)
        for k in range(4):
            words[:, k] = (words[:, k] & 0x0FFF) | (((bits >> (4 * k)) & 0xF) << 12)
        raw[:, 48:56] = words.view(np.uint8).reshape(nb, 8)
    else:
        off = {"TQ1_0": 52, "TQ2_0": 64}.get(name, 0)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(nb, 2)
    if name == "TQ2_0":
        q = raw[:, :64]
        raw[:, :64] = q & ~((q & (q >> 1) & 0x55) << 1)  # a field of 3 becomes 1
    return raw.reshape(-1)


@pytest.mark.parametrize("name", IQ_TYPES)
def test_codecs_bit_equal_to_the_jax_package(name):
    """Values and group scales of the port's torch codecs, bit for bit,
    NaN and Inf scales of random bytes included."""
    tt = TYPE_TRAITS[GGMLType[name]]
    raw = np.random.default_rng(11).integers(0, 256, size=(48, tt.type_size), dtype=np.uint8)
    with np.errstate(invalid="ignore"):
        ref = jiq.IQ_DEQUANT[JGGMLType[name]](raw.copy())
        ref_s = jiq.iq_group_scales(raw.copy(), JGGMLType[name])
    got = iq_codecs.IQ_DEQUANT[GGMLType[name]](torch.from_numpy(raw.copy())).numpy()
    got_s = iq_codecs.iq_group_scales(torch.from_numpy(raw.copy()), GGMLType[name]).numpy()
    _assert_bits_equal(got, ref)
    _assert_bits_equal(got_s, ref_s)


@pytest.mark.parametrize("name", IQ_TYPES)
def test_repack_planes_bit_equal_to_repack_np(name):
    n_out, n_in = 64, 512
    data = _blocks(name, n_out, n_in)
    ref = jqm.repack_np(data, JGGMLType[name], n_out, n_in)
    got = qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType[name], n_out, n_in)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].numpy().dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("name", IQ_TYPES)
def test_planes_decode_to_the_jax_codecs(name):
    """scale (f32) · plane_values equals the JAX package's codec dequant,
    the block with d = 0 included."""
    n_out, n_in = 64, 512
    data = _blocks(name, n_out, n_in, seed=1)
    planes = qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType[name], n_out, n_in)
    got = qmatmul.dequant_planes(planes, GGMLType[name], n_out, n_in).numpy()
    tt = TYPE_TRAITS[GGMLType[name]]
    ref = jiq.IQ_DEQUANT[JGGMLType[name]](data.reshape(-1, tt.type_size))
    np.testing.assert_array_equal(got, ref.reshape(n_out, n_in).T)


def test_zero_scale_block_takes_the_code_nearest_zero():
    """0/0 is taken as 0: each code of a block whose d is 0 is the table
    index nearest 0, ties to the lower index (IQ2: 8 before -8)."""
    data = _blocks("IQ2_XXS", 1, 1024)
    codes = qmatmul._expand_codes(
        qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType.IQ2_XXS, 1, 1024),
        GGMLType.IQ2_XXS)
    assert (codes[3 * 256:4 * 256] == 0).all() and (codes[:256] != 0).any()


@pytest.mark.parametrize("name", IQ_TYPES)
def test_value_tables_are_copies_of_the_jax_package(name):
    assert qmatmul._SCHEMA[GGMLType[name]] == jqm._SCHEMA[JGGMLType[name]]
    np.testing.assert_array_equal(iq_codecs.KSIGNS, jiq.KSIGNS)


def test_codes_past_a_six_entry_table_map_to_entry_0():
    """As the JAX package's where-chain: 3-bit codes 6 and 7 of the IQ2 and
    IQ1 tables give the table's first value."""
    for name in ("IQ2_XXS", "IQ1_S"):
        codes = torch.arange(8, dtype=torch.uint8).repeat(32)[:, None].expand(256, 4)
        planes = {"qs": qmatmul._bitplane_pack(codes & 3, 2, 256),
                  "qh": qmatmul._bitplane_pack(codes >> 2, 1, 256)}
        got = qmatmul.plane_values(planes, GGMLType[name])[:8, 0]
        ref = jqm._plane_values({k: jnp.asarray(v.numpy()) for k, v in planes.items()},
                                JGGMLType[name])[:8, 0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got[6] == got[7] == got[0]


@pytest.mark.parametrize("name", IQ_TYPES)
@pytest.mark.parametrize("M", [1, 16])
def test_qmm_reference_matches_pallas_qmm(name, M):
    """NMSE ≤ 1e-5 (the f32 sums run in another order). The TQ types at
    K = 2048, the smallest K whose scale tile the Pallas kernel takes."""
    n_out, n_in = 256, 2048 if name.startswith("TQ") else 512
    data = _blocks(name, n_out, n_in, seed=M)
    jplanes = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    assert jqmm.supports(JGGMLType[name], n_in, n_out)
    x = np.random.default_rng(100 + M).standard_normal((M, n_in)).astype(np.float32)
    ref = jqmm.qmatmul(jnp.asarray(x, jnp.bfloat16),
                       JQuantLinear(JGGMLType[name], n_out, n_in, jplanes))
    planes = qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu")
    got = qmm.qmm_reference(torch.from_numpy(x).to(torch.bfloat16), planes,
                            GGMLType[name], n_out, n_in)
    assert got.dtype == torch.bfloat16 and got.shape == (M, n_out)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


def _plain_blocks(name: str, n_out: int, n_in: int, seed: int) -> np.ndarray:
    if name in IQ_TYPES:
        return _blocks(name, n_out, n_in, seed)
    from tpullm_torch.models.synth import random_packed

    return random_packed(np.random.default_rng(seed), GGMLType[name], n_out * n_in)


@pytest.mark.parametrize("name", GROUPED)
def test_qmm_grouped_reference_matches_pallas_grouped_kernel(name, monkeypatch):
    """The JAX package's group-factored body (_kernel, taken by _qmm_2d for
    the types of GROUPED_TYPES) against the port's plain version, M = 16:
    NMSE ≤ 1e-5. The jit caches are cleared around the change of the set
    _qmm_2d reads when it traces."""
    M, n_out = 16, 256
    n_in = 2048 if name.startswith("TQ") else 512
    data = _plain_blocks(name, n_out, n_in, seed=3)
    jplanes = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    x = np.random.default_rng(7).standard_normal((M, n_in)).astype(np.float32)
    jax.clear_caches()
    monkeypatch.setattr(jqmm, "GROUPED_TYPES", {JGGMLType[name]})
    try:
        ref = np.asarray(jqmm.qmatmul(jnp.asarray(x, jnp.bfloat16),
                                      JQuantLinear(JGGMLType[name], n_out, n_in, jplanes)),
                         np.float32)
    finally:
        jax.clear_caches()
    planes = qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = qmm.qmm_grouped_reference(xt, planes, GGMLType[name], n_out, n_in)
    assert got.dtype == torch.bfloat16 and got.shape == (M, n_out)
    assert _nmse(got.float().numpy(), ref) <= 1e-5
    if not name.startswith("TQ"):
        # the materializing plain version is another function: it rounds
        # each scaled weight to bf16 (a ternary weight, ±scale, is exact)
        assert not torch.equal(got, qmm.qmm_reference(xt, planes, GGMLType[name], n_out, n_in))


ALL_TYPES = tuple(t.name for t in qmatmul._SCHEMA)


def _grouped_segments(gtype: GGMLType, j: int) -> list[tuple[list[int], int]]:
    """The segments of step j of a 256-row chunk in csrc/qmm_gemv.cuh's
    gemv_grouped_step, in the order it adds them: (chunk rows, chunk scale
    row) of each run of the step's 64 slots that shares one scale row."""
    meta = qmatmul._SCHEMA[gtype]
    G, bits = meta["G"], meta["bits"]
    if bits in (6, 8):  # wide: rows 64j.., groups of min(G, 64)
        gw = min(G, 64)
        return [(list(range(64 * j + g0, 64 * j + g0 + gw)), (64 * j + g0) // G)
                for g0 in range(0, 64, gw)]
    if bits in (2, 3):  # 2-bit: field f of packed rows 16j.. is rows 64f + 16j..
        fields = [list(range(64 * f + 16 * j, 64 * f + 16 * j + 16)) for f in range(4)]
        return [(sum(fields, []), 0)] if G == 256 else [(r, r[0] // G) for r in fields]
    if qmatmul.split_unit(gtype) == 256:  # the two nibbles of packed rows 32j..
        return [(list(range(32 * j, 32 * j + 32)), j),
                (list(range(128 + 32 * j, 160 + 32 * j)), 4 + j)]
    return [(list(range(32 * u, 32 * u + 32)), u) for u in (2 * j, 2 * j + 1)]


def _grouped_kernel_order(x, planes, gtype, n_out, n_in, split):
    """The group-factored function in the order of qmm_grouped below 16
    rows (the gemv body), in f32: per chunk, warp j's step j adds each
    segment's Σ bf16(x) · value times its scale row once, then each
    segment's (Σ bf16(x)) · minus_eff; the 4 warps' sums are added in warp
    order, the K splits (of whole chunks) in split order."""
    G = qmatmul._SCHEMA[gtype]["G"]
    xb = x.to(torch.bfloat16).float()
    vals, minus = qmm.grouped_values(planes, gtype)
    scale = planes["scale"].float()
    n_chunks = n_in // 256
    per = -(-n_chunks // split)
    total = torch.zeros((x.shape[0], n_out))
    for z in range(-(-n_chunks // per)):
        warps = [torch.zeros_like(total) for _ in range(4)]
        for c in range(z * per, min(n_chunks, (z + 1) * per)):
            for j in range(4):
                segs = [(torch.tensor(rows) + 256 * c, 256 * c // G + g)
                        for rows, g in _grouped_segments(gtype, j)]
                for rows, g in segs:
                    warps[j] = warps[j] + (xb[:, rows] @ vals[rows]) * scale[g]
                for rows, g in segs if minus is not None else ():
                    warps[j] = warps[j] - xb[:, rows].sum(1, keepdim=True) * minus[g]
        total = total + (((warps[0] + warps[1]) + warps[2]) + warps[3])
    return total


@pytest.mark.parametrize("name", ALL_TYPES)
def test_grouped_kernel_order_matches_the_plain_version(name):
    """The plain version of qmm_grouped's order below 16 rows (segments of
    each 64-slot step and their scale rows, warps in warp order, splits in
    split order) against qmm_grouped_reference, every format, M = 3, K =
    1024 in 1 and 3 splits: NMSE ≤ 1e-10 in f32 (the same products and
    rounding points; the f32 sums in another order). Each step's segments
    cover its 64 slots once, and the chunk's 256 rows are covered once."""
    gtype = GGMLType[name]
    for j in range(4):
        rows = [r for seg, _ in _grouped_segments(gtype, j) for r in seg]
        assert len(rows) == len(set(rows)) == 64
    assert sorted(r for j in range(4) for seg, _ in _grouped_segments(gtype, j)
                  for r in seg) == list(range(256))
    n_out, n_in = 256, 1024
    planes = qmatmul.repack(_plain_blocks(name, n_out, n_in, seed=8), gtype, n_out, n_in, "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, n_in))
                         .astype(np.float32)).to(torch.bfloat16).float()
    ref = qmm.qmm_grouped_reference(x, planes, gtype, n_out, n_in)
    for split in (1, 3):
        got = _grouped_kernel_order(x, planes, gtype, n_out, n_in, split)
        assert _nmse(got.numpy(), ref.numpy()) <= 1e-10, split


def _tc_order(gtype: GGMLType) -> tuple[int, int, int, int]:
    """csrc/qmm_tc.cuh TcOrder for `gtype`: (RUN, STRIDE, SEG, GSEG). Slot s
    of step j of a 256-row chunk is chunk row (s // RUN) · STRIDE + RUN · j +
    s % RUN; a minus segment is SEG slots, a scale segment of the grouped
    form GSEG."""
    meta = qmatmul._SCHEMA[gtype]
    G, bits = meta["G"], meta["bits"]
    crumb = bits in (2, 3)
    half256 = bits in (4, 5) and qmatmul.split_unit(gtype) == 256
    run = 16 if crumb else 32 if half256 else 64
    stride = 128 if half256 else 64
    seg = min(G, run)
    return run, stride, seg, 32 if G >= 64 else seg


def _tc_step_rows(gtype: GGMLType, j: int) -> list[int]:
    run, stride, _, _ = _tc_order(gtype)
    return [(s // run) * stride + run * j + s % run for s in range(64)]


def _grouped_tc_order(x, planes, gtype, n_out, n_in, split):
    """The group-factored function in the order of qmm_grouped from 16 rows
    (the grouped form of the tensor-core body), in f32: per chunk, each
    64-slot step of TcOrder; per scale segment of the step (GSEG slots) the
    products Σ bf16(x) · value into a fresh sum, added times the segment's
    scale row once; per minus segment (SEG slots) the f32 sum of bf16 x split
    exactly into three bf16 terms, each times −minus_eff (bf16), added; the
    K splits (of whole chunks) summed in split order."""
    G = qmatmul._SCHEMA[gtype]["G"]
    _, _, seg, gseg = _tc_order(gtype)
    xb = x.to(torch.bfloat16).float()
    vals, minus = qmm.grouped_values(planes, gtype)
    vals = vals.to(torch.bfloat16).float()
    scale = planes["scale"].float()
    neg = None if minus is None else (-minus).to(torch.bfloat16).float()
    n_chunks = n_in // 256
    per = -(-n_chunks // split)
    total = torch.zeros((x.shape[0], n_out))
    for z in range(-(-n_chunks // per)):
        acc = torch.zeros_like(total)
        for c in range(z * per, min(n_chunks, (z + 1) * per)):
            for j in range(4):
                rows = torch.tensor(_tc_step_rows(gtype, j)) + 256 * c
                for g in range(0, 64, gseg):
                    r = rows[g:g + gseg]
                    acc = acc + (xb[:, r] @ vals[r]) * scale[int(r[0]) // G]
                for g in range(0, 64, seg) if neg is not None else ():
                    r = rows[g:g + seg]
                    gsum = xb[:, r].sum(1, keepdim=True)
                    hi = gsum.to(torch.bfloat16).float()
                    lo = (gsum - hi).to(torch.bfloat16).float()
                    lo2 = (gsum - hi - lo).to(torch.bfloat16).float()
                    assert torch.equal(hi + lo + lo2, gsum)  # the split is exact
                    acc = acc + (hi * neg[int(r[0]) // G] + lo * neg[int(r[0]) // G]
                                 + lo2 * neg[int(r[0]) // G])
        total = total + acc
    return total


@pytest.mark.parametrize("name", ALL_TYPES)
@pytest.mark.parametrize("M", [16, 37])
def test_grouped_tensor_core_order_matches_the_plain_version(name, M):
    """The plain version of qmm_grouped's order from 16 rows (TcOrder's
    64-slot steps, each scale segment's products scaled once, the split-gsum
    minus_eff term, splits in split order) against qmm_grouped_reference,
    every format, K = 1024 in 1 and 3 splits: NMSE ≤ 1e-10 in f32 (the same
    products and rounding points; the f32 sums in another order). Each
    step covers 64 distinct rows, the chunk's 256 rows once, and every scale
    and minus segment lies in one scale group."""
    gtype = GGMLType[name]
    G = qmatmul._SCHEMA[gtype]["G"]
    _, _, seg, gseg = _tc_order(gtype)
    assert gseg in (16, 32) and 64 % seg == 0  # one or two k16 slices a scale segment
    steps = [_tc_step_rows(gtype, j) for j in range(4)]
    assert sorted(r for rows in steps for r in rows) == list(range(256))
    for rows in steps:
        for width in (seg, gseg):
            for g in range(0, 64, width):
                assert len({r // G for r in rows[g:g + width]}) == 1, (width, rows[g:g + width])
    n_out, n_in = 256, 1024
    planes = qmatmul.repack(_plain_blocks(name, n_out, n_in, seed=9), gtype, n_out, n_in, "cpu")
    x = torch.from_numpy(np.random.default_rng(M).standard_normal((M, n_in))
                         .astype(np.float32)).to(torch.bfloat16).float()
    ref = qmm.qmm_grouped_reference(x, planes, gtype, n_out, n_in)
    for split in (1, 3):
        got = _grouped_tc_order(x, planes, gtype, n_out, n_in, split)
        assert _nmse(got.numpy(), ref.numpy()) <= 1e-10, split


def test_grouped_types_route_matmul_to_the_grouped_plain_version(monkeypatch):
    from tpullm_torch.models.weights import QuantLinear

    n_out, n_in = 256, 512
    data = _plain_blocks("Q4_K", n_out, n_in, seed=4)
    lin = QuantLinear(GGMLType.Q4_K, n_out, n_in,
                      qmatmul.repack(data, GGMLType.Q4_K, n_out, n_in, "cpu"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, n_in))
                         .astype(np.float32)).to(torch.bfloat16)
    assert qmm.GROUPED_TYPES == set()  # TPULLM_QMM_GROUPED is not set in the tests
    assert torch.equal(lin(x), qmm.qmm_reference(x, lin.planes, GGMLType.Q4_K, n_out, n_in))
    monkeypatch.setattr(qmm, "GROUPED_TYPES", {GGMLType.Q4_K})
    before = dict(qmm.GROUPED_LAUNCHES)
    assert torch.equal(lin(x), qmm.qmm_grouped_reference(x, lin.planes, GGMLType.Q4_K,
                                                          n_out, n_in))
    assert qmm.GROUPED_LAUNCHES == before  # the CPU path launches no kernel


def test_grouped_types_are_read_from_the_environment(monkeypatch):
    """TPULLM_QMM_GROUPED is read once, at import, as the JAX package reads
    it."""
    import importlib.util

    monkeypatch.setenv("TPULLM_QMM_GROUPED", "Q4_K, IQ2_XXS")
    mod = importlib.util.module_from_spec(importlib.util.find_spec(qmm.__name__))
    mod.__spec__.loader.exec_module(mod)  # a second copy; `qmm` keeps its own set
    assert mod.GROUPED_TYPES == {GGMLType.Q4_K, GGMLType.IQ2_XXS}


def test_grouped_kernel_wrapper_refuses_cpu_tensors():
    planes = qmatmul.repack(_plain_blocks("IQ2_XXS", 128, 256, 5), GGMLType.IQ2_XXS, 128,
                            256, "cpu")
    with pytest.raises(ValueError):
        qmm.qmm_grouped(torch.zeros(1, 256, dtype=torch.bfloat16), planes,
                        GGMLType.IQ2_XXS, 128, 256)


def test_match_runs_in_bounded_chunks(monkeypatch):
    """A repack larger than the match's chunk gives the planes of one pass."""
    data = _blocks("IQ3_S", 64, 512, seed=6)
    whole = qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType.IQ3_S, 64, 512)
    monkeypatch.setattr(qmatmul, "_MATCH_BLOCKS", 5)
    parts = qmatmul.repack_planes(torch.from_numpy(data.copy()), GGMLType.IQ3_S, 64, 512)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
