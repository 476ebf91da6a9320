"""Card-only tests of tpullm_torch: each CUDA kernel against its plain
version on the card, and a short Engine run of the tiny model. They skip
without an NVIDIA GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.models.synth import PRESETS
from tpullm_torch.ops import qmatmul
from tpullm_torch.ops.kernels import flash, qmm

pytestmark = pytest.mark.cuda

# every plane format of the qmm kernels
FORMATS = ["Q4_K", "Q6_K", "Q5_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4", "IQ4_NL",
           "Q2_K", "Q3_K", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S",
           "IQ1_M", "TQ1_0", "TQ2_0"]

# NMSE bounds of the JAX package's on-chip conformance sweep
QMM_NMSE_BOUND = 5e-4
FLASH_NMSE_BOUND = 2e-3
FLASH_Q8_NMSE_BOUND = 5e-3
# host time around a profiled step's calls (chip_smoke.py's PROFILE_MARGIN_S)
PROFILE_MARGIN_S = 0.005


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean() / (ref * ref).mean().clamp_min(1e-300))


def _planes(name, n_out, n_in, dev, seed):
    from tpullm_torch.models.synth import random_packed

    raw = random_packed(np.random.default_rng(seed), GGMLType[name], n_out * n_in)
    return qmatmul.repack(np.frombuffer(raw, np.uint8), GGMLType[name], n_out, n_in, dev)


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M,K,N", [(1, 512, 768), (5, 1024, 256), (37, 512, 1028),
                                   (300, 768, 512)])
def test_qmm_kernel_matches_plain(dev, name, M, K, N):
    """Both regimes: M < 16 on CUDA cores (LAUNCHES), M ≥ 16 on the tensor
    cores (TC_LAUNCHES)."""
    planes = _planes(name, N, K, dev, seed=M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    counts = qmm.TC_LAUNCHES if M >= qmm.TC_MIN_M else qmm.LAUNCHES
    before = qmm.LAUNCHES[name] + qmm.TC_LAUNCHES[name], counts[name]
    got = qmm.qmm(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.LAUNCHES[name] + qmm.TC_LAUNCHES[name], counts[name]) == (before[0] + 1,
                                                                           before[1] + 1)
    ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M,K,N", [(16, 4096, 4096), (48, 1024, 1412), (512, 2048, 1024)])
def test_qmm_tensor_core_kernel_matches_plain(dev, name, M, K, N):
    """The tensor-core regime at the prefill row counts: one M tile (16, 48)
    and four (512); N = 1412 ends in a partial column tile; at these few
    output tiles the plan splits K."""
    planes = _planes(name, N, K, dev, seed=M + 7)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tm, split, _ = qmm.plan(M, K, N, n_sm)
    assert tm == qmm.TC_TILE and split > 1
    before = qmm.TC_LAUNCHES[name], qmm.LAUNCHES[name]
    got = qmm.qmm(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.TC_LAUNCHES[name], qmm.LAUNCHES[name]) == (before[0] + 1, before[1])
    ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M,K,N", [(1, 512, 768), (5, 1024, 256), (37, 512, 1028),
                                   (300, 768, 512)])
def test_qmm_grouped_kernel_matches_plain(dev, name, M, K, N):
    planes = _planes(name, N, K, dev, seed=M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    before = qmm.GROUPED_LAUNCHES[name], qmm.LAUNCHES[name]
    got = qmm.qmm_grouped(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.GROUPED_LAUNCHES[name], qmm.LAUNCHES[name]) == (before[0] + 1, before[1])
    ref = qmm.qmm_grouped_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M,K,N", [(16, 4096, 512), (37, 1024, 1028), (128, 2048, 1412),
                                   (300, 768, 512), (512, 2048, 1024)])
def test_qmm_grouped_tensor_core_kernel_matches_plain(dev, name, M, K, N):
    """qmm_grouped from 16 rows, the grouped form of the tensor-core body:
    one M tile (16, 37, 128) and several (300, 512); N = 1028 and 1412 end
    in a partial column tile; (16, 4096, 512) splits K 16 ways (four output
    tiles). Counted in GROUPED_LAUNCHES only; a call repeated back to back
    gives the same bits."""
    planes = _planes(name, N, K, dev, seed=M + 11)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    if (M, N) == (16, 512):  # the split case
        assert qmm.plan(M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)[1] > 1
    before = qmm.GROUPED_LAUNCHES[name], qmm.TC_LAUNCHES[name], qmm.LAUNCHES[name]
    got = qmm.qmm_grouped(x, planes, GGMLType[name], N, K)
    again = qmm.qmm_grouped(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.GROUPED_LAUNCHES[name], qmm.TC_LAUNCHES[name], qmm.LAUNCHES[name]) == \
        (before[0] + 2, before[1], before[2])
    ref = qmm.qmm_grouped_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND
    assert torch.equal(got, again)


def test_grouped_types_route_matmul_to_the_grouped_kernel(dev, monkeypatch):
    from tpullm_torch.models.weights import QuantLinear

    lin = QuantLinear(GGMLType.Q4_K, 768, 512, _planes("Q4_K", 768, 512, dev, seed=3))
    x = torch.randn(2, 512, device=dev).to(torch.bfloat16)
    monkeypatch.setattr(qmm, "GROUPED_TYPES", {GGMLType.Q4_K})
    before = qmm.GROUPED_LAUNCHES["Q4_K"], qmm.LAUNCHES["Q4_K"]
    lin(x)
    torch.cuda.synchronize()
    assert (qmm.GROUPED_LAUNCHES["Q4_K"], qmm.LAUNCHES["Q4_K"]) == (before[0] + 1, before[1])


def _stack(name, E, n_out, n_in, dev, seed):
    """A packed stack of random experts at any shape (load_expert_stack
    loads one that no kernel takes dense, as the JAX package does)."""
    from tpullm_torch.models.synth import random_packed
    from tpullm_torch.models.weights import QuantExpertStack

    raw = random_packed(np.random.default_rng(seed), GGMLType[name], E * n_out * n_in)
    per = [qmatmul.repack(d, GGMLType[name], n_out, n_in, dev) for d in raw.reshape(E, -1)]
    planes = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return QuantExpertStack(GGMLType[name], E, n_out, n_in, planes)


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
@pytest.mark.parametrize("M,K,N", [(1, 512, 768), (24, 768, 512), (40, 512, 1028),
                                   (32, 1024, 640), (512, 512, 768)])
def test_qmm_stack_kernel_matches_plain(dev, name, batched, M, K, N):
    E = 4
    stack = _stack(name, E, N, K, dev, seed=M)
    g = torch.Generator(dev).manual_seed(M)
    x = torch.randn(*((E, M, K) if batched else (M, K)), generator=g, device=dev)
    x = x.to(torch.bfloat16)
    before = qmm.STACK_LAUNCHES[name]
    got = qmm.qmm_stack(x, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    assert qmm.STACK_LAUNCHES[name] == before + 1
    ref = qmm.qmm_stack_reference(x, stack.planes, stack.gtype, N, K)
    assert got.shape == (E, M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("T,K,N", [(1, 512, 768), (2, 512, 768), (2, 1536, 256), (9, 512, 1028),
                                   (16, 1024, 1024), (32, 768, 512)])
def test_qmm_gather_kernel_matches_plain(dev, name, T, K, N):
    E = 8
    stack = _stack(name, E, N, K, dev, seed=T)
    g = torch.Generator(dev).manual_seed(T)
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
    ids[-1] = ids[0]  # a repeated expert
    before = qmm.GATHER_LAUNCHES[name]
    got = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    assert qmm.GATHER_LAUNCHES[name] == before + 1
    ref = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, N, K)
    assert got.shape == (T, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("name", ["Q4_K", "Q6_K", "IQ2_XXS", "MXFP4"])
@pytest.mark.parametrize("T,E", [(40, 8), (3, 40), (150, 4)])
def test_qmm_gather_beyond_32_slots_or_experts(dev, name, T, E):
    """More than 32 slots or experts: the blocks find their expert through
    the bit set in shared memory (not by warp votes), and past 128 slots
    collect them in rounds; ids outside the stack give NaN rows. K = 1024
    in 1 and 4 splits."""
    K, N = 1024, 260
    stack = _stack(name, E, N, K, dev, seed=T + E)
    g = torch.Generator(dev).manual_seed(T + E)
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
    ids[1], ids[-1] = E + 2, -3
    valid = (ids >= 0) & (ids < E)
    ref = qmm.qmm_gather_reference(x[valid], ids[valid], stack.planes, stack.gtype, N, K)
    for split in (1, 4):
        got = _gather(x, ids, stack, N, K, split)
        torch.cuda.synchronize()
        assert torch.isnan(got[~valid].float()).all(), split
        assert _nmse(got[valid].float(), ref.float()) <= QMM_NMSE_BOUND, split


def test_qmm_gather_kernel_gives_nan_rows_for_ids_outside_the_stack(dev):
    stack = _stack("Q4_K", 4, 512, 512, dev, seed=1)
    x = torch.randn(3, 512, device=dev).to(torch.bfloat16)
    ids = torch.tensor([0, 7, 2], dtype=torch.int32, device=dev)
    got = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, 512, 512)
    torch.cuda.synchronize()
    assert torch.isnan(got[1].float()).all() and torch.isfinite(got[[0, 2]].float()).all()


def _gather(x, ids, stack, N, K, split):
    """qmm_gather's kernel at a chosen split (chunks spread evenly), the x
    rows of its plan."""
    from tpullm_torch.ops.kernels import _build

    gtype, planes = stack.gtype, stack.planes
    (T, _), E, n_chunks = x.shape, planes["scale"].shape[0], K // 256
    tm = qmm.gather_plan(T, E, K, N, 132)[0]
    per = -(-n_chunks // split)
    split = -(-n_chunks // per)
    out = torch.empty((T, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split, T, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _build.counters(x.device, stream, -(-N // qmm.GEMV_BLOCK_N) * min(T, E))
    ops = [planes[qmm._code_plane(gtype)], planes.get("qh"), planes["scale"], planes.get("minus")]
    fn = _build.bind(f"qmm_moe{qmm._FAMILY[gtype]}", "tpullm_qmm_gather", qmm._GATHER_ARGS)
    _build.check(fn(qmm._FMT[gtype], x.data_ptr(), ids.data_ptr(),
                    *[None if t is None else t.data_ptr() for t in ops], out.data_ptr(),
                    partial.data_ptr(), counters.data_ptr(), T, K, N, E, tm, split, per, stream),
                 "qmm_gather")
    return out


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("T", [1, 2, 16, 32])
def test_qmm_gather_at_every_split(dev, name, T):
    """The gather kernel at T slots over 8 experts of K = 1024 (4 chunks),
    N = 1028 (a partial column tile, 4-byte copies), for each split count
    1 .. 4 (the last block of each expert's column tile sums them): ids
    with a repeated expert, every slot on one expert (rows tiles of up to 8
    of one expert), and ids outside the stack (NaN rows); each against the
    plain version, and a launch repeated back to back bit-identical."""
    E, K, N = 8, 1024, 1028
    stack = _stack(name, E, N, K, dev, seed=T)
    g = torch.Generator(dev).manual_seed(T)
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    mixed = torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
    mixed[-1] = mixed[0]
    invalid = mixed.clone()
    invalid[0], invalid[T // 2] = E, -1
    for label, ids in (("mixed", mixed), ("one expert", torch.full_like(mixed, 5)),
                       ("invalid", invalid)):
        valid = (ids >= 0) & (ids < E)  # T = 1 with invalid ids: none
        ref = qmm.qmm_gather_reference(x[valid], ids[valid], stack.planes, stack.gtype, N, K)
        for split in range(1, K // 256 + 1):
            a = _gather(x, ids, stack, N, K, split)
            b = _gather(x, ids, stack, N, K, split)
            torch.cuda.synchronize()
            assert torch.isnan(a[~valid].float()).all(), (label, split)
            assert torch.isfinite(a[valid].float()).all(), (label, split)
            if valid.any():
                assert _nmse(a[valid].float(), ref.float()) <= QMM_NMSE_BOUND, (label, split)
            assert torch.equal(a[valid], b[valid]), (label, split)


def _gemv(x, planes, name, N, K, tm, split, grouped=False):
    """qmm's CUDA-core kernel (or the group-factored one below 16 rows) at
    a chosen split (chunks spread evenly)."""
    from tpullm_torch.ops.kernels import _build

    gtype = GGMLType[name]
    M, n_chunks = x.shape[0], K // 256
    per = -(-n_chunks // split)
    split = -(-n_chunks // per)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split, M, N), dtype=torch.float32, device=x.device)
    tiles = -(-N // qmm.GEMV_BLOCK_N) * -(-M // tm)
    ops = [planes[qmm._code_plane(gtype)], planes.get("qh"), planes["scale"], planes.get("minus")]
    fn = _build.bind(f"qmm{qmm._FAMILY[gtype]}", "tpullm_qmm_grouped" if grouped else
                     "tpullm_qmm", qmm._QMM_ARGS)
    _build.check(fn(qmm._FMT[gtype], x.data_ptr(), *[None if t is None else t.data_ptr()
                                                     for t in ops],
                    out.data_ptr(), partial.data_ptr(),
                    _build.counters(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                                    tiles).data_ptr(), M, K, N, tm, split, per,
                    torch.cuda.current_stream(x.device).cuda_stream), "qmm")
    return out


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_qmm_gemv_at_every_split(dev, name, M):
    """The CUDA-core kernel at TM = M for every split count 1 .. 4 of K =
    1024 (the last block of each column tile sums the splits), N = 1028
    (a partial column tile, 4-byte copies) and N = 512 (16-byte copies);
    each split count against the plain version, and a launch repeated back
    to back on one stream bit-identical to the first."""
    for K, N in ((1024, 1028), (1024, 512)):
        planes = _planes(name, N, K, dev, seed=M + N)
        x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
        x = x.to(torch.bfloat16)
        ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
        for split in range(1, K // 256 + 1):
            a = _gemv(x, planes, name, N, K, M, split)
            b = _gemv(x, planes, name, N, K, M, split)
            torch.cuda.synchronize()
            assert torch.isfinite(a.float()).all()
            assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND, (K, N, split)
            assert torch.equal(a, b), (K, N, split)


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("M", [1, 2, 5, 8, 15])
def test_qmm_grouped_below_16_rows_at_every_split(dev, name, M):
    """The group-factored kernel below 16 rows (the gemv body, TM of
    gemv_plan: M = 15 is two row tiles of 8) for every split count 1 .. 4
    of K = 1024, N = 1028 and N = 512, against qmm_grouped_reference; a
    launch repeated back to back bit-identical."""
    for K, N in ((1024, 1028), (1024, 512)):
        planes = _planes(name, N, K, dev, seed=M + N + 1)
        x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
        x = x.to(torch.bfloat16)
        ref = qmm.qmm_grouped_reference(x, planes, GGMLType[name], N, K)
        tm = qmm.gemv_plan(M, K, N, 132)[0]
        for split in range(1, K // 256 + 1):
            a = _gemv(x, planes, name, N, K, tm, split, grouped=True)
            b = _gemv(x, planes, name, N, K, tm, split, grouped=True)
            torch.cuda.synchronize()
            assert torch.isfinite(a.float()).all()
            assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND, (K, N, split)
            assert torch.equal(a, b), (K, N, split)


def _kernel_names(fn, calls: int = 3) -> list[str]:
    """The qmm kernels that `calls` calls of fn launch, by the profiler's
    names, each with its launch count. The calls are profiled in the active
    step of a schedule after a warm-up step of the same calls, with
    PROFILE_MARGIN_S of host time before the first call and after the last
    kernel ends (a profile that starts with them, or a step that ends at
    the last kernel, can miss a kernel: on the H100 one of three
    qmm_gather_kernel events went missing once)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    names: list[str] = []

    def ready(prof):
        names.extend(f"{e.key} ×{e.count}" for e in prof.key_averages()
                     if "qmm" in e.key and getattr(e, "self_device_time_total", 0) > 0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
    return names


@pytest.mark.parametrize("T", [2, 32])
def test_qmm_gather_is_one_launch(dev, T):
    """A gather whose plan splits K (Mixtral's down, 14336 → 4096) launches
    one kernel, qmm_gather_kernel (no reduction kernel)."""
    K, N, E = 14336, 4096, 8
    stack = _stack("Q4_K", E, N, K, dev, seed=T)
    g = torch.Generator(dev).manual_seed(T)
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, E, (T,), generator=g, device=dev, dtype=torch.int32)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qmm.gather_plan(T, E, K, N, n_sm)[1] > 1
    a = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    kernels = _kernel_names(lambda: qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K))
    assert len(kernels) == 1 and "qmm_gather_kernel" in kernels[0], kernels
    assert kernels[0].endswith(" ×3"), kernels
    ref = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, N, K)
    assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("M", [1, 8])
def test_qmm_grouped_below_16_rows_is_one_launch(dev, M):
    """A group-factored call below 16 rows whose plan splits K launches one
    kernel, qmm_grouped_gemv_kernel (no reduction kernel)."""
    K, N = 14336, 4096
    planes = _planes("Q6_K", N, K, dev, seed=M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qmm.gemv_plan(M, K, N, n_sm)[1] > 1
    a = qmm.qmm_grouped(x, planes, GGMLType.Q6_K, N, K)
    torch.cuda.synchronize()
    kernels = _kernel_names(lambda: qmm.qmm_grouped(x, planes, GGMLType.Q6_K, N, K))
    assert len(kernels) == 1 and "qmm_grouped_gemv_kernel" in kernels[0], kernels
    assert kernels[0].endswith(" ×3"), kernels
    ref = qmm.qmm_grouped_reference(x, planes, GGMLType.Q6_K, N, K)
    assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("M,K,N", [(16, 4096, 512), (512, 4096, 28672)])
def test_qmm_grouped_from_16_rows_runs_the_tensor_core_kernel(dev, M, K, N):
    """A group-factored call from 16 rows launches qmm_grouped_tc_kernel,
    and qmm_reduce_kernel only when its plan splits K (16 ways at 16 × 512;
    none at the 8B gate_up's 512 rows); no kernel of the 16-row CUDA-core
    design (qmm_grouped_kernel) runs."""
    planes = _planes("Q4_K", N, K, dev, seed=M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split = qmm.plan(M, K, N, n_sm)[1]
    assert (split > 1) == (M == 16)
    a = qmm.qmm_grouped(x, planes, GGMLType.Q4_K, N, K)
    torch.cuda.synchronize()
    kernels = _kernel_names(lambda: qmm.qmm_grouped(x, planes, GGMLType.Q4_K, N, K))
    assert len(kernels) == 1 + (split > 1), kernels
    assert any("qmm_grouped_tc_kernel" in k and k.endswith(" ×3") for k in kernels), kernels
    assert any("qmm_reduce_kernel" in k and k.endswith(" ×3") for k in kernels) == (split > 1)
    assert not any("qmm_grouped_kernel" in k for k in kernels), kernels
    ref = qmm.qmm_grouped_reference(x, planes, GGMLType.Q4_K, N, K)
    assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("M", [1, 8])
def test_qmm_below_16_rows_is_one_launch(dev, M):
    """A qmm call below 16 rows whose plan splits K launches one kernel (no
    reduction kernel), and two calls back to back on one stream agree bit
    for bit."""
    K, N = 14336, 4096  # the 8B down: split many ways
    planes = _planes("Q4_K", N, K, dev, seed=5)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(5), device=dev)
    x = x.to(torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert qmm.gemv_plan(M, K, N, n_sm)[1] > 1
    a = qmm.qmm(x, planes, GGMLType.Q4_K, N, K)
    torch.cuda.synchronize()
    kernels = _kernel_names(lambda: qmm.qmm(x, planes, GGMLType.Q4_K, N, K))
    assert len(kernels) == 1 and "qmm_kernel" in kernels[0], kernels
    assert kernels[0].endswith(" ×3"), kernels
    b = qmm.qmm(x, planes, GGMLType.Q4_K, N, K)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = qmm.qmm_reference(x, planes, GGMLType.Q4_K, N, K)
    assert _nmse(a.float(), ref.float()) <= QMM_NMSE_BOUND


def test_split_outputs_on_two_streams_at_once(dev):
    """The K splits of qmm, qmm_grouped (below 16 rows) and qmm_gather and
    flash's key splits find their last block through a counter buffer of
    the launch's stream: calls on two streams at once each get their own
    buffer and give the one-stream results bit for bit."""
    from tpullm_torch.ops.kernels import _build

    K, N = 14336, 4096
    planes = _planes("Q4_K", N, K, dev, seed=6)
    stack = _stack("Q4_K", 8, N, K, dev, seed=6)
    x = torch.randn(2, K, generator=torch.Generator(dev).manual_seed(6), device=dev)
    x = x.to(torch.bfloat16)
    ids = torch.tensor([5, 2], dtype=torch.int32, device=dev)
    attend, _, _ = _flash_inputs(dev, "bf16", 2, 1, 32, 8, 4096, 128, (37, 3000), 6, False)
    calls = (lambda: qmm.qmm(x[:1], planes, GGMLType.Q4_K, N, K),
             lambda: qmm.qmm_grouped(x[:1], planes, GGMLType.Q4_K, N, K),
             lambda: qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K), attend)
    want = [f() for f in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    got = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                got.append([f() for f in calls])
    torch.cuda.synchronize()
    bufs = {_build.counters(dev, s.cuda_stream, 1).data_ptr() for s in streams}
    assert len(bufs) == 2
    assert all(torch.equal(a, b) for outs in got for a, b in zip(outs, want))


KV_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _flash_inputs(dev, kv, B, T, H, Hkv, S, D, offsets, seed, extras, DV=None):
    """(kernel, plain, NMSE bound) of one flash call on random inputs; `kv`
    the cache format: "bf16", "f16", "f32" (K and V drawn in bf16 and
    widened, then offset by a value below bf16's resolution so that the
    wider types hold bits bf16 does not) or "q8"; V DV wide (D if None)."""
    DV = DV or D
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, DV, generator=g, device=dev).to(torch.bfloat16)
    if kv in ("f16", "f32"):
        k = (k.float() + 1e-3 * torch.randn(B, Hkv, S, D, generator=g, device=dev)).to(
            KV_DTYPES[kv])
        v = (v.float() + 1e-3 * torch.randn(B, Hkv, S, DV, generator=g, device=dev)).to(
            KV_DTYPES[kv])
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    kw = dict(softcap=0.0, sliding_window=0, sinks=None, alibi_slopes=None)
    if extras:
        kw = dict(softcap=30.0, sliding_window=100,
                  sinks=torch.randn(H, generator=g, device=dev),
                  alibi_slopes=torch.linspace(0.5, 0.01, H, device=dev))
    if kv != "q8":
        return (lambda: flash.flash_attention(q, k, v, off, D ** -0.5, **kw),
                lambda: flash.flash_reference(q, k, v, off, D ** -0.5, **kw), FLASH_NMSE_BOUND)
    from tpullm_torch.runtime.kvcache import QuantKVCache

    k_q, k_s = QuantKVCache._quantize(k)
    v_q, v_s = QuantKVCache._quantize(v)
    return (lambda: flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, D ** -0.5, **kw),
            lambda: flash.flash_reference(q, k_q, v_q, off, D ** -0.5, k_scale=k_s,
                                          v_scale=v_s, **kw), FLASH_Q8_NMSE_BOUND)


def _flash_regimes(dev, T, D, kv, extras, DV=None):
    """The body of the regime tests (see test_flash_regimes_match_plain);
    the NMSE of each kv_len."""
    B, H, Hkv, S = 2, 8, 2, 4096
    decode = flash.regime(T, H, Hkv) == "decode"
    errs = {}
    for kv_len in (1, 31, 32, 33, 4095, 4096):
        if kv_len < T:
            continue
        offsets = (kv_len - T, (7 * kv_len + 1000) % (S - T + 1))
        kernel, plain, bound = _flash_inputs(dev, kv, B, T, H, Hkv, S, D, offsets,
                                             seed=T + kv_len + D, extras=extras, DV=DV)
        before = flash.launch_total(kv), flash.launch_total(kv, "decode")
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert (flash.launch_total(kv), flash.launch_total(kv, "decode")) == \
            (before[0] + 2, before[1] + 2 * decode)
        ref = plain()
        assert got.shape == (B, T, H, DV or D) and torch.isfinite(got.float()).all()
        errs[kv_len] = _nmse(got.float(), ref.float())
        assert errs[kv_len] <= bound, kv_len
        assert torch.equal(got, again), kv_len
    return errs


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "cap-win-sink-alibi"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 40, 512])
def test_flash_regimes_match_plain(dev, T, D, q8, extras):
    """Both regimes (GQA 8/2: T ≤ 4 is the split-KV decode, T ≥ 8 the
    tensor-core prefill), at each instantiated head dim (80 and 96 from the
    library flash_narrow), at kv_len 1, 31, 32, 33, 4095 and 4096 of S = 4096
    (the second batch at another kv_len), each call one launch, counted in
    its regime, and bit-identical when repeated back to back."""
    _flash_regimes(dev, T, D, "q8" if q8 else "bf16", extras)


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "cap-win-sink-alibi"])
@pytest.mark.parametrize("kv", ["f16", "f32"])
@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 40, 512])
def test_flash_f16_f32_regimes_match_plain(dev, T, D, kv, extras):
    """The f16 and f32 caches in both regimes, as the bf16 and q8 ones above,
    against flash_reference in f32 (NMSE bound 2e-3), each kv_len's NMSE
    printed."""
    errs = _flash_regimes(dev, T, D, kv, extras)
    print(f"flash {kv} T={T} D={D} extras={extras}: NMSE by kv_len "
          + ", ".join(f"{n}: {e:.2e}" for n, e in errs.items()))


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "cap-win-sink-alibi"])
@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8"])
@pytest.mark.parametrize("dims", [(192, 128), (96, 64)], ids=["192-128", "96-64"])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 40, 512])
def test_flash_dkdv_regimes_match_plain(dev, T, dims, kv, extras):
    """Key width ≠ value width (the decompressed MLA form: PLM and
    DeepSeek-V2's (192, 128), MiniCPM3's (96, 64); the library flash_dkdv)
    in both regimes on every cache format, as test_flash_regimes_match_plain
    holds the others: each kv_len against flash_reference, one launch a
    call counted under its pair's key, bit-identical when repeated."""
    D, DV = dims
    key = f"{kv}.{flash.dims_key(D, DV)}."
    before = {r: flash.LAUNCHES[key + r] for r in ("decode", "prefill")}
    errs = _flash_regimes(dev, T, D, kv, extras, DV=DV)
    n = 2 * len(errs)
    reg = flash.regime(T, 8, 2)
    assert flash.LAUNCHES[key + reg] == before[reg] + n
    print(f"flash {kv} T={T} {D}/{DV} extras={extras}: NMSE by kv_len "
          + ", ".join(f"{k}: {e:.2e}" for k, e in errs.items()))


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "cap-win-sink-alibi"])
@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8"])
@pytest.mark.parametrize("H", [17, 71, 80])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_row_groups_match_plain(dev, D, H, kv, extras):
    """A decode token of H heads on one KV head at D = 64 and 128 (Falcon-7B's
    71 at 64, and the row-grouped regime's edges 17 and 80): the decode
    kernel in ⌈H/16⌉ row groups, one launch a call counted in the decode
    regime, on every cache format against flash_reference at kv 38 and
    3001 of S = 4096, bit-identical when repeated."""
    before = flash.launch_total(kv, "decode")
    kernel, plain, bound = _flash_inputs(dev, kv, 2, 1, H, 1, 4096, D, (37, 3000), seed=H + D,
                                         extras=extras)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    assert flash.launch_total(kv, "decode") == before + 2
    assert got.shape == (2, 1, H, D) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), plain().float()) <= bound
    assert torch.equal(got, again)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("T,S,D,softcap,window,sinks,alibi", [
    (1, 100, 128, 0.0, 0, False, False),
    (40, 300, 64, 0.0, 0, False, False),
    (40, 300, 128, 30.0, 0, False, False),
    (17, 256, 64, 0.0, 48, False, False),
    (1, 256, 128, 0.0, 0, True, False),
    (33, 200, 64, 0.0, 0, False, True),
    (20, 160, 128, 25.0, 32, True, True),
    # Gemma at head dim 256: gemma3's window of 1024, gemma2's softcap 50
    (1, 2048, 256, 0.0, 1024, False, False),
    (512, 2048, 256, 0.0, 1024, False, False),
    (1, 2048, 256, 50.0, 1024, False, False),
    (300, 1200, 256, 50.0, 0, False, False),
])
def test_flash_kernel_matches_plain(dev, q8, T, S, D, softcap, window, sinks, alibi):
    B, H, Hkv = 2, 8, 2
    g = torch.Generator(dev).manual_seed(T + S)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor([0, S - T - 3], dtype=torch.int32, device=dev)
    sk = torch.randn(H, generator=g, device=dev) if sinks else None
    sl = torch.linspace(0.5, 0.01, H, device=dev) if alibi else None
    scale = D ** -0.5
    if q8:
        from tpullm_torch.runtime.kvcache import QuantKVCache

        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        got = flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale, softcap, window, sk, sl)
        ref = flash.flash_reference(q, k_q, v_q, off, scale, softcap, window, sk, sl,
                                    k_scale=k_s, v_scale=v_s)
        bound = FLASH_Q8_NMSE_BOUND
    else:
        got = flash.flash_attention(q, k, v, off, scale, softcap, window, sk, sl)
        ref = flash.flash_reference(q, k, v, off, scale, softcap, window, sk, sl)
        bound = FLASH_NMSE_BOUND
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= bound


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "f16", "f32"])
def test_engine_on_the_card_matches_the_cpu(dev, tmp_path, kv):
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny", seed=0)
    kv_dtype = torch.bfloat16 if kv == "bf16" else kv
    gpu = Engine(path, max_seq=256, kv_dtype=kv_dtype)
    cpu = Engine(path, device="cpu", max_seq=256, kv_dtype=kv_dtype)
    assert gpu.device.type == "cuda"
    ids = gpu.tokenizer.tokenize("the quick brown fox", add_special=True)
    fmt = "q8" if kv == "q8_0" else kv
    before = qmm.LAUNCHES["Q4_K"], flash.launch_total(fmt)
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert np.isfinite(a).all() and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    after = qmm.LAUNCHES["Q4_K"], flash.launch_total(fmt)
    assert after[0] > before[0] and after[1] == before[1] + 4 * gpu.hp.n_layer
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 8) == cpu.generate_tokens_device(ids, 8)


@pytest.mark.parametrize("kind", ["ring", "swa_full", "q8", "gemma2-ring", "gemma"])
def test_gemma_engine_on_the_card_matches_the_cpu(dev, tmp_path, kind):
    """tiny gemma3 (gemma2, gemma) on the card against the CPU: the ring
    (its SWA layers through attention_ring, the global layer through flash
    at D = 256), swa_full and q8 (every layer through flash, the SWA ones
    windowed): prompt and decode_step logits within NMSE 1e-3 over 295
    tokens (the ring of 128 wraps: max_seq 512, the prefill cap 16), greedy
    ids of the decode graph equal; a replay's launches one forward's."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import SWACache

    shape = {"gemma2-ring": "tiny-gemma2", "gemma": "tiny-gemma"}.get(kind, "tiny-gemma3")
    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    kw = {"swa_full": dict(swa_full=True), "q8": dict(kv_dtype="q8_0")}.get(kind, {})
    gpu, cpu = (Engine(path, device=d, max_seq=512, **kw) for d in (None, "cpu"))
    assert isinstance(gpu.cache, SWACache) == kind.endswith("ring")
    for e in (gpu, cpu):
        e.prefill_cap = 16
        e.new_cache()
    ids = list(range(5, 300))
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert np.isfinite(a).all() and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 40, chunk=8) == \
        cpu.generate_tokens_device(ids, 40, chunk=8)
    one = gpu.decode_runner(SamplingParams(), 8).launches_per_replay()
    n_ring = sum(gpu.hp.is_swa(i) for i in range(6)) if kind.endswith("ring") else 0
    assert one["flash"] == one["flash_decode"] == 6 - n_ring
    assert one["attn_ring_routes"] == n_ring and one["attn_dense_routes"] == 0


def test_gemma_batch_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """A BatchEngine of 3 slots on tiny gemma3's ring (prefill chunk 32, R =
    128, max_seq 256): a joint round, batched steps with an idle slot (its
    ring untouched), a freed slot admitted again: per-slot logits within
    NMSE 1e-3 of the CPU's."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine

    path = make_synthetic_llama_gguf(tmp_path / "g3.gguf", shape="tiny-gemma3", seed=0)
    gpu, cpu = (BatchEngine(path, device=d, n_slots=3, max_seq=256, prefill_chunk=32)
                for d in (None, "cpu"))
    assert gpu.cache.ring_len == 128
    prompts = {0: list(range(5, 200)), 2: list(range(7, 40))}
    a, b = gpu.prefill_slots(prompts), cpu.prefill_slots(prompts)
    errs = [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in prompts]
    idle = gpu.cache.swa_k[:, 1].clone()
    for feed in ({0: 300, 2: 17}, {2: 18}, {0: 5, 2: 6}):
        a, b = gpu.decode_batch(feed), cpu.decode_batch(feed)
        errs += [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in feed]
    assert torch.equal(gpu.cache.swa_k[:, 1], idle)
    gpu.free_slot(2)
    cpu.free_slot(2)
    assert int(gpu.cache.slot_pos[2].max()) == -1
    a, b = gpu.prefill_slots({2: [1, 2, 3]}), cpu.prefill_slots({2: [1, 2, 3]})
    errs.append(_nmse(torch.from_numpy(a[2]), torch.from_numpy(b[2])))
    assert max(errs) <= 1e-3, errs


# the MLA latent (DeepSeek-V2-Lite's attention): (B, T, offsets), S = 4096
LATENT_CASES = [(2, 1, (37, 3000)), (1, 1, (19,)), (2, 1, (-1, 500)), (2, 512, (0, 2500)),
                (4, 8, (-1, 0, 2500, -1)), (2, 100, (-1, 60))]


@pytest.mark.parametrize("B,T,offsets", LATENT_CASES,
                         ids=lambda c: str(c).replace(" ", "") if isinstance(c, tuple) else None)
def test_flash_latent_matches_plain(dev, B, T, offsets):
    """The latent form (Dk 576, Dv 512, v = k[..., :512], 16 heads on one KV
    head, bf16) in both regimes against flash_reference and the plain
    version of its own order; one launch counted under bf16.d576v512; an
    idle slot's (offset −1) first row exactly 0."""
    g = torch.Generator(dev).manual_seed(B * 1000 + T)
    q = torch.randn(B, T, 16, 576, generator=g, device=dev).to(torch.bfloat16)
    c = torch.randn(B, 1, 4096, 576, generator=g, device=dev).to(torch.bfloat16)
    v = c[..., :512]
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    reg = flash.regime(T, 16, 1, latent=True)
    key = f"bf16.d576v512.{reg}"
    before = flash.LAUNCHES[key]
    got = flash.flash_attention(q, c, v, off, 192 ** -0.5)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[key] == before + 1
    ref = flash.flash_reference(q, c, v, off, 192 ** -0.5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    own = (flash.flash_split_reference(q, c, v, off, 192 ** -0.5, n_sm=n_sm, p_terms=2)
           if reg == "decode"
           else flash.flash_prefill_reference(q, c, v, off, 192 ** -0.5))
    assert got.shape == (B, T, 16, 512) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= FLASH_NMSE_BOUND
    assert _nmse(got.float(), own.float()) <= FLASH_NMSE_BOUND
    for b, o in enumerate(offsets):
        if o < 0:
            assert not got[b, 0].float().any()


# the latent form at MiniCPM3's (288, 256) with its 40 heads, and at V2-Lite's
# (576, 512) with 16 heads at the verify's T = 2–4: (Dk, Dv, H, B, T,
# offsets); R = T·H up to 64 takes the decode regime in row groups of 16
LATENT_ROW_CASES = [(288, 256, 40, 2, 1, (37, 3000)), (288, 256, 40, 1, 1, (19,)),
                    (288, 256, 40, 2, 1, (-1, 500)), (288, 256, 40, 2, 2, (0, 2500)),
                    (288, 256, 40, 2, 512, (0, 2500)), (288, 256, 40, 4, 8, (-1, 0, 2500, -1)),
                    (576, 512, 16, 2, 2, (37, 3000)), (576, 512, 16, 2, 3, (5, 1000)),
                    (576, 512, 16, 2, 4, (0, 3000)), (576, 512, 16, 1, 4, (-1,)),
                    (576, 512, 12, 2, 4, (70, 2000))]


@pytest.mark.parametrize("Dk,Dv,H,B,T,offsets", LATENT_ROW_CASES,
                         ids=lambda c: str(c).replace(" ", "") if isinstance(c, tuple) else None)
def test_flash_latent_row_groups_match_plain(dev, Dk, Dv, H, B, T, offsets):
    """The latent form at (288, 256) in both regimes, and the decode
    regime's row groups (R = 40, 48, 64, 32 and a partial last group) at
    both widths: against flash_reference and the plain version of its own
    order (the split plan's, p as two bf16 terms), one launch counted under
    its key and regime, idle slots' rows exactly 0, and a second call
    bit-identical (each row group's counter left at zero)."""
    g = torch.Generator(dev).manual_seed(Dk + H + B * 100 + T)
    q = torch.randn(B, T, H, Dk, generator=g, device=dev).to(torch.bfloat16)
    c = torch.randn(B, 1, 4096, Dk, generator=g, device=dev).to(torch.bfloat16)
    v = c[..., :Dv]
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    scale = {576: 192, 288: 96}[Dk] ** -0.5  # the per-head key width's (qk_nope + rope)
    reg = flash.regime(T, H, 1, latent=True)
    assert reg == ("decode" if T * H <= 64 else "prefill")
    key = f"bf16.{flash.dims_key(Dk, Dv)}.{reg}"
    before = flash.LAUNCHES[key]
    got = flash.flash_attention(q, c, v, off, scale)
    again = flash.flash_attention(q, c, v, off, scale)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[key] == before + 2
    ref = flash.flash_reference(q, c, v, off, scale)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    own = (flash.flash_split_reference(q, c, v, off, scale, n_sm=n_sm, p_terms=2)
           if reg == "decode" else flash.flash_prefill_reference(q, c, v, off, scale))
    assert got.shape == (B, T, H, Dv) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= FLASH_NMSE_BOUND
    assert _nmse(got.float(), own.float()) <= FLASH_NMSE_BOUND
    assert torch.equal(got, again)
    for b, o in enumerate(offsets):
        if o < 0:
            assert not got[b, 0].float().any()


@pytest.mark.parametrize("form", ["absorbed", "decompressed", "decompressed-q8"])
@pytest.mark.parametrize("shape", ["tiny-minicpm3", "tiny-plm"])
def test_mla_alias_engine_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch, shape, form):
    """tiny-minicpm3 (latent 288 / 256 under 40 heads; heads 96 / 64) and
    tiny-plm (576 / 512; 192 / 128) on the card against the CPU, on the
    latent and (TPULLM_MLA=0) on the per-head bf16 and q8 caches: a 40-token
    prompt's and decode_step's logits within NMSE 1e-3, the decode graph's
    greedy ids equal; a replay launches flash once a layer in the decode
    regime at the form's shape, a 40-token prefill once a layer in the
    prefill regime, and no dense route."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    if form != "absorbed":
        monkeypatch.setenv("TPULLM_MLA", "0")
    kv = "q8_0" if form == "decompressed-q8" else "bf16"
    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    gpu, cpu = (Engine(path, device=d, max_seq=256, kv_dtype=kv) for d in (None, "cpu"))
    dims = {("tiny-minicpm3", True): "d288v256", ("tiny-minicpm3", False): "d96v64",
            ("tiny-plm", True): "d576v512", ("tiny-plm", False): "d192v128"}[
        shape, form == "absorbed"]
    fmt = "q8" if form == "decompressed-q8" else "bf16"
    ids = list(range(5, 45))
    before = flash.LAUNCHES[f"{fmt}.{dims}.prefill"], flash.ATTN_DENSE_ROUTES[fmt]
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert flash.LAUNCHES[f"{fmt}.{dims}.prefill"] == before[0] + 2
    errs = [_nmse(torch.from_numpy(a), torch.from_numpy(b))]
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        errs.append(_nmse(torch.from_numpy(a), torch.from_numpy(b)))
    assert np.isfinite(a).all() and max(errs) <= 1e-3, errs
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 24, chunk=8) == \
        cpu.generate_tokens_device(ids, 24, chunk=8)
    one = gpu.decode_runner(SamplingParams(), 8).launches_per_replay()
    assert one["flash"] == one["flash_decode"] == 2 and one["attn_dense_routes"] == 0
    assert flash.ATTN_DENSE_ROUTES[fmt] == before[1]


def test_latent_f16_and_other_widths_take_the_dense_route(dev):
    """An f16 latent, and a latent of (32, 24), go to the counted dense
    route (no kernel takes them); the bf16 one at (576, 512) to the kernel."""
    from tpullm_torch.ops.attention import attention_cached
    from tpullm_torch.runtime.kvcache import MLACache

    g = torch.Generator(dev).manual_seed(3)
    off = torch.tensor([30], dtype=torch.int32, device=dev)
    for dtype, (kvr, rope), routed in ((torch.float16, (512, 64), True),
                                       (torch.bfloat16, (24, 8), True),
                                       (torch.bfloat16, (512, 64), False)):
        cache = MLACache(torch.randn(1, 1, 1, 64, kvr + rope, generator=g, device=dev).to(dtype),
                         kvr)
        q = torch.randn(1, 1, 16, kvr + rope, generator=g, device=dev).to(torch.bfloat16)
        fmt = flash.DENSE_FORMATS[dtype]
        before = flash.ATTN_DENSE_ROUTES[fmt], flash.launch_total()
        out = attention_cached(q, cache, 0, 0.1, off)
        k, v = cache.kv(0)
        ref = flash.flash_reference(q, k, v, off, 0.1)
        assert out.shape == (1, 1, 16, kvr) and _nmse(out.float(), ref.float()) <= 1e-5
        assert (flash.ATTN_DENSE_ROUTES[fmt] - before[0], flash.launch_total() - before[1]) == \
            ((1, 0) if routed else (0, 1))


def test_deepseek2_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """tiny-deepseek2 (the latent at 576 / 512, 16 heads) on the card against
    the CPU: a 40-token prompt's and decode_step's logits within NMSE 1e-3,
    the decode graph's greedy ids equal; a replay launches the latent
    kernel once a layer in the decode regime, a 40-token prefill once a
    layer in the prefill regime, and no dense route."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import MLACache

    path = make_synthetic_llama_gguf(tmp_path / "tds2.gguf", shape="tiny-deepseek2", seed=0)
    gpu, cpu = (Engine(path, device=d, max_seq=256) for d in (None, "cpu"))
    assert isinstance(gpu.cache, MLACache) and gpu.cache.c.is_cuda
    ids = list(range(5, 45))
    before = flash.LAUNCHES["bf16.d576v512.prefill"]
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert flash.LAUNCHES["bf16.d576v512.prefill"] == before + 3
    errs = [_nmse(torch.from_numpy(a), torch.from_numpy(b))]
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        errs.append(_nmse(torch.from_numpy(a), torch.from_numpy(b)))
    assert np.isfinite(a).all() and max(errs) <= 1e-3, errs
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 24, chunk=8) == \
        cpu.generate_tokens_device(ids, 24, chunk=8)
    one = gpu.decode_runner(SamplingParams(), 8).launches_per_replay()
    assert one["flash"] == one["flash_decode"] == 3 and one["attn_dense_routes"] == 0


def test_deepseek2_batch_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """A BatchEngine of 3 slots on tiny-deepseek2's latent: a joint round,
    batched steps with an idle slot (its latent rows untouched), a freed
    slot admitted again: per-slot logits within NMSE 1e-3 of the CPU's."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine

    path = make_synthetic_llama_gguf(tmp_path / "tds2.gguf", shape="tiny-deepseek2", seed=0)
    gpu, cpu = (BatchEngine(path, device=d, n_slots=3, max_seq=256, prefill_chunk=32)
                for d in (None, "cpu"))
    prompts = {0: list(range(5, 100)), 2: list(range(7, 40))}
    a, b = gpu.prefill_slots(prompts), cpu.prefill_slots(prompts)
    errs = [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in prompts]
    idle = gpu.cache.c[:, 1].clone()
    for feed in ({0: 300, 2: 17}, {2: 18}, {0: 5, 2: 6}):
        a, b = gpu.decode_batch(feed), cpu.decode_batch(feed)
        errs += [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in feed]
    assert torch.equal(gpu.cache.c[:, 1], idle)
    gpu.free_slot(2)
    cpu.free_slot(2)
    a, b = gpu.prefill_slots({2: [1, 2, 3]}), cpu.prefill_slots({2: [1, 2, 3]})
    errs.append(_nmse(torch.from_numpy(a[2]), torch.from_numpy(b[2])))
    assert max(errs) <= 1e-3, errs


def test_moe_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """tiny-moe: the stack kernel at prefill (52 tokens, bucket 64), the
    gather kernel at decode, the logits of the CPU's plain versions."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / "tiny-moe.gguf", shape="tiny-moe", seed=0)
    gpu = Engine(path, max_seq=256)
    cpu = Engine(path, device="cpu", max_seq=256)
    ids = gpu.tokenizer.tokenize("the lazy dog jumps over the quick brown fox hello world",
                                 add_special=True)
    before = sum(qmm.STACK_LAUNCHES.values()), sum(qmm.GATHER_LAUNCHES.values())
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert np.isfinite(a).all() and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    after = sum(qmm.STACK_LAUNCHES.values()), sum(qmm.GATHER_LAUNCHES.values())
    n = gpu.hp.n_layer
    assert after == (before[0] + 3 * n, before[1] + 3 * 3 * n)


@pytest.mark.parametrize("ftype", [p for p in PRESETS if p != "Q4_K_M"] + ["IQ2_XXS-moe"])
def test_preset_engine_on_the_card_matches_the_cpu(dev, tmp_path, ftype):
    """Each tiny preset (tiny-moe for MXFP4_MOE and for IQ2_XXS-moe) on the
    card against the CPU: logits NMSE ≤ 1e-3 and the same greedy ids, the
    preset's base type launched (the expert kernels' for tiny-moe)."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf, preset_type
    from tpullm_torch.runtime.engine import Engine

    moe = ftype == "MXFP4_MOE" or ftype.endswith("-moe")
    ftype = ftype.removesuffix("-moe")
    shape = "tiny-moe" if moe else "tiny"
    path = make_synthetic_llama_gguf(tmp_path / "m.gguf", shape=shape, seed=0, ftype=ftype)
    gpu = Engine(path, max_seq=256)
    cpu = Engine(path, device="cpu", max_seq=256)
    ids = gpu.tokenizer.tokenize("the lazy dog jumps over the quick brown fox hello world",
                                 add_special=True)
    before = dict(qmm.LAUNCHES), dict(qmm.STACK_LAUNCHES), dict(qmm.GATHER_LAUNCHES)
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert np.isfinite(a).all() and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    if moe:
        base = preset_type(ftype, "ffn_up_exps", 0, 2, 8).name
        assert qmm.STACK_LAUNCHES[base] > before[1][base]
        assert qmm.GATHER_LAUNCHES[base] > before[2][base]
    else:
        base = preset_type(ftype, "ffn_up", 0, 2).name
        assert qmm.LAUNCHES[base] > before[0][base]
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 8) == cpu.generate_tokens_device(ids, 8)


def test_routes_on_the_card(dev, tmp_path):
    """The shapes no kernel takes, on the card: the tiny model with a
    250-token head serves against the CPU with every head call through the
    counted dequantize-then-matmul route; a stack and a gather at N = 250
    take its stack and gather forms; head dims (112, 112), which no kernel
    instantiates, take the counted dense attention path."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops import attention
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import KVCache

    path = make_synthetic_llama_gguf(tmp_path / "v250.gguf", shape="tiny", seed=0, n_vocab=250)
    gpu = Engine(path, max_seq=128)
    cpu = Engine(path, device="cpu", max_seq=128)
    ids = gpu.tokenizer.tokenize("hello world the quick brown fox", add_special=True)
    before = qmm.DEQUANT_ROUTES["Q6_K"]
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert a.shape == (250,) and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (100, 17, 249):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    assert qmm.DEQUANT_ROUTES["Q6_K"] == before + 4

    stack = _stack("Q4_K", 4, 250, 256, dev, seed=9)
    x = torch.randn(6, 256, generator=torch.Generator(dev).manual_seed(9), device=dev)
    x = x.to(torch.bfloat16)
    before = qmm.DEQUANT_ROUTES["Q4_K"], qmm.STACK_LAUNCHES["Q4_K"], qmm.GATHER_LAUNCHES["Q4_K"]
    got = qmatmul.stack_matmul(x, stack)
    ref = qmm.qmm_stack_reference(x, stack.planes, stack.gtype, 250, 256)
    assert got.shape == (4, 6, 250) and _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND
    ids = torch.tensor([1, 3, 0, 1, 2, 2], dtype=torch.int32, device=dev)
    got = qmatmul.gather_matmul(x, ids, stack)
    ref = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, 250, 256)
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND
    assert (qmm.DEQUANT_ROUTES["Q4_K"], qmm.STACK_LAUNCHES["Q4_K"],
            qmm.GATHER_LAUNCHES["Q4_K"]) == (before[0] + 2, before[1], before[2])

    g = torch.Generator(dev).manual_seed(4)
    cache = KVCache(torch.randn(1, 1, 2, 64, 112, generator=g, device=dev).to(torch.bfloat16),
                    torch.randn(1, 1, 2, 64, 112, generator=g, device=dev).to(torch.bfloat16))
    q = torch.randn(1, 9, 8, 112, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor([20], dtype=torch.int32, device=dev)
    before = flash.ATTN_DENSE_ROUTES["bf16"], dict(flash.LAUNCHES)
    got = attention.attention_cached(q, cache, 0, 112 ** -0.5, off)
    ref = flash.flash_reference(q, cache.k[0], cache.v[0], off, 112 ** -0.5)
    assert got.shape == (1, 9, 8, 112)
    assert (flash.ATTN_DENSE_ROUTES["bf16"], flash.LAUNCHES) == (before[0] + 1, before[1])
    assert _nmse(got.float(), ref.float()) <= FLASH_NMSE_BOUND


def _forward_launches(params) -> dict:
    """Launches one forward makes: 2-D qmm (each quantized linear, fused or
    not, and the head), expert kernels (each expert stack), flash (one per
    layer)."""
    from tpullm_torch.models.weights import FusedLinear, QuantExpertStack, QuantLinear

    mods = [params["output"], *[m for layer in params["layers"] for m in layer.values()]]
    return {"qmm": sum(isinstance(m, (QuantLinear, FusedLinear)) for m in mods),
            "experts": sum(isinstance(m, QuantExpertStack) for m in mods),
            "flash": len(params["layers"])}


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_decode_graph_matches_decode_step(dev, tmp_path, shape, kv):
    """generate_tokens_device on the card replays a CUDA graph of one step:
    over four chunks of 8 and a tail of 5 steps up to max_seq, the greedy
    ids of a decode_step + argmax loop on the same engine; each replay adds
    one forward's launches (2-D qmm on CUDA cores, flash in its decode
    regime, the gather for each expert stack), and the whole run's counts
    are those of its forwards."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    eng = Engine(path, max_seq=40, kv_dtype=torch.bfloat16 if kv == "bf16" else "q8_0")
    ids = [1, 300, 301]  # a prefill in the bucket of 8: the regimes of a decode step
    ref = [int(np.argmax(eng.prefill(ids)))]
    while eng.n_past < eng.max_seq:
        ref.append(int(np.argmax(eng.decode_step(ref[-1]))))
    eng.reset()
    fmt = "bf16" if kv == "bf16" else "q8"
    before = (sum(qmm.LAUNCHES.values()), flash.launch_total(fmt, "decode"),
              sum(qmm.GATHER_LAUNCHES.values()))
    got = eng.generate_tokens_device(ids, 200, chunk=8, to_end=True)
    torch.cuda.synchronize()
    assert got == ref and eng.n_past == 40
    runner = eng.decode_runner(SamplingParams(), 8)
    per = _forward_launches(eng.params)
    assert runner.launches_per_replay() == {
        "qmm": per["qmm"], "qmm_tc": 0, "qmm_stack": 0, "qmm_gather": per["experts"],
        "qmm_grouped": 0, "dequant_routes": 0, "flash": per["flash"],
        "flash_decode": per["flash"],
        "attn_dense_routes": 0, "attn_ring_routes": 0}
    assert runner.replays == 40 - len(ids) - 1  # the first step ran eagerly, before the capture
    forwards = 1 + (40 - len(ids))  # the prefill (bucket 8: the same regimes) and the steps
    after = (sum(qmm.LAUNCHES.values()), flash.launch_total(fmt, "decode"),
             sum(qmm.GATHER_LAUNCHES.values()))
    assert after == (before[0] + per["qmm"] * forwards, before[1] + per["flash"] * forwards,
                     before[2] + per["experts"] * forwards)


def test_sampled_decode_graph_is_deterministic(dev, tmp_path):
    """temp 0.8: the generator registered with the graph gives the same ids
    from the same seed, call after call, and others from another seed
    (tiny-moe: the tiny dense model's all but one-hot attention samples one
    token at any seed)."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / "tiny-moe.gguf", shape="tiny-moe", seed=0)
    eng = Engine(path, max_seq=128)
    ids = eng.tokenizer.tokenize("hello world", add_special=True)
    runs = []
    for seed in (5, 5, 6):
        eng.reset()
        runs.append(eng.generate_tokens_device(ids, 48, temp=0.8, seed=seed, chunk=16,
                                               stop_on_eog=False))
    assert runs[0] == runs[1] and runs[0] != runs[2] and len(runs[0]) == 48


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "f16", "f32"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_decode_step_graph_matches_eager(dev, tmp_path, shape, kv):
    """decode_step replays the logits-only graph (captured at its first
    call): its logits equal the eager _decode_logits' at the same state,
    bit for bit, interleaved with prefill, prefill_all_logits,
    generate_tokens_device, reset and load_state (f16/f32/bf16), and after
    new_cache (which drops the graphs); each replay adds one forward's
    launches."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime import state
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    eng = Engine(path, max_seq=96, kv_dtype=torch.bfloat16 if kv == "bf16" else kv)
    ids = eng.tokenizer.tokenize("hello world the quick", add_special=True)

    def check(tok: int):
        """decode_step(tok) against the eager step at the same n_past."""
        n = eng.n_past
        got = eng.decode_step(tok)
        row = None if kv == "q8_0" else eng.cache.k[:, :, :, n].clone()
        eng.n_past = n
        want = eng._decode_logits(torch.tensor([tok], device=dev)).cpu().numpy()
        assert np.array_equal(got, want), (n, tok)
        if row is not None:  # the replay and the eager step wrote the same row
            assert torch.equal(eng.cache.k[:, :, :, n], row)

    eng.prefill(ids)
    check(300)  # the first call: eager step, then capture
    runner = eng.logits_runner()
    per = _forward_launches(eng.params)
    assert runner.launches_per_replay()["qmm"] == per["qmm"]
    assert runner.launches_per_replay()["flash_decode"] == per["flash"]
    check(17)
    eng.prefill_all_logits([5, 6, 7])
    check(42)
    eng.generate_tokens_device(ids, 8, chunk=4)
    check(9)
    eng.reset()
    eng.prefill(ids[:2])
    check(11)
    if kv != "q8_0":
        state.save_state(eng, tmp_path / "s.npz", tokens=ids[:2] + [11])
        eng.reset()
        eng.prefill([1, 2, 3, 4, 5, 6])
        assert state.load_state(eng, tmp_path / "s.npz") == ids[:2] + [11]
        check(12)
    assert eng.logits_runner() is runner and runner.replays >= 4
    eng.new_cache()
    assert eng.logits_runner() is not runner
    eng.prefill(ids)
    check(300)
    check(301)


@pytest.mark.parametrize("ftype", ["Q4_K_M", "Q2_K", "Q4_0", "IQ4_XS", "IQ2_XXS", "TQ2_0",
                                   "MXFP4_MOE"])
def test_dense_mode_on_the_card(dev, tmp_path, ftype):
    """Weight mode "dense" on the card (bf16 weights dequantized on the
    device, torch.matmul): logits NMSE ≤ 1e-3 against the same mode on the
    CPU and the same greedy ids; no qmm launch, flash as in auto; for
    Q4_K_M also NMSE ≤ 1e-3 against auto on the card (2.7e-5 on the CPU;
    the chaotic tiny models amplify the bf16 scale rounding of the packed
    planes elsewhere, up to 0.1 on the CPU, so other presets are held
    against the CPU only)."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    shape = "tiny-moe" if ftype == "MXFP4_MOE" else "tiny"
    path = make_synthetic_llama_gguf(tmp_path / "m.gguf", shape=shape, seed=0, ftype=ftype)
    gpu = Engine(path, max_seq=128, mode="dense")
    cpu = Engine(path, device="cpu", max_seq=128, mode="dense")
    ids = gpu.tokenizer.tokenize("the lazy dog jumps over the quick brown fox hello world",
                                 add_special=True)
    before = (sum(qmm.LAUNCHES.values()) + sum(qmm.TC_LAUNCHES.values())
              + sum(qmm.STACK_LAUNCHES.values()) + sum(qmm.GATHER_LAUNCHES.values()),
              flash.launch_total("bf16"))
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        assert _nmse(torch.from_numpy(gpu.decode_step(tok)),
                     torch.from_numpy(cpu.decode_step(tok))) <= 1e-3
    after = (sum(qmm.LAUNCHES.values()) + sum(qmm.TC_LAUNCHES.values())
             + sum(qmm.STACK_LAUNCHES.values()) + sum(qmm.GATHER_LAUNCHES.values()),
             flash.launch_total("bf16"))
    assert after[0] == before[0] and after[1] == before[1] + 4 * gpu.hp.n_layer
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 8) == cpu.generate_tokens_device(ids, 8)
    if ftype == "Q4_K_M":
        auto = Engine(path, max_seq=128)
        gpu.reset()
        assert _nmse(torch.from_numpy(gpu.prefill(ids)),
                     torch.from_numpy(auto.prefill(ids))) <= 1e-3


# -- continuous batching (runtime/batch_engine.py, server/) ----------------------

@pytest.mark.parametrize("kv", ["bf16", "q8", "f16", "f32"])
@pytest.mark.parametrize("B", [4, 8])
def test_flash_decode_with_idle_slots_matches_plain(dev, B, kv):
    """The decode regime at B = 4 and 8 with per-slot offsets that include
    −1 (idle) and kv lengths from 20 to 4000 of S = 4096 (the 8B's heads):
    idle rows exactly 0, every row finite, NMSE against the plain version
    within the bound, one launch."""
    H, Hkv, D, S = 32, 8, 128, 4096
    offsets = [-1, 19, -1, 3000, 63, -1, 3999, 500][:B]
    g = torch.Generator(dev).manual_seed(B)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    before = flash.launch_total(kv, "decode")
    if kv == "q8":
        from tpullm_torch.runtime.kvcache import QuantKVCache

        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        got = flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale)
        ref = flash.flash_reference(q, k_q, v_q, off, scale, k_scale=k_s, v_scale=v_s)
        bound = FLASH_Q8_NMSE_BOUND
    else:
        dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}[kv]
        k, v = k.to(dt), v.to(dt)
        got = flash.flash_attention(q, k, v, off, scale)
        ref = flash.flash_reference(q, k, v, off, scale)
        bound = FLASH_NMSE_BOUND
    torch.cuda.synchronize()
    assert flash.launch_total(kv, "decode") == before + 1
    idle = [b for b, o in enumerate(offsets) if o < 0]
    assert torch.isfinite(got.float()).all() and not got[idle].float().any()
    assert _nmse(got.float(), ref.float()) <= bound


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T", [8, 64])
def test_flash_prefill_with_idle_slots_matches_plain(dev, T, q8):
    """A joint prefill round's attention (4 slots × a bucket of T, the
    tensor-core regime) with idle slots at −1: every row finite, the first
    row of an idle slot (no visible key) exactly 0, NMSE within the bound
    against the plain version."""
    B, H, Hkv, D, S = 4, 32, 8, 128, 512
    offsets = [-1, 0, 100, -1]
    g = torch.Generator(dev).manual_seed(T)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    assert flash.regime(T, H, Hkv) == "prefill"
    if q8:
        from tpullm_torch.runtime.kvcache import QuantKVCache

        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        got = flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale)
        ref = flash.flash_reference(q, k_q, v_q, off, scale, k_scale=k_s, v_scale=v_s)
    else:
        got = flash.flash_attention(q, k, v, off, scale)
        ref = flash.flash_reference(q, k, v, off, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and not got[[0, 3], 0].float().any()
    assert _nmse(got.float(), ref.float()) <= (FLASH_Q8_NMSE_BOUND if q8 else FLASH_NMSE_BOUND)


@pytest.mark.parametrize("name,K,N", [("Q4_K", 4096, 28672), ("Q6_K", 14336, 4096)])
@pytest.mark.parametrize("M", [4, 8])
def test_qmm_at_slot_counts_matches_plain(dev, name, K, N, M):
    """qmm at M = n_slots (the batched decode step) at the 8B's gate_up
    (Q4_K) and down (Q6_K): one launch on CUDA cores, NMSE within the
    bound."""
    planes = _planes(name, N, K, dev, seed=M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    before = qmm.LAUNCHES[name]
    got = qmm.qmm(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES[name] == before + 1
    ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
    assert torch.isfinite(got.float()).all() and _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


def _batch_engines(tmp_path, shape, kv, **kw):
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine

    path = tmp_path / f"{shape}.gguf"
    if not path.exists():
        make_synthetic_llama_gguf(path, shape=shape, seed=0)
    kv_dtype = torch.bfloat16 if kv == "bf16" else kv
    return [BatchEngine(path, device=d, n_slots=4, max_seq=128, kv_dtype=kv_dtype, **kw)
            for d in (None, "cpu")]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_batch_engine_on_the_card_matches_the_cpu(dev, tmp_path, shape, kv):
    """A joint prefill round of three slots (one idle), then batched steps
    with mixed and idle slots: per-slot logits of the card (graph replays)
    within NMSE 1e-3 of the CPU's, the greedy step's ids equal; each replay
    adds one forward's launches at M = n_slots."""
    gpu, cpu = _batch_engines(tmp_path, shape, kv)
    assert gpu.device.type == "cuda"
    prompts = {0: [1, 300, 301, 302, 303], 1: [1, 17], 3: list(range(1, 40))}
    a, b = gpu.prefill_slots(prompts), cpu.prefill_slots(prompts)
    for s in prompts:
        assert np.isfinite(a[s]).all() and _nmse(torch.from_numpy(a[s]),
                                                 torch.from_numpy(b[s])) <= 1e-3
    for feed in ({0: 300, 1: 17, 3: 42}, {1: 18}, {0: 5, 3: 6}):
        a, b = gpu.decode_batch(feed), cpu.decode_batch(feed)
        for s in feed:
            assert _nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) <= 1e-3
    feed = {0: 7, 1: 8, 3: 9}
    assert gpu.decode_batch_greedy(feed) == cpu.decode_batch_greedy(feed)
    per = _forward_launches(gpu.params)
    one = gpu.runner(4).launches_per_replay()
    assert one["qmm"] == per["qmm"] and one["flash_decode"] == per["flash"]
    assert one["qmm_gather"] == per["experts"] and one["qmm_tc"] == 0
    assert gpu.runner(4).replays == 2  # captured at the first step, then two replays
    assert gpu.runner(2).graph is not None  # {1: 18}: the step of the first 2 slots


def test_batched_graph_ids_equal_the_eager_step(dev, tmp_path):
    """The greedy step as graph replays (at each step's width) against the
    full-width step run eagerly (BatchRunner.step) on a second engine from
    the same state: equal ids at every step, slots joining and leaving."""
    a, _ = _batch_engines(tmp_path, "tiny", "bf16")
    b, _ = _batch_engines(tmp_path, "tiny", "bf16")
    prompts = {0: [1, 300, 301], 2: [1, 5, 6, 7, 8]}
    a.prefill_slots(prompts)
    b.prefill_slots(prompts)
    feeds = [{0: 11, 2: 12}, {0: 13, 3: 14}, {0: 15, 1: 16, 2: 17}, {1: 18, 3: 19},
             {0: 20, 3: 21}]
    a.prefill_slot(1, [1, 2])
    b.prefill_slot(1, [1, 2])
    runner = b.runner(4)
    for feed in feeds:
        got = a.decode_batch_greedy(feed)
        runner.inputs.copy_(b._inputs(feed, 4))
        with torch.inference_mode():
            runner.step()
        for s in feed:
            b.n_past[s] += 1
        assert got == {s: int(runner.ids[s]) for s in feed}
    assert a.runner(4).replays == 2 and runner.graph is None


def test_server_on_the_card(dev, tmp_path):
    """tpullm-torch-server's app on the card: a completion and a streamed
    chat through HTTP, the decode graphs captured on the scheduler's
    thread at start-up (precompile), and the scheduler stopped after."""
    import http.client
    import json

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.server.api import make_app, serve

    path = make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny", seed=0)
    app, sched = make_app(path, n_slots=2, max_seq=128)
    httpd = serve(app, "127.0.0.1", 0)
    try:
        sched.precompile(background=False)
        assert len(sched.engine._runners) == 2  # one graph a width: 1 and 2
        assert all(r.graph is not None for r in sched.engine._runners.values())
        port = httpd.server_address[1]
        for path_, body in (("/v1/completions", {"prompt": "the quick", "max_tokens": 6,
                                                  "temperature": 0}),
                            ("/v1/chat/completions", {"messages": [{"role": "user",
                                                                    "content": "hi"}],
                                                       "max_tokens": 6, "stream": True,
                                                       "temperature": 0.8, "seed": 3})):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request("POST", path_, json.dumps(body), {"Content-Type": "application/json"})
            r = c.getresponse()
            raw = r.read().decode()
            c.close()
            assert r.status == 200, raw
            assert ("data: [DONE]" in raw) if body.get("stream") else \
                json.loads(raw)["usage"]["completion_tokens"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    assert not sched._thread.is_alive()


def _verify_launches(eng, rows: int, T: int) -> dict:
    """Launches one verify forward of `rows` rows in all (T a slot) makes:
    every 2-D qmm (the head on every row) on the tensor cores from 16 rows,
    on CUDA cores below; the expert stacks gathered up to 16 rows; flash
    once per layer, in the regime T·H/Hkv picks."""
    from tpullm_torch.ops import moe

    per = _forward_launches(eng.params)
    tc = rows >= qmm.TC_MIN_M
    stack = rows > moe._GATHER_MAX_TOKENS
    decode = flash.regime(T, eng.hp.n_head, eng.hp.n_head_kv) == "decode"
    return {"qmm": 0 if tc else per["qmm"], "qmm_tc": per["qmm"] if tc else 0,
            "qmm_stack": per["experts"] if stack else 0,
            "qmm_gather": 0 if stack else per["experts"], "qmm_grouped": 0,
            "dequant_routes": 0, "flash": per["flash"],
            "flash_decode": per["flash"] if decode else 0,
            "attn_dense_routes": 0, "attn_ring_routes": 0}


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_verify_graph_matches_eager_prefill_all_logits(dev, tmp_path, shape, kv):
    """Engine.verify_logits replays the verify graph of the prefill bucket
    (8 and 16 rows): its logits within NMSE 1e-3 of the eager
    prefill_all_logits at the same state, verify_ids their argmax; each
    replay launches one forward's kernels at its rows."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    eng = Engine(path, max_seq=96, kv_dtype=torch.bfloat16 if kv == "bf16" else kv)
    ids = eng.tokenizer.tokenize("hello world the quick", add_special=True)
    eng.prefill(ids)
    for tail in ([300, 301, 17], [5, 6, 7, 8, 9], list(range(40, 52)), [11, 12]):
        n = eng.n_past
        want = eng.prefill_all_logits(tail)
        eng.n_past = n
        got = eng.verify_logits(tail)
        eng.n_past = n
        assert np.isfinite(got).all()
        assert _nmse(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-3
        assert eng.verify_ids(tail) == [int(i) for i in np.argmax(got, axis=-1)]
    for rows, r in eng._verify_runners.items():
        assert r.graph is not None and r.replays >= 1
        assert r.launches_per_replay() == _verify_launches(eng, rows, rows)


def test_ring_verify_graph_rollback_matches_a_fresh_engine(dev, tmp_path):
    """Speculative rollback on the iSWA ring under the verify graph (the
    tiny gemma3, bf16, a ring of 128 slots for chunks of 16, wrapped by a
    140-token prompt): a verify of 6 tokens, n_past rewound by 4, a verify
    of 4 other tokens at the rewound offset (a replay of the same graph),
    two decode steps: every row equals an engine on the same weights that
    never saw the rejected tokens (NMSE ≤ 1e-6), and the ring's slot
    positions equal."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import SWACache

    path = make_synthetic_llama_gguf(tmp_path / "g.gguf", shape="tiny-gemma3", seed=0)
    engs = []
    for _ in range(2):
        e = Engine(path if not engs else engs[0].model, max_seq=256)
        e.prefill_cap = 16
        e.new_cache()
        assert isinstance(e.cache, SWACache) and e.cache.ring_len == 128
        engs.append(e)
    eng, fresh = engs
    rng = np.random.default_rng(4)
    prompt, drafts, other = (rng.integers(5, 380, size=n).tolist() for n in (140, 6, 4))
    for e in engs:
        e.prefill(prompt)
    eng.verify_logits(drafts)
    eng.n_past -= 4
    fresh.verify_logits(drafts[:2])
    rows = [(eng.verify_logits(other), fresh.verify_logits(other))]
    rows += [(eng.decode_step(t), fresh.decode_step(t)) for t in (30, 31)]
    for a, b in rows:
        assert np.isfinite(a).all()
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-6
    assert torch.equal(eng.cache.slot_pos, fresh.cache.slot_pos)
    assert eng._verify_runners[8].graph is not None and eng._verify_runners[8].replays >= 1


def test_engine_options_on_the_card_match_the_cpu(dev, tmp_path):
    """An Engine with a LoRA adapter, control vectors and self-extend
    (grp_attn_n 2) on the tiny Q4_K_M model: on the card (the qmm and
    flash kernels, the decode graph) its prompt logits within NMSE 1e-3 of
    the same engine on the CPU, and 16 greedy ids of the decode graph
    equal the CPU's; the adapter engine's decode replay launches 7 qmm a
    layer and the head."""
    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.models.lora import save_lora_gguf
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.tools.cvector import save_control_vector

    path = make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny", seed=0)
    rng = np.random.default_rng(5)
    tensors = {}
    for name, info in GGUFReader(path).tensors.items():
        if name.startswith("blk.") and name.split(".")[2] in ("attn_q", "attn_v", "ffn_up",
                                                               "ffn_down"):
            n_out, n_in = info.shape[1], info.shape[0]
            tensors[name] = (rng.standard_normal((4, n_in)).astype(np.float32) * 0.05,
                             rng.standard_normal((n_out, 4)).astype(np.float32) * 0.05)
    ad = save_lora_gguf(tmp_path / "a.gguf", tensors, alpha=8.0)
    cv = save_control_vector(tmp_path / "cv.gguf", rng.standard_normal((2, 256)).astype(
        np.float32) * 5e8)
    kw = dict(max_seq=128, lora=[(ad, 0.5)], control_vectors=[(cv, 0.7)], grp_attn_n=2)
    card, cpu = Engine(path, **kw), Engine(path, device="cpu", **kw)
    ids = list(range(5, 45))
    got, want = card.prefill_all_logits(ids), cpu.prefill_all_logits(ids)
    assert np.isfinite(got).all() and _nmse(torch.from_numpy(got), torch.from_numpy(want)) <= 1e-3
    card.reset()
    cpu.reset()
    assert card.generate_tokens_device(ids, 16, temp=0.0, chunk=8) == \
        cpu.generate_tokens_device(ids, 16, temp=0.0, chunk=8)
    (runner,) = card._runners.values()
    one = runner.launches_per_replay()
    assert one["qmm"] == 7 * card.hp.n_layer + 1 and one["flash"] == card.hp.n_layer


def test_speculative_rounds_are_graph_replays(dev, tmp_path):
    """generate_speculative on the card with an n-gram and a draft
    speculator (the target's own file): greedy ids equal the plain greedy
    ids; every verify round but each bucket's first (run eagerly before
    its capture) is a replay of the target's verify graph, and the draft
    catches up and drafts on its graphs only (no eager forward after its
    prompt)."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime import speculative
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / "tiny-moe.gguf", shape="tiny-moe", seed=0)
    eng, draft = Engine(path, max_seq=128), Engine(path, max_seq=128)
    ids = eng.tokenizer.tokenize("hello world", add_special=True)
    plain = list(eng.generate_tokens(ids, 40))
    for spec in (speculative.NgramSpeculator(n_draft=4),
                 speculative.DraftModelSpeculator(draft, n_draft=4)):
        eng.reset()
        before = sum(r.replays for r in eng._verify_runners.values())
        eager = []
        arch = draft.arch

        def counting(*a, **kw):  # the draft's forwards that run in Python
            eager.append(a[2].shape)
            return arch.forward(*a, **kw)

        draft.arch = dataclasses.replace(arch, forward=counting)
        try:
            out, stats = speculative.generate_speculative(eng, spec, ids, 40)
        finally:
            draft.arch = arch
        assert out == plain
        replays = sum(r.replays for r in eng._verify_runners.values()) - before
        assert replays + len(eng._verify_runners) >= stats.n_rounds >= replays
        if isinstance(spec, speculative.DraftModelSpeculator):
            assert stats.accept_rate > 0.9
            # the draft's prompt, then only each of its runners' first run
            # (the eager step before the capture, and the capture itself)
            runners = (len(draft._runners) + len(draft._verify_runners)
                       + (draft._logits_runner is not None))
            assert len(eager) <= 1 + 2 * runners


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_verify_batch_on_the_card_matches_the_cpu(dev, tmp_path, kv):
    """BatchEngine.verify_batch on the card (a graph replay of 4 slots × 5
    rows, slot 1 idle) against the CPU's: each slot's logits within NMSE
    1e-3, n_past unchanged, the idle slot's cache rows untouched; the
    greedy ids equal; the replay launches one forward's kernels at 20 rows
    (the tensor cores)."""
    gpu, cpu = _batch_engines(tmp_path, "tiny", kv)
    prompts = {0: [1, 300, 301, 302, 303], 2: [1, 17], 3: list(range(1, 40))}
    gpu.prefill_slots(prompts)
    cpu.prefill_slots(prompts)
    c = gpu.cache
    idle = [t[:, 1].clone() for t in ((c.k, c.v) if hasattr(c, "k") else (c.k_q, c.k_s))]
    seqs = {0: [5, 6, 7, 8], 2: [9], 3: [10, 11]}
    a, b = gpu.verify_batch(seqs, 5), cpu.verify_batch(seqs, 5)
    for s in seqs:
        assert np.isfinite(a[s]).all()
        assert _nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) <= 1e-3
    assert list(gpu.n_past) == list(cpu.n_past)
    after = [t[:, 1] for t in ((c.k, c.v) if hasattr(c, "k") else (c.k_q, c.k_s))]
    assert all(torch.equal(x, y) for x, y in zip(idle, after))
    assert gpu.verify_batch_greedy(seqs, 5) == cpu.verify_batch_greedy(seqs, 5)
    r = gpu._verify_runners[(4, 5)]
    assert r.graph is not None and r.replays == 1
    assert r.launches_per_replay() == _verify_launches(gpu, 20, 5)


def test_speculative_server_on_the_card(dev, tmp_path):
    """The scheduler with ngram and draft speculation on the card: three
    concurrent greedy requests give the plain scheduler's ids; precompile
    captured the verify graphs, and every verify step was a replay."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.sampling import SamplerParams
    from tpullm_torch.server.scheduler import GenRequest, Scheduler

    path = make_synthetic_llama_gguf(tmp_path / "tiny-moe.gguf", shape="tiny-moe", seed=0)

    def serve(sched, prompts):
        reqs = [sched.submit(GenRequest(prompt_ids=p, max_tokens=24,
                                        sampling=SamplerParams(temp=0.0))) for p in prompts]
        sched.start()
        sched.precompile(background=False)
        try:
            out = []
            for r in reqs:
                toks = []
                while True:
                    ev = r.out.get(timeout=120)
                    if ev[0] != "token":
                        break
                    toks.append(ev[1])
                out.append(toks)
        finally:
            sched.stop()
        return out

    eng = BatchEngine(path, n_slots=3, max_seq=128)
    tok = eng.tokenizer
    prompts = [tok.tokenize(p, add_special=True)
               for p in ("the dog the dog the dog", "world hello world hello", "the lazy dog")]
    plain = serve(Scheduler(eng), prompts)
    for kw in (dict(spec_type="ngram_simple"),
               dict(draft_engine=BatchEngine(path, n_slots=3, max_seq=128))):
        for s in range(eng.n_slots):
            eng.free_slot(s)
        sched = Scheduler(eng, n_draft=4, **kw)
        assert serve(sched, prompts) == plain
        assert sched.n_spec_drafted > 0
        assert all(r.graph is not None for r in eng._verify_runners.values())
        assert sorted(eng._verify_runners) == [(1, 5), (2, 5), (3, 5)]


# ---------------------------------------------------------------------------
# the Qwen shapes: 128 experts top-8, GQA groups of 8 and 7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [8, 32, 128])
@pytest.mark.parametrize("name,K,N", [("Q4_K", 2048, 768), ("Q6_K", 768, 2048)],
                         ids=["gate", "down"])
def test_qmm_gather_at_128_experts(dev, name, K, N, T):
    """Qwen3-30B-A3B's expert stacks (128 experts; gate 2048 → 768, down
    768 → 2048) through the gather at T / 8 tokens' top-8: the bit-set
    path past 32 experts, one launch; ids 128 and −1 give NaN rows, the
    others their expert's product."""
    E = 128
    stack = _stack(name, E, N, K, dev, seed=T)
    g = torch.Generator(dev).manual_seed(T)
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:8]
                       for _ in range(T // 8)]).reshape(T).int()
    before = qmm.GATHER_LAUNCHES[name]
    got = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    assert qmm.GATHER_LAUNCHES[name] == before + 1
    ref = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, N, K)
    assert torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND
    ids[1], ids[-1] = E, -1
    valid = (ids >= 0) & (ids < E)
    got = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    assert torch.isnan(got[~valid].float()).all()
    assert _nmse(got[valid].float(), ref[valid].float()) <= QMM_NMSE_BOUND


# the Qwen 2-D linears at their Q4_K_M types: Qwen2.5-7B's at K = 3584 and
# 18944 (74 chunks of 256, split unevenly below 16 rows), Qwen3-30B-A3B's
QWEN_QMM_SHAPES = [("Q4_K", 3584, 4608), ("Q4_K", 3584, 3584), ("Q4_K", 3584, 37888),
                   ("Q6_K", 18944, 3584), ("Q4_K", 18944, 3584), ("Q6_K", 3584, 152064),
                   ("Q4_K", 2048, 5120), ("Q4_K", 4096, 2048), ("Q6_K", 2048, 151936)]


@pytest.mark.parametrize("M", [1, 512])
@pytest.mark.parametrize("name,K,N", QWEN_QMM_SHAPES,
                         ids=["7b-qkv", "7b-wo", "7b-gate_up", "7b-down-q6k", "7b-down-q4k",
                              "7b-head", "30b-a3b-qkv", "30b-a3b-wo", "30b-a3b-head"])
def test_qmm_at_qwen_shapes(dev, name, K, N, M):
    """qmm at the Qwen 2-D shapes, a decode row (the CUDA-core kernel, K
    split by gemv_plan) and a 512-token prefill (the tensor-core kernel):
    one launch of the regime's kernel, within the bound of its plain
    version."""
    planes = _planes(name, N, K, dev, seed=K + N + M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    tc = M >= qmm.TC_MIN_M
    before = qmm.LAUNCHES[name], qmm.TC_LAUNCHES[name]
    got = qmm.qmm(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.LAUNCHES[name], qmm.TC_LAUNCHES[name]) == (before[0] + (not tc),
                                                           before[1] + tc)
    ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_qmm_stack_at_128_experts(dev, batched):
    """qmm_stack over 128 experts at M = 512 (the gate on a shared x, the
    down on each expert's own x, as ops/moe.py feeds them)."""
    E, M = 128, 512
    name, K, N = ("Q6_K", 768, 2048) if batched else ("Q4_K", 2048, 768)
    stack = _stack(name, E, N, K, dev, seed=E + batched)
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn(*((E, M, K) if batched else (M, K)), generator=g, device=dev)
    x = x.to(torch.bfloat16)
    got = qmm.qmm_stack(x, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    ref = qmm.qmm_stack_reference(x, stack.planes, stack.gtype, N, K)
    assert got.shape == (E, M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T", [1, 2, 3, 512])
@pytest.mark.parametrize("H,Hkv", [(32, 4), (28, 4)], ids=["group8", "group7"])
def test_flash_at_qwen_heads(dev, H, Hkv, T, q8):
    """Flash at D = 128 with Qwen3-30B-A3B's 32 heads over 4 and Qwen2.5-7B's
    28 over 4 (a group of 7: T·7 rows cross the decode regime's 16 at
    T = 3), kv lengths 37 / 3000 + T of S = 4096: the regime T·H/Hkv picks,
    one launch, within the bound of its cache."""
    kv = "q8" if q8 else "bf16"
    kernel, plain, bound = _flash_inputs(dev, kv, 2, T, H, Hkv, 4096, 128, (37, 3000),
                                         seed=H + T, extras=False)
    decode = flash.regime(T, H, Hkv) == "decode"
    assert decode == (T * (H // Hkv) <= 16)
    before = flash.launch_total(kv), flash.launch_total(kv, "decode")
    got = kernel()
    torch.cuda.synchronize()
    assert (flash.launch_total(kv), flash.launch_total(kv, "decode")) == \
        (before[0] + 1, before[1] + decode)
    assert torch.isfinite(got.float()).all()
    assert _nmse(got.float(), plain().float()) <= bound


@pytest.mark.parametrize("shape", ["tiny-qwen3moe", "tiny-qwen2moe", "tiny-qwen2", "tiny-qwen3"])
def test_qwen_engine_on_the_card_matches_the_cpu(dev, tmp_path, shape):
    """The tiny Qwen shapes on the card against the CPU: a 30-token prompt's
    and three decode steps' logits within NMSE 1e-3 (the MoE shapes: the
    stack at the prompt, the gather at decode), the decode graph's greedy
    ids equal; a replay's launches: every quantized linear through qmm,
    the experts through the gather, flash once a layer in the decode
    regime, no counted route."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    gpu, cpu = (Engine(path, device=d, max_seq=256) for d in (None, "cpu"))
    ids = list(range(5, 35))
    errs = [_nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (300, 17, 42):
        errs.append(_nmse(torch.from_numpy(gpu.decode_step(tok)),
                          torch.from_numpy(cpu.decode_step(tok))))
    assert max(errs) <= 1e-3, errs
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 24, chunk=8) == \
        cpu.generate_tokens_device(ids, 24, chunk=8)
    one = gpu.decode_runner(SamplingParams(), 8).launches_per_replay()
    n_moe = 3 * gpu.hp.n_layer if gpu.hp.n_expert else 0
    assert one["qmm_gather"] == n_moe and one["qmm_stack"] == 0
    assert one["flash"] == one["flash_decode"] == gpu.hp.n_layer
    assert one["dequant_routes"] == one["attn_dense_routes"] == 0


def test_qwen3moe_batch_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """A BatchEngine of 3 slots on tiny-qwen3moe: a joint round (every
    expert), batched steps with an idle slot (the gather), a freed slot
    admitted again: per-slot logits within NMSE 1e-3 of the CPU's."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine

    path = make_synthetic_llama_gguf(tmp_path / "tq3m.gguf", shape="tiny-qwen3moe", seed=0)
    gpu, cpu = (BatchEngine(path, device=d, n_slots=3, max_seq=256, prefill_chunk=32)
                for d in (None, "cpu"))
    prompts = {0: list(range(5, 100)), 2: list(range(7, 40))}
    a, b = gpu.prefill_slots(prompts), cpu.prefill_slots(prompts)
    errs = [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in prompts]
    idle = gpu.cache.k[:, 1].clone()
    for feed in ({0: 300, 2: 17}, {2: 18}, {0: 5, 2: 6}):
        a, b = gpu.decode_batch(feed), cpu.decode_batch(feed)
        errs += [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in feed]
    assert torch.equal(gpu.cache.k[:, 1], idle)
    gpu.free_slot(2)
    cpu.free_slot(2)
    a, b = gpu.prefill_slots({2: [1, 2, 3]}), cpu.prefill_slots({2: [1, 2, 3]})
    errs.append(_nmse(torch.from_numpy(a[2]), torch.from_numpy(b[2])))
    assert max(errs) <= 1e-3, errs


# ---------------------------------------------------------------------------
# the Phi families and Qwen (v1): flash at head dims 96 and 80, the engines
# ---------------------------------------------------------------------------

# Phi-3-mini: 32 heads on 32 KV heads of 96, a window of 2047 on a full
# cache of 4096; Phi-2: 32 on 32 of 80, no window, context 2048
PHI_FLASH = {96: dict(S=4096, offset=3000, window=2047), 80: dict(S=2048, offset=1500, window=0)}


@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8"])
@pytest.mark.parametrize("D,T", [(96, 1), (96, 9), (96, 16), (96, 17), (96, 2560),
                                 (80, 1), (80, 9), (80, 16), (80, 17)])
def test_flash_at_phi_heads(dev, D, T, kv):
    """Flash at the Phi heads (H = Hkv = 32, B = 1): the decode regime at
    R = T = 1, 9 and 16 (P·V's 32 threads a row at D/4 = 24 and 20, the
    lanes past it idle), the prefill regime from 17 rows; Phi-3 under its
    window of 2047 at offset 3000 (keys from 954: lo > 0 in the split
    plan) and its 2560-token prompt from offset 0 (k_begin > 0 from the
    window's edge on; Phi-2's context of 2048 holds no such prompt); one
    launch in its regime, within the bound of its cache; no dense-route
    call."""
    cfg = PHI_FLASH[D]
    off = 0 if T == 2560 else cfg["offset"]
    bound = FLASH_Q8_NMSE_BOUND if kv == "q8" else FLASH_NMSE_BOUND
    g = torch.Generator(dev).manual_seed(D * T)
    q = torch.randn(1, T, 32, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 32, cfg["S"], D, generator=g, device=dev).to(KV_DTYPES.get(kv,
                                                                                   torch.bfloat16))
    v = torch.randn(1, 32, cfg["S"], D, generator=g, device=dev).to(k.dtype)
    offs = torch.tensor([off], dtype=torch.int32, device=dev)
    w, scale = cfg["window"], D ** -0.5
    if kv == "q8":
        from tpullm_torch.runtime.kvcache import QuantKVCache

        (k_q, k_s), (v_q, v_s) = QuantKVCache._quantize(k), QuantKVCache._quantize(v)

        def kernel():
            return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, offs, scale, sliding_window=w)

        def plain():
            return flash.flash_reference(q, k_q, v_q, offs, scale, sliding_window=w,
                                         k_scale=k_s, v_scale=v_s)
    else:
        def kernel():
            return flash.flash_attention(q, k, v, offs, scale, sliding_window=w)

        def plain():
            return flash.flash_reference(q, k, v, offs, scale, sliding_window=w)
    decode = flash.regime(T, 32, 32) == "decode"
    assert decode == (T <= 16)
    before = (flash.launch_total(kv), flash.launch_total(kv, "decode"),
              sum(flash.ATTN_DENSE_ROUTES.values()))
    got = kernel()
    torch.cuda.synchronize()
    assert (flash.launch_total(kv), flash.launch_total(kv, "decode"),
            sum(flash.ATTN_DENSE_ROUTES.values())) == (before[0] + 1, before[1] + decode,
                                                       before[2])
    assert flash.LAUNCHES[f"{kv}.d{D}.{'decode' if decode else 'prefill'}"] > 0
    assert got.shape == (1, T, 32, D) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), plain().float()) <= bound


@pytest.mark.parametrize("shape", ["tiny-phi3", "tiny-phi2", "tiny-qwen"])
def test_phi_engine_on_the_card_matches_the_cpu(dev, tmp_path, shape):
    """The tiny Phi and Qwen (v1) shapes on the card against the CPU: a
    40-token prompt's (past tiny-phi3's window of 16) and three decode
    steps' logits within NMSE 1e-3, the decode graph's greedy ids equal; a
    replay's launches: every quantized linear through qmm (the fused
    attn_qkv and gate|up one launch each), flash once a layer at the
    shape's head dim (96, 80, 64) in the decode regime, no counted route."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    gpu, cpu = (Engine(path, device=d, max_seq=256) for d in (None, "cpu"))
    ids = list(range(5, 45))
    errs = [_nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (300, 17, 42):
        errs.append(_nmse(torch.from_numpy(gpu.decode_step(tok)),
                          torch.from_numpy(cpu.decode_step(tok))))
    assert max(errs) <= 1e-3, errs
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 24, chunk=8) == \
        cpu.generate_tokens_device(ids, 24, chunk=8)
    one = gpu.decode_runner(SamplingParams(), 8).launches_per_replay()
    d = gpu.hp.head_dim
    assert one["flash"] == one["flash_decode"] == gpu.hp.n_layer
    assert flash.LAUNCHES[f"bf16.d{d}.decode"] > 0 and flash.LAUNCHES[f"bf16.d{d}.prefill"] > 0
    assert one["dequant_routes"] == one["attn_dense_routes"] == 0
    # q|k|v, wo, gate|up (phi2: up) and down: four linears a layer, and the head
    assert one["qmm"] == 4 * gpu.hp.n_layer + 1 and one["qmm_tc"] == 0


def test_phi2_batch_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """A BatchEngine of 3 slots on tiny-phi2 (the parallel block, LayerNorm
    biases, the biased head): a joint round, batched steps with an idle
    slot (its cache rows untouched), a freed slot admitted again: per-slot
    logits within NMSE 1e-3 of the CPU's."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine

    path = make_synthetic_llama_gguf(tmp_path / "tphi2.gguf", shape="tiny-phi2", seed=0)
    gpu, cpu = (BatchEngine(path, device=d, n_slots=3, max_seq=256, prefill_chunk=32)
                for d in (None, "cpu"))
    prompts = {0: list(range(5, 100)), 2: list(range(7, 40))}
    a, b = gpu.prefill_slots(prompts), cpu.prefill_slots(prompts)
    errs = [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in prompts]
    idle = gpu.cache.k[:, 1].clone()
    for feed in ({0: 300, 2: 17}, {2: 18}, {0: 5, 2: 6}):
        a, b = gpu.decode_batch(feed), cpu.decode_batch(feed)
        errs += [_nmse(torch.from_numpy(a[s]), torch.from_numpy(b[s])) for s in feed]
    assert torch.equal(gpu.cache.k[:, 1], idle)
    gpu.free_slot(2)
    cpu.free_slot(2)
    a, b = gpu.prefill_slots({2: [1, 2, 3]}), cpu.prefill_slots({2: [1, 2, 3]})
    errs.append(_nmse(torch.from_numpy(a[2]), torch.from_numpy(b[2])))
    assert max(errs) <= 1e-3, errs


@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8"])
@pytest.mark.parametrize("offset", [19, 3000])
def test_flash_alibi_decode_at_one_row_many_splits(dev, kv, offset):
    """ALiBi at D = 128 in the decode regime at R = 1 (BLOOM-7B1's decode
    token: 32 heads on 32, the slopes of max bias 8), kv 20 and 3001 of S =
    4096 (the keys split over many blocks), every cache format: one launch
    a call in the decode regime, against flash_reference."""
    from tpullm_torch.ops.attention import alibi_slopes

    H, D, S = 32, 128, 4096
    assert flash.regime(1, H, H) == "decode"
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert flash.max_splits(1, H, S, n_sm) > 1
    g = torch.Generator(dev).manual_seed(offset)
    q = torch.randn(1, 1, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, H, S, D, generator=g, device=dev).to(KV_DTYPES.get(kv, torch.bfloat16))
    v = torch.randn(1, H, S, D, generator=g, device=dev).to(KV_DTYPES.get(kv, torch.bfloat16))
    off = torch.tensor([offset], dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, 8.0, dev)
    before = flash.launch_total(kv, "decode")
    if kv == "q8":
        from tpullm_torch.runtime.kvcache import QuantKVCache

        (k_q, k_s), (v_q, v_s) = QuantKVCache._quantize(k), QuantKVCache._quantize(v)
        got = flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, D ** -0.5, alibi_slopes=sl)
        ref = flash.flash_reference(q, k_q, v_q, off, D ** -0.5, alibi_slopes=sl, k_scale=k_s,
                                    v_scale=v_s)
        bound = FLASH_Q8_NMSE_BOUND
    else:
        got = flash.flash_attention(q, k, v, off, D ** -0.5, alibi_slopes=sl)
        ref = flash.flash_reference(q, k, v, off, D ** -0.5, alibi_slopes=sl)
        bound = FLASH_NMSE_BOUND
    torch.cuda.synchronize()
    assert flash.launch_total(kv, "decode") == before + 1
    assert torch.isfinite(got.float()).all() and _nmse(got.float(), ref.float()) <= bound


@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8"])
def test_flash_row_groups_at_starcoder_r48(dev, kv):
    """StarCoder-15.5B's decode token: 48 heads on one KV head of 128 (three
    row groups of 16), B = 2 at kv 38 / 3001, every cache format: one
    decode-regime launch a call against flash_reference."""
    assert flash.regime(1, 48, 1) == "decode"
    before = flash.launch_total(kv, "decode")
    kernel, plain, bound = _flash_inputs(dev, kv, 2, 1, 48, 1, 4096, 128, (37, 3000), seed=48,
                                         extras=False)
    got = kernel()
    torch.cuda.synchronize()
    assert flash.launch_total(kv, "decode") == before + 1
    assert got.shape == (2, 1, 48, 128) and _nmse(got.float(), plain().float()) <= bound


def test_bloom_and_gpt2_on_the_card_match_the_cpu(dev, tmp_path):
    """tiny-bloom (ALiBi, tied head) and tiny-gpt2 (learned positions, 64 of
    them) on the card against the CPU: a 70-token prompt (tiny-gpt2's past
    its table) and decode steps within NMSE 1e-3; tiny-bloom's greedy ids
    on the decode graph against the CPU's (after this prompt tiny-gpt2's
    top two, ids 339 and 378, tie at 2.90625 on the CPU; the card's argmax
    took 378), and both models' decode-graph ids (tiny-gpt2's positions
    clamped in the graph) against the same engine's eager steps."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    for shape in ("tiny-bloom", "tiny-gpt2"):
        path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
        gpu, cpu = Engine(path, max_seq=128), Engine(path, device="cpu", max_seq=128)
        ids = [int(t) for t in np.random.default_rng(10).integers(5, 370, size=70)]
        errs = [_nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
        for tok in (3, 17, 5):
            errs.append(_nmse(torch.from_numpy(gpu.decode_step(tok)),
                              torch.from_numpy(cpu.decode_step(tok))))
        assert max(errs) <= 1e-3, (shape, errs)
        gpu.reset()
        graph = gpu.generate_tokens_device(ids, 8, chunk=4)
        gpu.reset()
        eager = [int(np.argmax(gpu.prefill(ids)))]
        with torch.inference_mode():
            for _ in range(7):
                logits = gpu._decode_logits(torch.tensor(eager[-1], device=gpu.device))
                eager.append(int(torch.argmax(logits)))
        assert graph == eager, (shape, graph, eager)
        if shape == "tiny-bloom":
            cpu.reset()
            assert graph == cpu.generate_tokens_device(ids, 8, chunk=4)


@pytest.mark.parametrize("shape", ["tiny-olmoe", "tiny-phimoe", "tiny-llama4"])
def test_moe_families_on_the_card_match_the_cpu(dev, tmp_path, shape):
    """tiny-olmoe (64 experts top-8: the gather's bit-set path), tiny-phimoe
    (sparsemixer, LayerNorms with biases, a biased head) and tiny-llama4
    (chunks of 16 in a 128-slot cache: the dense chunk route, counted in
    flash.ATTN_DENSE_ROUTES three times a forward; a NoPE layer on the
    flash kernel) on the card against the CPU: a 30-token prompt (every
    expert: qmm_stack) and a 9-token one (qmm_gather), three decode steps
    each, within NMSE 1e-3; the decode graph's ids against the same
    engine's eager steps."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    gpu, cpu = Engine(path, max_seq=128), Engine(path, device="cpu", max_seq=128)
    chunked = 3 if shape == "tiny-llama4" else 0
    for n in (30, 9):
        ids = [int(t) for t in np.random.default_rng(n).integers(5, 370, size=n)]
        gpu.reset()
        cpu.reset()
        before = sum(flash.ATTN_DENSE_ROUTES.values())
        errs = [_nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
        for tok in (3, 17, 5):
            errs.append(_nmse(torch.from_numpy(gpu.decode_step(tok)),
                              torch.from_numpy(cpu.decode_step(tok))))
        torch.cuda.synchronize()
        assert sum(flash.ATTN_DENSE_ROUTES.values()) - before == 4 * chunked
        assert max(errs) <= 1e-3, (shape, n, errs)
        gpu.reset()
        graph = gpu.generate_tokens_device(ids, 8, chunk=4)
        gpu.reset()
        eager = [int(np.argmax(gpu.prefill(ids)))]
        with torch.inference_mode():
            for _ in range(7):
                logits = gpu._decode_logits(torch.tensor(eager[-1], device=gpu.device))
                eager.append(int(torch.argmax(logits)))
        assert graph == eager, (shape, graph, eager)


def test_route_sparsemixer_captures_in_a_graph(dev):
    """route_sparsemixer reads nothing back to the host: captured as a CUDA
    graph, its replay on new logits gives the eager call's ids and weights
    (seeded logits, and rows at the band's edge and with ties)."""
    from tpullm_torch.ops.moe import route_sparsemixer

    gen = torch.Generator(dev).manual_seed(3)
    logits = torch.randn(64, 16, generator=gen, device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        route_sparsemixer(logits)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            w, idx = route_sparsemixer(logits)
    torch.cuda.current_stream(dev).wait_stream(stream)
    edge = torch.full((64, 16), -3.0, device=dev)
    edge[:, 3], edge[:, 9] = 2.0, 2.0 - 0.04 * torch.linspace(0.9, 1.1, 64, device=dev)
    edge[::7, 5] = 2.0  # ties with expert 3
    for new in (torch.randn(64, 16, generator=gen, device=dev), edge):
        logits.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want_w, want_idx = route_sparsemixer(new)
        assert torch.equal(idx, want_idx) and torch.equal(w, want_w)


# the 2-D linears of the recurrent card models at their Q4_K_M types:
# Falcon-Mamba-7B's ssm_in, ssm_x (N = 256 + 2·16), ssm_dt (K = dt rank 256)
# and ssm_out; Mamba-Codestral-7B's ssm_in (N = 2·8192 + 2·8·128 + 128); Jamba's
# attention and dense FFN (Mini-1.5: 4096 → 1024 KV, 14336 down); Granite-4.0-H-
# Tiny's ssm_in (N = 2·3072 + 2·128 + 48), ssm_out, attention and shared expert
RECURRENT_QMM_SHAPES = [("Q4_K", 4096, 16384), ("Q4_K", 8192, 288), ("Q4_K", 256, 8192),
                        ("Q4_K", 8192, 4096), ("Q4_K", 4096, 18560), ("Q4_K", 4096, 1024),
                        ("Q6_K", 14336, 4096), ("Q4_K", 1536, 6448), ("Q4_K", 3072, 1536),
                        ("Q4_K", 1536, 512), ("Q4_K", 1024, 1536)]


@pytest.mark.parametrize("M", [1, 512])
@pytest.mark.parametrize("name,K,N", RECURRENT_QMM_SHAPES,
                         ids=["ssm_in", "ssm_x", "ssm_dt", "ssm_out", "codestral-ssm_in",
                              "jamba-kv", "jamba-down", "granite-ssm_in", "granite-ssm_out",
                              "granite-kv", "granite-shexp-down"])
def test_qmm_at_recurrent_shapes(dev, name, K, N, M):
    """qmm at the recurrent models' 2-D shapes: a decode row (CUDA cores) and
    a 512-token ladder chunk (tensor cores), one launch of the regime's
    kernel, within the bound of its plain version."""
    planes = _planes(name, N, K, dev, seed=K + N + M)
    x = torch.randn(M, K, generator=torch.Generator(dev).manual_seed(M), device=dev)
    x = x.to(torch.bfloat16)
    tc = M >= qmm.TC_MIN_M
    before = qmm.LAUNCHES[name], qmm.TC_LAUNCHES[name]
    got = qmm.qmm(x, planes, GGMLType[name], N, K)
    torch.cuda.synchronize()
    assert (qmm.LAUNCHES[name], qmm.TC_LAUNCHES[name]) == (before[0] + (not tc),
                                                           before[1] + tc)
    ref = qmm.qmm_reference(x, planes, GGMLType[name], N, K)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("E,top,name,K,N", [(16, 2, "Q4_K", 4096, 14336),
                                            (16, 2, "Q6_K", 14336, 4096),
                                            (64, 6, "Q4_K", 1536, 512),
                                            (64, 6, "Q4_K", 512, 1536)],
                         ids=["jamba-gate", "jamba-down", "granite-gate", "granite-down"])
def test_expert_kernels_at_recurrent_shapes(dev, E, top, name, K, N):
    """Jamba-Mini-1.5's (16 experts top-2) and Granite-4.0-H-Tiny's (64
    top-6) expert stacks: qmm_gather at one decode token's top-k and
    qmm_stack at a 512-token chunk, one launch each, within the bound."""
    stack = _stack(name, E, N, K, dev, seed=E + K)
    g = torch.Generator(dev).manual_seed(E)
    x = torch.randn(top, K, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randperm(E, generator=g, device=dev)[:top].int()
    before = qmm.GATHER_LAUNCHES[name], qmm.STACK_LAUNCHES[name]
    got = qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N, K)
    xs = torch.randn(512, K, generator=g, device=dev).to(torch.bfloat16)
    got_s = qmm.qmm_stack(xs, stack.planes, stack.gtype, N, K)
    torch.cuda.synchronize()
    assert (qmm.GATHER_LAUNCHES[name], qmm.STACK_LAUNCHES[name]) == (before[0] + 1,
                                                                     before[1] + 1)
    ref = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, N, K)
    assert _nmse(got.float(), ref.float()) <= QMM_NMSE_BOUND
    ref = qmm.qmm_stack_reference(xs, stack.planes, stack.gtype, N, K)
    assert torch.isfinite(got_s.float()).all()
    assert _nmse(got_s.float(), ref.float()) <= QMM_NMSE_BOUND


@pytest.mark.parametrize("shape", ["tiny-mamba", "tiny-falcon-mamba", "tiny-mamba2",
                                   "tiny-jamba", "tiny-nemotron-h", "tiny-granite-h",
                                   "tiny-nemotron-h-moe", "tiny-falcon-h1"])
def test_recurrent_engines_on_the_card_match_the_cpu(dev, tmp_path, shape):
    """The tiny recurrent models on the card against the CPU: a 13-token
    prompt (ladder chunks 8 and 1) and three decode steps within NMSE 1e-3;
    the decode graph's ids against the same engine's eager steps; on a
    3-slot BatchEngine an idle slot's state (and K/V) bit-for-bit unchanged
    by the others' prefill and decode steps, a freed slot's zero."""
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    gpu, cpu = Engine(path, max_seq=64), Engine(path, device="cpu", max_seq=64)
    ids = [int(t) for t in np.random.default_rng(13).integers(5, 370, size=13)]
    errs = [_nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (3, 17, 5):
        errs.append(_nmse(torch.from_numpy(gpu.decode_step(tok)),
                          torch.from_numpy(cpu.decode_step(tok))))
    assert max(errs) <= 1e-3, (shape, errs)
    gpu.reset()
    graph = gpu.generate_tokens_device(ids, 8, chunk=4)
    gpu.reset()
    eager = [int(np.argmax(gpu.prefill(ids)))]
    with torch.inference_mode():
        for _ in range(7):
            logits = gpu._decode_logits(torch.tensor(eager[-1], device=gpu.device))
            eager.append(int(torch.argmax(logits)))
    assert graph == eager, (shape, graph, eager)
    be = BatchEngine(gpu.model, n_slots=3, max_seq=64)
    be.prefill_slots({1: ids[:11]})
    keep = [a[:, 1].clone() for a in vars(be.cache).values() if isinstance(a, torch.Tensor)]
    be.prefill_slots({0: ids, 2: ids[:5]})
    be.decode_batch({0: 11, 2: 12})
    be.decode_batch_greedy({0: 13})
    now = [a[:, 1] for a in vars(be.cache).values() if isinstance(a, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(keep, now))
    be.free_slot(0)
    assert not be.cache.conv[:, 0].any() and not be.cache.ssm[:, 0].any()
