"""Card-only tests of tpullm_torch: each CUDA kernel against its plain
version on the card, and a short Engine run of the tiny model. They skip
without an NVIDIA GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

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
    from tpullm_torch.gguf.reader import GGUFTensorInfo
    from tpullm_torch.models.synth import random_packed
    from tpullm_torch.models.weights import load_expert_stack

    raw = random_packed(np.random.default_rng(seed), GGMLType[name], E * n_out * n_in)
    info = GGUFTensorInfo("blk.0.ffn_up_exps.weight", GGMLType[name], (n_in, n_out, E), 0, raw)
    return load_expert_stack(info, dev)


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
    step of a schedule after a warm-up step of the same calls (a profile
    that starts with them can miss their first kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    names: list[str] = []

    def ready(prof):
        names.extend(f"{e.key} ×{e.count}" for e in prof.key_averages()
                     if "qmm" in e.key and getattr(e, "self_device_time_total", 0) > 0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
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
    attend, _, _ = _flash_inputs(dev, False, 2, 1, 32, 8, 4096, 128, (37, 3000), 6, False)
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


def _flash_inputs(dev, q8, B, T, H, Hkv, S, D, offsets, seed, extras):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    kw = dict(softcap=0.0, sliding_window=0, sinks=None, alibi_slopes=None)
    if extras:
        kw = dict(softcap=30.0, sliding_window=100,
                  sinks=torch.randn(H, generator=g, device=dev),
                  alibi_slopes=torch.linspace(0.5, 0.01, H, device=dev))
    if not q8:
        return (lambda: flash.flash_attention(q, k, v, off, D ** -0.5, **kw),
                lambda: flash.flash_reference(q, k, v, off, D ** -0.5, **kw), FLASH_NMSE_BOUND)
    from tpullm_torch.runtime.kvcache import QuantKVCache

    k_q, k_s = QuantKVCache._quantize(k)
    v_q, v_s = QuantKVCache._quantize(v)
    return (lambda: flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, D ** -0.5, **kw),
            lambda: flash.flash_reference(q, k_q, v_q, off, D ** -0.5, k_scale=k_s,
                                          v_scale=v_s, **kw), FLASH_Q8_NMSE_BOUND)


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "cap-win-sink-alibi"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 4, 8, 16, 40, 512])
def test_flash_regimes_match_plain(dev, T, D, q8, extras):
    """Both regimes (GQA 8/2: T ≤ 4 is the split-KV decode, T ≥ 8 the
    tensor-core prefill) at kv_len 1, 31, 32, 33, 4095 and 4096 of S = 4096
    (the second batch at another kv_len), each call one launch, counted in
    its regime, and bit-identical when repeated back to back."""
    B, H, Hkv, S = 2, 8, 2, 4096
    decode = flash.regime(T, H, Hkv) == "decode"
    for kv_len in (1, 31, 32, 33, 4095, 4096):
        if kv_len < T:
            continue
        offsets = (kv_len - T, (7 * kv_len + 1000) % (S - T + 1))
        kernel, plain, bound = _flash_inputs(dev, q8, B, T, H, Hkv, S, D, offsets,
                                             seed=T + kv_len + D, extras=extras)
        fmt = "q8" if q8 else "bf16"
        before = flash.LAUNCHES[fmt], flash.DECODE_LAUNCHES[fmt]
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert (flash.LAUNCHES[fmt], flash.DECODE_LAUNCHES[fmt]) == \
            (before[0] + 2, before[1] + 2 * decode)
        ref = plain()
        assert got.shape == (B, T, H, D) and torch.isfinite(got.float()).all()
        assert _nmse(got.float(), ref.float()) <= bound, kv_len
        assert torch.equal(got, again), kv_len


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("T,S,D,softcap,window,sinks,alibi", [
    (1, 100, 128, 0.0, 0, False, False),
    (40, 300, 64, 0.0, 0, False, False),
    (40, 300, 128, 30.0, 0, False, False),
    (17, 256, 64, 0.0, 48, False, False),
    (1, 256, 128, 0.0, 0, True, False),
    (33, 200, 64, 0.0, 0, False, True),
    (20, 160, 128, 25.0, 32, True, True),
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


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_engine_on_the_card_matches_the_cpu(dev, tmp_path, kv):
    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp_path / "tiny.gguf", shape="tiny", seed=0)
    kv_dtype = torch.bfloat16 if kv == "bf16" else "q8_0"
    gpu = Engine(path, max_seq=256, kv_dtype=kv_dtype)
    cpu = Engine(path, device="cpu", max_seq=256, kv_dtype=kv_dtype)
    assert gpu.device.type == "cuda"
    ids = gpu.tokenizer.tokenize("the quick brown fox", add_special=True)
    before = qmm.LAUNCHES["Q4_K"], flash.LAUNCHES["q8" if kv == "q8_0" else "bf16"]
    a, b = gpu.prefill(ids), cpu.prefill(ids)
    assert np.isfinite(a).all() and _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    for tok in (300, 17, 42):
        a, b = gpu.decode_step(tok), cpu.decode_step(tok)
        assert _nmse(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-3
    after = qmm.LAUNCHES["Q4_K"], flash.LAUNCHES["q8" if kv == "q8_0" else "bf16"]
    assert after[0] > before[0] and after[1] == before[1] + 4 * gpu.hp.n_layer
    gpu.reset()
    cpu.reset()
    assert gpu.generate_tokens_device(ids, 8) == cpu.generate_tokens_device(ids, 8)


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
    take its stack and gather forms; a head dim of 96 takes the counted
    dense attention path."""
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
    cache = KVCache(torch.randn(1, 1, 2, 64, 96, generator=g, device=dev).to(torch.bfloat16),
                    torch.randn(1, 1, 2, 64, 96, generator=g, device=dev).to(torch.bfloat16))
    q = torch.randn(1, 9, 8, 96, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor([20], dtype=torch.int32, device=dev)
    before = flash.ATTN_DENSE_ROUTES["bf16"], dict(flash.LAUNCHES)
    got = attention.attention_cached(q, cache, 0, 96 ** -0.5, off)
    ref = flash.flash_reference(q, cache.k[0], cache.v[0], off, 96 ** -0.5)
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
    before = (sum(qmm.LAUNCHES.values()), flash.DECODE_LAUNCHES[fmt],
              sum(qmm.GATHER_LAUNCHES.values()))
    got = eng.generate_tokens_device(ids, 200, chunk=8, to_end=True)
    torch.cuda.synchronize()
    assert got == ref and eng.n_past == 40
    runner = eng.decode_runner(SamplingParams(), 8)
    per = _forward_launches(eng.params)
    assert runner.launches_per_replay() == {
        "qmm": per["qmm"], "qmm_tc": 0, "qmm_stack": 0, "qmm_gather": per["experts"],
        "qmm_grouped": 0, "dequant_routes": 0, "flash": per["flash"],
        "flash_decode": per["flash"], "attn_dense_routes": 0}
    assert runner.replays == 40 - len(ids) - 1  # the first step ran eagerly, before the capture
    forwards = 1 + (40 - len(ids))  # the prefill (bucket 8: the same regimes) and the steps
    after = (sum(qmm.LAUNCHES.values()), flash.DECODE_LAUNCHES[fmt],
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
