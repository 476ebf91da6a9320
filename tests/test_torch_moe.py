"""Port parity for the MoE path: routing, the expert-stack load, the plain
versions of the qmm_stack and qmm_gather kernels, and moe_ffn in both
regimes (tpullm_torch) against the JAX package's, whose stack and gather
Pallas kernels run in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.gguf.reader import GGUFTensorInfo as JInfo
from tpullm.models.weights import load_expert_stack as jload_expert_stack
from tpullm.ops import moe as jmoe
from tpullm.ops.pallas import qmm as jqmm

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFTensorInfo
from tpullm_torch.models.synth import random_packed
from tpullm_torch.models.weights import QuantExpertStack, load_expert_stack
from tpullm_torch.ops import moe, qmatmul
from tpullm_torch.ops.kernels import qmm

E, N_EMBD, N_FF = 4, 256, 512
# every plane format of the expert kernels
FORMATS = ["Q4_K", "Q6_K", "Q5_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4", "IQ4_NL",
           "Q2_K", "Q3_K", "IQ4_XS"]


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _stack_infos(name, n_out, n_in, seed, e=E):
    """The same packed expert stack (ggml ne (n_in, n_out, E)) as the port's
    and the JAX package's tensor info."""
    data = random_packed(np.random.default_rng(seed), GGMLType[name], e * n_out * n_in)
    shape = (n_in, n_out, e)
    port = GGUFTensorInfo("blk.0.ffn_up_exps.weight", GGMLType[name], shape, 0, data)
    ref = JInfo("blk.0.ffn_up_exps.weight", JGGMLType[name], shape, 0, data)
    return port, ref


def _stacks(name, n_out, n_in, seed, e=E):
    port, ref = _stack_infos(name, n_out, n_in, seed, e)
    return load_expert_stack(port, "cpu"), jload_expert_stack(ref)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _tied_logits() -> np.ndarray:
    rng = np.random.default_rng(0)
    rows = [
        [1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # three-way tie across the top-2 edge
        [0.5] * 8,  # all tied
        [0.0, 2.0, 0.0, 2.0, 0.0, 2.0, 0.0, 2.0],
        [-1.0, 3.0, 3.0, -1.0, 0.2, 3.0, 0.2, 0.2],
    ]
    r = rng.standard_normal((12, 8)).astype(np.float32)
    r[:, 5] = r[:, 2]  # ties inside random rows
    return np.concatenate([np.asarray(rows, np.float32), r])


@pytest.mark.parametrize("gating,norm,bias", [
    ("softmax", True, False), ("softmax", False, False), ("sigmoid", True, False),
    ("softmax", True, True)])
def test_route_matches_jax_with_ties(gating, norm, bias):
    """Ids equal, ties going to the lower expert id as jax.lax.top_k does;
    weights within 1e-6 (f32 softmax in two frameworks)."""
    logits = _tied_logits()
    sb = np.linspace(0.0, 0.3, 8).astype(np.float32) if bias else None
    w_ref, i_ref = jmoe.route(jnp.asarray(logits), 2, gating=gating, norm_weights=norm,
                              select_bias=None if sb is None else jnp.asarray(sb))
    w, i = moe.route(torch.from_numpy(logits), 2, gating=gating, norm_weights=norm,
                     select_bias=None if sb is None else torch.from_numpy(sb))
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# expert stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FORMATS)
def test_load_expert_stack_planes_bit_equal_to_jax(name):
    got, ref = _stacks(name, N_FF, N_EMBD, seed=1)
    assert isinstance(got, QuantExpertStack)
    assert (got.gtype, got.n_expert, got.n_out, got.n_in) == (GGMLType[name], E, N_FF, N_EMBD)
    assert got.shape == (E, N_EMBD, N_FF)
    assert sorted(got.planes) == sorted(ref.planes)
    for k, v in ref.planes.items():
        assert got.planes[k].dtype == (torch.bfloat16 if k in ("scale", "minus") else torch.uint8)
        np.testing.assert_array_equal(_np(got.planes[k]) if k in ("scale", "minus")
                                      else got.planes[k].numpy(),
                                      np.asarray(v, np.float32 if k in ("scale", "minus")
                                                 else np.uint8), err_msg=k)


def test_load_expert_stack_keeps_float_stacks_dense():
    w = np.random.default_rng(2).standard_normal((E, 32, 64)).astype(np.float32)  # (E, n_out, n_in)
    info = GGUFTensorInfo("blk.0.ffn_up_exps.weight", GGMLType.F32, (64, 32, E), 0,
                          w.reshape(-1).view(np.uint8))
    got = load_expert_stack(info, "cpu", dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), w.transpose(0, 2, 1))


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_stack_reference_matches_pallas_stack(name, batched):
    """The plain qmm_stack against _kernel_stack in interpret mode: the same
    rounding points, NMSE ≤ 1e-5 for the f32 sum order."""
    got_stack, ref_stack = _stacks(name, N_FF, N_EMBD, seed=3)
    rng = np.random.default_rng(4)
    M = 24
    x = rng.standard_normal((E, M, N_EMBD) if batched else (M, N_EMBD)).astype(np.float32)
    ref = jqmm.qmatmul_stack(jnp.asarray(x, jnp.bfloat16), ref_stack)
    got = qmatmul.stack_matmul(_bf16(x), got_stack)
    assert got.dtype == torch.bfloat16 and got.shape == (E, M, N_FF)
    assert _nmse(_np(got), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("T", [2, 9])
def test_gather_reference_matches_pallas_gather(name, T):
    """The plain qmm_gather against _kernel_gather in interpret mode, with
    ids that repeat an expert: NMSE ≤ 1e-5."""
    got_stack, ref_stack = _stacks(name, N_EMBD, N_FF, seed=5)
    rng = np.random.default_rng(6 + T)
    x = rng.standard_normal((T, N_FF)).astype(np.float32)
    ids = rng.integers(0, E, size=T).astype(np.int32)
    ids[-1] = ids[0]
    ref = jqmm.qmatmul_gather(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ids), ref_stack)
    got = qmatmul.gather_matmul(_bf16(x), torch.from_numpy(ids), got_stack)
    assert got.dtype == torch.bfloat16 and got.shape == (T, N_EMBD)
    assert _nmse(_np(got), np.asarray(ref, np.float32)) <= 1e-5


def test_gather_reference_is_per_row_qmm_reference():
    stack, _ = _stacks("Q4_K", N_EMBD, N_FF, seed=7)
    rng = np.random.default_rng(7)
    x = _bf16(rng.standard_normal((5, N_FF)).astype(np.float32))
    ids = torch.tensor([3, 0, 3, 1, 3], dtype=torch.int32)
    got = qmm.qmm_gather_reference(x, ids, stack.planes, stack.gtype, N_EMBD, N_FF)
    for t, e in enumerate(ids.tolist()):
        one = {k: v[e] for k, v in stack.planes.items()}
        row = qmm.qmm_reference(x[t:t + 1], one, stack.gtype, N_EMBD, N_FF)[0]
        assert _nmse(_np(got[t]), _np(row)) <= 1e-12


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    stack, _ = _stacks("Q6_K", N_FF, N_EMBD, seed=8)
    x = _bf16(np.random.default_rng(8).standard_normal((3, N_EMBD)).astype(np.float32))
    before = (dict(qmm.STACK_LAUNCHES), dict(qmm.GATHER_LAUNCHES))
    ids = torch.tensor([1, 2, 1], dtype=torch.int32)
    assert torch.equal(qmatmul.stack_matmul(x, stack), qmm.qmm_stack_reference(
        x, stack.planes, stack.gtype, N_FF, N_EMBD))
    assert torch.equal(qmatmul.gather_matmul(x, ids, stack), qmm.qmm_gather_reference(
        x, ids, stack.planes, stack.gtype, N_FF, N_EMBD))
    assert (qmm.STACK_LAUNCHES, qmm.GATHER_LAUNCHES) == before


def test_expert_kernel_wrappers_refuse_cpu_tensors_and_unported_formats():
    stack, _ = _stacks("Q4_K", N_FF, N_EMBD, seed=9)
    x = torch.zeros(2, N_EMBD, dtype=torch.bfloat16)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        qmm.qmm_stack(x, stack.planes, stack.gtype, N_FF, N_EMBD)
    with pytest.raises(ValueError):
        qmm.qmm_gather(x, ids, stack.planes, stack.gtype, N_FF, N_EMBD)
    # every format of the plane schema is ported; a type outside it is not
    for fn in (lambda g: qmm.qmm_stack(x, stack.planes, g, N_FF, N_EMBD),
               lambda g: qmm.qmm_gather(x, ids, stack.planes, g, N_FF, N_EMBD)):
        with pytest.raises(NotImplementedError):
            fn(GGMLType.Q8_1)


@pytest.mark.parametrize("T,K,N,expect", [(2, 4096, 14336, (2, 6, 3)), (2, 14336, 4096, (2, 4, 14)),
                                           (32, 4096, 14336, (8, 2, 8)),
                                           (32, 14336, 4096, (8, 7, 8))])
def test_gather_plan_splits_k_for_few_slots(T, K, N, expect):
    """Mixtral's gate and down on 132 SMs: at decode (2 slots, two experts'
    column tiles) the gather splits K as qmm M = 1 does over as many tiles
    (the gate's 224 tiles as the 8B gate_up's); at the 16-token bucket (32
    slots over 8 experts) x's 8 rows cap the chunks a split. Every chunk is
    covered once."""
    tm, split, per = qmm.gather_plan(T, 8, K, N, n_sm=132)
    assert (tm, split, per) == expect
    n_chunks = K // 256
    assert split * per >= n_chunks > (split - 1) * per
    if T == 2:  # the same split as the 2-D kernel over the same tiles
        assert (split, per) == qmm.gemv_plan(1, K, 2 * N, n_sm=132)[1:]


@pytest.mark.parametrize("T", [1, 2, 3, 8, 16, 32, 100, 300])
@pytest.mark.parametrize("E", [4, 8, 128])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (256, 4), (1024, 1028),
                                 (2048, 768)])
def test_gather_plan_covers_k_and_keeps_the_wave(T, E, K, N):
    """gather_plan: every chunk in exactly one split; x's rows cover the
    largest row tile (min(T, 8)) within GEMV_X_BYTES; the counters of a
    split output fit the buffer; with at most half a wave of the min(T, E)
    routed experts' column tiles, a split keeps their blocks in one wave
    of GEMV_WAVE_BLOCKS blocks an SM (unless x's limit asks for more
    splits), and K is split whenever those tiles leave half the wave
    empty; from a wave of tiles on, no split but x's."""
    n_sm = 132
    tm, split, per = qmm.gather_plan(T, E, K, N, n_sm)
    assert tm in qmm.GEMV_TMS and tm >= min(T, qmm.GEMV_TMS[-1])
    assert tm == 1 or tm // 2 < min(T, qmm.GEMV_TMS[-1])  # the least that covers
    n_chunks = K // 256
    assert 1 <= split <= n_chunks
    assert split * per >= n_chunks > (split - 1) * per
    assert tm * per * 256 * 2 <= qmm.GEMV_X_BYTES
    tiles = -(-N // qmm.GEMV_BLOCK_N) * min(T, E)
    assert split == 1 or tiles <= qmm._build.COUNTERS
    wave = qmm.GEMV_WAVE_BLOCKS * n_sm
    x_limited = per == qmm.GEMV_X_BYTES // (tm * 512)
    if 2 * tiles <= wave:
        assert split == 1 or tiles * split <= wave or x_limited
        assert split > 1 or n_chunks == 1
    if tiles >= wave:
        assert split == 1 or x_limited


def _gather_blocks(ids: list[int], E: int) -> tuple[list[tuple[int, list[list[int]]]], list[int]]:
    """The slot grouping of csrc/qmm_moe.cu's qmm_gather_kernel, in plain
    Python: grid row y (of min(T, E)) takes the y-th smallest expert that
    ids routes to (none past the distinct experts); its slots, in slot
    order 128 ids a round, run in row tiles of up to 8, each on the least
    of GEMV_TMS that covers it. Returns [(expert, [tile slots, ...]), ...]
    by row, and the slots whose id lies outside 0..E-1 (NaN rows)."""
    T = len(ids)
    routed = sorted({e for e in ids if 0 <= e < E})
    blocks = []
    for y in range(min(T, E)):
        if y >= len(routed):
            continue  # the block exits before its first copy
        e, tiles = routed[y], []
        for p in range(0, T, 128):
            slots = [t for t in range(p, min(T, p + 128)) if ids[t] == e]
            tiles += [slots[r:r + 8] for r in range(0, len(slots), 8)]
        blocks.append((e, tiles))
    return blocks, [t for t in range(T) if not 0 <= ids[t] < E]


def _ids_case(T: int, case: str, rng) -> np.ndarray:
    ids = rng.integers(0, E, size=T).astype(np.int32)
    if case == "repeated":
        ids[-1] = ids[0]
    elif case == "one expert":
        ids[:] = 2
    elif case == "invalid":
        ids[0], ids[T // 2] = E, -1
    return ids


@pytest.mark.parametrize("T", [1, 2, 16, 32])
@pytest.mark.parametrize("case", ["repeated", "one expert", "invalid"])
def test_gather_slot_grouping_matches_the_plain_version_and_jax(T, case):
    """The kernel's slot grouping (by expert, row tiles of up to 8, invalid
    ids to NaN rows), each tile through qmm_reference on its expert's
    planes, gives qmm_gather_reference's rows bit for bit and NaN rows for
    the invalid ids; the valid rows agree with the JAX qmatmul_gather in
    interpret mode within NMSE 1e-5 (the f32 sums in another order). Every
    slot is in exactly one tile or NaN; a tile's rows never exceed 8 and
    its TM is the least of GEMV_TMS that covers it; no expert is streamed
    more than ⌈its slots / 8⌉ times."""
    got_stack, ref_stack = _stacks("Q4_K", N_EMBD, N_FF, seed=30)
    rng = np.random.default_rng(31 + T)
    x = _bf16(rng.standard_normal((T, N_FF)).astype(np.float32))
    ids = _ids_case(T, case, rng)
    blocks, nan_slots = _gather_blocks(ids.tolist(), E)
    seen = [t for _, tiles in blocks for tile in tiles for t in tile] + nan_slots
    assert sorted(seen) == list(range(T))
    for e, tiles in blocks:
        assert len(tiles) == -(-int((ids == e).sum()) // 8)
        for tile in tiles:
            tm = next(t for t in qmm.GEMV_TMS if t >= len(tile))
            assert 1 <= len(tile) <= tm <= qmm.gather_plan(T, E, N_FF, N_EMBD, 132)[0]
    out = torch.full((T, N_EMBD), float("nan"), dtype=torch.bfloat16)
    for e, tiles in blocks:
        planes = {k: v[e] for k, v in got_stack.planes.items()}
        for tile in tiles:
            out[tile] = qmm.qmm_reference(x[tile], planes, got_stack.gtype, N_EMBD, N_FF)
    valid = torch.from_numpy((ids >= 0) & (ids < E))
    assert torch.isnan(out[~valid].float()).all() and torch.isfinite(out[valid].float()).all()
    if not valid.any():
        return
    vids = torch.from_numpy(ids)[valid]
    ref = qmm.qmm_gather_reference(x[valid], vids, got_stack.planes, got_stack.gtype, N_EMBD,
                                   N_FF)
    assert torch.equal(out[valid], ref)
    jref = jqmm.qmatmul_gather(jnp.asarray(x[valid].float().numpy(), jnp.bfloat16),
                               jnp.asarray(vids.numpy()), ref_stack)
    assert _nmse(_np(out[valid]), np.asarray(jref, np.float32)) <= 1e-5


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ffn_stacks():
    """Q4_K gate/up and a Q6_K down stack, as both packages load them."""
    return [_stacks("Q4_K", N_FF, N_EMBD, seed=10), _stacks("Q4_K", N_FF, N_EMBD, seed=11),
            _stacks("Q6_K", N_EMBD, N_FF, seed=12)]


@pytest.mark.parametrize("n_tokens", [4, 24], ids=["gather", "dense"])
def test_moe_ffn_matches_jax(ffn_stacks, n_tokens):
    """The same x, routing weights and ids through both packages' moe_ffn:
    NMSE ≤ 1e-5 (the same rounding points; f32 sums in another order, and
    the bf16 intermediates between the projections)."""
    (g, jg), (u, ju), (d, jd) = ffn_stacks
    rng = np.random.default_rng(13 + n_tokens)
    x = rng.standard_normal((n_tokens, N_EMBD)).astype(np.float32)
    logits = rng.standard_normal((n_tokens, E)).astype(np.float32)
    jw, ji = jmoe.route(jnp.asarray(logits), 2, norm_weights=True)
    ref = jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16), jw, ji, jg, ju, jd)
    got = moe.moe_ffn(_bf16(x), torch.from_numpy(np.array(jw)),
                      torch.from_numpy(np.array(ji)), g, u, d)
    assert got.dtype == torch.bfloat16 and got.shape == (n_tokens, N_EMBD)
    assert _nmse(_np(got), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("n_tokens", [4, 24], ids=["gather", "dense"])
@pytest.mark.parametrize("act", ["relu_sqr", "gelu"])
def test_gateless_weight_before_ffn_matches_jax(ffn_stacks, n_tokens, act):
    """Gateless experts with the routing weight on the input (llama4's
    placement), both regimes: NMSE ≤ 1e-5."""
    _, (u, ju), (d, jd) = ffn_stacks
    rng = np.random.default_rng(17 + n_tokens)
    x = rng.standard_normal((n_tokens, N_EMBD)).astype(np.float32)
    logits = rng.standard_normal((n_tokens, E)).astype(np.float32)
    jw, ji = jmoe.route(jnp.asarray(logits), 2)
    ref = jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16), jw, ji, None, ju, jd, act=act,
                       weight_before_ffn=True)
    got = moe.moe_ffn(_bf16(x), torch.from_numpy(np.array(jw)),
                      torch.from_numpy(np.array(ji)), None, u, d, act=act,
                      weight_before_ffn=True)
    assert _nmse(_np(got), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("n_tokens", [4, 24], ids=["gather", "dense"])
def test_moe_ffn_dense_stacks_match_jax(n_tokens):
    """Float expert stacks [E, n_in, n_out] (no kernel) in both regimes, f32:
    NMSE ≤ 1e-10."""
    rng = np.random.default_rng(21)
    wg, wu = (rng.standard_normal((E, 64, 96)).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.standard_normal((E, 96, 64)).astype(np.float32) * 0.1
    x = rng.standard_normal((n_tokens, 64)).astype(np.float32)
    jw, ji = jmoe.route(jnp.asarray(rng.standard_normal((n_tokens, E)).astype(np.float32)), 2)
    ref = jmoe.moe_ffn(jnp.asarray(x), jw, ji, jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd))
    got = moe.moe_ffn(torch.from_numpy(x), torch.from_numpy(np.array(jw)),
                      torch.from_numpy(np.array(ji)), torch.from_numpy(wg),
                      torch.from_numpy(wu), torch.from_numpy(wd))
    assert _nmse(got.numpy(), np.asarray(ref)) <= 1e-10


def test_gather_max_tokens_matches_jax():
    assert moe._GATHER_MAX_TOKENS == jmoe._GATHER_MAX_TOKENS == 16
