"""Port parity for the routes around the kernels: the dequantize-then-matmul
route for the shapes no qmm kernel takes and the dense attention path for
the head dims the flash kernel does not take (each against the JAX
package's route for the shapes its kernels refuse), the regime predicates
and tile plans of the qmm kernels, and the Engine's generation up to the
context end against the JAX Engine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.gguf.reader import GGUFTensorInfo as JInfo
from tpullm.models.weights import QuantLinear as JQuantLinear
from tpullm.models.weights import quant_expert_stack as jquant_expert_stack
from tpullm.ops import attention as jattn
from tpullm.ops import qmatmul as jqm
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFTensorInfo
from tpullm_torch.models.synth import make_synthetic_llama_gguf, random_packed
from tpullm_torch.models.weights import QuantLinear, load_expert_stack
from tpullm_torch.ops import attention, qmatmul
from tpullm_torch.ops.kernels import flash, qmm
from tpullm_torch.runtime.engine import Engine

FORMATS = ["Q4_K", "Q6_K", "Q5_K", "Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "MXFP4", "IQ4_NL",
           "Q2_K", "Q3_K", "IQ4_XS", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S",
           "IQ1_M", "TQ1_0", "TQ2_0"]
# the expert formats the JAX package keeps packed in a stack, one per code layout
STACK_FORMATS = ["Q4_K", "Q5_0", "Q2_K", "Q6_K"]
N_SM = 132  # the H100's SMs


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the dequantize-then-matmul route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FORMATS)
def test_matmul_dequant_matches_jax_matmul_reference(name):
    """N = 250 (N % 4 != 0): a shape no qmm kernel takes, which the JAX
    package sends to matmul_reference. Both dequantize in f32, round once to
    bf16 and run one product with a bf16 output: NMSE ≤ 1e-5 covers the f32
    sum order and the bf16 output rounding."""
    n_out, n_in, M = 250, 512, 9
    assert not qmm.takes(n_in, n_out)
    data = random_packed(np.random.default_rng(11), GGMLType[name], n_out * n_in)
    jplanes = jqm.upload_planes(jqm.repack_np(data, JGGMLType[name], n_out, n_in))
    x = np.random.default_rng(12).standard_normal((M, n_in)).astype(np.float32)
    ref = jqm.matmul_reference(jnp.asarray(x, jnp.bfloat16),
                               JQuantLinear(JGGMLType[name], n_out, n_in, jplanes))
    ql = QuantLinear(GGMLType[name], n_out, n_in,
                     qmatmul.repack(data, GGMLType[name], n_out, n_in, "cpu"))
    got = qmatmul.matmul_dequant(_bf16(x), ql)
    assert got.dtype == torch.bfloat16 and got.shape == (M, n_out)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


def _stacks(name, n_out, n_in, seed, e=4):
    data = random_packed(np.random.default_rng(seed), GGMLType[name], e * n_out * n_in)
    shape = (n_in, n_out, e)
    port = GGUFTensorInfo("blk.0.ffn_up_exps.weight", GGMLType[name], shape, 0, data)
    ref = JInfo("blk.0.ffn_up_exps.weight", JGGMLType[name], shape, 0, data)
    # the JAX package would load a stack of this shape dense: its planes, directly
    return load_expert_stack(port, "cpu"), jquant_expert_stack(ref)


@pytest.mark.parametrize("name", STACK_FORMATS)
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_stack_matmul_dequant_matches_jax_reference(name, batched):
    """Against stack_matmul_reference, at N = 250; NMSE ≤ 1e-5 as above."""
    stack, jstack = _stacks(name, 250, 256, seed=21)
    x = np.random.default_rng(22).standard_normal((4, 6, 256) if batched else (6, 256))
    x = x.astype(np.float32)
    ref = jqm.stack_matmul_reference(jnp.asarray(x, jnp.bfloat16), jstack)
    got = qmatmul.stack_matmul_dequant(_bf16(x), stack)
    assert got.shape == (4, 6, 250)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("name", STACK_FORMATS)
def test_gather_matmul_dequant_matches_jax_reference(name):
    """Against gather_matmul_reference, a repeated expert among the ids."""
    stack, jstack = _stacks(name, 250, 256, seed=31)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    ids = np.array([2, 0, 3, 2, 1], np.int32)
    ref = jqm.gather_matmul_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ids), jstack)
    got = qmatmul.gather_matmul_dequant(_bf16(x), torch.from_numpy(ids), stack)
    assert got.shape == (5, 250)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


def test_cpu_tensors_never_take_the_dequant_route():
    """On the CPU every shape goes to the kernel's plain version; the route
    and its count are the card's."""
    data = random_packed(np.random.default_rng(5), GGMLType.Q6_K, 250 * 256)
    ql = QuantLinear(GGMLType.Q6_K, 250, 256, qmatmul.repack(data, GGMLType.Q6_K, 250, 256, "cpu"))
    x = _bf16(np.random.default_rng(6).standard_normal((3, 256)).astype(np.float32))
    before = dict(qmm.DEQUANT_ROUTES)
    y = ql(x)
    assert qmm.DEQUANT_ROUTES == before
    assert torch.equal(y, qmm.qmm_reference(x, ql.planes, GGMLType.Q6_K, 250, 256))


# ---------------------------------------------------------------------------
# regimes and tile plans
# ---------------------------------------------------------------------------

def _route(M: int, K: int, N: int) -> str:
    if not qmm.takes(K, N):
        return "dequant"
    return "tensor_core" if M >= qmm.TC_MIN_M else "cuda_core"  # as qmm.qmm picks


@pytest.mark.parametrize("M,K,N,want", [
    (1, 4096, 28672, "cuda_core"),     # decode
    (8, 4096, 28672, "cuda_core"),     # the prefill bucket of 8
    (15, 4096, 4096, "cuda_core"),
    (16, 4096, 4096, "tensor_core"),   # the prefill bucket of 16
    (512, 14336, 4096, "tensor_core"),
    (1, 4096, 32001, "dequant"),       # a Llama-2 fine-tune's head
    (512, 4096, 250, "dequant"),
    (16, 4160, 4096, "dequant"),       # K % 256 != 0 (a 32-block format's K)
])
def test_qmm_regime_by_shape(M, K, N, want):
    assert _route(M, K, N) == want


@pytest.mark.parametrize("M,K,N,batches,gemv,want", [
    (16, 14336, 4096, 1, False, (qmm.TC_TILE, 8, 7)),    # 32 tiles: K split 8 ways
    (512, 14336, 4096, 1, False, (qmm.TC_TILE, 2, 28)),  # 128 tiles: split 2 ways
    (512, 4096, 28672, 1, False, (qmm.TC_TILE, 1, 16)),
    (512, 4096, 14336, 8, False, (qmm.TC_TILE, 1, 16)),
    (1, 512, 768, 4, False, (qmm.TC_TILE, 2, 1)),  # the stack has no CUDA-core regime
    (9, 4096, 4096, 1, True, (8, 4, 4)),  # two row tiles of 8: 64 tiles split 4 ways
    (16, 4096, 28672, 1, False, (qmm.TC_TILE, 1, 16)),  # the bucket of 16, 8B gate_up: 224 tiles
    (16, 4096, 6144, 1, False, (qmm.TC_TILE, 4, 4)),    # 48 tiles: 4 splits of 4 chunks
])
def test_qmm_plan_tiles(M, K, N, batches, gemv, want):
    """`plan` (the tensor-core body: qmm and qmm_grouped from TC_MIN_M rows,
    qmm_stack) or, with `gemv`, `gemv_plan` (qmm below TC_MIN_M rows); that
    qmm_grouped launches by the same plans as qmm is
    test_qmm_and_qmm_grouped_launch_by_one_plan."""
    if gemv:
        tm, split, per = qmm.gemv_plan(M, K, N, N_SM)
    else:
        tm, split, per = qmm.plan(M, K, N, N_SM, batches=batches)
    assert (tm, split, per) == want
    n_chunks = K // 256
    assert split * per >= n_chunks > (split - 1) * per  # every chunk once
    if not gemv and split > 1:  # a split keeps the blocks within one wave
        tiles = -(-M // qmm.TC_TILE) * -(-N // qmm.TC_TILE) * batches
        assert tiles * split <= N_SM * qmm.TC_BLOCKS


@pytest.mark.parametrize("grouped", [False, True], ids=["qmm", "grouped"])
@pytest.mark.parametrize("M,K,N", [(1, 4096, 28672), (8, 14336, 4096), (15, 4096, 4096),
                                   (16, 4096, 28672), (16, 14336, 4096), (37, 4096, 6144),
                                   (512, 4096, 28672), (512, 14336, 4096)])
def test_qmm_and_qmm_grouped_launch_by_one_plan(M, K, N, grouped, monkeypatch):
    """The wrapper's path to the card, on the CPU with the library calls
    recorded instead of made: qmm and qmm_grouped plan alike, from TC_MIN_M
    rows the tensor-core entry of the format's library with `plan`'s split
    (qmm_grouped: tpullm_qmm_grouped_tc, not a kernel of its own tiles),
    below it the gemv entry with `gemv_plan`'s; each call counted once, in
    TC_LAUNCHES, LAUNCHES or GROUPED_LAUNCHES."""
    calls = []

    def bind(lib, entry, argtypes):
        def fn(*args):
            calls.append((lib, entry, len(argtypes), args))
            return 0
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(qmm, "_check", lambda *a: [torch.zeros(1)] * 4)
    monkeypatch.setattr(qmm._build, "bind", bind)
    monkeypatch.setattr(qmm._build, "n_sm", lambda dev: N_SM)
    monkeypatch.setattr(qmm._build, "counters", lambda dev, stream, n: torch.zeros(n))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    counts = {name: dict(getattr(qmm, name)) for name in
              ("LAUNCHES", "TC_LAUNCHES", "GROUPED_LAUNCHES")}
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    out = (qmm.qmm_grouped if grouped else qmm.qmm)(x, {}, GGMLType.Q4_K, N, K)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    (lib, entry, n_args, args), = calls
    assert lib == f"qmm{qmm._FAMILY[GGMLType.Q4_K]}" and n_args == len(args)
    base = "tpullm_qmm_grouped" if grouped else "tpullm_qmm"
    if M >= qmm.TC_MIN_M:
        tm, split, per = qmm.plan(M, K, N, N_SM)
        assert tm == qmm.TC_TILE
        assert (entry, args[-6:-1]) == (base + "_tc", (M, K, N, split, per))
        counted = "GROUPED_LAUNCHES" if grouped else "TC_LAUNCHES"
    else:
        tm, split, per = qmm.gemv_plan(M, K, N, N_SM)
        assert (entry, args[-7:-1]) == (base, (M, K, N, tm, split, per))
        counted = "GROUPED_LAUNCHES" if grouped else "LAUNCHES"
    assert (args[7] is None) == (split == 1)  # the partials only for a split K
    for name, before in counts.items():
        want = before["Q4_K"] + (name == counted)
        assert getattr(qmm, name)["Q4_K"] == want, name


@pytest.mark.parametrize("d,dv,want", [(64, 64, True), (128, 128, True), (80, 80, False),
                                       (96, 96, False), (256, 256, False), (192, 128, False)])
def test_flash_takes_head_dims(d, dv, want):
    assert flash.takes(d, dv) is want


# ---------------------------------------------------------------------------
# the dense attention path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dv,softcap,window", [(80, 80, 0.0, 0), (96, 96, 0.0, 0),
                                                 (96, 96, 30.0, 0), (80, 80, 0.0, 12),
                                                 (192, 128, 0.0, 0)])
def test_dense_attention_matches_jax_attention(d, dv, softcap, window):
    """The card's dense path (attention_reference under the causal mask of
    the offsets) against the JAX package's `attention` dispatch on shapes
    its flash kernel refuses: both f32 from bf16 inputs, bf16 output."""
    B, T, H, Hkv, S = 2, 7, 4, 2, 40
    rng = np.random.default_rng(d + dv + window)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, dv)).astype(np.float32)
    off = np.array([0, 25], np.int32)
    scale = d ** -0.5
    positions = off[:, None] + np.arange(T)[None]
    jmask = jattn.causal_mask(jnp.asarray(positions), S, jnp.asarray(off + T), window)
    ref = jattn.attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16), jmask, scale, softcap,
                          offsets=jnp.asarray(off), sliding_window=window)
    got = attention._attention_dense(_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(off),
                                     scale, softcap, window, None, None)
    assert got.shape == (B, T, H, dv) and got.dtype == torch.bfloat16
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


@pytest.mark.parametrize("d", [80, 96])
def test_attention_reference_matches_jax_at_other_head_dims(d):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 5, 4, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 16, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 16, d)).astype(np.float32)
    positions = np.arange(3, 8)[None]
    mask = attention.causal_mask(torch.from_numpy(positions), 16, 8)
    jmask = jattn.causal_mask(jnp.asarray(positions), 16, 8)
    got = attention.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), mask, d ** -0.5)
    ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                    d ** -0.5)
    assert _nmse(got.numpy(), np.asarray(ref)) <= 1e-10


def test_dense_attention_with_sinks_matches_jax():
    """Sinks on a refused head dim: the JAX package's dense sink path."""
    rng = np.random.default_rng(3)
    B, T, H, Hkv, S, d = 1, 6, 4, 2, 24, 96
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
    sinks = rng.standard_normal(H).astype(np.float32)
    off = np.array([10], np.int32)
    positions = off[:, None] + np.arange(T)[None]
    jmask = jattn.causal_mask(jnp.asarray(positions), S, jnp.asarray(off + T))
    ref = jattn.attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16), jmask, d ** -0.5,
                          offsets=jnp.asarray(off), sinks=jnp.asarray(sinks))
    got = attention._attention_dense(_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(off),
                                     d ** -0.5, 0.0, 0, torch.from_numpy(sinks), None)
    assert _nmse(got.float().numpy(), np.asarray(ref, np.float32)) <= 1e-5


# ---------------------------------------------------------------------------
# Engines: a 250-token head, and generation up to the context end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vocab250_gguf(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("v250") / "tiny-v250.gguf",
                                     shape="tiny", seed=0, n_vocab=250)


def test_vocab_250_model_matches_jax(vocab250_gguf):
    """The tiny model with a 250-token Q6_K head (N % 4 != 0: on the card it
    takes the dequantize-then-matmul route): logits NMSE ≤ 1e-3 at the
    prefill and 8 decode steps, and the same 16 greedy ids."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        je = JEngine(vocab250_gguf, max_seq=128, kv_dtype=jnp.bfloat16)
    te = Engine(vocab250_gguf, device="cpu", max_seq=128)
    assert te.hp.n_vocab == 250 and te.params["output"].n_out == 250
    ids = te.tokenizer.tokenize("hello world the quick brown fox", add_special=True)
    assert ids == je.tokenizer.tokenize("hello world the quick brown fox", add_special=True)
    errs = [_nmse(te.prefill(ids), je.prefill(ids))]
    for tok in (100, 17, 42, 200, 5, 249, 64, 3):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= 1e-3, errs
    je.reset()
    te.reset()
    ref = [int(np.argmax(je.prefill(ids)))]
    while len(ref) < 16:
        ref.append(int(np.argmax(je.decode_step(ref[-1]))))
    assert te.generate_tokens_device(ids, 16, temp=0.0) == ref


def _generate_to_end(path, monkeypatch, prompt: str):
    max_seq = 64
    if "moe" in str(path):
        monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")  # the load the port mirrors
    je = JEngine(path, max_seq=max_seq, kv_dtype=jnp.bfloat16)
    te = Engine(path, device="cpu", max_seq=max_seq)
    ids = te.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    ref = list(je.generate_tokens(ids, 200))
    got = te.generate_tokens_device(ids, 200, temp=0.0, to_end=True)
    return ids, ref, got, te, je


@pytest.mark.parametrize("shape,prompt", [("tiny", "hello world"), ("tiny-moe", "hello world")])
def test_generate_runs_to_the_context_end_as_jax(tmp_path, monkeypatch, shape, prompt):
    """max_new_tokens past the end: the JAX generate yields one id per
    position from the prompt's end up to n_past == max_seq, the last one
    included; the port's chunks stop 32 positions short of it and the rest
    runs token by token to the same ids."""
    path = make_synthetic_llama_gguf(tmp_path / f"{shape}.gguf", shape=shape, seed=0)
    ids, ref, got, te, je = _generate_to_end(path, monkeypatch, prompt)
    assert len(ref) == 64 - len(ids) + 1
    assert got == ref and te.n_past == 64
    te.reset()
    je.reset()
    assert te.generate(prompt, 200) == je.generate(prompt, 200)
