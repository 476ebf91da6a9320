"""The decode step that the card captures as a CUDA graph
(runtime/graph.py `DecodeRunner.step`), run eagerly on the CPU: the forward
at a device-tensor offset against the forward at the host int, the T = 1
cache write at a device offset against `_seq_write`, the generated ids
against the JAX package's generate_tokens_device and generate_tokens, and
the aten calls of one step (no value read back to the host: none a graph
would bake in)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.ops.sampling_ops import SamplingParams, sample_token
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.runtime.graph import DecodeRunner
from tpullm_torch.runtime.kvcache import KVCache, QuantKVCache, _seq_write

# aten calls that read a device value back to the host (a CUDA graph would
# bake the value in, or the capture fails)
HOST_READS = ("_local_scalar_dense", "nonzero", "unique", "item")


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph")
    return {shape: make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0)
            for shape in ("tiny", "tiny-moe")}


def _kv(kv):
    return torch.bfloat16 if kv == "bf16" else "q8_0"


def _cache_tensors(cache):
    return [cache.k, cache.v] if isinstance(cache, KVCache) else \
        [cache.k_q, cache.v_q, cache.k_s, cache.v_s]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_forward_at_a_device_offset_is_the_forward_at_the_int(ggufs, shape, kv):
    """After the same prefill, one decode forward at cache_offset = n (host
    int) and at a device int32 tensor holding n: bit-equal logits and
    caches."""
    a = Engine(ggufs[shape], device="cpu", max_seq=64, kv_dtype=_kv(kv))
    b = Engine(ggufs[shape], device="cpu", max_seq=64, kv_dtype=_kv(kv))
    ids = a.tokenizer.tokenize("hello world the quick brown fox")
    a.prefill(ids)
    b.prefill(ids)
    n = len(ids)
    tok = torch.tensor([[300]])
    with torch.inference_mode():
        la, _ = a.arch.forward(a.hp, a.params, tok, torch.tensor([[n]], dtype=torch.int32),
                               a.cache, n)
        off = torch.tensor([n], dtype=torch.int32)
        lb, _ = b.arch.forward(b.hp, b.params, tok, off.reshape(1, 1), b.cache, off)
    assert torch.equal(la, lb)
    for ta, tb in zip(_cache_tensors(a.cache), _cache_tensors(b.cache)):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("off", [0, 5, 63])
@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_one_row_write_at_a_device_offset_is_seq_write(kind, off):
    """KVCache and QuantKVCache.update at T = 1: the device offset writes
    (index_copy_) what the host int writes (narrow + copy_), and nothing
    else; _seq_write itself alike."""
    g = torch.Generator().manual_seed(off)
    L, B, Hkv, S, D = 2, 1, 2, 64, 64

    def fresh():
        if kind == "bf16":
            return KVCache(
                torch.randn(L, B, Hkv, S, D, generator=g).to(torch.bfloat16),
                torch.randn(L, B, Hkv, S, D, generator=g).to(torch.bfloat16))
        return QuantKVCache(torch.randint(-127, 128, (L, B, Hkv, S, D), generator=g,
                                          dtype=torch.int8),
                            torch.randint(-127, 128, (L, B, Hkv, S, D), generator=g,
                                          dtype=torch.int8),
                            torch.rand(L, B, Hkv, S, generator=g),
                            torch.rand(L, B, Hkv, S, generator=g))

    base = fresh()
    a = type(base)(*[t.clone() for t in _cache_tensors(base)])
    b = type(base)(*[t.clone() for t in _cache_tensors(base)])
    k = torch.randn(B, Hkv, 1, D, generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, 1, D, generator=g).to(torch.bfloat16)
    a.update(1, k, v, off)
    b.update(1, k, v, torch.tensor([off], dtype=torch.int32))
    for ta, tb, t0 in zip(_cache_tensors(a), _cache_tensors(b), _cache_tensors(base)):
        assert torch.equal(ta, tb)
        assert torch.equal(ta[0], t0[0]) and not torch.equal(ta[1], t0[1])
    dst, src = torch.zeros(3, 8, 4), torch.randn(3, 1, 4, generator=g)
    want = dst.clone()
    _seq_write(want, src, off % 8, seq_axis=1)
    _seq_write(dst, src, torch.tensor(off % 8), seq_axis=1)
    assert torch.equal(dst, want)
    with pytest.raises(ValueError):
        _seq_write(dst, torch.zeros(3, 2, 4), torch.tensor(0), seq_axis=1)


def _jax_engine(path, kv, max_seq, monkeypatch):
    if "moe" in str(path):
        monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")  # the load the port mirrors
    return JEngine(path, max_seq=max_seq, kv_dtype=jnp.bfloat16 if kv == "bf16" else "q8_0")


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_step_function_gives_the_jax_ids(ggufs, shape, kv, monkeypatch):
    """The runner's step run eagerly on the CPU: the JAX package's
    generate_tokens_device ids (the prefill's id and one chunk: n_past + 32
    reaches max_seq after it), and with `to_end` the JAX generate_tokens
    ids up to the step at n_past == max_seq; one runner for the calls."""
    max_seq = 64
    je = _jax_engine(ggufs[shape], kv, max_seq, monkeypatch)
    te = Engine(ggufs[shape], device="cpu", max_seq=max_seq, kv_dtype=_kv(kv))
    ids = te.tokenizer.tokenize("hello world", add_special=True, parse_special=True)
    ref_chunks = je.generate_tokens_device(ids, 200, temp=0.0)
    assert len(ref_chunks) == 33
    je.reset()
    ref = list(je.generate_tokens(ids, 200))
    assert len(ref) == max_seq - len(ids) + 1
    assert te.generate_tokens_device(ids, 200) == ref_chunks
    te.reset()
    assert te.generate_tokens_device(ids, 200, to_end=True) == ref and te.n_past == max_seq
    assert list(te._runners) == [(SamplingParams(), 32)]


class _Calls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_a_step_reads_nothing_back_to_the_host(ggufs, kv, temp):
    """One step of the dense tiny model (greedy and sampled): no aten call
    of HOST_READS. (The MoE model's plain gather reads its ids on the
    CPU; on the card the gather kernel reads them itself.)"""
    te = Engine(ggufs["tiny"], device="cpu", max_seq=64, kv_dtype=_kv(kv))
    runner = te.decode_runner(SamplingParams(temp), 4)
    with torch.inference_mode():
        tok = torch.argmax(torch.from_numpy(te.prefill([1, 300, 301])))
        runner.start(tok, te.n_past)
        with _Calls() as mode:
            runner.step()
    assert len(mode.calls) > 100
    assert not [c for c in mode.calls if any(h in c for h in HOST_READS)]
    assert int(runner.n_past) == te.n_past + 1 and int(runner.step_index) == 1


def test_sampled_draw_is_torch_multinomial():
    """The device sampler's draw (argmax of p / Exp(1) noise) gives the id
    torch.multinomial draws from the same generator state."""
    for seed in range(20):
        logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(300)
                                  .astype(np.float32))
        sp = SamplingParams(temp=0.9, top_k=0, top_p=1.0, min_p=0.0)
        got = sample_token(logits, torch.Generator().manual_seed(seed), sp)
        vals, idx = torch.topk(logits, 64)
        probs = torch.softmax(vals / 0.9, dim=-1)
        want = idx[torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(seed))[0]]
        assert int(got) == int(want)


def test_runner_rejects_runs_it_cannot_hold(ggufs):
    te = Engine(ggufs["tiny"], device="cpu", max_seq=64)
    runner = te.decode_runner(SamplingParams(), 8)
    assert isinstance(runner, DecodeRunner) and te.decode_runner(SamplingParams(), 8) is runner
    for n in (0, 9):
        with pytest.raises(ValueError):
            runner.run(n)
