"""Port parity of runtime/state.py: a state file saved by the JAX Engine
restores in the port's and the reverse, in the same npz format, and the
continuation after the restore takes the same greedy ids. Restores write
into the cache in place (the decode graphs hold its buffers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime import state as jstate
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import state
from tpullm_torch.runtime.engine import Engine

# prompts on which no greedy decision of the continuation flips between the
# packages (the tiny models are chaotic: attention scores up to ≈ 960, MoE
# routing margins of 1e-3)
PROMPTS = {"tiny": "the quick brown fox jumps over", "tiny-moe": "hello world"}
STEPS = 6


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both Engines on tiny and tiny-moe (the JAX one loading through its
    device repack, the load the port mirrors)."""
    d = tmp_path_factory.mktemp("state")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        for shape in PROMPTS:
            path = make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0)
            out[shape] = (Engine(path, device="cpu", max_seq=64),
                          JEngine(path, max_seq=64, kv_dtype=jnp.bfloat16), path)
    return out


def _continue(eng, first: int, steps: int) -> list[int]:
    """Greedy ids of `steps` decode steps from `first`."""
    out = [first]
    for _ in range(steps):
        out.append(int(np.argmax(eng.decode_step(out[-1]))))
    return out


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
@pytest.mark.parametrize("shape", list(PROMPTS))
def test_state_file_restores_across_packages(engines, tmp_path, shape, direction):
    """One package prefills the prompt and saves; the other restores (the
    same token prefix and n_past) and continues greedily: the ids of the
    saver's own continuation."""
    te, je, _ = engines[shape]
    saver, loader = (je, te) if direction == "jax to port" else (te, je)
    save, load = ((jstate.save_state, state.load_state) if direction == "jax to port"
                  else (state.save_state, jstate.load_state))
    ids = te.tokenizer.tokenize(PROMPTS[shape], add_special=True)
    for e in (te, je):
        e.reset()
    first = int(np.argmax(saver.prefill(ids)))
    path = tmp_path / "state.npz"
    save(saver, path, tokens=ids)
    want = _continue(saver, first, STEPS)
    assert load(loader, path) == ids and loader.n_past == len(ids)
    assert _continue(loader, first, STEPS) == want


def test_state_round_trip_in_place(engines, tmp_path):
    """A port save and restore: the same cache object and buffers (the
    logits graph kept), the rows equal, and decode_step after the restore
    the numbers of the eager step."""
    te, _, _ = engines["tiny"]
    te.reset()
    ids = te.tokenizer.tokenize("hello world the quick", add_special=True)
    te.prefill(ids)
    te.decode_step(17)
    runner, cache, k_ptr = te.logits_runner(), te.cache, te.cache.k.data_ptr()
    path = tmp_path / "s.npz"
    state.save_state(te, path, tokens=ids + [17])
    rows = te.cache.k[:, 0, :, :te.n_past].clone()
    te.cache.k.zero_()
    te.cache.v.zero_()
    te.reset()
    assert state.load_state(te, path) == ids + [17] and te.n_past == len(ids) + 1
    assert te.cache is cache and te.cache.k.data_ptr() == k_ptr and te.logits_runner() is runner
    assert torch.equal(te.cache.k[:, 0, :, :te.n_past], rows)
    got = te.decode_step(42)
    te.n_past -= 1
    want = te._decode_logits(torch.tensor([42])).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kv", ["f16", "f32"])
def test_state_of_f16_and_f32_caches(engines, tmp_path, kv):
    """A dense cache of any type saves as f32 and restores into another
    engine's cache of that type bit for bit."""
    _, _, path = engines["tiny"]
    a = Engine(path, device="cpu", max_seq=32, kv_dtype=kv)
    b = Engine(path, device="cpu", max_seq=32, kv_dtype=kv)
    a.prefill(a.tokenizer.tokenize("the lazy dog", add_special=True))
    state.save_state(a, tmp_path / "s.npz")
    state.load_state(b, tmp_path / "s.npz")
    assert b.n_past == a.n_past
    n = a.n_past  # (the prefill's bucket also wrote rows past n_past in a)
    for x, y in ((a.cache.k, b.cache.k), (a.cache.v, b.cache.v)):
        torch.testing.assert_close(x[:, :, :, :n], y[:, :, :, :n], rtol=0, atol=0)


def test_q8_cache_and_mismatches_raise(engines, tmp_path):
    """A q8 cache has no dense rows to save or restore (as in the JAX
    package, whose QuantKVCache has no .k); a file of another model, a file
    longer than max_seq and a file that is not a state file raise."""
    te, _, path = engines["tiny"]
    q8 = Engine(path, device="cpu", max_seq=32, kv_dtype="q8_0")
    with pytest.raises(ValueError, match="dense KV cache"):
        state.save_state(q8, tmp_path / "q.npz")
    te.reset()
    te.prefill(te.tokenizer.tokenize("the lazy dog", add_special=True))
    state.save_state(te, tmp_path / "s.npz")
    with pytest.raises(ValueError, match="dense KV cache"):
        state.load_state(q8, tmp_path / "s.npz")
    moe = engines["tiny-moe"][0]
    if moe.hp.n_layer != te.hp.n_layer or moe.hp.n_head_kv != te.hp.n_head_kv:
        with pytest.raises(ValueError, match="mismatch"):
            state.load_state(moe, tmp_path / "s.npz")
    short = Engine(path, device="cpu", max_seq=2)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        state.load_state(short, tmp_path / "s.npz")
    np.savez(tmp_path / "x.npz", magic="something else")
    with pytest.raises(ValueError, match="not a tpullm state file"):
        state.load_state(te, tmp_path / "x.npz")
