"""tpullm-torch-fit-params (runtime/fit.py) against the JAX package's
tpullm-fit-params, on the CPU.

The rule (15 % reserve, slots shed before context, rounding to 256) is the
JAX tool's: on a dense-f32 tiny model, fed the JAX tool's weight bytes, it
gives the JAX result at every memory size tried, and its bf16 cache bytes
a position are the JAX tool's. Its inputs are the port's: the weight bytes
equal the bytes of the tensors the port's Engine holds (a packed model's
planes, a dense one's bf16 linears), and the cache bytes those of the
Engine's cache for the kind asked."""

import pytest
import torch

from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.runtime.fit import fit_params as jfit_params

from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import fit
from tpullm_torch.runtime.engine import Engine

# memory sizes around the tiny models' needs: none left, slots shed, a
# partial context, the whole wanted context
HBM = (2**18, 2**19, 3 * 2**19, 2**20, 2**21, 2**22, 2**24, 2**30)


def _held_bytes(tree) -> int:
    """Bytes of every distinct tensor under an Engine's params tree."""
    seen, total = set(), 0

    def walk(obj):
        nonlocal total
        if isinstance(obj, torch.Tensor):
            if obj.data_ptr() not in seen:
                seen.add(obj.data_ptr())
                total += obj.nbytes
        elif isinstance(obj, torch.nn.Module):
            for b in obj.buffers():
                walk(b)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
    walk(tree)
    return total


@pytest.fixture(scope="module")
def dense_f32(tmp_path_factory):
    return make_tiny_llama_gguf(str(tmp_path_factory.mktemp("fit") / "dense.gguf"), seed=1)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("fit") / "tiny.gguf", shape="tiny")


@pytest.mark.parametrize("want_seq,want_slots", [(4096, 1), (2048, 4), (640, 3)])
def test_rule_is_the_jax_tools(dense_f32, want_seq, want_slots):
    """Fed the JAX tool's weight and cache bytes, the port's rule gives its
    context, slots and verdict at every memory size; the port's bf16 cache
    bytes a position are the JAX tool's."""
    r = GGUFReader(dense_f32)
    per_tok = fit.cache_bytes(r, "bf16", want_seq) // want_seq
    for hbm in HBM:
        want = jfit_params(dense_f32, want_seq=want_seq, want_slots=want_slots, hbm_bytes=hbm)
        got = fit.fit_rule(want.weight_bytes, want.kv_bytes_per_token, hbm, want_seq,
                           want_slots)
        assert (got.max_seq, got.n_slots, got.fits) == (want.max_seq, want.n_slots, want.fits)
        assert per_tok == want.kv_bytes_per_token


@pytest.mark.parametrize("mode", ["dense", "auto"])
def test_weight_bytes_are_the_engines(dense_f32, packed, mode):
    """The predicted weights are the bytes the port's Engine holds: the
    dense-f32 file's linears and embedding in bf16, its norms in f32; the
    packed file's planes."""
    path = dense_f32 if mode == "dense" else packed
    eng = Engine(path, device="cpu", max_seq=64)
    assert fit.weight_bytes(GGUFReader(path)) == _held_bytes(eng.params)


@pytest.mark.parametrize("kv", ["bf16", "f16", "f32", "q8_0"])
def test_cache_bytes_are_the_engines(packed, kv):
    """The cache bytes at a context are those of the Engine's cache of that
    kind; q8 holds 2·D·Hkv codes and 8·Hkv scale bytes a layer a position."""
    eng = Engine(packed, device="cpu", max_seq=256, kv_dtype=kv)
    held = sum(t.nbytes for t in vars(eng.cache).values() if isinstance(t, torch.Tensor))
    r = GGUFReader(packed)
    assert fit.cache_bytes(r, kv, 256) == held
    hp = eng.hp
    per_layer = {"bf16": 4, "f16": 4, "f32": 8}.get(kv)
    want = (hp.n_head_kv * hp.head_dim * per_layer if per_layer
            else 2 * hp.head_dim * hp.n_head_kv + 8 * hp.n_head_kv)
    assert fit.cache_bytes(r, kv, 256) == 256 * hp.n_layer * want


def test_fit_params_and_the_tool(packed, capsys):
    """fit_params at a memory size: the context fills what the reserve and
    the weights leave, rounded to 256; the tool prints it and exits 0, or 1
    when nothing fits; on the CPU without a memory size it raises."""
    w = fit.weight_bytes(GGUFReader(packed))
    per_tok = fit.cache_bytes(GGUFReader(packed), "bf16", 8192) // 8192
    hbm = int((w + 3000 * per_tok) / 0.85) + 1
    res = fit.fit_params(packed, want_seq=8192, hbm_bytes=hbm)
    assert (res.max_seq, res.n_slots, res.fits) == (2816, 1, True)
    assert res.predicted_bytes == w + 2816 * per_tok
    assert fit.main(["-m", str(packed), "-c", "8192", "--hbm-gb", str(hbm / 2**30),
                     "--device", "cpu"]) == 0
    assert "fitted:             -c 2816 -np 1" in capsys.readouterr().out
    assert fit.main(["-m", str(packed), "--hbm-gb", "0.0001", "--device", "cpu"]) == 1
    with pytest.raises(ValueError, match="hbm_bytes"):
        fit.fit_params(packed, device="cpu")
