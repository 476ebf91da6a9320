"""Port parity: GGUF writer/reader, hparams and the SPM tokenizer of
tpullm_torch against the JAX package's, and the device sampler."""

import numpy as np
import pytest
import torch

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm import tokenizer as jtok

from tpullm_torch.device import resolve_device
from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.gguf.writer import GGUFWriter
from tpullm_torch.models.hparams import hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf, use_more_bits
from tpullm_torch.ops.sampling_ops import SamplingParams, sample_token
from tpullm_torch import tokenizer


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("g") / "t.gguf",
                                     shape="tiny", seed=3)


def test_reader_matches_jax_reader(tiny):
    r, jr = GGUFReader(tiny), JReader(tiny)
    assert r.architecture == jr.architecture == "llama"
    assert sorted(r.tensors) == sorted(jr.tensors)
    for name, info in r.tensors.items():
        j = jr.tensors[name]
        assert info.shape == j.shape and int(info.ggml_type) == int(j.ggml_type)
        np.testing.assert_array_equal(info.data, j.data)
    for k, v in jr.metadata.items():
        got = r.metadata[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v)
        else:
            assert got == v, k


def test_writer_float_tensors_round_trip(tmp_path):
    w = GGUFWriter(tmp_path / "f.gguf", architecture="llama")
    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    w.add_tensor("a", a)
    w.add_tensor("b", a, GGMLType.F16)
    w.add_kv("x.list", [1, 2, 3])
    w.write()
    r = GGUFReader(tmp_path / "f.gguf")
    np.testing.assert_array_equal(r.tensors["a"].to_numpy(), a)
    np.testing.assert_array_equal(r.tensors["b"].to_numpy(), a.astype(np.float16).astype(np.float32))
    assert list(r.metadata["x.list"]) == [1, 2, 3]
    with pytest.raises(NotImplementedError):
        w.add_tensor("q", a, GGMLType.Q4_K)


def test_hparams_match_jax(tiny):
    hp, jhp = hparams_from_gguf(GGUFReader(tiny)), jhparams(JReader(tiny))
    for f in ("n_vocab", "n_embd", "n_layer", "n_head", "n_head_kv", "n_ff", "head_dim",
              "head_dim_v", "rms_eps", "sliding_window", "attn_scale", "max_alibi_bias"):
        assert getattr(hp, f) == getattr(jhp, f), f
    for f in ("dims", "freq_base", "scaling_type", "style"):
        assert getattr(hp.rope, f) == getattr(jhp.rope, f), f
    with pytest.raises(NotImplementedError):
        get_arch("qwen2")


@pytest.mark.parametrize("text", ["hello world", "the quick brown fox", "héllo\nwörld  ok",
                                  "</s>inside<s>text", ""])
def test_spm_tokenizer_matches_jax(tiny, text):
    tok = tokenizer.from_gguf(GGUFReader(tiny))
    jt = jtok.from_gguf(JReader(tiny))
    for add, parse in ((True, False), (True, True), (False, False)):
        ids = tok.tokenize(text, add_special=add, parse_special=parse)
        assert ids == jt.tokenize(text, add_special=add, parse_special=parse)
        assert tok.detokenize(ids) == jt.detokenize(ids)


def test_use_more_bits_matches_jax():
    from tpullm.tools.quantize import use_more_bits as j_use_more_bits

    for n in (2, 8, 32, 80):
        assert [use_more_bits(i, n) for i in range(n)] == [j_use_more_bits(i, n) for i in range(n)]


def test_greedy_is_argmax_first_index_on_ties():
    logits = torch.tensor([0.5, 3.0, -1.0, 3.0, 2.0])
    assert int(sample_token(logits, None, SamplingParams(temp=0.0))) == 1


def test_sampling_respects_top_k_and_generator():
    logits = torch.arange(300, dtype=torch.float32) * 0.5
    sp = SamplingParams(temp=1.0, top_k=3, top_p=1.0, min_p=0.0)
    draws = []
    for seed in (0, 0, 1):
        g = torch.Generator()
        g.manual_seed(seed)
        draws.append([int(sample_token(logits, g, sp)) for _ in range(50)])
    assert draws[0] == draws[1]  # same generator seed, same stream
    assert set(draws[0]) <= {297, 298, 299}
    # min-p 0.5 keeps logits within log(2) of the max: the top two here
    sp = SamplingParams(temp=1.0, top_k=0, top_p=1.0, min_p=0.5)
    g = torch.Generator()
    g.manual_seed(2)
    assert {int(sample_token(logits, g, sp)) for _ in range(50)} == {298, 299}


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
