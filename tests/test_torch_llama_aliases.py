"""Port parity of the llama graph's aliases (models/registry.py: `llama`
and 17 archs that ride its forward, models/llama.py), against the JAX
package, both on the CPU.

Each alias gets a tiny file carrying the tensors and keys it reads
(tpullm/models/testing.py make_tiny_llama_gguf: q/k/v and output biases,
per-head qk norms, seed_oss's post_attention_norm, granite's multipliers;
the arch's own defaults: NEOX RoPE, minicpm's multipliers, smollm3's NoPE
step, refact's ALiBi, the post-RoPE qk norms of maincoder and
hunyuan-dense), and a llama file with full-projection qk norms (q_norm over
n_head·head_dim, written here). The packed path: the port's synthetic
`tiny-qwen2` and `tiny-qwen3` at Q4_K_M on Qwen's BPE (pre "qwen2").

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: logits within NMSE 1e-6.
Packed weights, bf16 activations and a bf16 cache: NMSE ≤ 1e-3 (the bound
of tests/test_torch_slice.py). The JAX side loads through its device
repack (`TPULLM_DEVICE_REPACK=1`, the load the port mirrors)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.reader import GGUFReader as JReader
from tpullm.models.hparams import hparams_from_gguf as jhparams
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.runtime.batch_engine import BatchEngine as JBatchEngine
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.gguf.writer import GGUFWriter
from tpullm_torch.models import llama
from tpullm_torch.models.hparams import LLAMA_ALIASES, hparams_from_gguf
from tpullm_torch.models.registry import get_arch
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache

# what each alias's tiny file carries (make_tiny_llama_gguf's options)
ALIAS_FILES = {
    "mistral": {},
    "qwen2": dict(with_qkv_bias=True),
    "qwen3": dict(with_qk_norm=True),
    "granite": dict(extra_kv={"granite.embedding_scale": 12.0, "granite.residual_scale": 0.22,
                              "granite.logit_scale": 8.0, "granite.attention.scale": 0.0078125}),
    "internlm2": {},
    "exaone": {},
    "smollm3": dict(n_layer=4),  # layer 3 skips RoPE (no_rope_step 4)
    "minicpm": {},
    "xverse": {},
    "ernie4_5": {},
    "refact": {},  # ALiBi 8 in place of RoPE
    "baichuan": {},
    "mistral3": {},
    "pangu-embedded": dict(with_qkv_bias=True, with_bo=True),
    "seed_oss": dict(with_qkv_bias=True, ffn_norm_tensor="post_attention_norm"),
    "maincoder": dict(with_qk_norm=True, with_bo=True),
    "hunyuan-dense": dict(with_qk_norm=True),
}
FULL_QK_NORM = "llama-full-qk-norm"  # the llama graph with full-projection qk norms
CASES = [*ALIAS_FILES, FULL_QK_NORM]


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def _ids(n: int, seed: int, hi: int = 280) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(5, hi, size=n)]


def rewrite_gguf(src, dst, *, kv: dict | None = None, tensors: dict | None = None) -> str:
    """A copy of the GGUF `src` at `dst` with metadata `kv` set and f32
    `tensors` added (logical-order arrays), the other tensors' bytes as
    they are."""
    r = GGUFReader(src)
    w = GGUFWriter(dst)
    meta = {**r.metadata, **(kv or {})}
    for key, value in meta.items():
        w.add_kv(key, value)
    for name, info in r.tensors.items():
        w.add_packed_tensor(name, info.shape, info.ggml_type, info.data)
    for name, arr in (tensors or {}).items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    return str(dst)


def full_qk_norms(n_layer: int, n_q: int, n_k: int, seed: int) -> dict:
    """Full-projection qk norm weights (1 + 0.1·N(0, 1)), q over n_q and k
    over n_k features, for each of n_layer layers."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_layer):
        out[f"blk.{i}.attn_q_norm.weight"] = 1.0 + 0.1 * rng.standard_normal(n_q)
        out[f"blk.{i}.attn_k_norm.weight"] = 1.0 + 0.1 * rng.standard_normal(n_k)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama_aliases")
    out = {arch: make_tiny_llama_gguf(str(d / f"{arch}.gguf"), arch=arch, seed=1, **kw)
           for arch, kw in ALIAS_FILES.items()}
    plain = make_tiny_llama_gguf(str(d / "llama.gguf"), seed=1)
    # make_tiny_llama_gguf's widths: 2 layers, 4 heads over 2 KV heads of 16
    out[FULL_QK_NORM] = rewrite_gguf(plain, d / "llama-full.gguf",
                                     tensors=full_qk_norms(2, 4 * 16, 2 * 16, seed=2))
    for shape in ("tiny-qwen2", "tiny-qwen3"):
        out[shape] = make_synthetic_llama_gguf(d / f"{shape}.gguf", shape=shape, seed=0)
    return out


@pytest.fixture(autouse=True)
def device_repack(monkeypatch):
    monkeypatch.setenv("TPULLM_DEVICE_REPACK", "1")


# ---------------------------------------------------------------------------
# hparams and the registry
# ---------------------------------------------------------------------------

def assert_hparams_match(path):
    """Every field of the port's HParams equals the JAX package's, every
    RopeParams field too (the style among them), the per-layer arrays
    (n_head_kv_arr, n_ff_arr) and the SSM fields (ssm_*, rope_finetuned)
    among them; returns the port's."""
    hp, jhp = hparams_from_gguf(GGUFReader(path)), jhparams(JReader(str(path)))
    for field in hp.__dataclass_fields__:
        got, want = getattr(hp, field), getattr(jhp, field)
        if field == "rope":
            for f in got.__dataclass_fields__:
                assert getattr(got, f) == getattr(want, f), f"rope.{f}"
        else:
            assert got == want, field
    return hp


@pytest.mark.parametrize("case", CASES + ["tiny-qwen2", "tiny-qwen3"])
def test_hparams_match_jax(files, case):
    """The port's HParams of each alias's file equal the JAX package's
    field for field: the RoPE style of NEOX_ROPE_ARCHS, the multipliers,
    the ALiBi and NoPE defaults, qk_norm_post_rope."""
    hp = assert_hparams_match(files[case])
    neox = hp.arch in ("qwen2", "qwen3", "exaone", "pangu-embedded", "seed_oss",
                       "hunyuan-dense")
    assert hp.rope.style == ("neox" if neox else "norm")
    assert hp.qk_norm_post_rope == (hp.arch in ("maincoder", "hunyuan-dense"))
    if hp.arch == "minicpm":
        assert (hp.embd_scale, hp.logit_scale) == (12.0, 256.0 / 64)
        assert hp.residual_scale == pytest.approx(1.4 / 2 ** 0.5)
    assert hp.max_alibi_bias == (8.0 if hp.arch == "refact" else 0.0)
    assert hp.no_rope_step == (4 if hp.arch == "smollm3" else 0)


def test_baichuan_13b_takes_alibi(tmp_path):
    """baichuan's 40-layer 13B takes ALiBi 8 without a key, its 32-layer 7B
    RoPE, in both packages."""
    for n_layer, want in ((40, 8.0), (32, 0.0)):
        path = make_tiny_llama_gguf(str(tmp_path / f"b{n_layer}.gguf"), arch="baichuan",
                                    n_layer=n_layer, n_embd=32, n_head=2, n_head_kv=1,
                                    n_ff=32)
        assert assert_hparams_match(path).max_alibi_bias == want


def test_registry_maps_the_aliases_and_refuses_the_rest():
    """The 17 aliases and the five that ride the llama graph's options
    (arcee, apertus, llama-embed, qwen2vl, qwen3vl) run the llama forward;
    archs that wait (gpt-oss, stablelm) are refused; the registry maps 64
    names."""
    from tpullm_torch.models.hparams import LLAMA_OPTION_ALIASES
    from tpullm_torch.models.registry import _REGISTRY

    assert len(LLAMA_ALIASES) == 17
    assert LLAMA_OPTION_ALIASES == ("arcee", "apertus", "llama-embed", "qwen2vl", "qwen3vl")
    for arch in ("llama", *LLAMA_ALIASES, *LLAMA_OPTION_ALIASES):
        assert get_arch(arch).forward is llama.forward
    for arch in ("gpt-oss", "stablelm"):
        with pytest.raises(NotImplementedError, match="is not ported"):
            get_arch(arch)
    assert len(_REGISTRY) == 64


# ---------------------------------------------------------------------------
# forward against the JAX package
# ---------------------------------------------------------------------------

def _dense_f32(path):
    return (Engine(path, device="cpu", max_seq=64, mode="dense", dtype=torch.float32,
                   kv_dtype=torch.float32),
            JEngine(path, max_seq=64, mode="dense", dtype=jnp.float32, kv_dtype=jnp.float32))


@pytest.mark.parametrize("case", CASES)
def test_logits_and_greedy_ids_match_jax(files, case):
    """Dense f32 weights and cache: every row of a 20-token prompt's logits
    and three decode steps' within F32_NMSE of the JAX Engine's, and the
    greedy ids of the decode graph's step over two chunks and a tail equal."""
    te, je = _dense_f32(files[case])
    prompt = _ids(20, 0)
    errs = [_nmse(te.prefill_all_logits(prompt), je.prefill_all_logits(prompt))]
    te.reset()
    je.reset()
    te.prefill(prompt)
    je.prefill(prompt)
    for tok in (7, 200, 33):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= F32_NMSE, errs
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 10, chunk=4, stop_on_eog=False)
    assert got == je.generate_tokens_device(prompt, 10, chunk=4, stop_on_eog=False)


@pytest.mark.parametrize("order", ["pre-rope", "post-rope", "full-projection"])
def test_qk_norm_orders_are_distinct(files, order):
    """The three orders give other logits than each other on the same
    weights: norms that commute with RoPE would make the post-RoPE cases
    vacuous (per-head weights of 1 do; these are 1 + 0.1·N(0, 1))."""
    path = files["hunyuan-dense" if order == "post-rope" else
                 FULL_QK_NORM if order == "full-projection" else "qwen3"]
    te, _ = _dense_f32(path)
    hp = te.hp
    flipped = {"post-rope": dict(qk_norm_post_rope=False),
               "pre-rope": dict(qk_norm_post_rope=True)}.get(order)
    prompt = _ids(12, 1)
    ref = te.prefill_all_logits(prompt)
    if flipped is None:  # the same norms applied per head instead
        for layer in te.params["layers"]:
            layer["q_norm"] = layer["q_norm"][:hp.head_dim]
            layer["k_norm"] = layer["k_norm"][:hp.head_dim]
    else:
        te.hp = dataclasses.replace(hp, **flipped)
    te.reset()
    assert _nmse(te.prefill_all_logits(prompt), ref) > 1e-4


# ---------------------------------------------------------------------------
# the packed Qwen shapes: Engine, the decode graphs, BatchEngine, convert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(files):
    """The port's and the JAX package's Engines on tiny-qwen2 and
    tiny-qwen3 (Q4_K_M, bf16 cache)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")
        return {s: (Engine(files[s], device="cpu", max_seq=128),
                    JEngine(files[s], max_seq=128, kv_dtype=jnp.bfloat16))
                for s in ("tiny-qwen2", "tiny-qwen3")}


@pytest.mark.parametrize("shape", ["tiny-qwen2", "tiny-qwen3"])
def test_packed_logits_and_greedy_ids_match_jax(packed, shape):
    """Q4_K_M planes: a 30-token prompt's logits and three decode steps'
    within NMSE_BOUND; greedy ids of the decode graph's step (two chunks
    and a tail) equal the JAX Engine's and the host loop's (decode_step)."""
    te, je = packed[shape]
    assert te.hp.rope.style == je.hp.rope.style == "neox"
    prompt = _ids(30, 2, hi=370)
    te.reset()
    je.reset()
    errs = [_nmse(te.prefill(prompt), je.prefill(prompt))]
    for tok in (100, 17, 301):
        errs.append(_nmse(te.decode_step(tok), je.decode_step(tok)))
    assert max(errs) <= NMSE_BOUND, errs
    te.reset()
    je.reset()
    got = te.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    assert got == je.generate_tokens_device(prompt, 20, chunk=8, stop_on_eog=False)
    te.reset()
    assert list(te.generate_tokens(prompt, 20, stop_on_eog=False)) == got


def test_tiny_qwen_files_carry_their_tensors(files):
    """tiny-qwen2's q/k/v biases, tiny-qwen3's per-head q/k norms, Qwen's
    BPE pre-tokenizer."""
    r2, r3 = GGUFReader(files["tiny-qwen2"]), GGUFReader(files["tiny-qwen3"])
    assert {"blk.0.attn_q.bias", "blk.1.attn_v.bias"} <= set(r2.tensors)
    assert not any("norm" in n and "attn_q" in n for n in r2.tensors)
    assert r3.tensors["blk.0.attn_q_norm.weight"].shape == (64,)
    for r in (r2, r3):
        assert (r.metadata["tokenizer.ggml.model"], r.metadata["tokenizer.ggml.pre"]) == \
            ("gpt2", "qwen2")


def _batch_rows(eng) -> list:
    """A joint prefill of slots 0 and 2 (slot 1 idle), decode steps with an
    idle slot, slot 2 freed and admitted again: each fed row's logits."""
    rows = []
    got = eng.prefill_slots({0: _ids(30, 4), 2: _ids(11, 5)})
    rows += [got[0], got[2]]
    for feed in ({0: 101, 2: 102}, {0: 103}, {2: 104}):
        got = eng.decode_batch(feed)
        rows += [got[s] for s in feed]
    eng.free_slot(2)
    rows.append(eng.prefill_slots({2: _ids(9, 6)})[2])
    return rows


@pytest.mark.parametrize("shape", ["tiny-qwen2", "tiny-qwen3"])
def test_batch_engine_matches_jax(files, shape):
    """BatchEngine (per-slot offsets, −1 for the idle slot) against the JAX
    BatchEngine on dense f32 weights and cache: every row within F32_NMSE;
    the idle slot's cache rows stay zero."""
    kw = dict(n_slots=3, max_seq=64, prefill_chunk=16, mode="dense")
    te = BatchEngine(files[shape], device="cpu", dtype=torch.float32, kv_dtype=torch.float32,
                     **kw)
    je = JBatchEngine(files[shape], dtype=jnp.float32, kv_dtype=jnp.float32, **kw)
    errs = [_nmse(a, b) for a, b in zip(_batch_rows(te), _batch_rows(je))]
    assert len(errs) == 7 and max(errs) <= F32_NMSE, errs
    assert not te.cache.k[:, 1].any()


@pytest.mark.parametrize("shape", ["tiny-qwen2", "tiny-qwen3"])
def test_params_from_jax_gives_the_same_logits(files, shape):
    """The JAX Engine's tree (biases, per-head norms), carried across, gives
    the port's own logits within NMSE_BOUND."""
    from tpullm_torch.convert import params_from_jax

    je = JEngine(files[shape], max_seq=64, kv_dtype=jnp.bfloat16)
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, je.params), "cpu")
    key = "bq" if shape == "tiny-qwen2" else "q_norm"
    assert isinstance(tree["layers"][0][key], torch.Tensor)
    own = Engine(files[shape], device="cpu", max_seq=64)
    carried = Engine(files[shape], device="cpu", max_seq=64)
    carried.params = tree
    ids = _ids(20, 7, hi=370)
    assert _nmse(carried.prefill(ids), own.prefill(ids)) <= NMSE_BOUND
    assert _nmse(carried.decode_step(100), own.decode_step(100)) <= NMSE_BOUND
