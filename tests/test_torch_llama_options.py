"""Port parity of the llama graph's last options (models/llama.py forward,
ops/rope.py M-RoPE, runtime/engine.py prefill_embeddings and the
non-causal embed_tokens) and the six names they open: arcee (gateless
ReLU²), apertus (xIELU, per-head qk norms), llama-embed (non-causal
embeddings), qwen2vl and qwen3vl (M-RoPE: contiguous and interleaved
sections; input embeddings and deepstack residuals), qwen3vlmoe (the
qwen-moe graph with IMROPE sections), against the JAX package, both on the
CPU.

The llama names get a tiny file from tpullm/models/testing.py
make_tiny_llama_gguf (dense f32 weights) with their keys and tensors
(arcee and apertus without ffn_gate; apertus' xielu.* values per layer; the
VL names' rope.dimension_sections); qwen3vlmoe is the port's synthetic
tiny-qwen3moe at Q4_K_M, its keys renamed and its sections added.

Tolerances: dense f32 weights and an f32 cache make the two packages'
graphs the same f32 arithmetic in another order: NMSE 1e-6. Packed weights,
bf16 activations and cache: NMSE 1e-3 (tests/test_torch_llama_aliases.py).
RoPE tables and rotated q: 1e-6 absolute (f32 angles)."""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.models.hparams import RopeParams as JRopeParams
from tpullm.models.testing import make_tiny_llama_gguf
from tpullm.ops.rope import apply_rope as japply_rope
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.gguf.writer import GGUFWriter
from tpullm_torch.models.hparams import RopeParams
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.ops.rope import apply_rope_angles, rope_angles
from tpullm_torch.runtime.batch_engine import BatchEngine
from tpullm_torch.runtime.engine import Engine

F32_NMSE = 1e-6  # dense f32 weights, f32 cache: the same arithmetic in another order
NMSE_BOUND = 1e-3  # packed weights, bf16 activations and cache
PROMPT = [1, 5, 9, 12, 7, 3, 44, 80, 100, 22, 11, 60, 71]
EMBED_TOKENS = [1, 5, 9, 12, 7, 3]  # the llama-embed probe's tokens


def _nmse(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


def rewrite(src, dst, *, kv: dict | None = None, drop: tuple = (),
            arch: str | None = None) -> str:
    """A copy of the GGUF `src` at `dst`: metadata `kv` set, the tensors
    whose names hold a string of `drop` left out, and with `arch` the
    architecture renamed (its keys with it)."""
    r = GGUFReader(src)
    old = r.architecture
    w = GGUFWriter(dst)
    for key, value in {**r.metadata, **(kv or {})}.items():
        if arch is not None:
            value = arch if key == "general.architecture" else value
            key = arch + key[len(old):] if key.startswith(old + ".") else key
        w.add_kv(key, value)
    for name, info in r.tensors.items():
        if not any(d in name for d in drop):
            w.add_packed_tensor(name, info.shape, info.ggml_type, info.data)
    w.write()
    return str(dst)


def _xielu_kv(n_layer: int, seed: int) -> dict:
    """apertus' raw per-layer xIELU values (before the softplus folding)."""
    rng = np.random.default_rng(seed)
    return {"xielu.alpha_p": (0.1 + 0.1 * rng.standard_normal(n_layer)).astype(np.float32),
            "xielu.alpha_n": (-0.4 + 0.1 * rng.standard_normal(n_layer)).astype(np.float32),
            "xielu.beta": np.full(n_layer, 0.5, np.float32),
            "xielu.eps": np.full(n_layer, -1e-6, np.float32)}


# make_tiny_llama_gguf's widths: 2 layers, 4 heads over 2 KV heads of 16
# (8 frequency dims: the sections below cover them unequally)
DENSE = {
    "arcee": (dict(), dict(drop=("ffn_gate",))),
    "apertus": (dict(with_qk_norm=True), dict(kv=_xielu_kv(2, 3), drop=("ffn_gate",))),
    "qwen2vl": (dict(with_qkv_bias=True, extra_kv={
        "qwen2vl.rope.dimension_sections": np.asarray([2, 3, 3, 0], np.int32)}), None),
    "qwen3vl": (dict(with_qk_norm=True, extra_kv={
        "qwen3vl.rope.dimension_sections": np.asarray([3, 2, 2, 0], np.int32)}), None),
    "llama-embed": (dict(), None),
}
PACKED = "qwen3vlmoe"
ARCHS = [*DENSE, PACKED]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama_options")
    out = {}
    for arch, (make_kw, rewrite_kw) in DENSE.items():
        path = make_tiny_llama_gguf(str(d / f"{arch}.gguf"), arch=arch, seed=1, **make_kw)
        out[arch] = rewrite(path, d / f"{arch}-rw.gguf", **rewrite_kw) if rewrite_kw else path
    moe = make_synthetic_llama_gguf(d / "tiny-qwen3moe.gguf", shape="tiny-qwen3moe", seed=0)
    out[PACKED] = rewrite(moe, d / "qwen3vlmoe.gguf", arch=PACKED, kv={
        "qwen3moe.rope.dimension_sections": np.asarray([24, 20, 20, 0], np.int32)})
    return out


@pytest.fixture(scope="module")
def engines(files):
    """One (port, JAX) Engine pair per arch, made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            if arch == PACKED:
                made[arch] = (Engine(files[arch], device="cpu", max_seq=64),
                              JEngine(files[arch], max_seq=64))
            else:
                made[arch] = (Engine(files[arch], device="cpu", max_seq=64, mode="dense",
                                     dtype=torch.float32, kv_dtype=torch.float32),
                              JEngine(files[arch], max_seq=64, mode="dense", dtype=jnp.float32,
                                      kv_dtype=jnp.float32))
        te, je = made[arch]
        te.reset()
        je.n_past = 0
        return te, je
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULLM_DEVICE_REPACK", "1")  # the JAX load the port mirrors, for this file
        yield get


# ---------------------------------------------------------------------------
# M-RoPE against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interleaved,sections", [(False, (16, 24, 24, 0)),
                                                  (True, (24, 20, 20, 0)),
                                                  (False, (3, 2, 3, 0))],
                         ids=["qwen2vl", "qwen3vl", "short-sections"])
def test_mrope_matches_jax(interleaved, sections):
    """q rotated by three unequal position streams, against
    tpullm.ops.rope.apply_rope, to 1e-6: q of magnitude below 1 at positions
    below 64 (an image grid's rows and columns; at positions in the
    thousands the two packages' f32 angles already part by 3e-5 in plain
    NEOX RoPE). All streams equal give NEOX RoPE exactly."""
    rng = np.random.default_rng(7)
    B, T, H, D = 2, 9, 3, 128
    rp = RopeParams(dims=D, freq_base=1e6, style="neox", sections=sections,
                    mrope_interleaved=interleaved)
    jrp = JRopeParams(dims=D, freq_base=1e6, style="neox", sections=sections,
                      mrope_interleaved=interleaved)
    q = rng.uniform(-1.0, 1.0, size=(B, T, H, D)).astype(np.float32)
    pos = rng.integers(0, 64, size=(3, B, T)).astype(np.int32)
    cos, sin = rope_angles(rp, torch.from_numpy(pos))
    assert cos.shape == (B, T, D // 2)
    got = apply_rope_angles(torch.from_numpy(q), cos, sin, "neox").numpy()
    want = np.asarray(japply_rope(jnp.asarray(q), jnp.asarray(pos), jrp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    same = np.broadcast_to(pos[0], (3, B, T))
    cos3, sin3 = rope_angles(rp, torch.from_numpy(np.ascontiguousarray(same)))
    cos1, sin1 = rope_angles(RopeParams(dims=D, freq_base=1e6, style="neox"),
                             torch.from_numpy(pos[0]))
    assert torch.equal(cos3, cos1) and torch.equal(sin3, sin1)


# ---------------------------------------------------------------------------
# the six names against the JAX Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_hparams_match_jax(engines, arch):
    """The options' fields as the JAX package reads them: RoPE style and
    sections, causal, pooling, xIELU's folded values."""
    te, je = engines(arch)
    for field in ("causal", "pooling", "xielu"):
        assert getattr(te.hp, field) == getattr(je.hp, field), field
    for field in ("style", "sections", "mrope_interleaved", "dims"):
        assert getattr(te.hp.rope, field) == getattr(je.hp.rope, field), field
    assert te.hp.rope.style == "neox" or arch in ("arcee", "llama-embed")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "llama-embed"])
def test_logits_and_decode_steps_match_jax(engines, arch):
    """Every row of a 13-token prompt's logits, then three decode steps
    (the logits graph), within the bound of the weights' kind."""
    te, je = engines(arch)
    bound = NMSE_BOUND if arch == PACKED else F32_NMSE
    if arch == PACKED:  # the packed JAX side prefills its last row
        assert _nmse(te.prefill(PROMPT), je.prefill(PROMPT)) <= bound
    else:
        assert _nmse(te.prefill_all_logits(PROMPT), je.prefill_all_logits(PROMPT)) <= bound
    for tok in (3, 17, 5):
        assert _nmse(te.decode_step(tok), je.decode_step(tok)) <= bound


@pytest.mark.parametrize("arch,streams,deepstack", [
    ("qwen2vl", True, False), ("qwen3vl", True, True), ("qwen3vl", False, True),
    ("arcee", False, False)])
def test_prefill_embeddings_match_jax(engines, arch, streams, deepstack):
    """prefill_embeddings of 13 input embeddings (an image grid's three
    position streams, two deepstack residuals, or neither) after a text
    prefill, then a decode step: against the JAX Engine.prefill_embeddings,
    and n_past advanced by 13 in both."""
    te, je = engines(arch)
    rng = np.random.default_rng(11)
    n, E = 13, te.hp.n_embd
    emb = (0.05 * rng.standard_normal((n, E))).astype(np.float32)
    pos = (np.stack([np.full(n, 6), 6 + np.arange(n) // 4, 6 + np.arange(n) % 4]).astype(np.int32)
           if streams else None)
    ds = (0.05 * rng.standard_normal((2, n, E))).astype(np.float32) if deepstack else None
    assert _nmse(te.prefill(PROMPT[:6]), je.prefill(PROMPT[:6])) <= F32_NMSE
    got, want = te.prefill_embeddings(emb, pos, ds), je.prefill_embeddings(emb, pos, ds)
    assert got.shape == (te.hp.n_vocab,) and te.n_past == je.n_past == 6 + n
    assert _nmse(got, want) <= F32_NMSE
    assert _nmse(te.decode_step(9), je.decode_step(9)) <= F32_NMSE


def test_prefill_embeddings_takes_the_prefill_cap_in_chunks(engines):
    """Embeddings past the prefill cap run in chunks of it, as the JAX
    package's: the same last logits as the JAX Engine at a cap of 8."""
    te, je = engines("qwen3vl")
    te.prefill_cap = je.prefill_cap = 8
    try:
        rng = np.random.default_rng(12)
        emb = (0.05 * rng.standard_normal((19, te.hp.n_embd))).astype(np.float32)
        pos = np.stack([np.arange(19)] * 3).astype(np.int32)
        assert _nmse(te.prefill_embeddings(emb, pos), je.prefill_embeddings(emb, pos)) \
            <= F32_NMSE
    finally:
        te.prefill_cap = je.prefill_cap = 64


def test_llama_embed_is_the_jax_vector_of_a_new_engine(engines, files):
    """llama-embed's vector: the port's equals the JAX package's on a new
    engine, and stays so after a 12-token prefill without a reset, where
    the JAX package's moves (its forward reads the cache slots before the
    tokens, which that prefill filled: ROADMAP.md §3)."""
    te, je = engines("llama-embed")
    fresh_j = je.embed_tokens(EMBED_TOKENS, normalize=False)
    fresh_t = te.embed_tokens(EMBED_TOKENS, normalize=False)
    assert _nmse(fresh_t, fresh_j) <= F32_NMSE
    te.prefill(list(range(1, 13)))
    je.prefill(list(range(1, 13)))
    again_t = te.embed_tokens(EMBED_TOKENS, normalize=False)
    again_j = je.embed_tokens(EMBED_TOKENS, normalize=False)
    assert np.array_equal(again_t, fresh_t)
    assert np.abs(again_j - fresh_j).max() > 0.1 * np.abs(fresh_j).max()
    # a slot of the BatchEngine (the server's /v1/embeddings) beside a live slot
    be = BatchEngine(files["llama-embed"], n_slots=2, max_seq=64, device="cpu", mode="dense",
                     dtype=torch.float32, kv_dtype=torch.float32)
    be.prefill_slot(0, list(range(1, 20)))
    assert _nmse(be.embed_tokens(1, EMBED_TOKENS, normalize=False), fresh_t) <= F32_NMSE
    assert int(be.n_past[0]) == 19
