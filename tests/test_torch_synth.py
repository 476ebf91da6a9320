"""The synthetic models: the type recipes of the presets (Q4_K_M dense and
with 8 experts, Q2_K, Q3_K_M, the legacy and IQ4 presets, MXFP4_MOE), the
block scale fields, and seeded bytes."""

import hashlib

import numpy as np
import pytest

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.gguf.constants import GGMLType as JGGMLType
from tpullm.tools.quantize import tensor_type_policy

from tpullm_torch.gguf.constants import GGMLType
from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models.synth import (PRESETS, SCALE_FIELDS, SHAPES, make_synthetic_llama_gguf,
                                       preset_type, random_packed, use_more_bits)

# the Q4_K_M tiny files as the seed gave them before the other presets came
Q4_K_M_SHA256 = {"tiny": "41448b233eb76b2a74c584a4c6eedf4a5ff4c02bfe325e282913296833889172",
                 "tiny-moe": "9462e9b4c5762ab9bfac0c47edeaa1892c9649883c2cb98043c8d5b47b48c003"}
KINDS = ("token_embd", "attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
         "ffn_down", "ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps", "output")


def q4_k_m_type(kind: str, i_layer: int, n_layer: int, n_expert: int = 0) -> GGMLType:
    """The Q4_K_M recipe as the synth wrote it before preset_type took its
    place (kept here to hold preset_type's "Q4_K_M" branch to it)."""
    if kind == "output":
        return GGMLType.Q6_K
    if kind == "ffn_gate_inp":
        return GGMLType.F32
    if n_expert == 8 and kind in ("attn_k", "attn_v"):
        return GGMLType.Q8_0
    if n_expert == 8 and kind == "attn_output":
        return GGMLType.Q5_K
    if kind in ("attn_v", "ffn_down", "ffn_down_exps") and use_more_bits(i_layer, n_layer):
        return GGMLType.Q6_K
    return GGMLType.Q4_K


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("s") / "m.gguf",
                                     shape="tiny-moe", seed=0)


def _expected_8_expert(name: str) -> GGMLType:
    """llama_tensor_get_type's Q4_K_M answer for a model with 8 experts
    (src/llama-quant.cpp): Q8_0 attn_k/attn_v, Q5_K attn_output, Q6_K
    ffn_down_exps on the use_more_bits layers (layer 1 of 2), Q6_K head,
    F32 norms and router, Q4_K elsewhere."""
    if name.endswith("norm.weight") or name.endswith("ffn_gate_inp.weight"):
        return GGMLType.F32
    if name == "output.weight":
        return GGMLType.Q6_K
    if name.endswith(("attn_k.weight", "attn_v.weight")):
        return GGMLType.Q8_0
    if name.endswith("attn_output.weight"):
        return GGMLType.Q5_K
    if name == "blk.1.ffn_down_exps.weight":
        return GGMLType.Q6_K
    return GGMLType.Q4_K


def test_tiny_moe_tensors_follow_the_8_expert_q4_k_m_recipe(tiny_moe):
    r = GGUFReader(tiny_moe)
    cfg = SHAPES["tiny-moe"]
    assert r.metadata["llama.expert_count"] == 8 and r.metadata["llama.expert_used_count"] == 2
    for i in range(cfg["n_layer"]):
        for kind in ("ffn_gate_inp", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            assert f"blk.{i}.{kind}.weight" in r.tensors
        assert f"blk.{i}.ffn_gate.weight" not in r.tensors
    for name, info in r.tensors.items():
        assert info.ggml_type == _expected_8_expert(name), name
    n_embd, n_ff = cfg["n_embd"], cfg["n_ff"]
    assert r.tensors["blk.0.ffn_gate_exps.weight"].shape == (n_embd, n_ff, 8)
    assert r.tensors["blk.1.ffn_down_exps.weight"].shape == (n_ff, n_embd, 8)
    assert r.tensors["blk.0.ffn_gate_inp.weight"].shape == (n_embd, 8)


@pytest.mark.parametrize("n_layer", [2, 32])
def test_dense_recipe_matches_the_jax_quantize_policy(n_layer):
    """Without experts the recipe is the JAX package's Q4_K_M policy."""
    for i in range(n_layer):
        for kind in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                     "ffn_down"):
            want = tensor_type_policy(f"blk.{i}.{kind}.weight", JGGMLType.Q4_K, "Q4_K_M",
                                      n_layer)
            assert int(preset_type("Q4_K_M", kind, i, n_layer)) == int(want), (i, kind)
    for kind in ("token_embd", "output"):
        want = tensor_type_policy(f"{kind}.weight", JGGMLType.Q4_K, "Q4_K_M", n_layer)
        assert int(preset_type("Q4_K_M", kind, 0, n_layer)) == int(want), kind


def test_mixtral_recipe_upgrades_ffn_down_exps_on_use_more_bits_layers():
    types = [preset_type("Q4_K_M", "ffn_down_exps", i, 32, 8) for i in range(32)]
    assert types.count(GGMLType.Q6_K) == 16 and types[0] == types[31] == GGMLType.Q6_K
    assert {preset_type("Q4_K_M", k, 5, 32, 8) for k in ("ffn_gate_exps", "ffn_up_exps",
                                                         "attn_q")} == {GGMLType.Q4_K}


@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_synth_bytes_come_from_the_seed(tmp_path, shape):
    a = make_synthetic_llama_gguf(tmp_path / "a.gguf", shape=shape, seed=0)
    b = make_synthetic_llama_gguf(tmp_path / "b.gguf", shape=shape, seed=0)
    c = make_synthetic_llama_gguf(tmp_path / "c.gguf", shape=shape, seed=1)
    assert _sha(a) == _sha(b) != _sha(c)


def test_moe_weights_have_unit_scale_activations(tiny_moe):
    """The MoE shapes set block scales so each matrix's RMS is n_in^-1/2."""
    from tpullm_torch.ops import qmatmul

    r = GGUFReader(tiny_moe)
    for name in ("blk.0.attn_q.weight", "blk.0.attn_k.weight", "blk.0.attn_output.weight",
                 "output.weight"):
        info = r.tensors[name]
        n_in, n_out = info.shape
        planes = qmatmul.repack(info.data, info.ggml_type, n_out, n_in, "cpu")
        rms = float(qmatmul.dequant_planes(planes, info.ggml_type, n_out, n_in)
                    .pow(2).mean().sqrt())
        assert 0.8 < rms * n_in ** 0.5 < 1.25, (name, rms)
    router = r.tensors["blk.0.ffn_gate_inp.weight"].to_numpy()
    assert 0.9 < float(np.sqrt((router ** 2).mean())) * router.shape[1] ** 0.5 < 1.1


@pytest.mark.parametrize("shape", ["llama-3-8b", "mixtral-8x7b"])
def test_preset_type_q4_k_m_is_the_old_recipe(shape):
    n_layer, n_expert = SHAPES[shape]["n_layer"], SHAPES[shape].get("n_expert", 0)
    for kind in KINDS:
        for i in range(n_layer):
            assert preset_type("Q4_K_M", kind, i, n_layer, n_expert) \
                == q4_k_m_type(kind, i, n_layer, n_expert), (kind, i)


@pytest.mark.parametrize("shape", ["tiny", "tiny-moe"])
def test_q4_k_m_bytes_are_unchanged(tmp_path, shape):
    assert _sha(make_synthetic_llama_gguf(tmp_path / "m.gguf", shape=shape, seed=0)) \
        == Q4_K_M_SHA256[shape]


def _table(ftype: str, kind: str, i: int, n: int) -> GGMLType:
    """The preset table of llama_tensor_get_type for a dense llama with
    n_gqa = 4 (n layers), written out row by row."""
    T = GGMLType
    if kind == "output":
        return T.Q6_K
    rows = {
        "Q2_K": dict(default=T.Q2_K, attn_v=T.Q4_K, attn_output=T.Q3_K, ffn_down=T.Q3_K),
        "Q3_K_M": dict(default=T.Q3_K, attn_v=T.Q5_K if i < 2 else T.Q4_K,
                       attn_output=T.Q4_K, ffn_down=T.Q5_K if i < n // 16 else T.Q4_K),
        "IQ4_NL": dict(default=T.IQ4_NL, attn_v=T.Q5_K,
                       ffn_down=T.Q5_K if i < n // 8 else T.IQ4_NL),
        "IQ4_XS": dict(default=T.IQ4_XS, attn_v=T.Q5_K,
                       ffn_down=T.Q5_K if i < n // 8 else T.IQ4_XS),
    }
    row = rows[ftype] if ftype in rows else dict(default=T[ftype])
    return row.get(kind, row["default"])


def _iq_table(ftype: str, kind: str, i: int, n: int, n_expert: int = 0) -> GGMLType:
    """The i-quant and ternary rows of llama_tensor_get_type (n_gqa = 4, no
    imatrix, n layers), written out row by row; with 8 experts the IQ1 and
    IQ2 presets make attn_k and attn_v Q4_K and attn_output Q5_K, and the
    expert stacks take their FFN kind's type."""
    T = GGMLType
    kind = kind.removesuffix("_exps")
    first = i < n // 8
    rows = {
        "IQ2_XXS": dict(default=T.IQ2_XXS, attn_v=T.Q4_K, ffn_down=T.Q2_K if first else T.IQ2_XXS,
                        output=T.Q5_K, token_embd=T.Q2_K),
        "IQ2_XS": dict(default=T.IQ2_XS, attn_v=T.Q4_K, ffn_down=T.Q2_K if first else T.IQ2_XS,
                       output=T.Q5_K, token_embd=T.Q2_K),
        "IQ2_M": dict(default=T.IQ2_S, attn_v=T.Q4_K, attn_output=T.IQ3_S,
                      ffn_down=T.IQ3_S if first else T.IQ2_S, output=T.Q5_K, token_embd=T.IQ3_S),
        "IQ1_S": dict(default=T.IQ1_S, attn_v=T.Q4_K, attn_output=T.IQ2_XXS,
                      ffn_down=T.Q2_K if first else T.IQ1_S, output=T.Q5_K, token_embd=T.Q2_K),
        "IQ1_M": dict(default=T.IQ1_M, attn_v=T.Q4_K, attn_output=T.IQ2_XXS,
                      ffn_down=T.Q2_K if first else T.IQ1_M, output=T.Q5_K, token_embd=T.Q2_K),
        "IQ3_XXS": dict(default=T.IQ3_XXS, attn_q=T.IQ2_S, attn_k=T.IQ2_S, attn_v=T.Q4_K,
                        ffn_down=T.Q4_K if first else T.Q3_K, output=T.Q5_K, token_embd=T.IQ3_S),
        "IQ3_M": dict(default=T.IQ3_S, attn_v=T.Q4_K, attn_output=T.Q4_K,
                      ffn_down=T.Q4_K if first else T.IQ3_S, output=T.Q6_K, token_embd=T.IQ3_S),
        "TQ1_0": dict(default=T.TQ1_0, output=T.Q6_K, token_embd=T.Q4_K),
        "TQ2_0": dict(default=T.TQ2_0, output=T.Q6_K, token_embd=T.Q4_K),
    }
    row = dict(rows[ftype])
    if n_expert == 8 and ftype in ("IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ1_S", "IQ1_M"):
        row.update(attn_k=T.Q4_K, attn_v=T.Q4_K, attn_output=T.Q5_K)
    return row.get(kind, row["default"])


IQ_PRESETS = ["IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ3_XXS", "IQ3_M", "TQ1_0",
              "TQ2_0"]


@pytest.mark.parametrize("ftype", IQ_PRESETS)
def test_iq_preset_types_follow_the_table(tmp_path, ftype):
    """The recipe at 32 layers (ffn_down of layers 0..3 takes the i < n/8
    type), at 2, and with 8 experts; the tiny file's tensors follow it."""
    for n, n_expert in ((32, 0), (2, 0), (32, 8)):
        kinds = KINDS if n_expert else [k for k in KINDS if "_exps" not in k]
        for i in range(n):
            for kind in kinds:
                if kind == "ffn_gate_inp":
                    continue
                assert preset_type(ftype, kind, i, n, n_expert) \
                    == _iq_table(ftype, kind, i, n, n_expert), (n, n_expert, i, kind)
    r = GGUFReader(make_synthetic_llama_gguf(tmp_path / "m.gguf", shape="tiny", ftype=ftype))
    for name, info in r.tensors.items():
        if name.endswith("norm.weight"):
            continue
        kind = name.split(".")[-2]
        i = int(name.split(".")[1]) if name.startswith("blk.") else 0
        assert info.ggml_type == _iq_table(ftype, kind, i, 2), name


@pytest.mark.parametrize("ftype", ["Q2_K", "Q3_K_M", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL",
                                   "IQ4_XS"])
def test_dense_preset_types_follow_the_table(tmp_path, ftype):
    for n in (32, 2):
        for i in range(n):
            for kind in ("token_embd", "attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                         "ffn_up", "ffn_down", "output"):
                assert preset_type(ftype, kind, i, n) == _table(ftype, kind, i, n), (n, i, kind)
    r = GGUFReader(make_synthetic_llama_gguf(tmp_path / "m.gguf", shape="tiny", ftype=ftype))
    for name, info in r.tensors.items():
        if name.endswith("norm.weight"):
            continue
        kind = name.split(".")[-2]
        i = int(name.split(".")[1]) if name.startswith("blk.") else 0
        assert info.ggml_type == _table(ftype, kind, i, 2), name


def test_legacy_presets_match_the_jax_quantize_policy():
    """For Q4_0, Q4_1, Q5_0 and Q5_1 the JAX package's policy is llama.cpp's
    (the type everywhere, Q6_K for the head)."""
    for ftype in ("Q4_0", "Q4_1", "Q5_0", "Q5_1"):
        for name, kind, i in (("token_embd.weight", "token_embd", 0),
                              ("blk.3.attn_v.weight", "attn_v", 3),
                              ("blk.0.ffn_down.weight", "ffn_down", 0),
                              ("output.weight", "output", 0)):
            want = tensor_type_policy(name, JGGMLType[ftype], ftype, 32)
            assert int(preset_type(ftype, kind, i, 32)) == int(want), (ftype, name)


def test_mxfp4_moe_types(tmp_path):
    """Every expert stack MXFP4, every other quantized tensor Q8_0, the
    router F32, on tiny-moe."""
    r = GGUFReader(make_synthetic_llama_gguf(tmp_path / "m.gguf", shape="tiny-moe",
                                             ftype="MXFP4_MOE"))
    for name, info in r.tensors.items():
        want = (GGMLType.F32 if name.endswith(("norm.weight", "ffn_gate_inp.weight"))
                else GGMLType.MXFP4 if "_exps" in name else GGMLType.Q8_0)
        assert info.ggml_type == want, name


def test_unknown_preset_raises():
    with pytest.raises(ValueError):
        preset_type("Q4_K_S", "attn_q", 0, 32)
    assert "MXFP4_MOE" in PRESETS and len(PRESETS) == 19
    assert set(IQ_PRESETS) < set(PRESETS)


@pytest.mark.parametrize("name", ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL", "Q2_K", "Q3_K",
                                  "IQ4_XS", "MXFP4", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS",
                                  "IQ3_S", "IQ1_S", "TQ1_0", "TQ2_0"])
def test_scale_fields_of_new_types_are_finite(name):
    """Every f16 scale field of every block is finite and d of
    scale·U(0.5, 1.5); MXFP4's exponent byte is the nearest 128 + log2(d)."""
    from tpullm_torch.gguf.constants import TYPE_TRAITS

    gtype = GGMLType[name]
    tt = TYPE_TRAITS[gtype]
    raw = random_packed(np.random.default_rng(4), gtype, 64 * tt.block_size, scale=0.02,
                        words=True).reshape(64, tt.type_size)
    if gtype == GGMLType.MXFP4:
        d = np.exp2(raw[:, 0].astype(np.float64) - 128)
        assert (raw[:, 0] >= 1).all() and (raw[:, 0] <= 254).all()
        assert (d > 0.01 / 2 ** 0.5).all() and (d < 0.03 * 2 ** 0.5).all()
        return
    for off in SCALE_FIELDS[gtype]:
        d = raw[:, off:off + 2].copy().view("<f2")[:, 0].astype(np.float64)
        assert np.isfinite(d).all() and (d >= 0.0099).all() and (d <= 0.0301).all(), off


def test_mxfp4_moe_weights_have_unit_scale_activations(tmp_path):
    """The MXFP4 expert stacks of tiny-moe at MXFP4_MOE have an RMS near
    n_in^-1/2: d rounds to a power of two, within a factor √2."""
    from tpullm_torch.models.weights import load_expert_stack
    from tpullm_torch.ops import qmatmul

    r = GGUFReader(make_synthetic_llama_gguf(tmp_path / "m.gguf", shape="tiny-moe",
                                             ftype="MXFP4_MOE"))
    for name in ("blk.0.ffn_gate_exps.weight", "blk.1.ffn_down_exps.weight"):
        st = load_expert_stack(r.tensors[name], "cpu")
        w = qmatmul.dequant_planes({k: v[0] for k, v in st.planes.items()}, st.gtype,
                                   st.n_out, st.n_in)
        rms = float(w.pow(2).mean().sqrt())
        assert 0.7 < rms * st.n_in ** 0.5 < 1.4, (name, rms)


def test_iq1_m_d_sits_in_the_top_nibbles_of_its_scale_words():
    """IQ1_M's f16 d, nibble k in the top nibble of scale word k (bytes
    48..55), as the JAX package's codec reads it; the other 12 bits of each
    word stay as drawn."""
    from tpullm.quant import iq_codecs as jiq

    from tpullm_torch.gguf.constants import TYPE_TRAITS

    tt = TYPE_TRAITS[GGMLType.IQ1_M]
    plain = np.random.default_rng(4).integers(0, 256, size=(64, tt.type_size), dtype=np.uint8)
    raw = random_packed(np.random.default_rng(4), GGMLType.IQ1_M, 64 * 256,
                        scale=0.02).reshape(64, tt.type_size)
    words = raw[:, 48:56].copy().view("<u2")
    d = ((words[:, 0] >> 12) | ((words[:, 1] >> 8) & 0xF0) | ((words[:, 2] >> 4) & 0xF00)
         | (words[:, 3] & 0xF000)).astype("<u2").view("<f2").astype(np.float64)
    assert (d >= 0.0099).all() and (d <= 0.0301).all()
    np.testing.assert_array_equal(words & 0x0FFF, plain[:, 48:56].copy().view("<u2") & 0x0FFF)
    np.testing.assert_array_equal(raw[:, :48], plain[:, :48])
    v = jiq.dequant_iq1_m(raw)
    assert np.isfinite(v).all() and 0 < np.abs(v).max() <= 0.0301 * 15 * 1.125


def test_tq2_0_fields_are_ternary():
    """TQ2_0's 2-bit fields are 0..2 (a 3, which decodes to +2, is never
    drawn), so every weight is -d, 0 or d."""
    from tpullm.quant import iq_codecs as jiq

    from tpullm_torch.gguf.constants import TYPE_TRAITS

    tt = TYPE_TRAITS[GGMLType.TQ2_0]
    raw = random_packed(np.random.default_rng(5), GGMLType.TQ2_0, 256 * 256,
                        words=True).reshape(256, tt.type_size)
    fields = (raw[:, :64, None] >> np.array([0, 2, 4, 6], dtype=np.uint8)) & 3
    assert fields.max() == 2 and (np.bincount(fields.reshape(-1), minlength=4)[:3] > 0).all()
    d = raw[:, 64:66].copy().view("<f2").astype(np.float32)
    v = jiq.dequant_tq2_0(raw)
    assert set(np.unique(np.round(v / d, 6))) == {-1.0, 0.0, 1.0}
