"""Synthesis of random *packed* llama models from a seed.

Writes GGUF files whose quantized payloads are random codes with sane
scales: numerically meaningless, but byte-layout-identical to real models,
so the load, repack, kernel and engine paths run at true shapes without a
download. The types follow llama.cpp's recipe of a preset (`preset_type`:
Q4_K_M with its branch for 8-expert models, Q2_K, Q3_K_M, the legacy and
IQ4 presets, MXFP4_MOE, the i-quant presets IQ1_S .. IQ3_M and the ternary
TQ1_0 and TQ2_0). Payloads are drawn while the file is written, one
tensor at a time, so a 28 GB model never sits in host memory.
"""

from __future__ import annotations

import math

import numpy as np

from ..gguf.constants import GGMLType, MXFP4_VALUES, TokenType, TYPE_TRAITS
from ..gguf.writer import GGUFWriter

# `legacy` shapes keep their first bytes: block scales d of 0.02·U(0.5, 1.5),
# which give weights of RMS 1.5 to 28 and attention that is all but one-hot,
# and at Q4_K_M uint8 draws. The other shapes draw uint32 words, as every
# other preset does, and set d so that every weight matrix has an RMS of
# n_in^-1/2, as a trained model's has.
SHAPES = {
    "llama-3-8b": dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                       n_ff=14336, n_vocab=128256, rope_base=500000.0, legacy=True),
    # the test model: every width a multiple of 128, and of 256 on K
    "tiny": dict(n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                 n_ff=512, n_vocab=384, rope_base=10000.0, legacy=True),
    # mistralai/Mixtral-8x7B-v0.1 config.json (n_ff = intermediate_size, the
    # width of one expert)
    "mixtral-8x7b": dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                         n_ff=14336, n_vocab=32000, rope_base=1000000.0,
                         n_expert=8, n_expert_used=2),
    # the MoE test model: 8 experts, so the recipe takes its 8-expert branch,
    # and layer 1 is a use_more_bits layer (Q6_K ffn_down_exps)
    "tiny-moe": dict(n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                     n_ff=512, n_vocab=384, rope_base=10000.0,
                     n_expert=8, n_expert_used=2),
}

# byte offsets of the f16 scale fields per block that random_packed sets to
# d (every other byte stays random); MXFP4 holds an e8m0 exponent byte at 0,
# IQ1_M its f16 d in the top nibbles of the four scale words at bytes 48-55
SCALE_FIELDS = {
    GGMLType.Q4_0: (0,), GGMLType.Q5_0: (0,), GGMLType.IQ4_NL: (0,), GGMLType.IQ4_XS: (0,),
    GGMLType.Q8_0: (0,),
    GGMLType.Q4_1: (0, 2), GGMLType.Q5_1: (0, 2),  # d and m
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2),  # d and dmin
    GGMLType.Q2_K: (80, 82),  # d and dmin
    GGMLType.Q3_K: (108,),
    GGMLType.Q6_K: (208,),
    GGMLType.IQ2_XXS: (0,), GGMLType.IQ2_XS: (0,), GGMLType.IQ2_S: (0,),
    GGMLType.IQ3_XXS: (0,), GGMLType.IQ3_S: (0,), GGMLType.IQ1_S: (0,),
    GGMLType.TQ1_0: (52,), GGMLType.TQ2_0: (64,),
}

# RMS of a decoded weight per unit block scale d, over random_packed's draws
# (the sub-scales and codes are random bytes); MXFP4's is its table's RMS
_RMS_PER_D = {GGMLType.Q8_0: 77.2, GGMLType.Q4_K: 311.0, GGMLType.Q5_K: 677.9,
              GGMLType.Q6_K: 1410.7,
              GGMLType.MXFP4: math.sqrt(sum(v * v for v in MXFP4_VALUES) / 16),
              # over a [1024, 4096] draw of each (uint32 words, seed 0)
              GGMLType.Q2_K: 13.94, GGMLType.Q3_K: 45.3, GGMLType.IQ2_XXS: 55.4,
              GGMLType.IQ2_XS: 58.0, GGMLType.IQ2_S: 58.8, GGMLType.IQ3_XXS: 148.2,
              GGMLType.IQ3_S: 146.7, GGMLType.IQ1_S: 7.48, GGMLType.IQ1_M: 7.50,
              GGMLType.TQ1_0: 0.852, GGMLType.TQ2_0: 0.736}

PRESETS = ("Q4_K_M", "Q2_K", "Q3_K_M", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL", "IQ4_XS",
           "MXFP4_MOE", "IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ3_XXS", "IQ3_M",
           "TQ1_0", "TQ2_0")
# the i-quant presets of 1 and 2 bits, which llama.cpp treats alike
_LOW_BIT = ("IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_M")

DEFAULT_WORDS = [
    "▁the", "▁quick", "▁brown", "▁fox", "▁jumps", "▁over", "▁lazy", "▁dog",
    "▁hello", "▁world", "he", "ll", "o", "wor", "ld", "▁a", "▁an", "ing", "ed",
    "▁", "t", "h", "e", "a", "s", "d", "f", "g",
]


def _byte_vocab(extra_words: list[str]) -> tuple[list[str], list[float], list[int]]:
    """A functional SPM vocab: control tokens, the 256 byte tokens, words."""
    tokens = ["<unk>", "<s>", "</s>"]
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL]
    scores = [-99.0, -99.0, -99.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(TokenType.BYTE)
        scores.append(-98.0)
    for i, w in enumerate(extra_words):
        tokens.append(w)
        types.append(TokenType.NORMAL)
        scores.append(-float(i))
    return tokens, scores, types


# Llama-3's special tokens, in its order from id n_vocab - 256; the rest of
# its 256 are <|reserved_special_token_3|> .. <|reserved_special_token_247|>
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                   "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                   "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                   "<|eom_id|>", "<|eot_id|>", "<|python_tag|>")
BPE_MAX_TOKEN_CHARS = 16  # merged tokens of the synthetic BPE vocab are at most this long


def _bpe_vocab(n_vocab: int, seed: int) -> tuple[list[str], list[int], list[str], dict]:
    """A functional byte-level BPE vocab as llama.cpp writes Llama-3's
    (tokens, types, merges and the special ids): the 256 GPT-2 byte tokens,
    then merged tokens, then Llama-3's special tokens (256 of them, or 16
    below a 4096-token vocab). The first merges spell the words of
    DEFAULT_WORDS, with and without a leading space ("Ġ"), left to right;
    the rest join two tokens drawn from `seed` (earlier tokens more often),
    up to BPE_MAX_TOKEN_CHARS characters, until the vocab is full."""
    from ..tokenizer.bpe import byte_to_unicode

    b2u = byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges: list[str] = []
    n_special = 256 if n_vocab >= 4096 else 16
    n_merged = n_vocab - 256 - n_special
    if n_merged < 0:
        raise ValueError(f"a BPE vocab needs at least {256 + n_special} tokens")
    have = set(tokens)

    def merge(a: str, b: str) -> bool:
        if len(merges) >= n_merged or a + b in have:
            return False
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        have.add(a + b)
        return True

    for word in DEFAULT_WORDS:
        for spelled in ("".join(b2u[b] for b in word.replace("▁", " ").encode()),
                        "".join(b2u[b] for b in word.replace("▁", "").encode())):
            for i in range(2, len(spelled) + 1):
                merge(spelled[:i - 1], spelled[i - 1])
    rng = np.random.default_rng([seed, 0xB9E])
    while len(merges) < n_merged:
        a = tokens[int(len(tokens) * rng.random() ** 2)]
        b = tokens[int(len(tokens) * rng.random() ** 2)]
        if len(a) + len(b) <= BPE_MAX_TOKEN_CHARS:
            merge(a, b)
    types = [TokenType.NORMAL] * len(tokens)
    first = len(tokens)
    tokens += list(LLAMA3_SPECIALS) + [f"<|reserved_special_token_{i}|>"
                                       for i in range(3, 3 + n_special - len(LLAMA3_SPECIALS))]
    types += [TokenType.CONTROL] * n_special
    special = dict(bos=first, eos=first + 1, eot=first + 9, eom=first + 8)
    return tokens, types, merges, special


def use_more_bits(i_layer: int, n_layer: int) -> bool:
    """The Q4_K_M layer pattern that upgrades attn_v and ffn_down
    (llama.cpp llama-quant.cpp)."""
    return (i_layer < n_layer // 8 or i_layer >= 7 * n_layer // 8
            or (i_layer - n_layer // 8) % 3 == 2)


def preset_type(ftype: str, kind: str, i_layer: int, n_layer: int,
                n_expert: int = 0) -> GGMLType:
    """The type llama.cpp's recipe `ftype` (a name of PRESETS) gives a llama
    tensor (llama_tensor_get_type in src/llama-quant.cpp, for a llama with
    n_gqa = 4 and no imatrix). `kind` is the tensor name without `blk.N.`
    and `.weight`; an expert stack (`*_exps`) takes its FFN kind's type.
    The router (ffn_gate_inp) is never quantized.

    | ftype | default | attn_v | attn_output | ffn_down | output | token_embd |
    | Q4_K_M | Q4_K | Q6_K on use_more_bits layers | Q4_K | Q6_K on use_more_bits layers | Q6_K | Q4_K |
    | Q2_K | Q2_K | Q4_K | Q3_K | Q3_K | Q6_K | Q2_K |
    | Q3_K_M | Q3_K | Q5_K for layers 0-1, else Q4_K | Q4_K | Q5_K for i < n/16, else Q4_K | Q6_K | Q3_K |
    | Q4_0, Q4_1, Q5_0, Q5_1 | that type | default | default | default | Q6_K | default |
    | IQ4_NL, IQ4_XS | that type | Q5_K | default | Q5_K for i < n/8, else default | Q6_K | default |
    | MXFP4_MOE | Q8_0 | Q8_0 | Q8_0 | Q8_0 | Q8_0 | Q8_0 |
    | IQ2_XXS, IQ2_XS | that type | Q4_K | default | Q2_K for i < n/8 | Q5_K | Q2_K |
    | IQ2_M | IQ2_S | Q4_K | IQ3_S | IQ3_S for i < n/8 | Q5_K | IQ3_S |
    | IQ1_S, IQ1_M | that type | Q4_K | IQ2_XXS | Q2_K for i < n/8 | Q5_K | Q2_K |
    | IQ3_XXS | IQ3_XXS (attn_q, attn_k IQ2_S) | Q4_K | default | Q4_K for i < n/8, else Q3_K | Q5_K | IQ3_S |
    | IQ3_M | IQ3_S | Q4_K | Q4_K | Q4_K for i < n/8 | Q6_K | IQ3_S |
    | TQ1_0, TQ2_0 | that type | default | default | default | Q6_K | Q4_K |

    MXFP4_MOE makes every expert stack MXFP4. Q4_K_M with exactly 8
    experts makes attn_k and attn_v Q8_0 and attn_output Q5_K; the IQ1 and
    IQ2 presets with exactly 8 experts make attn_k and attn_v Q4_K and
    attn_output Q5_K."""
    if kind == "ffn_gate_inp":
        return GGMLType.F32
    if ftype == "MXFP4_MOE":
        return GGMLType.MXFP4 if kind.endswith("_exps") else GGMLType.Q8_0
    kind = kind.removesuffix("_exps")
    if ftype == "Q4_K_M":
        if kind == "output":
            return GGMLType.Q6_K
        if n_expert == 8 and kind in ("attn_k", "attn_v"):
            return GGMLType.Q8_0
        if n_expert == 8 and kind == "attn_output":
            return GGMLType.Q5_K
        if kind in ("attn_v", "ffn_down") and use_more_bits(i_layer, n_layer):
            return GGMLType.Q6_K
        return GGMLType.Q4_K
    if ftype in _LOW_BIT or ftype == "IQ3_XXS":
        return _iq_type(ftype, kind, i_layer, n_layer, n_expert)
    if ftype == "IQ3_M":
        if kind in ("attn_v", "attn_output") or (kind == "ffn_down" and i_layer < n_layer // 8):
            return GGMLType.Q4_K
        return {"output": GGMLType.Q6_K, "token_embd": GGMLType.IQ3_S}.get(kind, GGMLType.IQ3_S)
    if ftype in ("TQ1_0", "TQ2_0"):
        return {"output": GGMLType.Q6_K, "token_embd": GGMLType.Q4_K}.get(kind, GGMLType[ftype])
    if kind == "output":
        return GGMLType.Q6_K
    if ftype == "Q2_K":
        return {"attn_v": GGMLType.Q4_K, "attn_output": GGMLType.Q3_K,
                "ffn_down": GGMLType.Q3_K}.get(kind, GGMLType.Q2_K)
    if ftype == "Q3_K_M":
        if kind == "attn_v":
            return GGMLType.Q5_K if i_layer < 2 else GGMLType.Q4_K
        if kind == "ffn_down":
            return GGMLType.Q5_K if i_layer < n_layer // 16 else GGMLType.Q4_K
        return GGMLType.Q4_K if kind == "attn_output" else GGMLType.Q3_K
    if ftype in ("IQ4_NL", "IQ4_XS"):
        if kind == "attn_v" or (kind == "ffn_down" and i_layer < n_layer // 8):
            return GGMLType.Q5_K
        return GGMLType[ftype]
    if ftype in ("Q4_0", "Q4_1", "Q5_0", "Q5_1"):
        return GGMLType[ftype]
    raise ValueError(f"unknown preset {ftype!r}; presets: {PRESETS}")


def _iq_type(ftype: str, kind: str, i_layer: int, n_layer: int, n_expert: int) -> GGMLType:
    """preset_type of the IQ1, IQ2 and IQ3_XXS presets."""
    if kind == "output":
        return GGMLType.Q5_K
    if n_expert == 8 and ftype in _LOW_BIT:
        if kind in ("attn_k", "attn_v"):
            return GGMLType.Q4_K
        if kind == "attn_output":
            return GGMLType.Q5_K
    if kind == "attn_v":
        return GGMLType.Q4_K
    first = i_layer < n_layer // 8
    if ftype == "IQ3_XXS":
        if kind == "ffn_down":
            return GGMLType.Q4_K if first else GGMLType.Q3_K
        return {"attn_q": GGMLType.IQ2_S, "attn_k": GGMLType.IQ2_S,
                "token_embd": GGMLType.IQ3_S}.get(kind, GGMLType.IQ3_XXS)
    if ftype == "IQ2_M":
        if kind in ("attn_output", "token_embd") or (kind == "ffn_down" and first):
            return GGMLType.IQ3_S
        return GGMLType.IQ2_S
    if kind == "token_embd" or (kind == "ffn_down" and first):
        return GGMLType.Q2_K
    if kind == "attn_output" and ftype in ("IQ1_S", "IQ1_M"):
        return GGMLType.IQ2_XXS
    return GGMLType[ftype]


def write_scales(raw, gtype: GGMLType, d) -> None:
    """Sets the scale fields of blocks `raw` (nb, type_size) uint8 to d (nb
    positive values): an f16 d at each offset of SCALE_FIELDS, for MXFP4
    the e8m0 exponent byte nearest 128 + log2(d), kept in 1..254, for IQ1_M
    nibble k of the f16 d in the top nibble of scale word k. TQ2_0's 2-bit
    fields of 3, which decode to +2 and which no ternary file holds, become
    1 (the weight 0). Works on numpy arrays and on torch tensors alike, on
    any device."""
    if gtype == GGMLType.MXFP4:
        if isinstance(raw, np.ndarray):
            raw[:, 0] = np.clip(np.rint(128 + np.log2(d)), 1, 254).astype(np.uint8)
        else:
            import torch

            raw[:, 0] = torch.clamp(torch.round(128 + torch.log2(d)), 1, 254).to(torch.uint8)
        return
    if isinstance(raw, np.ndarray):
        db = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    else:
        import torch

        db = d.to(torch.float16).view(torch.uint8).reshape(-1, 2)
    if gtype == GGMLType.IQ1_M:
        # the high byte of word k (byte 49 + 2k) takes nibble k of d in its top nibble
        for k in range(4):
            nib = (db[:, k // 2] >> (4 * (k % 2))) & 0x0F
            raw[:, 49 + 2 * k] = (raw[:, 49 + 2 * k] & 0x0F) | (nib << 4)
        return
    if gtype == GGMLType.TQ2_0:
        q = raw[:, 0:64]
        raw[:, 0:64] = q & ~((q & (q >> 1) & 0x55) << 1)
    for off in SCALE_FIELDS[gtype]:
        raw[:, off: off + 2] = db


def random_packed(rng: np.random.Generator, gtype: GGMLType, n_elements: int,
                  scale: float = 0.02, words: bool = False) -> np.ndarray:
    """Random blocks of `gtype` with finite block scales d of
    scale·U(0.5, 1.5), as flat uint8. With `words` the bytes come from
    uint32 draws (about twice the byte rate of uint8 draws, other bytes from
    the same seed)."""
    tt = TYPE_TRAITS[gtype]
    nb = n_elements // tt.block_size
    n = nb * tt.type_size
    if words:
        raw = rng.integers(0, 2**32, size=-(-n // 4), dtype=np.uint32).view(np.uint8)
        raw = raw[:n].reshape(nb, tt.type_size)
    else:
        raw = rng.integers(0, 256, size=(nb, tt.type_size), dtype=np.uint8)
    write_scales(raw, gtype, rng.uniform(0.5, 1.5, size=nb) * scale)
    return raw.reshape(-1)


def make_synthetic_llama_gguf(path, shape: str = "llama-3-8b", seed: int = 0,
                              ftype: str = "Q4_K_M", n_layer: int | None = None,
                              n_vocab: int | None = None, vocab: str = "spm") -> str:
    """Writes the synthetic model `shape` (a key of SHAPES) at preset
    `ftype` (a name of PRESETS) to `path`, with `n_layer` layers and
    `n_vocab` tokens in place of the shape's own if given (an SPM vocab
    below the shape's keeps its first n_vocab tokens); the same arguments
    give the same bytes. `vocab` "spm" writes an SPM vocab
    (tokenizer.ggml.model "llama"), "bpe" a byte-level BPE vocab with
    merges as a Llama-3 GGUF carries it (model "gpt2", pre "llama-bpe":
    `_bpe_vocab`); the weights are the same either way."""
    synthetic_writer(path, shape, seed, ftype, n_layer, n_vocab, vocab).write()
    return str(path)


def synthetic_writer(path, shape: str = "llama-3-8b", seed: int = 0, ftype: str = "Q4_K_M",
                     n_layer: int | None = None, n_vocab: int | None = None,
                     vocab: str = "spm") -> GGUFWriter:
    """The writer of make_synthetic_llama_gguf, its payloads not drawn yet
    (`payload_bytes()` sizes the file before it is written)."""
    if ftype not in PRESETS:
        raise ValueError(f"unknown preset {ftype!r}; presets: {PRESETS}")
    if vocab not in ("spm", "bpe"):
        raise ValueError(f"unknown vocab {vocab!r}: 'spm' or 'bpe'")
    cfg = SHAPES[shape]
    rng = np.random.default_rng(seed)
    n_layer, n_embd = n_layer or cfg["n_layer"], cfg["n_embd"]
    n_head, n_head_kv, n_ff = cfg["n_head"], cfg["n_head_kv"], cfg["n_ff"]
    n_vocab = n_vocab or cfg["n_vocab"]
    n_expert = cfg.get("n_expert", 0)
    head_dim = n_embd // n_head
    legacy = cfg.get("legacy", False)
    words = not legacy or ftype != "Q4_K_M"

    if vocab == "spm":
        tokens, scores, types = _byte_vocab(DEFAULT_WORDS)
        while len(tokens) < n_vocab:  # pad the vocab with filler tokens
            tokens.append(f"<extra_{len(tokens)}>")
            scores.append(-1e6)
            types.append(TokenType.USER_DEFINED)
    else:
        tokens, types, merges, special = _bpe_vocab(n_vocab, seed)

    w = GGUFWriter(path, architecture="llama")
    w.add_kv("general.name", f"tpullm-synth-{shape}" + ("" if ftype == "Q4_K_M" else f"-{ftype}")
             + ("" if n_vocab == cfg["n_vocab"] else f"-v{n_vocab}")
             + ("" if vocab == "spm" else "-bpe"))
    w.add_kv("llama.block_count", n_layer)
    w.add_kv("llama.context_length", 8192)
    w.add_kv("llama.embedding_length", n_embd)
    w.add_kv("llama.feed_forward_length", n_ff)
    w.add_kv("llama.attention.head_count", n_head)
    w.add_kv("llama.attention.head_count_kv", n_head_kv)
    w.add_kv("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_kv("llama.rope.freq_base", cfg["rope_base"])
    w.add_kv("llama.rope.dimension_count", head_dim)
    w.add_kv("llama.vocab_size", n_vocab)
    if n_expert:
        w.add_kv("llama.expert_count", n_expert)
        w.add_kv("llama.expert_used_count", cfg["n_expert_used"])
    if vocab == "spm":
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", tokens[:n_vocab])
        w.add_kv("tokenizer.ggml.scores", np.asarray(scores[:n_vocab], dtype=np.float32))
        w.add_kv("tokenizer.ggml.token_type", np.asarray(types[:n_vocab], dtype=np.int32))
        w.add_kv("tokenizer.ggml.bos_token_id", 1)
        w.add_kv("tokenizer.ggml.eos_token_id", 2)
    else:
        w.add_kv("tokenizer.ggml.model", "gpt2")
        w.add_kv("tokenizer.ggml.pre", "llama-bpe")
        w.add_kv("tokenizer.ggml.tokens", tokens)
        w.add_kv("tokenizer.ggml.token_type", np.asarray(types, dtype=np.int32))
        w.add_kv("tokenizer.ggml.merges", merges)
        w.add_kv("tokenizer.ggml.bos_token_id", special["bos"])
        w.add_kv("tokenizer.ggml.eos_token_id", special["eos"])
        w.add_kv("tokenizer.ggml.eot_token_id", special["eot"])
        w.add_kv("tokenizer.ggml.eom_token_id", special["eom"])
    w.add_kv("tokenizer.ggml.add_bos_token", True)

    def packed(name, n_out, n_in, i=0, n_stack=1):
        """A quantized weight (n_stack > 1: a stack of experts), its bytes
        drawn when the file is written."""
        kind = name.split(".")[-2]
        gtype = preset_type(ftype, kind, i, n_layer, n_expert)
        shape = (n_in, n_out) if n_stack == 1 else (n_in, n_out, n_stack)
        scale = 0.02 if legacy else n_in ** -0.5 / _RMS_PER_D[gtype]
        w.add_packed_tensor(name, shape, gtype, lambda: random_packed(
            rng, gtype, n_stack * n_out * n_in, scale=scale, words=words))

    def norm(name, n):
        w.add_tensor(name, np.ones(n, dtype=np.float32))

    packed("token_embd.weight", n_vocab, n_embd)
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        packed(p + "attn_q.weight", n_head * head_dim, n_embd, i)
        packed(p + "attn_k.weight", n_head_kv * head_dim, n_embd, i)
        packed(p + "attn_v.weight", n_head_kv * head_dim, n_embd, i)
        packed(p + "attn_output.weight", n_embd, n_head * head_dim, i)
        norm(p + "ffn_norm.weight", n_embd)
        if n_expert:
            # the router: f32 normal / sqrt(n_embd), so its logits have unit scale
            w.add_packed_tensor(p + "ffn_gate_inp.weight", (n_embd, n_expert), GGMLType.F32,
                                lambda: (rng.standard_normal((n_expert, n_embd))
                                         * n_embd ** -0.5).astype("<f4").reshape(-1).view(np.uint8))
            packed(p + "ffn_gate_exps.weight", n_ff, n_embd, i, n_expert)
            packed(p + "ffn_up_exps.weight", n_ff, n_embd, i, n_expert)
            packed(p + "ffn_down_exps.weight", n_embd, n_ff, i, n_expert)
        else:
            packed(p + "ffn_gate.weight", n_ff, n_embd, i)
            packed(p + "ffn_up.weight", n_ff, n_embd, i)
            packed(p + "ffn_down.weight", n_embd, n_ff, i)
    norm("output_norm.weight", n_embd)
    packed("output.weight", n_vocab, n_embd)
    return w
