"""Synthesis of random *packed* llama models from a seed.

Writes GGUF files whose quantized payloads are random codes with sane
scales: numerically meaningless, but byte-layout-identical to real models,
so the load, repack, kernel and engine paths run at true shapes without a
download. The type recipe is Q4_K_M's: Q4_K everywhere, Q6_K for attn_v and
ffn_down on the `use_more_bits` layers, a Q6_K output head.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, TokenType, TYPE_TRAITS
from ..gguf.writer import GGUFWriter

SHAPES = {
    "llama-3-8b": dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                       n_ff=14336, n_vocab=128256, rope_base=500000.0),
    # the test model: every width a multiple of 128, and of 256 on K
    "tiny": dict(n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                 n_ff=512, n_vocab=384, rope_base=10000.0),
}

# byte offsets of the f16 scale fields per block that must be finite/small
_SCALE_FIELDS = {
    GGMLType.Q4_K: (0, 2),
    GGMLType.Q6_K: (208,),
}

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


def use_more_bits(i_layer: int, n_layer: int) -> bool:
    """The Q4_K_M layer pattern that upgrades attn_v and ffn_down
    (llama.cpp llama-quant.cpp)."""
    return (i_layer < n_layer // 8 or i_layer >= 7 * n_layer // 8
            or (i_layer - n_layer // 8) % 3 == 2)


def random_packed(rng: np.random.Generator, gtype: GGMLType, n_elements: int,
                  scale: float = 0.02) -> bytes:
    tt = TYPE_TRAITS[gtype]
    nb = n_elements // tt.block_size
    raw = rng.integers(0, 256, size=(nb, tt.type_size), dtype=np.uint8)
    d = (rng.uniform(0.5, 1.5, size=nb) * scale).astype(np.float16)
    db = d.view(np.uint8).reshape(nb, 2)
    for off in _SCALE_FIELDS[gtype]:
        raw[:, off: off + 2] = db
    return raw.reshape(-1).tobytes()


def make_synthetic_llama_gguf(path, shape: str = "llama-3-8b",
                              weight_type: GGMLType = GGMLType.Q4_K,
                              head_type: GGMLType = GGMLType.Q6_K,
                              seed: int = 0) -> str:
    cfg = SHAPES[shape]
    rng = np.random.default_rng(seed)
    n_layer, n_embd = cfg["n_layer"], cfg["n_embd"]
    n_head, n_head_kv, n_ff = cfg["n_head"], cfg["n_head_kv"], cfg["n_ff"]
    n_vocab = cfg["n_vocab"]
    head_dim = n_embd // n_head

    tokens, scores, types = _byte_vocab(DEFAULT_WORDS)
    while len(tokens) < n_vocab:  # pad the vocab with filler tokens
        tokens.append(f"<extra_{len(tokens)}>")
        scores.append(-1e6)
        types.append(TokenType.USER_DEFINED)

    w = GGUFWriter(path, architecture="llama")
    w.add_kv("general.name", f"tpullm-synth-{shape}")
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
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", tokens[:n_vocab])
    w.add_kv("tokenizer.ggml.scores", np.asarray(scores[:n_vocab], dtype=np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.asarray(types[:n_vocab], dtype=np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    w.add_kv("tokenizer.ggml.add_bos_token", True)

    def packed(name, n_out, n_in, gtype):
        w.add_packed_tensor(name, (n_in, n_out), gtype,
                            random_packed(rng, gtype, n_out * n_in))

    def norm(name, n):
        w.add_tensor(name, np.ones(n, dtype=np.float32))

    def bump(i):
        if head_type != weight_type and use_more_bits(i, n_layer):
            return GGMLType.Q6_K
        return weight_type

    packed("token_embd.weight", n_vocab, n_embd, weight_type)
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        packed(p + "attn_q.weight", n_head * head_dim, n_embd, weight_type)
        packed(p + "attn_k.weight", n_head_kv * head_dim, n_embd, weight_type)
        packed(p + "attn_v.weight", n_head_kv * head_dim, n_embd, bump(i))
        packed(p + "attn_output.weight", n_embd, n_head * head_dim, weight_type)
        norm(p + "ffn_norm.weight", n_embd)
        packed(p + "ffn_gate.weight", n_ff, n_embd, weight_type)
        packed(p + "ffn_up.weight", n_ff, n_embd, weight_type)
        packed(p + "ffn_down.weight", n_embd, n_ff, bump(i))
    norm("output_norm.weight", n_embd)
    packed("output.weight", n_vocab, n_embd, head_type)
    w.write()
    return str(path)
