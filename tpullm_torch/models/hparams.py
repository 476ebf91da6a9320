"""Model hyperparameters read from GGUF metadata: the fields the llama
forward reads, and the metadata → hparams mapping for arch `llama`."""

from __future__ import annotations

from dataclasses import dataclass

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader


@dataclass(frozen=True)
class RopeParams:
    dims: int = 0  # rotary dims (<= head_dim)
    freq_base: float = 10000.0
    scaling_type: str = "none"  # none | linear | yarn
    scale_factor: float = 1.0
    orig_ctx: int = 0
    attn_factor: float = 1.0
    ext_factor: float = 0.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    # "norm" = rotate adjacent pairs (GGML interleaved, llama GGUF layout);
    # "neox" = rotate halves (GPT-NeoX/HF layout)
    style: str = "norm"


@dataclass(frozen=True)
class HParams:
    arch: str
    n_vocab: int
    n_ctx_train: int
    n_embd: int
    n_layer: int
    n_head: int
    n_head_kv: int
    n_ff: int
    head_dim: int
    head_dim_v: int
    rms_eps: float
    rope: RopeParams
    # ALiBi: >0 replaces rope with per-head linear position bias
    max_alibi_bias: float = 0.0
    sliding_window: int = 0
    attn_scale: float | None = None
    embd_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # NoPE interleave: every Nth layer skips rope; 0 = never
    no_rope_step: int = 0
    # MoE (mixtral rides arch llama): experts per layer, experts per token
    n_expert: int = 0
    n_expert_used: int = 0
    pooling: str = "none"  # embeddings' default pooling (llama_pooling_type)


def hparams_from_gguf(r: GGUFReader) -> HParams:
    arch = r.architecture
    if arch != "llama":
        raise NotImplementedError(f"hparams for architecture {arch!r} are not ported")

    def k(template, default=None):
        v = r.metadata.get(template.format(arch=arch))
        return default if v is None else v

    n_embd = int(k(Keys.LLM.EMBEDDING_LENGTH))
    n_head = int(k(Keys.Attention.HEAD_COUNT))
    n_head_kv = int(k(Keys.Attention.HEAD_COUNT_KV, n_head))
    head_dim = int(k(Keys.Attention.KEY_LENGTH, n_embd // max(n_head, 1)))
    head_dim_v = int(k(Keys.Attention.VALUE_LENGTH, head_dim))

    n_vocab = k(Keys.LLM.VOCAB_SIZE)
    if n_vocab is None:
        toks = r.metadata.get(Keys.Tokenizer.LIST)
        n_vocab = len(toks) if toks is not None else 0

    rope = RopeParams(
        dims=int(k(Keys.Rope.DIMENSION_COUNT, head_dim)),
        freq_base=float(k(Keys.Rope.FREQ_BASE, 10000.0)),
        scaling_type=str(k(Keys.Rope.SCALING_TYPE, "none") or "none"),
        scale_factor=float(k(Keys.Rope.SCALING_FACTOR, 1.0)),
        orig_ctx=int(k(Keys.Rope.SCALING_ORIG_CTX_LEN, 0)),
        attn_factor=float(k(Keys.Rope.SCALING_ATTN_FACTOR, 1.0)),
        ext_factor=float(k(Keys.Rope.SCALING_YARN_EXT_FACTOR, 0.0)),
        beta_fast=float(k(Keys.Rope.SCALING_YARN_BETA_FAST, 32.0)),
        beta_slow=float(k(Keys.Rope.SCALING_YARN_BETA_SLOW, 1.0)),
        style="norm",  # llama GGUFs carry q/k permuted for interleaved pairs
    )
    scale = k(Keys.Attention.SCALE)
    return HParams(
        arch=arch,
        n_vocab=int(n_vocab),
        n_ctx_train=int(k(Keys.LLM.CONTEXT_LENGTH, 2048)),
        n_embd=n_embd,
        n_layer=int(k(Keys.LLM.BLOCK_COUNT)),
        n_head=n_head,
        n_head_kv=n_head_kv,
        n_ff=int(k(Keys.LLM.FEED_FORWARD_LENGTH, 0)),
        head_dim=head_dim,
        head_dim_v=head_dim_v,
        rms_eps=float(k(Keys.Attention.LAYERNORM_RMS_EPS,
                        k(Keys.Attention.LAYERNORM_EPS, 1e-5))),
        rope=rope,
        max_alibi_bias=float(k(Keys.Attention.MAX_ALIBI_BIAS, 0.0)),
        sliding_window=int(k(Keys.Attention.SLIDING_WINDOW, 0)),
        attn_scale=float(scale) if scale is not None else None,
        embd_scale=float(k("{arch}.embedding_scale", 1.0)),
        residual_scale=float(k("{arch}.residual_scale", 1.0)),
        logit_scale=float(k("{arch}.logit_scale", 1.0)),
        no_rope_step=int(k("{arch}.attention.no_rope_layer_step", 0)),
        n_expert=int(k(Keys.LLM.EXPERT_COUNT, 0)),
        n_expert_used=int(k(Keys.LLM.EXPERT_USED_COUNT, 0)),
        pooling={0: "none", 1: "mean", 2: "cls", 3: "last", 4: "rank"}.get(
            int(k("{arch}.pooling_type", 0)), "none"),
    )
