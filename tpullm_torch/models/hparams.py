"""Model hyperparameters read from GGUF metadata: the fields the llama,
qwen-moe (olmoe), gemma, deepseek2 (minicpm3, plm), phi2, phimoe, falcon,
bloom, gpt2, llama4, mamba (falcon-mamba, mamba2) and jamba (nemotron_h,
granitehybrid, nemotron_h_moe, falcon-h1) forwards read,
and the metadata → hparams mapping for the archs the port runs (`ARCHS`),
as the JAX package's models/hparams.py maps them."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader

# the archs whose metadata this module maps (models/registry.py runs them):
# the llama graph and its aliases (those that ride its options apart), the
# qwen-moe graph and its aliases, the gemma family, deepseek2 and its MLA
# aliases minicpm3 and plm, phi3, phi2, phimoe and qwen (v1), the falcon
# family, the ALiBi family (bloom, mpt, jais: no RoPE), gpt2 / starcoder
# (learned positions: no RoPE), olmoe (the qwen-moe graph), llama4 and the
# recurrent archs (MAMBA_ARCHS, HYBRID_ARCHS)
LLAMA_ALIASES = ("mistral", "qwen2", "qwen3", "granite", "internlm2", "exaone", "smollm3",
                 "minicpm", "xverse", "ernie4_5", "refact", "baichuan", "mistral3",
                 "pangu-embedded", "seed_oss", "maincoder", "hunyuan-dense")
# the llama graph's options: arcee's gateless ReLU² FFN, apertus' xIELU,
# llama-embed's non-causal embeddings, the VL text stacks' M-RoPE (and
# qwen3vl's input embeddings with deepstack residuals)
LLAMA_OPTION_ALIASES = ("arcee", "apertus", "llama-embed", "qwen2vl", "qwen3vl")
QWEN_MOE_ALIASES = ("qwen2moe", "deepseek", "granitemoe", "ernie4_5-moe", "dots1",
                    "hunyuan-moe", "minimax-m2", "bailingmoe", "bailingmoe2", "glm4moe",
                    "exaone-moe")
FALCON_ARCHS = ("falcon", "gptneox", "codeshell")
BLOOM_ARCHS = ("bloom", "mpt", "jais")
GPT2_ARCHS = ("gpt2", "starcoder")
# the recurrent-state archs: the pure SSMs (models/mamba.py) and the hybrids
# of attention and SSM layers (models/jamba.py)
MAMBA_ARCHS = ("mamba", "falcon-mamba", "mamba2")
HYBRID_ARCHS = ("jamba", "nemotron_h", "granitehybrid", "nemotron_h_moe", "falcon-h1")
ARCHS = ("llama", *LLAMA_ALIASES, *LLAMA_OPTION_ALIASES, "qwen3moe", *QWEN_MOE_ALIASES,
         "qwen3vlmoe", "gemma", "gemma2", "gemma3", "deepseek2", "minicpm3", "plm", "phi3",
         "phi2", "phimoe", "qwen", *FALCON_ARCHS, *BLOOM_ARCHS, *GPT2_ARCHS, "olmoe",
         "llama4", *MAMBA_ARCHS, *HYBRID_ARCHS)
# the archs without a causal mask unless the file says otherwise (of those
# the port runs)
NON_CAUSAL_ARCHS = ("llama-embed",)
# the default interleave of sliding-window layers: every Nth layer global
# (llama4's chunked layers: every 4th layer a NoPE full-attention layer)
_SWA_PATTERN = {"gemma2": 2, "gemma3": 6, "llama4": 4}

# arch → RoPE style, the JAX package's NEOX_ROPE_ARCHS (llama.cpp's
# llama_model_rope_type): these rotate halves (the HF layout), every other
# arch adjacent pairs. Reference-converted GGUFs of the NORM archs carry
# q/k permuted for the pairs, so a wrong style garbles a real checkpoint
# without an error.
NEOX_ROPE_ARCHS = {
    "falcon", "falcon-h1", "grok", "dbrx", "bert", "jina-bert-v3",
    "modern-bert", "nomic-bert", "nomic-bert-moe", "stablelm", "bitnet",
    "qwen", "qwen2", "dream", "qwen2moe", "qwen3", "qwen3moe", "llada-moe",
    "rnd1", "olmo2", "olmoe", "phi2", "phi3", "phimoe", "plamo", "plamo2",
    "plamo3", "gemma", "gemma2", "gemma3", "gemma3n", "gemma-embedding",
    "starcoder2", "openelm", "gptneox", "codeshell", "orion", "nemotron",
    "exaone", "exaone4", "exaone-moe", "minicpm3", "bailingmoe2", "dots1",
    "hunyuan-moe", "gpt-oss", "hunyuan-dense", "lfm2", "lfm2moe",
    "smallthinker", "seed_oss", "grovemoe", "apertus", "minimax-m2",
    "cogvlm", "pangu-embedded", "afmoe", "qwen3next", "mimo2", "step35",
    "glm4moe",
    "qwen2vl", "qwen3vl", "qwen3vlmoe",
}
# the archs whose per-head qk norms follow RoPE (llama.cpp's maincoder and
# hunyuan graphs); every other arch norms before it
QK_NORM_POST_ROPE_ARCHS = ("maincoder", "hunyuan-dense", "hunyuan-moe")


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
    # M-RoPE (qwen2vl, qwen3vl, qwen3vlmoe): the frequency sections of the
    # position streams (t, h, w, extra) from {arch}.rope.dimension_sections;
    # empty: one stream
    sections: tuple = ()
    # qwen3vl's IMROPE: the sections interleave [T H W T H W …] over the
    # frequency dims instead of taking contiguous chunks
    mrope_interleaved: bool = False


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
    # the per-head qk norms after RoPE instead of before (maincoder, hunyuan)
    qk_norm_post_rope: bool = False
    # trailing NextN (multi-token prediction) layers the forward skips
    # (bailingmoe2, glm4moe: n_layer counts them)
    nextn_layers: int = 0
    # MoE (mixtral rides arch llama): experts per layer, experts per token
    n_expert: int = 0
    n_expert_used: int = 0
    pooling: str = "none"  # embeddings' default pooling (llama_pooling_type)
    # iSWA: layer il is a sliding-window layer unless (il + 1) % swa_pattern
    # == 0 (gemma2 2, gemma3 6; 1: every layer when sliding_window > 0)
    swa_pattern: int = 1
    softcap_attn: float = 0.0  # tanh softcap of the attention scores (gemma2)
    softcap_final: float = 0.0  # tanh softcap of the logits (gemma2)
    rope_freq_base_swa: float = 0.0  # RoPE base of the SWA layers; 0: the global base
    # deepseek2 (MLA): q and kv LoRA ranks (0: q direct), the per-head
    # key/value dims of files that store the MQA form in key_length /
    # value_length (0: those keys hold them), the leading dense layers
    n_lora_q: int = 0
    n_lora_kv: int = 0
    head_dim_k_mla: int = 0
    head_dim_v_mla: int = 0
    n_layer_dense_lead: int = 0
    # MoE beyond mixtral: shared experts, an expert's FFN width, the routing
    # weights' scale and renormalisation, and the gating (softmax | sigmoid)
    n_expert_shared: int = 0
    n_ff_exp: int = 0
    expert_weights_scale: float = 1.0
    expert_weights_norm: bool = False
    expert_gating_func: str = "softmax"
    causal: bool = True  # False: llama-embed's embeddings (Engine.embed_tokens)
    # apertus' xIELU: per layer (alpha_n, alpha_p, beta, eps) with ggml_xielu's
    # softplus folding applied (`_read_xielu`); None: no xIELU
    xielu: tuple | None = None
    # gptneox's use_parallel_residual: x + attn(ln1(x)) + ffn(ln2(x))
    par_residual: bool = False
    # mpt's f_clamp_kqv: q, k and v clipped to ±clamp_kqv; 0: no clamp
    clamp_kqv: float = 0.0
    # per-layer KV head counts and FFN widths where the file writes arrays
    # (the hybrids: 0 KV heads on a mixer layer); the scalars n_head_kv and
    # n_ff then hold the per-layer maxima, as the JAX package keeps them
    n_head_kv_arr: tuple | None = None
    n_ff_arr: tuple | None = None
    # the SSM layers (llama_hparams ssm_*): conv taps, inner width, state
    # size, dt rank (mamba2: its head count), B/C groups (mamba2), and
    # falcon-mamba's weightless RMS on dt/B/C
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    ssm_n_group: int = 0
    ssm_dt_b_c_rms: bool = False
    # granitehybrid: RoPE on its attention layers only where this is set
    rope_finetuned: bool = False

    def is_swa(self, il: int) -> bool:
        return self.sliding_window > 0 and (il + 1) % self.swa_pattern != 0

    def n_head_kv_l(self, il: int) -> int:
        return self.n_head_kv_arr[il] if self.n_head_kv_arr else self.n_head_kv

    def n_ff_l(self, il: int) -> int:
        return self.n_ff_arr[il] if self.n_ff_arr else self.n_ff


def _read_xielu(r: GGUFReader, n_layer: int):
    """Apertus' per-layer xIELU values from the global xielu.* keys (a
    number or one a layer), folded as ggml_xielu folds them: alpha_n ←
    beta + softplus(alpha_n), alpha_p ← softplus(alpha_p); None without
    xielu.alpha_n."""
    if r.metadata.get("xielu.alpha_n") is None or n_layer == 0:
        return None

    def per_layer(key, default):
        v = r.metadata.get(key, default)
        if isinstance(v, (list, tuple, np.ndarray)):
            return [float(x) for x in v]
        return [float(v)] * n_layer

    def softplus(v):
        return float(np.log1p(np.exp(v)))

    a_n, a_p = per_layer("xielu.alpha_n", 0.0), per_layer("xielu.alpha_p", 0.0)
    beta, eps = per_layer("xielu.beta", 0.5), per_layer("xielu.eps", -1e-6)
    return tuple((beta[i] + softplus(a_n[i]), softplus(a_p[i]), beta[i], eps[i])
                 for i in range(n_layer))


def hparams_from_gguf(r: GGUFReader) -> HParams:
    arch = r.architecture
    if arch not in ARCHS:
        raise NotImplementedError(f"hparams for architecture {arch!r} are not ported")
    gemma = arch.startswith("gemma")
    minicpm = arch in ("minicpm", "minicpm3")

    def k(template, default=None):
        v = r.metadata.get(template.format(arch=arch))
        return default if v is None else v

    def scalar_or_arr(raw, default):
        """A per-layer key that a file may write as an array (the hybrids'
        KV head counts and FFN widths): (its maximum, the tuple), or (the
        value, None)."""
        if raw is None:
            return default, None
        if isinstance(raw, (list, tuple, np.ndarray)):
            arr = tuple(int(v) for v in raw)
            return max(arr), arr
        return int(raw), None

    n_embd = int(k(Keys.LLM.EMBEDDING_LENGTH))
    n_layer = int(k(Keys.LLM.BLOCK_COUNT))
    n_head = int(k(Keys.Attention.HEAD_COUNT))
    n_head_kv, n_head_kv_arr = scalar_or_arr(k(Keys.Attention.HEAD_COUNT_KV), n_head)
    n_ff, n_ff_arr = scalar_or_arr(k(Keys.LLM.FEED_FORWARD_LENGTH), 0)
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
        style="neox" if arch in NEOX_ROPE_ARCHS else "norm",
        sections=tuple(int(v) for v in np.atleast_1d(k(Keys.Rope.DIMENSION_SECTIONS, ()))),
        mrope_interleaved=arch in ("qwen3vl", "qwen3vlmoe"),
    )
    scale = k(Keys.Attention.SCALE)
    return HParams(
        arch=arch,
        n_vocab=int(n_vocab),
        n_ctx_train=int(k(Keys.LLM.CONTEXT_LENGTH, 2048)),
        n_embd=n_embd,
        n_layer=n_layer,
        n_head=n_head,
        n_head_kv=n_head_kv,
        n_ff=n_ff,
        head_dim=head_dim,
        head_dim_v=head_dim_v,
        rms_eps=float(k(Keys.Attention.LAYERNORM_RMS_EPS,
                        k(Keys.Attention.LAYERNORM_EPS, 1e-5))),
        rope=rope,
        # bloom, refact and baichuan's 40-layer 13B take ALiBi 8 without a
        # key (mpt and jais read theirs)
        max_alibi_bias=float(k(Keys.Attention.MAX_ALIBI_BIAS, 8.0 if arch in ("bloom", "refact")
                               or (arch == "baichuan" and n_layer == 40) else 0.0)),
        sliding_window=int(k(Keys.Attention.SLIDING_WINDOW, 0)),
        attn_scale=float(scale) if scale is not None else None,
        # minicpm's and minicpm3's multipliers without keys: embedding 12,
        # residual 1.4/√n_layer, logits 256/n_embd (granite's keys otherwise)
        embd_scale=float(k("{arch}.embedding_scale",
                           12.0 if minicpm else math.sqrt(n_embd) if gemma else 1.0)),
        residual_scale=float(k("{arch}.residual_scale",
                               1.4 / math.sqrt(n_layer) if minicpm else 1.0)),
        logit_scale=float(k("{arch}.logit_scale", 256.0 / n_embd if minicpm else 1.0)),
        no_rope_step=int(k("{arch}.attention.no_rope_layer_step",
                           4 if arch == "smollm3" else 0)),
        qk_norm_post_rope=arch in QK_NORM_POST_ROPE_ARCHS,
        nextn_layers=int(k("{arch}.nextn_predict_layers", 0)),
        n_expert=int(k(Keys.LLM.EXPERT_COUNT, 0)),
        n_expert_used=int(k(Keys.LLM.EXPERT_USED_COUNT, 0)),
        pooling={0: "none", 1: "mean", 2: "cls", 3: "last", 4: "rank"}.get(
            int(k("{arch}.pooling_type", 1 if arch == "llama-embed" else 0)), "none"),
        swa_pattern=int(k(Keys.Attention.SLIDING_WINDOW_PATTERN, _SWA_PATTERN.get(arch, 1))),
        softcap_attn=float(k(Keys.LLM.ATTN_LOGIT_SOFTCAPPING, 0.0)),
        softcap_final=float(k(Keys.LLM.FINAL_LOGIT_SOFTCAPPING, 0.0)),
        rope_freq_base_swa=float(k(Keys.Rope.FREQ_BASE_SWA,
                                   10000.0 if arch == "gemma3" else 0.0)),
        n_lora_q=int(k(Keys.Attention.Q_LORA_RANK, 0) or 0),
        n_lora_kv=int(k(Keys.Attention.KV_LORA_RANK, 0) or 0),
        head_dim_k_mla=int(k(Keys.Attention.KEY_LENGTH_MLA, 0) or 0),
        head_dim_v_mla=int(k(Keys.Attention.VALUE_LENGTH_MLA, 0) or 0),
        n_layer_dense_lead=int(k(Keys.LLM.LEADING_DENSE_BLOCK_COUNT, 0)),
        n_expert_shared=int(k(Keys.LLM.EXPERT_SHARED_COUNT, 0)),
        n_ff_exp=int(k(Keys.LLM.EXPERT_FEED_FORWARD_LENGTH, 0)),
        expert_weights_scale=float(k(Keys.LLM.EXPERT_WEIGHTS_SCALE, 1.0)),
        expert_weights_norm=bool(k(Keys.LLM.EXPERT_WEIGHTS_NORM, False)),
        # llama_expert_gating_func_type: 1 softmax, 2 sigmoid
        expert_gating_func={1: "softmax", 2: "sigmoid"}.get(
            int(k(Keys.LLM.EXPERT_GATING_FUNC, 1) or 1), "softmax"),
        causal=bool(k(Keys.Attention.CAUSAL, arch not in NON_CAUSAL_ARCHS)),
        xielu=_read_xielu(r, n_layer),
        par_residual=bool(k(Keys.LLM.USE_PARALLEL_RESIDUAL, False)),
        clamp_kqv=float(k("{arch}.attention.clamp_kqv", 0.0) or 0.0),
        n_head_kv_arr=n_head_kv_arr,
        n_ff_arr=n_ff_arr,
        # the JAX package's reading (lfm2's shortconv keys are its fallbacks)
        ssm_d_conv=int(k("{arch}.ssm.conv_kernel", k("{arch}.shortconv.l_cache", 0))),
        ssm_d_inner=int(k("{arch}.ssm.inner_size",
                          n_embd if k("{arch}.shortconv.l_cache") else 0)),
        ssm_d_state=int(k("{arch}.ssm.state_size", k("{arch}.wkv.head_size", 0))),
        ssm_dt_rank=int(k("{arch}.ssm.time_step_rank", 0)),
        ssm_n_group=int(k("{arch}.ssm.group_count", 0)),
        ssm_dt_b_c_rms=bool(k("{arch}.ssm.dt_b_c_rms", arch == "falcon-mamba")),
        rope_finetuned=bool(k("{arch}.rope.scaling.finetuned", False)),
    )
