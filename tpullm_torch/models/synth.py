"""Synthesis of random *packed* llama (and its aliases with options: the VL
text stacks, apertus, arcee, llama-embed), qwen, gemma, deepseek2 (and its
MLA aliases minicpm3 and plm), phi, falcon / gpt-neox, bloom / mpt / jais,
gpt2 / starcoder, olmoe, phimoe and llama4 models from a seed.

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

# nvidia/Nemotron-H-8B-Base-8K's hybrid_override_pattern (M mamba, * attention,
# - MLP)
_NEMOTRON_H_8B = "M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M-"

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
    # google/gemma-3-4b-it config.json text_config: head_dim 256, the 262144
    # tokens of the tokenizer (the config's 262208 pad for image tokens),
    # rope_scaling linear 8 on the global layers, query_pre_attn_scalar 256
    # (= head_dim: no attention.scale key), tied embeddings
    "gemma-3-4b": dict(arch="gemma3", n_layer=34, n_embd=2560, n_head=8, n_head_kv=4,
                       head_dim=256, n_ff=10240, n_vocab=262144, rope_base=1000000.0,
                       rope_base_swa=10000.0, rope_scaling=("linear", 8.0),
                       sliding_window=1024, swa_pattern=6, rms_eps=1e-6, n_ctx=131072),
    # the gemma test models: 6 layers (one global layer at gemma3's pattern of
    # 6), 2 heads of head dim 256 on one KV head, a window of 16; gemma2 with
    # its softcaps, gemma (v1) with no window
    "tiny-gemma3": dict(arch="gemma3", n_layer=6, n_embd=256, n_head=2, n_head_kv=1,
                        head_dim=256, n_ff=512, n_vocab=384, rope_base=1000000.0,
                        rope_base_swa=10000.0, sliding_window=16, swa_pattern=6,
                        rms_eps=1e-6),
    "tiny-gemma2": dict(arch="gemma2", n_layer=6, n_embd=256, n_head=2, n_head_kv=1,
                        head_dim=256, n_ff=512, n_vocab=384, rope_base=10000.0,
                        sliding_window=16, swa_pattern=2, softcaps=(50.0, 30.0),
                        rms_eps=1e-6),
    "tiny-gemma": dict(arch="gemma", n_layer=6, n_embd=256, n_head=2, n_head_kv=1,
                       head_dim=256, n_ff=512, n_vocab=384, rope_base=10000.0,
                       rms_eps=1e-6),
    # deepseek-ai/DeepSeek-V2-Lite config.json: q_lora_rank null (q direct),
    # kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim
    # 128, 64 routed experts (moe_intermediate_size 1408) top-6 softmax, not
    # renormalised, 2 shared, first_k_dense_replace 1 (intermediate_size
    # 10944), YaRN factor 40 on 4096 (mscale_all_dim 0.707: the converter's
    # yarn_log_multiplier 0.0707); the older converter's metadata (per-head
    # key/value lengths, head_count_kv = n_head, the fused attn_kv_b)
    "deepseek-v2-lite": dict(arch="deepseek2", n_layer=27, n_embd=2048, n_head=16,
                             n_head_kv=16, n_ff=10944, n_vocab=102400, rope_base=10000.0,
                             rms_eps=1e-6, n_ctx=163840, kv_lora=512, qk_nope=128,
                             qk_rope=64, v_dim=128, n_expert=64, n_expert_used=6,
                             n_ff_exp=1408, n_expert_shared=2, n_dense_lead=1,
                             gating=1, weights_scale=1.0, weights_norm=False,
                             rope_scaling=("yarn", 40.0), rope_orig_ctx=4096,
                             yarn_log_mul=0.0707),
    # the deepseek2 test model: the latent of the kernel's widths (kv_lora 512
    # and 64 rope dims: Dk 576, Dv 512, 16 heads on the latent's one KV head)
    # with narrow heads (qk_nope and v 32), one dense lead layer, 4 experts
    # top-2 softmax not renormalised (V2's routing), one shared expert
    "tiny-deepseek2": dict(arch="deepseek2", n_layer=3, n_embd=256, n_head=16, n_head_kv=16,
                           n_ff=512, n_vocab=384, rope_base=10000.0, rms_eps=1e-6,
                           kv_lora=512, qk_nope=32, qk_rope=64, v_dim=32, n_expert=4,
                           n_expert_used=2, n_ff_exp=256, n_expert_shared=1, n_dense_lead=1,
                           gating=1, weights_scale=1.0, weights_norm=False),
    # openbmb/MiniCPM3-4B config.json: 62 layers, hidden 2560, 40 heads (40 KV
    # heads), q_lora_rank 768, kv_lora_rank 256, qk_nope_head_dim 64,
    # qk_rope_head_dim 32, v_head_dim 64, intermediate_size 6400 (every layer
    # dense SwiGLU), vocab 73448 (SPM), rms_norm_eps 1e-5, rope_theta 10000,
    # max_position_embeddings 32768, untied; scale_emb 12, scale_depth 1.4 and
    # dim_model_base 256 are the defaults models/hparams.py gives minicpm3
    # (llama.cpp's converter writes no key for them), and its longrope
    # factors are not written (neither package reads rope_factors_*). The
    # keys as the converter writes them: key_length 96, value_length 64
    # (per-head; no *_mla keys), head_count_kv 40
    "minicpm3-4b": dict(arch="minicpm3", n_layer=62, n_embd=2560, n_head=40, n_head_kv=40,
                        n_ff=6400, n_vocab=73448, rope_base=10000.0, rms_eps=1e-5,
                        n_ctx=32768, q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
                        v_dim=64),
    # PLM-Team/PLM-1.8B-Base config.json: 32 layers, hidden 2048, 16 heads (16
    # KV heads), kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64,
    # v_head_dim 128, q direct (no q LoRA), intermediate_size 8192 with a
    # gateless ReLU² (every layer dense), vocab 151936 (Qwen's BPE), rms
    # 1e-6, rope_theta 100000, max_position_embeddings 4096, tied embeddings
    "plm-1.8b": dict(arch="plm", n_layer=32, n_embd=2048, n_head=16, n_head_kv=16, n_ff=8192,
                     n_vocab=151936, rope_base=100000.0, rms_eps=1e-6, n_ctx=4096, kv_lora=512,
                     qk_nope=128, qk_rope=64, v_dim=128, gateless=True, tied=True,
                     vocab="bpe", pre="qwen2"),
    # the MLA alias test models, K a multiple of 256 on every linear: tiny-
    # minicpm3 with MiniCPM3's latent (256 + 32: the kernel's (288, 256)) and
    # heads (96 / 64), 40 heads on the latent's one KV head (R = 40 at T = 1),
    # a q LoRA of 256; tiny-plm with PLM's latent (512 + 64) and heads (192 /
    # 128), 4 heads, q direct, gateless ReLU², tied
    "tiny-minicpm3": dict(arch="minicpm3", n_layer=2, n_embd=256, n_head=40, n_head_kv=40,
                          n_ff=512, n_vocab=384, rope_base=10000.0, rms_eps=1e-5, q_lora=256,
                          kv_lora=256, qk_nope=64, qk_rope=32, v_dim=64),
    "tiny-plm": dict(arch="plm", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                     n_vocab=384, rope_base=100000.0, rms_eps=1e-6, kv_lora=512, qk_nope=128,
                     qk_rope=64, v_dim=128, gateless=True, tied=True),
    # Qwen/Qwen3-30B-A3B config.json: 48 layers, hidden 2048, 32 heads over 4
    # KV heads of head_dim 128 (q is 4096 wide), per-head q/k norms, 128
    # experts (moe_intermediate_size 768) top-8 renormalised
    # (norm_topk_prob), intermediate_size 6144 (no dense layer uses it), vocab
    # 151936, rope_theta 1e6, rms_norm_eps 1e-6, max_position_embeddings
    # 40960, untied; Qwen's byte-level BPE (pre "qwen2")
    "qwen3-30b-a3b": dict(arch="qwen3moe", n_layer=48, n_embd=2048, n_head=32, n_head_kv=4,
                          head_dim=128, n_ff=6144, n_vocab=151936, rope_base=1000000.0,
                          rms_eps=1e-6, n_ctx=40960, n_expert=128, n_expert_used=8,
                          n_ff_exp=768, qk_norm=True, vocab="bpe", pre="qwen2"),
    # Qwen/Qwen2.5-7B config.json: 28 layers, hidden 3584, 28 heads over 4 KV
    # heads (head_dim 128: a GQA group of 7), intermediate_size 18944, vocab
    # 152064, q/k/v biases, rope_theta 1e6, rms_norm_eps 1e-6,
    # max_position_embeddings 131072, untied
    "qwen2.5-7b": dict(arch="qwen2", n_layer=28, n_embd=3584, n_head=28, n_head_kv=4,
                       n_ff=18944, n_vocab=152064, rope_base=1000000.0, rms_eps=1e-6,
                       n_ctx=131072, qkv_bias=True, vocab="bpe", pre="qwen2"),
    # the qwen test models, at the widths of "tiny" (K a multiple of 256, so
    # the packed planes and the plain qmm versions run), Qwen's BPE: qwen2
    # with q/k/v biases, qwen3 with per-head q/k norms, qwen3moe with those
    # norms and 16 experts top-4 renormalised (K = 256 on the down
    # experts), qwen2moe with a sigmoid-gated shared expert, not renormalised
    "tiny-qwen2": dict(arch="qwen2", n_layer=2, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                       n_vocab=384, rope_base=1000000.0, rms_eps=1e-6, qkv_bias=True,
                       vocab="bpe", pre="qwen2"),
    "tiny-qwen3": dict(arch="qwen3", n_layer=2, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                       n_vocab=384, rope_base=1000000.0, rms_eps=1e-6, qk_norm=True,
                       vocab="bpe", pre="qwen2"),
    "tiny-qwen3moe": dict(arch="qwen3moe", n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                          head_dim=128, n_ff=768, n_vocab=384, rope_base=1000000.0,
                          rms_eps=1e-6, n_expert=16, n_expert_used=4, n_ff_exp=256,
                          qk_norm=True, vocab="bpe", pre="qwen2"),
    "tiny-qwen2moe": dict(arch="qwen2moe", n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                          n_ff=512, n_vocab=384, rope_base=1000000.0, rms_eps=1e-6,
                          n_expert=16, n_expert_used=4, n_ff_exp=256, n_ff_shexp=512,
                          qkv_bias=True, vocab="bpe", pre="qwen2"),
    # microsoft/Phi-3-mini-4k-instruct config.json: 32 layers, hidden 3072, 32
    # heads over 32 KV heads (head dim 96), intermediate_size 8192 (ffn_up
    # holds gate | up: 16384 rows), vocab 32064 (SPM), rope_theta 10000,
    # rms_norm_eps 1e-5, sliding_window 2047 (every layer: no pattern key),
    # max_position_embeddings 4096, untied
    "phi-3-mini-4k": dict(arch="phi3", n_layer=32, n_embd=3072, n_head=32, n_head_kv=32,
                          n_ff=8192, n_vocab=32064, rope_base=10000.0, rms_eps=1e-5,
                          sliding_window=2047, n_ctx=4096),
    # microsoft/phi-2 config.json: 32 layers, hidden 2560, 32 heads (head dim
    # 80), intermediate_size 10240, partial_rotary_factor 0.4 (32 rotary
    # dims), vocab 51200 (GPT-2's byte-level BPE, pre "phi-2"),
    # layer_norm_eps 1e-5, max_position_embeddings 2048; LayerNorms with
    # biases, q|k|v fused with a bias, biased FFN and head
    "phi-2": dict(arch="phi2", n_layer=32, n_embd=2560, n_head=32, n_head_kv=32, n_ff=10240,
                  n_rot=32, n_vocab=51200, rope_base=10000.0, rms_eps=1e-5, n_ctx=2048,
                  vocab="bpe", pre="phi-2"),
    # Qwen/Qwen-7B config.json: 32 layers, hidden 4096, 32 heads of 128 (MHA),
    # intermediate_size 22016 (the GGUF's feed_forward_length is half: 11008,
    # the width of gate and of up), vocab 151936, rotary_emb_base 10000,
    # layer_norm_epsilon 1e-6, seq_length 8192, untied; q|k|v fused with a
    # bias; Qwen's BPE (pre "qwen2")
    "qwen-7b": dict(arch="qwen", n_layer=32, n_embd=4096, n_head=32, n_head_kv=32, n_ff=11008,
                    n_vocab=151936, rope_base=10000.0, rms_eps=1e-6, n_ctx=8192, vocab="bpe",
                    pre="qwen2"),
    # the Phi and Qwen (v1) test models, every K a multiple of 256 (the packed
    # K-quant planes): tiny-phi3 with Phi-3-mini's head dim 96 (8 heads) and
    # a window of 16 (below the tests' prompts); tiny-phi2 with Phi-2's head
    # dim 80 (16 heads) and 32 rotary dims, LayerNorm biases and a biased
    # head; tiny-qwen at the widths of "tiny"
    "tiny-phi3": dict(arch="phi3", n_layer=2, n_embd=768, n_head=8, n_head_kv=8, n_ff=512,
                      n_vocab=384, rope_base=10000.0, rms_eps=1e-5, sliding_window=16),
    "tiny-phi2": dict(arch="phi2", n_layer=2, n_embd=1280, n_head=16, n_head_kv=16, n_ff=512,
                      n_rot=32, n_vocab=384, rope_base=10000.0, rms_eps=1e-5, vocab="bpe",
                      pre="phi-2"),
    "tiny-qwen": dict(arch="qwen", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                      n_vocab=384, rope_base=10000.0, rms_eps=1e-6, vocab="bpe", pre="qwen2"),
    # Qwen/Qwen3-VL-8B-Instruct config.json text_config: 36 layers, hidden
    # 4096, 32 heads over 8 KV heads of head_dim 128, per-head q/k norms,
    # intermediate_size 12288, vocab 151936, rope_theta 5e6, mrope_section
    # [24, 20, 20] interleaved (IMROPE), rms_norm_eps 1e-6,
    # max_position_embeddings 262144, untied; deepstack after layers 0-2
    # (the vision tower's three deepstack_visual_indexes: input, not weights)
    "qwen3-vl-8b": dict(arch="qwen3vl", n_layer=36, n_embd=4096, n_head=32, n_head_kv=8,
                        head_dim=128, n_ff=12288, n_vocab=151936, rope_base=5000000.0,
                        rms_eps=1e-6, n_ctx=262144, qk_norm=True, sections=(24, 20, 20, 0),
                        vocab="bpe", pre="qwen2"),
    # Qwen/Qwen2-VL-7B-Instruct config.json: the Qwen2-7B stack (28 layers,
    # hidden 3584, 28 heads over 4, intermediate_size 18944, vocab 152064,
    # q/k/v biases), rope_theta 1e6, mrope_section [16, 24, 24] contiguous,
    # rms_norm_eps 1e-6, max_position_embeddings 32768, untied
    "qwen2-vl-7b": dict(arch="qwen2vl", n_layer=28, n_embd=3584, n_head=28, n_head_kv=4,
                        n_ff=18944, n_vocab=152064, rope_base=1000000.0, rms_eps=1e-6,
                        n_ctx=32768, qkv_bias=True, sections=(16, 24, 24, 0), vocab="bpe",
                        pre="qwen2"),
    # Qwen/Qwen3-VL-30B-A3B-Instruct config.json text_config: the Qwen3-30B-A3B
    # stack (48 layers, hidden 2048, 32 heads over 4 of 128, q/k norms, 128
    # experts of 768 top-8), rope_theta 5e6, mrope_section [24, 20, 20]
    # interleaved, max_position_embeddings 262144, untied
    "qwen3-vl-30b-a3b": dict(arch="qwen3vlmoe", n_layer=48, n_embd=2048, n_head=32,
                             n_head_kv=4, head_dim=128, n_ff=6144, n_vocab=151936,
                             rope_base=5000000.0, rms_eps=1e-6, n_ctx=262144, n_expert=128,
                             n_expert_used=8, n_ff_exp=768, qk_norm=True,
                             sections=(24, 20, 20, 0), vocab="bpe", pre="qwen2"),
    # swiss-ai/Apertus-8B-2509 config.json: 32 layers, hidden 4096, 32 heads
    # over 8 (head_dim 128), per-head q/k norms, intermediate_size 21504 with
    # no gate and the xIELU activation (per layer alpha_p, alpha_n, beta 0.5,
    # eps −1e-6: written raw, before softplus, near HF's initial 0.8 and
    # 0.8), vocab 131072, rope_theta 12e6 (its llama3 scaling not written:
    # neither package reads rope_factors), rms_norm_eps 1e-5,
    # max_position_embeddings 65536, untied
    "apertus-8b": dict(arch="apertus", n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                       n_ff=21504, n_vocab=131072, rope_base=12000000.0, rms_eps=1e-5,
                       n_ctx=65536, qk_norm=True, gateless=True, xielu=True, vocab="bpe"),
    # arcee-ai/AFM-4.5B config.json: 36 layers, hidden 2560, 20 heads over 4
    # (head_dim 128), intermediate_size 18432 with no gate, ReLU²
    # (hidden_act relu2), vocab 128004, rope_theta 10000, rms_norm_eps 1e-5,
    # max_position_embeddings 65536, untied
    "afm-4.5b": dict(arch="arcee", n_layer=36, n_embd=2560, n_head=20, n_head_kv=4,
                     n_ff=18432, n_vocab=128004, rope_base=10000.0, rms_eps=1e-5, n_ctx=65536,
                     gateless=True, vocab="bpe"),
    # nvidia/llama-embed-nemotron-8b: a Llama-3.1-8B (the llama-3-8b widths,
    # rope_theta 500000, rms 1e-5, Llama-3's BPE), arch llama-embed (no
    # causal mask, mean pooling by default)
    "llama-embed-8b": dict(arch="llama-embed", n_layer=32, n_embd=4096, n_head=32,
                           n_head_kv=8, n_ff=14336, n_vocab=128256, rope_base=500000.0,
                           n_ctx=131072, vocab="bpe"),
    # tiiuae/falcon-7b config.json: 32 layers, hidden 4544, 71 heads over one
    # KV head (multi-query, head_dim 64), parallel attention and MLP on one
    # LayerNorm, 4·4544 = 18176 FFN, vocab 65024, rotary base 10000,
    # layer_norm_epsilon 1e-5, 2048 positions, untied head; no biases.
    # n_embd is no multiple of 256: q|k|v, wo, up, the embedding and the
    # head take the recipe's fallback types (Q5_1, Q5_0, Q8_0)
    "falcon-7b": dict(arch="falcon", n_layer=32, n_embd=4544, n_head=71, n_head_kv=1,
                      n_ff=18176, n_vocab=65024, rope_base=10000.0, rms_eps=1e-5, n_ctx=2048,
                      vocab="bpe", pre="falcon"),
    # EleutherAI/pythia-6.9b config.json (arch gptneox): 32 layers, hidden
    # 4096, 32 heads (MHA, head_dim 128), rotary_pct 0.25 (32 rotary dims),
    # intermediate_size 16384, vocab 50432, use_parallel_residual true,
    # layer_norm_eps 1e-5, 2048 positions, untied; biases on q|k|v, wo, up
    # and down
    "pythia-6.9b": dict(arch="gptneox", n_layer=32, n_embd=4096, n_head=32, n_head_kv=32,
                        n_ff=16384, n_rot=32, n_vocab=50432, rope_base=10000.0, rms_eps=1e-5,
                        n_ctx=2048, par_residual=True, vocab="bpe", pre="gpt-2"),
    # the falcon family's test models: tiny-falcon with Falcon-7B's layout
    # (5 heads of 64 on one KV head, n_embd 320: its fallback types) and
    # tiny-gptneox with Pythia's (partial rotary, biases, parallel residual)
    "tiny-falcon": dict(arch="falcon", n_layer=2, n_embd=320, n_head=5, n_head_kv=1,
                        n_ff=1280, n_vocab=384, rope_base=10000.0, rms_eps=1e-5),
    "tiny-gptneox": dict(arch="gptneox", n_layer=2, n_embd=256, n_head=4, n_head_kv=4,
                         n_ff=512, n_rot=16, n_vocab=384, rope_base=10000.0, rms_eps=1e-5,
                         par_residual=True),
    # bigscience/bloom-7b1 config.json: 30 layers, hidden 4096, 32 heads (MHA,
    # head_dim 128), 4·4096 = 16384 FFN, vocab 250880, layer_norm_epsilon
    # 1e-5, ALiBi (no positions, no rope; llama.cpp's bloom takes max bias 8
    # without a key), seq_length 2048, the head tied to the embedding, the
    # word_embeddings_layernorm (token_embd_norm); biases on every norm,
    # q|k|v, wo, up and down; BLOOM's BPE (pre "bloom")
    "bloom-7b1": dict(arch="bloom", n_layer=30, n_embd=4096, n_head=32, n_head_kv=32,
                      n_ff=16384, n_vocab=250880, rms_eps=1e-5, n_ctx=2048, tied=True,
                      vocab="bpe", pre="bloom"),
    # mosaicml/mpt-7b config.json: 32 layers, d_model 4096, 32 heads (MHA),
    # expansion_ratio 4 (16384), vocab 50432, ALiBi with alibi_bias_max 8,
    # no_bias (no biases on norms or linears), no qk LayerNorm, clip_qkv
    # null, max_seq_len 2048, tied head; GPT-NeoX's BPE (pre "mpt")
    "mpt-7b": dict(arch="mpt", n_layer=32, n_embd=4096, n_head=32, n_head_kv=32, n_ff=16384,
                   n_vocab=50432, rms_eps=1e-5, n_ctx=2048, alibi_bias=8.0, no_bias=True,
                   tied=True, vocab="bpe", pre="mpt"),
    # bigcode/starcoder config.json (gpt_bigcode): 40 layers, n_embd 6144, 48
    # heads over one KV head (multi-query, head_dim 128), n_inner 24576, vocab
    # 49152, n_positions 8192 (learned), layer_norm_epsilon 1e-5, biases on
    # every norm and linear, its own lm_head; StarCoder's BPE (pre "starcoder")
    "starcoder-15b": dict(arch="starcoder", n_layer=40, n_embd=6144, n_head=48, n_head_kv=1,
                          n_ff=24576, n_vocab=49152, rms_eps=1e-5, n_ctx=8192, positions=True,
                          vocab="bpe", pre="starcoder"),
    # openai-community/gpt2 config.json: 12 layers, n_embd 768, 12 heads (head
    # dim 64), n_inner 3072 (4·768), vocab 50257, n_positions 1024 (learned),
    # layer_norm_epsilon 1e-5, biases on every norm and linear, the head tied
    # to wte; GPT-2's BPE
    "gpt2": dict(arch="gpt2", n_layer=12, n_embd=768, n_head=12, n_head_kv=12, n_ff=3072,
                 n_vocab=50257, rms_eps=1e-5, n_ctx=1024, positions=True, tied=True,
                 vocab="bpe", pre="gpt-2"),
    # the ALiBi family's and gpt2's test models, K a multiple of 256 on every
    # linear, heads of 64: tiny-bloom with BLOOM's layout (token_embd_norm,
    # biases, tied head), tiny-mpt with every mpt option (no biases, learned
    # positions, clamp_kqv 2, full-width q/k LayerNorms, tied), tiny-jais with
    # its SiLU gate and biases, tiny-gpt2 with GPT-2's (a table of 64
    # positions, tied) and tiny-starcoder with StarCoder's (4 heads on one KV
    # head, its own head)
    "tiny-bloom": dict(arch="bloom", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                       n_vocab=384, rms_eps=1e-5, n_ctx=256, tied=True),
    "tiny-mpt": dict(arch="mpt", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                     n_vocab=384, rms_eps=1e-5, n_ctx=256, alibi_bias=8.0, no_bias=True,
                     positions=True, clamp_kqv=2.0, qk_norm=True, tied=True),
    "tiny-jais": dict(arch="jais", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                      n_vocab=384, rms_eps=1e-5, n_ctx=256, alibi_bias=8.0),
    "tiny-gpt2": dict(arch="gpt2", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=512,
                      n_vocab=384, rms_eps=1e-5, n_ctx=64, positions=True, tied=True),
    "tiny-starcoder": dict(arch="starcoder", n_layer=2, n_embd=256, n_head=4, n_head_kv=1,
                           n_ff=512, n_vocab=384, rms_eps=1e-5, n_ctx=256, positions=True),
    # allenai/OLMoE-1B-7B-0924 config.json: 16 layers, hidden 2048, 16 heads
    # (MHA, head_dim 128), q/k RMSNorms over the whole projection (2048 wide),
    # 64 experts (intermediate_size 1024) top-8 softmax, not renormalised
    # (norm_topk_prob false), no shared expert, vocab 50304 (GPT-NeoX's BPE,
    # pre "olmo"), rope_theta 10000, rms_norm_eps 1e-5,
    # max_position_embeddings 4096, untied
    "olmoe-1b-7b": dict(arch="olmoe", n_layer=16, n_embd=2048, n_head=16, n_head_kv=16,
                        n_ff=1024, n_vocab=50304, rope_base=10000.0, rms_eps=1e-5, n_ctx=4096,
                        n_expert=64, n_expert_used=8, qk_norm_full=True, vocab="bpe",
                        pre="olmo"),
    # microsoft/Phi-3.5-MoE-instruct config.json: 32 layers, hidden 4096, 32
    # heads over 8 (head_dim 128), 16 experts (intermediate_size 6400) top-2
    # routed by sparsemixer, vocab 32064 (SPM), rope_theta 10000 (its longrope
    # factors not written: neither package reads them), rms_norm_eps 1e-5 (the
    # LayerNorms' eps), sliding_window 131072 and max_position_embeddings
    # 131072 (the card runs 4096), attention_bias (q/k/v and o biases),
    # LayerNorms with biases, lm_head_bias, untied
    "phi-3.5-moe": dict(arch="phimoe", n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                        n_ff=6400, n_vocab=32064, rope_base=10000.0, rms_eps=1e-5, n_ctx=4096,
                        sliding_window=131072, n_expert=16, n_expert_used=2, qkv_bias=True,
                        norm_bias=True, wo_bias=True, head_bias=True),
    # meta-llama/Llama-4-Scout-17B-16E config.json text_config: 48 layers,
    # hidden 5120, 40 heads over 8 (head_dim 128), 16 experts
    # (intermediate_size 8192) top-1 sigmoid, the weight on the expert input,
    # a shared expert of 8192, every layer MoE (interleave_moe_layer_step 1;
    # intermediate_size_mlp 16384 is the width of dense layers Scout has
    # none of), attention_chunk_size 8192 (llama4.attention.sliding_window
    # as the converter writes it; every 4th layer NoPE with the temperature
    # tuning), use_qk_norm (the L2 norm), vocab 202048 (BPE, pre "llama4"),
    # rope_theta 500000 (its llama3 scaling not written: neither package
    # reads it), rms_norm_eps 1e-5, untied; the card runs 4096 of its
    # 10485760 positions
    "llama-4-scout": dict(arch="llama4", n_layer=48, n_embd=5120, n_head=40, n_head_kv=8,
                          n_ff=16384, n_vocab=202048, rope_base=500000.0, rms_eps=1e-5,
                          n_ctx=4096, sliding_window=8192, n_expert=16, n_expert_used=1,
                          n_ff_exp=8192, n_ff_shexp=8192, gated_shexp=False, vocab="bpe",
                          pre="llama4"),
    # the MoE families' test models, K a multiple of 256 on every linear:
    # tiny-olmoe with OLMoE's layout (MHA, full-projection q/k norms, 64
    # experts top-8 not renormalised: the gather's bit-set path past 32
    # experts); tiny-phimoe with Phi-3.5-MoE's (16 experts top-2 by
    # sparsemixer, LayerNorms with biases, q/k/v, o and head biases, a
    # window of 16); tiny-llama4 with Llama 4's (a chunk of 16: layers 0-2
    # chunked with the L2 norm, layer 3 NoPE; layer 1 dense, Maverick's
    # interleave; 16 experts top-1 and a shared expert)
    "tiny-olmoe": dict(arch="olmoe", n_layer=2, n_embd=256, n_head=4, n_head_kv=4, n_ff=256,
                       n_vocab=384, rope_base=10000.0, rms_eps=1e-5, n_expert=64,
                       n_expert_used=8, qk_norm_full=True),
    "tiny-phimoe": dict(arch="phimoe", n_layer=2, n_embd=256, n_head=4, n_head_kv=2, n_ff=256,
                        n_vocab=384, rope_base=10000.0, rms_eps=1e-5, sliding_window=16,
                        n_expert=16, n_expert_used=2, qkv_bias=True, norm_bias=True,
                        wo_bias=True, head_bias=True),
    "tiny-llama4": dict(arch="llama4", n_layer=4, n_embd=256, n_head=4, n_head_kv=2,
                        head_dim=128, n_ff=512, n_vocab=384, rope_base=500000.0, rms_eps=1e-5,
                        sliding_window=16, n_expert=16, n_expert_used=1, n_ff_exp=256,
                        n_ff_shexp=256, gated_shexp=False, dense_layers=(1,)),

    # the recurrent archs. A shape's `pattern` holds a letter a layer: M an
    # SSM mixer, A attention, F nemotron-h's FFN-only layer, H Falcon-H1's
    # attention beside a Mamba-2 mixer; `ffn` a letter a layer: d SwiGLU, r
    # the gateless ReLU² FFN, e routed experts (with the shared expert where
    # the shape has n_ff_shexp), - none. `ssm`: (d_inner, d_state, dt rank
    # or Mamba-2 heads, B/C groups: 0 for mamba1, d_conv). A depth cut keeps
    # the first n_layer letters.
    # tiiuae/falcon-mamba-7b config.json: 64 layers, hidden 4096, expand 2
    # (d_inner 8192), state 16, time_step_rank 256, conv 4, vocab 65024,
    # rms 1e-5, the weightless RMS on dt/B/C (mixer_rms_eps), untied
    "falcon-mamba-7b": dict(arch="falcon-mamba", n_layer=64, n_embd=4096, n_head=0,
                            n_head_kv=0, n_ff=0, n_vocab=65024, rms_eps=1e-5,
                            ssm=(8192, 16, 256, 0, 4), pattern="M" * 64, ffn="-" * 64),
    # mistralai/Mamba-Codestral-7B-v0.1 config.json: 64 layers, hidden 4096,
    # expand 2 (d_inner 8192), 128 heads of 64, state 128, 8 groups, conv 4,
    # the grouped RMS norm, vocab 32768, rms 1e-5, untied
    "mamba-codestral-7b": dict(arch="mamba2", n_layer=64, n_embd=4096, n_head=0, n_head_kv=0,
                               n_ff=0, n_vocab=32768, rms_eps=1e-5, ssm=(8192, 128, 128, 8, 4),
                               ssm_norm=True, pattern="M" * 64, ffn="-" * 64),
    # ai21labs/AI21-Jamba-Mini-1.5 config.json: 32 layers, hidden 4096, 32
    # heads on 8 (head dim 128), intermediate 14336, mamba expand 2 (d_inner
    # 8192), state 16, dt_rank 256, conv 4 with the dt/B/C layernorms,
    # attention every 8th layer from layer 4 (attn_layer_period 8, offset
    # 4), 16 experts top-2 every 2nd layer from layer 1 (expert_layer_period
    # 2, offset 1), vocab 65536, rms 1e-6, untied; an 8-layer cut holds one
    # whole period
    "jamba-mini-1.5": dict(arch="jamba", n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                           n_ff=14336, n_vocab=65536, rms_eps=1e-6, rope_base=10000.0,
                           n_expert=16, n_expert_used=2, ssm=(8192, 16, 256, 0, 4),
                           dt_b_c_norms=True,
                           pattern="".join("A" if i % 8 == 4 else "M" for i in range(32)),
                           ffn="".join("e" if i % 2 else "d" for i in range(32))),
    # ibm-granite/granite-4.0-h-tiny config.json: 40 layers, hidden 1536,
    # mamba2 48 heads of 64 (d_inner 3072), state 128, 1 group, conv 4, the
    # grouped norm; attention (12 heads on 4, head dim 128, no position
    # embedding) at layers 5, 15, 25 and 35 (layer_types); 64 experts top-6 of
    # width 512 on every layer with a gated shared expert of 1024; the
    # granite multipliers (embedding 12, residual 0.22, attention 1/128,
    # logits 6); vocab 100352, rms 1e-5, tied
    "granite-4.0-h-tiny": dict(arch="granitehybrid", n_layer=40, n_embd=1536, n_head=12,
                               n_head_kv=4, head_dim=128, n_ff=1024, n_vocab=100352,
                               rms_eps=1e-5, rope_base=10000.0, n_expert=64, n_expert_used=6,
                               n_ff_exp=512, n_ff_shexp=1024, ssm=(3072, 128, 48, 1, 4),
                               ssm_norm=True, tied=True,
                               multipliers=(12.0, 0.22, 6.0, 0.0078125),
                               pattern="".join("A" if i % 10 == 5 else "M" for i in range(40)),
                               ffn="e" * 40),
    # nvidia/Nemotron-H-8B-Base-8K config.json: 52 layers, hidden 4096, 32
    # heads on 8 (head dim 128), mamba2 128 heads of 64 (d_inner 8192),
    # state 128, 8 groups, conv 4, the grouped norm, ReLU² MLP layers of
    # 21504, vocab 131072, rms 1e-5, untied; hybrid_override_pattern
    # M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M*-M-M-M-M-M- (M mamba, * attention,
    # - MLP)
    "nemotron-h-8b": dict(arch="nemotron_h", n_layer=52, n_embd=4096, n_head=32, n_head_kv=8,
                          n_ff=21504, n_vocab=131072, rms_eps=1e-5, rope_base=10000.0,
                          ssm=(8192, 128, 128, 8, 4), ssm_norm=True,
                          pattern=_NEMOTRON_H_8B.replace("-", "F").replace("*", "A"),
                          ffn="".join("r" if c == "-" else "-" for c in _NEMOTRON_H_8B)),
    # the recurrent test models, every K a multiple of 256: tiny-mamba and
    # tiny-falcon-mamba (d_inner 512, state 16, dt rank 256: ssm_x 288
    # wide), tiny-mamba2 (8 heads of 64, state 64, 2 groups: ssm_in 1288
    # wide); the hybrids hold a mixer and an attention layer (4 heads of 64
    # on 2): tiny-jamba (mamba1 with the dt/B/C norms, SwiGLU and 8 experts
    # top-2), tiny-nemotron-h (Mamba-2, attention, an FFN-only ReLU² layer),
    # tiny-granite-h (Mamba-2 and attention, 8 experts top-2 of 256 and a
    # gated shared expert, the granite multipliers), tiny-nemotron-h-moe
    # (an FFN-only layer of 8 gateless ReLU² experts, sigmoid top-2 with the
    # selection bias, weights renormalised and scaled 2.5, an ungated ReLU²
    # shared expert), tiny-falcon-h1 (attention with RoPE beside Mamba-2 on
    # both layers, SwiGLU)
    "tiny-mamba": dict(arch="mamba", n_layer=2, n_embd=256, n_head=0, n_head_kv=0, n_ff=0,
                       n_vocab=384, rms_eps=1e-5, ssm=(512, 16, 256, 0, 4), pattern="MM",
                       ffn="--"),
    "tiny-falcon-mamba": dict(arch="falcon-mamba", n_layer=2, n_embd=256, n_head=0,
                              n_head_kv=0, n_ff=0, n_vocab=384, rms_eps=1e-5,
                              ssm=(512, 16, 256, 0, 4), pattern="MM", ffn="--"),
    "tiny-mamba2": dict(arch="mamba2", n_layer=2, n_embd=256, n_head=0, n_head_kv=0, n_ff=0,
                        n_vocab=384, rms_eps=1e-5, ssm=(512, 64, 8, 2, 4), ssm_norm=True,
                        pattern="MM", ffn="--"),
    "tiny-jamba": dict(arch="jamba", n_layer=4, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                       n_vocab=384, rms_eps=1e-6, rope_base=10000.0, n_expert=8,
                       n_expert_used=2, ssm=(512, 16, 256, 0, 4), dt_b_c_norms=True,
                       pattern="MMAM", ffn="dede"),
    "tiny-nemotron-h": dict(arch="nemotron_h", n_layer=4, n_embd=256, n_head=4, n_head_kv=2,
                            n_ff=512, n_vocab=384, rms_eps=1e-5, rope_base=10000.0,
                            ssm=(512, 64, 8, 2, 4), ssm_norm=True, pattern="MAFM", ffn="--r-"),
    "tiny-granite-h": dict(arch="granitehybrid", n_layer=4, n_embd=256, n_head=4, n_head_kv=2,
                           n_ff=256, n_vocab=384, rms_eps=1e-5, rope_base=10000.0, n_expert=8,
                           n_expert_used=2, n_ff_exp=256, n_ff_shexp=256,
                           ssm=(512, 64, 8, 2, 4), ssm_norm=True,
                           multipliers=(12.0, 0.22, 6.0, 0.015625), pattern="MAMM",
                           ffn="eeee"),
    "tiny-nemotron-h-moe": dict(arch="nemotron_h_moe", n_layer=4, n_embd=256, n_head=4,
                                n_head_kv=2, n_ff=256, n_vocab=384, rms_eps=1e-5,
                                rope_base=10000.0, n_expert=8, n_expert_used=2, n_ff_exp=256,
                                n_ff_shexp=256, gating=2, weights_scale=2.5,
                                weights_norm=True, ssm=(512, 64, 8, 2, 4), ssm_norm=True,
                                pattern="MAFM", ffn="--e-"),
    "tiny-falcon-h1": dict(arch="falcon-h1", n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                           n_ff=512, n_vocab=384, rms_eps=1e-5, rope_base=10000.0,
                           ssm=(512, 64, 8, 2, 4), ssm_norm=True, pattern="HH", ffn="dd"),
}

# the archs whose norms are LayerNorms (layer_norm_epsilon)
_LAYER_NORM_ARCHS = ("phi2", "falcon", "gptneox", "codeshell", "bloom", "mpt", "jais", "gpt2",
                     "starcoder")
# the fused-qkv archs without RoPE: ALiBi (bloom, mpt, jais) or learned
# positions (gpt2, starcoder)
_NO_ROPE_ARCHS = ("bloom", "mpt", "jais", "gpt2", "starcoder")

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
              GGMLType.Q5_0: math.sqrt(2736 / 32),  # codes q − 16 uniform over −16 .. 15
              GGMLType.Q4_0: math.sqrt(344 / 16),  # codes q − 8 uniform over −8 .. 7
              # codes q + 1 (m = d): uniform over 1 .. 32 and 1 .. 16
              GGMLType.Q5_1: math.sqrt(357.5), GGMLType.Q4_1: math.sqrt(93.5),
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


# the fallback of llama_tensor_get_type for a tensor whose rows (n_in) are
# not a multiple of 256, the K-quants' super-block
_K_FALLBACK = {**{t: GGMLType.IQ4_NL for t in (
    GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ2_XS,
    GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M)},
    GGMLType.TQ1_0: GGMLType.Q4_0, GGMLType.TQ2_0: GGMLType.Q4_0,
    GGMLType.Q4_K: GGMLType.Q5_0, GGMLType.Q5_K: GGMLType.Q5_1, GGMLType.Q6_K: GGMLType.Q8_0}


def preset_type(ftype: str, kind: str, i_layer: int, n_layer: int,
                n_expert: int = 0, tied: bool = False, n_in: int = 256) -> GGMLType:
    """The type llama.cpp's recipe `ftype` (a name of PRESETS) gives a llama
    tensor (llama_tensor_get_type in src/llama-quant.cpp, for a llama with
    n_gqa = 4 and no imatrix). `kind` is the tensor name without `blk.N.`
    and `.weight`; an expert stack (`*_exps`) and a shared expert
    (`*_shexp`) take their FFN kind's type. The router (ffn_gate_inp) is
    never quantized. With a `tied` head (no output.weight, as gemma's)
    token_embd takes the output's type. A tensor whose rows (`n_in`) are
    not a multiple of 256 takes the recipe's fallback for its type (Q4_K →
    Q5_0, Q5_K → Q5_1, Q6_K → Q8_0, TQ1_0 / TQ2_0 → Q4_0, Q2_K, Q3_K and
    the i-quants → IQ4_NL).

    A fused attn_qkv (phi3, phi2, qwen) takes llama.cpp's attn_qkv rule:
    Q5_K at Q4_K_M, Q4_K at Q3_K_M and IQ3_M, else the default type
    (ffn_up, fused gate|up or not, the default).

    deepseek2's tensors: attn_q (or attn_q_a and attn_q_b), attn_kv_a_mqa,
    attn_kv_b and attn_output take the default type (no rule names them:
    attn_kv_b counts among llama.cpp's attn_v tensors but is not typed as
    one); ffn_down, ffn_down_exps and ffn_down_shexp the ffn_down rule at
    their layer (llama.cpp parses it from the name when there are experts,
    over n_layer layers); ffn_gate/up_shexp the default; exp_probs_b is an
    f32 bias like the norms. At Q4_K_M DeepSeek-V2-Lite's K = 1408 down
    experts take Q5_0, or Q8_0 on use_more_bits layers, as does its dense
    lead's K = 10944 ffn_down.

    | ftype | default | attn_v | attn_output | ffn_down | output | token_embd | attn_qkv |
    | Q4_K_M | Q4_K | Q6_K on use_more_bits layers | Q4_K | Q6_K on use_more_bits layers | Q6_K | Q4_K | Q5_K |
    | Q2_K | Q2_K | Q4_K | Q3_K | Q3_K | Q6_K | Q2_K | default |
    | Q3_K_M | Q3_K | Q5_K for layers 0-1, else Q4_K | Q4_K | Q5_K for i < n/16, else Q4_K | Q6_K | Q3_K | Q4_K |
    | Q4_0, Q4_1, Q5_0, Q5_1 | that type | default | default | default | Q6_K | default |
    | IQ4_NL, IQ4_XS | that type | Q5_K | default | Q5_K for i < n/8, else default | Q6_K | default |
    | MXFP4_MOE | Q8_0 | Q8_0 | Q8_0 | Q8_0 | Q8_0 | Q8_0 |
    | IQ2_XXS, IQ2_XS | that type | Q4_K | default | Q2_K for i < n/8 | Q5_K | Q2_K |
    | IQ2_M | IQ2_S | Q4_K | IQ3_S | IQ3_S for i < n/8 | Q5_K | IQ3_S |
    | IQ1_S, IQ1_M | that type | Q4_K | IQ2_XXS | Q2_K for i < n/8 | Q5_K | Q2_K |
    | IQ3_XXS | IQ3_XXS (attn_q, attn_k IQ2_S) | Q4_K | default | Q4_K for i < n/8, else Q3_K | Q5_K | IQ3_S |
    | IQ3_M | IQ3_S | Q4_K | Q4_K | Q4_K for i < n/8 | Q6_K | IQ3_S | Q4_K |
    | TQ1_0, TQ2_0 | that type | default | default | default | Q6_K | Q4_K |

    MXFP4_MOE makes every expert stack MXFP4. Q4_K_M with exactly 8
    experts makes attn_k and attn_v Q8_0 and attn_output Q5_K; the IQ1 and
    IQ2 presets with exactly 8 experts make attn_k and attn_v Q4_K and
    attn_output Q5_K."""
    if kind == "ffn_gate_inp":
        return GGMLType.F32
    gtype = _preset_type(ftype, kind, i_layer, n_layer, n_expert, tied)
    return _K_FALLBACK.get(gtype, gtype) if n_in % 256 else gtype


def _preset_type(ftype: str, kind: str, i_layer: int, n_layer: int, n_expert: int,
                 tied: bool) -> GGMLType:
    if tied and kind == "token_embd":
        kind = "output"
    if ftype == "MXFP4_MOE":
        return GGMLType.MXFP4 if kind.endswith("_exps") else GGMLType.Q8_0
    kind = kind.removesuffix("_exps").removesuffix("_shexp")
    if kind == "attn_qkv" and ftype in ("Q4_K_M", "Q3_K_M", "IQ3_M"):
        return GGMLType.Q5_K if ftype == "Q4_K_M" else GGMLType.Q4_K
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
                              n_vocab: int | None = None, vocab: str | None = None) -> str:
    """Writes the synthetic model `shape` (a key of SHAPES: a llama, or a
    gemma shape with its arch's metadata and tensors) at preset
    `ftype` (a name of PRESETS) to `path`, with `n_layer` layers and
    `n_vocab` tokens in place of the shape's own if given (an SPM vocab
    below the shape's keeps its first n_vocab tokens); the same arguments
    give the same bytes. `vocab` "spm" writes an SPM vocab
    (tokenizer.ggml.model "llama"), "bpe" a byte-level BPE vocab with
    merges as a Llama-3 GGUF carries it (model "gpt2", pre "llama-bpe", or
    the shape's `pre`: "qwen2" for the Qwen shapes; `_bpe_vocab`); None the
    shape's own ("bpe" for the Qwen shapes, else "spm"); the weights are
    the same either way."""
    synthetic_writer(path, shape, seed, ftype, n_layer, n_vocab, vocab).write()
    return str(path)


def synthetic_writer(path, shape: str = "llama-3-8b", seed: int = 0, ftype: str = "Q4_K_M",
                     n_layer: int | None = None, n_vocab: int | None = None,
                     vocab: str | None = None) -> GGUFWriter:
    """The writer of make_synthetic_llama_gguf, its payloads not drawn yet
    (`payload_bytes()` sizes the file before it is written)."""
    if ftype not in PRESETS:
        raise ValueError(f"unknown preset {ftype!r}; presets: {PRESETS}")
    cfg = SHAPES[shape]
    vocab = vocab or cfg.get("vocab", "spm")
    if vocab not in ("spm", "bpe"):
        raise ValueError(f"unknown vocab {vocab!r}: 'spm' or 'bpe'")
    rng = np.random.default_rng(seed)
    arch = cfg.get("arch", "llama")
    gemma = arch.startswith("gemma")
    tied = gemma or cfg.get("tied", False)
    mla = arch in ("deepseek2", "minicpm3", "plm")
    layer_norm = arch in _LAYER_NORM_ARCHS
    n_layer, n_embd = n_layer or cfg["n_layer"], cfg["n_embd"]
    n_head, n_head_kv, n_ff = cfg["n_head"], cfg["n_head_kv"], cfg["n_ff"]
    n_vocab = n_vocab or cfg["n_vocab"]
    n_expert = cfg.get("n_expert", 0)
    head_dim = cfg.get("head_dim", n_embd // max(n_head, 1))
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

    w = GGUFWriter(path, architecture=arch)
    w.add_kv("general.name", f"tpullm-synth-{shape}" + ("" if ftype == "Q4_K_M" else f"-{ftype}")
             + ("" if n_vocab == cfg["n_vocab"] else f"-v{n_vocab}")
             + ("" if vocab == cfg.get("vocab", "spm") else f"-{vocab}"))
    w.add_kv(f"{arch}.block_count", n_layer)
    w.add_kv(f"{arch}.context_length", cfg.get("n_ctx", 8192))
    w.add_kv(f"{arch}.embedding_length", n_embd)
    w.add_kv(f"{arch}.feed_forward_length", n_ff)
    w.add_kv(f"{arch}.attention.head_count", n_head)
    w.add_kv(f"{arch}.attention.head_count_kv", n_head_kv)
    w.add_kv(f"{arch}.attention.layer_norm_{'' if layer_norm else 'rms_'}epsilon",
             cfg.get("rms_eps", 1e-5))
    if arch not in _NO_ROPE_ARCHS and "rope_base" in cfg:  # the SSMs have no RoPE
        w.add_kv(f"{arch}.rope.freq_base", cfg["rope_base"])
        w.add_kv(f"{arch}.rope.dimension_count", cfg.get("n_rot", cfg.get("qk_rope", head_dim)))
    if "alibi_bias" in cfg:
        w.add_kv(f"{arch}.attention.max_alibi_bias", cfg["alibi_bias"])
    if "clamp_kqv" in cfg:
        w.add_kv(f"{arch}.attention.clamp_kqv", cfg["clamp_kqv"])
    w.add_kv(f"{arch}.vocab_size", n_vocab)
    if gemma or (n_head and head_dim != n_embd // n_head):
        w.add_kv(f"{arch}.attention.key_length", head_dim)
        w.add_kv(f"{arch}.attention.value_length", head_dim)
    if "n_ff_exp" in cfg and not mla:
        w.add_kv(f"{arch}.expert_feed_forward_length", cfg["n_ff_exp"])
    if "n_ff_shexp" in cfg:
        w.add_kv(f"{arch}.expert_shared_feed_forward_length", cfg["n_ff_shexp"])
    if "rope_base_swa" in cfg:
        w.add_kv(f"{arch}.rope.freq_base_swa", cfg["rope_base_swa"])
    if "rope_scaling" in cfg:
        w.add_kv(f"{arch}.rope.scaling.type", cfg["rope_scaling"][0])
        w.add_kv(f"{arch}.rope.scaling.factor", cfg["rope_scaling"][1])
    if "rope_orig_ctx" in cfg:  # YaRN as llama.cpp's deepseek2 converter writes it
        w.add_kv(f"{arch}.rope.scaling.original_context_length", cfg["rope_orig_ctx"])
        w.add_kv(f"{arch}.rope.scaling.yarn_log_multiplier", cfg["yarn_log_mul"])
    if mla:
        w.add_kv(f"{arch}.attention.key_length", cfg["qk_nope"] + cfg["qk_rope"])
        w.add_kv(f"{arch}.attention.value_length", cfg["v_dim"])
        w.add_kv(f"{arch}.attention.kv_lora_rank", cfg["kv_lora"])
        if "q_lora" in cfg:
            w.add_kv(f"{arch}.attention.q_lora_rank", cfg["q_lora"])
    if mla and n_expert:
        w.add_kv(f"{arch}.leading_dense_block_count", cfg["n_dense_lead"])
        w.add_kv(f"{arch}.expert_feed_forward_length", cfg["n_ff_exp"])
        w.add_kv(f"{arch}.expert_shared_count", cfg["n_expert_shared"])
        w.add_kv(f"{arch}.expert_weights_scale", cfg["weights_scale"])
        w.add_kv(f"{arch}.expert_weights_norm", cfg["weights_norm"])
        w.add_kv(f"{arch}.expert_gating_func", cfg["gating"])
    if "sections" in cfg:
        w.add_kv(f"{arch}.rope.dimension_sections", np.asarray(cfg["sections"], np.int32))
    if "par_residual" in cfg:
        w.add_kv(f"{arch}.use_parallel_residual", cfg["par_residual"])
    if cfg.get("xielu"):  # apertus' raw per-layer values, near softplus⁻¹ of 0.8 and 0.8 − β
        for key, base in (("alpha_p", 0.1164), ("alpha_n", -0.4328)):
            w.add_kv(f"xielu.{key}", (base + 0.1 * rng.standard_normal(n_layer)).astype(
                np.float32))
        w.add_kv("xielu.beta", np.full(n_layer, 0.5, np.float32))
        w.add_kv("xielu.eps", np.full(n_layer, -1e-6, np.float32))
    if "sliding_window" in cfg:
        w.add_kv(f"{arch}.attention.sliding_window", cfg["sliding_window"])
    if "swa_pattern" in cfg:
        w.add_kv(f"{arch}.attention.sliding_window_pattern", cfg["swa_pattern"])
    if "softcaps" in cfg:
        w.add_kv(f"{arch}.attn_logit_softcapping", cfg["softcaps"][0])
        w.add_kv(f"{arch}.final_logit_softcapping", cfg["softcaps"][1])
    if n_expert:
        w.add_kv(f"{arch}.expert_count", n_expert)
        w.add_kv(f"{arch}.expert_used_count", cfg["n_expert_used"])
    if "ssm" in cfg:
        _ssm_metadata(w, cfg, n_layer)
    if vocab == "spm":
        w.add_kv("tokenizer.ggml.model", "llama")
        w.add_kv("tokenizer.ggml.tokens", tokens[:n_vocab])
        w.add_kv("tokenizer.ggml.scores", np.asarray(scores[:n_vocab], dtype=np.float32))
        w.add_kv("tokenizer.ggml.token_type", np.asarray(types[:n_vocab], dtype=np.int32))
        w.add_kv("tokenizer.ggml.bos_token_id", 1)
        w.add_kv("tokenizer.ggml.eos_token_id", 2)
    else:
        w.add_kv("tokenizer.ggml.model", "gpt2")
        w.add_kv("tokenizer.ggml.pre", cfg.get("pre", "llama-bpe"))
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
        gtype = preset_type(ftype, kind, i, n_layer, n_expert, tied=tied, n_in=n_in)
        shape = (n_in, n_out) if n_stack == 1 else (n_in, n_out, n_stack)
        scale = 0.02 if legacy else n_in ** -0.5 / _RMS_PER_D[gtype]
        w.add_packed_tensor(name, shape, gtype, lambda: random_packed(
            rng, gtype, n_stack * n_out * n_in, scale=scale, words=words))

    def norm(name, n):
        w.add_tensor(name, np.ones(n, dtype=np.float32))

    def vector(name, n, scale, base=0.0):
        """An f32 vector of base + scale·N(0, 1): biases, the shared
        expert's gate, qk norms (base 1)."""
        w.add_tensor(name, (base + rng.standard_normal(n) * scale).astype(np.float32))

    def router(name):
        # f32 normal / sqrt(n_embd), so its logits have unit scale
        w.add_packed_tensor(name, (n_embd, n_expert), GGMLType.F32,
                            lambda: (rng.standard_normal((n_expert, n_embd))
                                     * n_embd ** -0.5).astype("<f4").reshape(-1).view(np.uint8))

    packed("token_embd.weight", n_vocab, n_embd)
    if arch == "bloom":
        norm("token_embd_norm.weight", n_embd)
        vector("token_embd_norm.bias", n_embd, 0.1)
    if cfg.get("positions"):  # learned positions: f32, never quantized (llama-quant.cpp)
        n_pos = cfg.get("n_ctx", 8192)
        w.add_packed_tensor("position_embd.weight", (n_embd, n_pos), GGMLType.F32,
                            lambda: (rng.standard_normal((n_pos, n_embd)) * 0.02).astype(
                                "<f4").reshape(-1).view(np.uint8))
    if mla:
        _deepseek2_layers(cfg, n_layer, packed, norm, router)
    elif "ssm" in cfg:
        _ssm_layers(cfg, n_layer, packed, norm, vector, router, w, rng)
    elif arch in ("phi3", "phi2", "qwen"):
        _fused_qkv_layers(cfg, n_layer, packed, norm, vector)
    elif arch in _NO_ROPE_ARCHS:
        _bloom_layers(cfg, n_layer, packed, norm, vector)
    elif layer_norm:
        _falcon_layers(cfg, n_layer, packed, norm, vector)
    else:
        n_ff_exp, n_sh = cfg.get("n_ff_exp", n_ff), cfg.get("n_ff_shexp", 0)
        for i in range(n_layer):
            p = f"blk.{i}."
            norm(p + "attn_norm.weight", n_embd)
            packed(p + "attn_q.weight", n_head * head_dim, n_embd, i)
            packed(p + "attn_k.weight", n_head_kv * head_dim, n_embd, i)
            packed(p + "attn_v.weight", n_head_kv * head_dim, n_embd, i)
            packed(p + "attn_output.weight", n_embd, n_head * head_dim, i)
            if cfg.get("qkv_bias"):
                for kind, n in (("q", n_head), ("k", n_head_kv), ("v", n_head_kv)):
                    vector(p + f"attn_{kind}.bias", n * head_dim, 0.1)
            if arch == "gemma3":
                norm(p + "attn_q_norm.weight", head_dim)
                norm(p + "attn_k_norm.weight", head_dim)
            if cfg.get("qk_norm"):
                vector(p + "attn_q_norm.weight", head_dim, 0.1, base=1.0)
                vector(p + "attn_k_norm.weight", head_dim, 0.1, base=1.0)
            if cfg.get("qk_norm_full"):  # olmoe's q/k norms over the whole projection
                vector(p + "attn_q_norm.weight", n_head * head_dim, 0.1, base=1.0)
                vector(p + "attn_k_norm.weight", n_head_kv * head_dim, 0.1, base=1.0)
            if cfg.get("wo_bias"):
                vector(p + "attn_output.bias", n_embd, 0.1)
            if cfg.get("norm_bias"):  # phimoe's LayerNorms
                vector(p + "attn_norm.bias", n_embd, 0.1)
                vector(p + "ffn_norm.bias", n_embd, 0.1)
            if arch in ("gemma2", "gemma3"):
                norm(p + "post_attention_norm.weight", n_embd)
                norm(p + "post_ffw_norm.weight", n_embd)
            norm(p + "ffn_norm.weight", n_embd)
            if n_expert and i not in cfg.get("dense_layers", ()):
                router(p + "ffn_gate_inp.weight")
                packed(p + "ffn_gate_exps.weight", n_ff_exp, n_embd, i, n_expert)
                packed(p + "ffn_up_exps.weight", n_ff_exp, n_embd, i, n_expert)
                packed(p + "ffn_down_exps.weight", n_embd, n_ff_exp, i, n_expert)
                if n_sh:  # the shared expert and qwen2moe's sigmoid gate (not llama4's)
                    if cfg.get("gated_shexp", True):
                        vector(p + "ffn_gate_inp_shexp.weight", n_embd, n_embd ** -0.5)
                    packed(p + "ffn_gate_shexp.weight", n_sh, n_embd, i)
                    packed(p + "ffn_up_shexp.weight", n_sh, n_embd, i)
                    packed(p + "ffn_down_shexp.weight", n_embd, n_sh, i)
            else:
                if not cfg.get("gateless"):
                    packed(p + "ffn_gate.weight", n_ff, n_embd, i)
                packed(p + "ffn_up.weight", n_ff, n_embd, i)
                packed(p + "ffn_down.weight", n_embd, n_ff, i)
    norm("output_norm.weight", n_embd)
    if not tied:  # gemma and plm tie their head to token_embd
        packed("output.weight", n_vocab, n_embd)
    if (layer_norm and not cfg.get("no_bias")) or cfg.get("norm_bias"):
        vector("output_norm.bias", n_embd, 0.1)
    if arch == "phi2" or cfg.get("head_bias"):
        vector("output.bias", n_vocab, 0.1)
    return w


def _fused_qkv_layers(cfg: dict, n_layer: int, packed, norm, vector) -> None:
    """The layers of a phi3, phi2 or qwen shape, with the tensor names
    llama.cpp's converter writes: q|k|v in one attn_qkv (with one fused
    bias in qwen and phi2); phi3's ffn_up holds gate | up (2·n_ff rows),
    qwen has gate and up apart, phi2 an un-gated up; phi2's LayerNorms and
    its wo, up and down carry biases (random, as the qkv bias)."""
    arch, n_embd, n_ff = cfg["arch"], cfg["n_embd"], cfg["n_ff"]
    head_dim = n_embd // cfg["n_head"]
    n_qkv = (cfg["n_head"] + 2 * cfg["n_head_kv"]) * head_dim
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        packed(p + "attn_qkv.weight", n_qkv, n_embd, i)
        if arch != "phi3":
            vector(p + "attn_qkv.bias", n_qkv, 0.1)
        packed(p + "attn_output.weight", n_embd, cfg["n_head"] * head_dim, i)
        if arch == "phi2":
            vector(p + "attn_norm.bias", n_embd, 0.1)
            vector(p + "attn_output.bias", n_embd, 0.1)
            packed(p + "ffn_up.weight", n_ff, n_embd, i)
            vector(p + "ffn_up.bias", n_ff, 0.1)
            packed(p + "ffn_down.weight", n_embd, n_ff, i)
            vector(p + "ffn_down.bias", n_embd, 0.1)
            continue
        norm(p + "ffn_norm.weight", n_embd)
        if arch == "phi3":
            packed(p + "ffn_up.weight", 2 * n_ff, n_embd, i)
        else:
            packed(p + "ffn_gate.weight", n_ff, n_embd, i)
            packed(p + "ffn_up.weight", n_ff, n_embd, i)
        packed(p + "ffn_down.weight", n_embd, n_ff, i)


def _falcon_layers(cfg: dict, n_layer: int, packed, norm, vector) -> None:
    """The layers of a falcon or gptneox shape, with the tensor names
    llama.cpp's converter writes: the LayerNorm attn_norm with its bias,
    q|k|v in one attn_qkv, attn_output, ffn_up and ffn_down; gptneox also
    the ffn_norm LayerNorm and biases on attn_qkv, attn_output, ffn_up and
    ffn_down (random, as phi2's)."""
    n_embd, n_ff = cfg["n_embd"], cfg["n_ff"]
    head_dim = n_embd // cfg["n_head"]
    n_qkv = (cfg["n_head"] + 2 * cfg["n_head_kv"]) * head_dim
    neox = cfg["arch"] != "falcon"
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        vector(p + "attn_norm.bias", n_embd, 0.1)
        packed(p + "attn_qkv.weight", n_qkv, n_embd, i)
        packed(p + "attn_output.weight", n_embd, cfg["n_head"] * head_dim, i)
        if neox:
            vector(p + "attn_qkv.bias", n_qkv, 0.1)
            vector(p + "attn_output.bias", n_embd, 0.1)
            norm(p + "ffn_norm.weight", n_embd)
            vector(p + "ffn_norm.bias", n_embd, 0.1)
        packed(p + "ffn_up.weight", n_ff, n_embd, i)
        packed(p + "ffn_down.weight", n_embd, n_ff, i)
        if neox:
            vector(p + "ffn_up.bias", n_ff, 0.1)
            vector(p + "ffn_down.bias", n_embd, 0.1)


def _bloom_layers(cfg: dict, n_layer: int, packed, norm, vector) -> None:
    """The layers of a bloom, mpt, jais, gpt2 or starcoder shape, with the
    tensor names llama.cpp's converter writes: the LayerNorms attn_norm and
    ffn_norm, q|k|v in one attn_qkv (starcoder's one KV head), attn_output,
    (jais' ffn_gate,) ffn_up and ffn_down; biases (random, as phi2's) on the
    norms and those linears unless the shape has `no_bias` (mpt); mpt's
    full-width q/k LayerNorms where the shape has `qk_norm`."""
    n_embd, n_ff, n_head = cfg["n_embd"], cfg["n_ff"], cfg["n_head"]
    head_dim = n_embd // n_head
    n_qkv = (n_head + 2 * cfg["n_head_kv"]) * head_dim
    biased = not cfg.get("no_bias")

    def bias(name, n):
        if biased:
            vector(name, n, 0.1)

    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        bias(p + "attn_norm.bias", n_embd)
        packed(p + "attn_qkv.weight", n_qkv, n_embd, i)
        bias(p + "attn_qkv.bias", n_qkv)
        if cfg.get("qk_norm"):
            vector(p + "attn_q_norm.weight", n_embd, 0.1, base=1.0)
            vector(p + "attn_k_norm.weight", cfg["n_head_kv"] * head_dim, 0.1, base=1.0)
        packed(p + "attn_output.weight", n_embd, n_head * head_dim, i)
        bias(p + "attn_output.bias", n_embd)
        norm(p + "ffn_norm.weight", n_embd)
        bias(p + "ffn_norm.bias", n_embd)
        if cfg["arch"] == "jais":
            packed(p + "ffn_gate.weight", n_ff, n_embd, i)
            bias(p + "ffn_gate.bias", n_ff)
        packed(p + "ffn_up.weight", n_ff, n_embd, i)
        bias(p + "ffn_up.bias", n_ff)
        packed(p + "ffn_down.weight", n_embd, n_ff, i)
        bias(p + "ffn_down.bias", n_embd)


def _deepseek2_layers(cfg: dict, n_layer: int, packed, norm, router) -> None:
    """The layers of a deepseek2, minicpm3 or plm shape, with the tensor
    names the JAX package's models/deepseek2.py reads (the fused attn_kv_b
    of the older converter, not the split attn_k_b / attn_v_b of newer
    ones): q direct or through the q LoRA (attn_q_a, its norm, attn_q_b),
    the kv compression and its norm, attn_kv_b, the output; the dense
    layers' SwiGLU (plm: ffn_up and ffn_down only, the gateless ReLU²), and
    past the dense lead a router (no exp_probs_b: V2's routing), the expert
    stacks and the shared expert."""
    n_embd, n_head, E = cfg["n_embd"], cfg["n_head"], cfg.get("n_expert", 0)
    dk, kvr, rope = cfg["qk_nope"] + cfg["qk_rope"], cfg["kv_lora"], cfg["qk_rope"]
    n_sh = cfg.get("n_ff_exp", 0) * cfg.get("n_expert_shared", 0)
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", n_embd)
        if "q_lora" in cfg:
            packed(p + "attn_q_a.weight", cfg["q_lora"], n_embd, i)
            norm(p + "attn_q_a_norm.weight", cfg["q_lora"])
            packed(p + "attn_q_b.weight", n_head * dk, cfg["q_lora"], i)
        else:
            packed(p + "attn_q.weight", n_head * dk, n_embd, i)
        packed(p + "attn_kv_a_mqa.weight", kvr + rope, n_embd, i)
        norm(p + "attn_kv_a_norm.weight", kvr)
        packed(p + "attn_kv_b.weight", n_head * (cfg["qk_nope"] + cfg["v_dim"]), kvr, i)
        packed(p + "attn_output.weight", n_embd, n_head * cfg["v_dim"], i)
        norm(p + "ffn_norm.weight", n_embd)
        if not E or i < cfg["n_dense_lead"]:
            if not cfg.get("gateless"):
                packed(p + "ffn_gate.weight", cfg["n_ff"], n_embd, i)
            packed(p + "ffn_up.weight", cfg["n_ff"], n_embd, i)
            packed(p + "ffn_down.weight", n_embd, cfg["n_ff"], i)
            continue
        router(p + "ffn_gate_inp.weight")
        packed(p + "ffn_gate_exps.weight", cfg["n_ff_exp"], n_embd, i, E)
        packed(p + "ffn_up_exps.weight", cfg["n_ff_exp"], n_embd, i, E)
        packed(p + "ffn_down_exps.weight", n_embd, cfg["n_ff_exp"], i, E)
        packed(p + "ffn_gate_shexp.weight", n_sh, n_embd, i)
        packed(p + "ffn_up_shexp.weight", n_sh, n_embd, i)
        packed(p + "ffn_down_shexp.weight", n_embd, n_sh, i)


def _ssm_metadata(w: GGUFWriter, cfg: dict, n_layer: int) -> None:
    """The keys of a recurrent shape, as llama.cpp's converter writes them:
    the ssm.* widths (group_count for Mamba-2), falcon-mamba's dt_b_c_rms;
    a hybrid's KV heads a layer as an array (0 on a layer without
    attention; Falcon-H1's a scalar), nemotron-h's FFN widths a layer (0
    but on its FFN-only layers); granite's multipliers; nemotron_h_moe's
    gating (sigmoid), weight scale and renormalisation."""
    arch = cfg["arch"]
    d_inner, d_state, rank, groups, d_conv = cfg["ssm"]
    for key, val in (("conv_kernel", d_conv), ("inner_size", d_inner), ("state_size", d_state),
                     ("time_step_rank", rank)):
        w.add_kv(f"{arch}.ssm.{key}", val)
    if groups:
        w.add_kv(f"{arch}.ssm.group_count", groups)
    if arch == "falcon-mamba":
        w.add_kv(f"{arch}.ssm.dt_b_c_rms", True)
    pattern = cfg["pattern"][:n_layer]
    if cfg["n_head_kv"] and arch != "falcon-h1":
        w.set_kv(f"{arch}.attention.head_count_kv", np.asarray(
            [cfg["n_head_kv"] if c == "A" else 0 for c in pattern], np.int32))
    if arch in ("nemotron_h", "nemotron_h_moe"):
        w.set_kv(f"{arch}.feed_forward_length", np.asarray(
            [cfg["n_ff"] if c == "F" else 0 for c in pattern], np.int32))
    if "multipliers" in cfg:
        embd, res, logit, attn = cfg["multipliers"]
        w.add_kv(f"{arch}.embedding_scale", embd)
        w.add_kv(f"{arch}.residual_scale", res)
        w.add_kv(f"{arch}.logit_scale", logit)
        w.add_kv(f"{arch}.attention.scale", attn)
    if "gating" in cfg:
        w.add_kv(f"{arch}.expert_gating_func", cfg["gating"])
        w.add_kv(f"{arch}.expert_weights_scale", cfg["weights_scale"])
        w.add_kv(f"{arch}.expert_weights_norm", cfg["weights_norm"])


def _ssm_layers(cfg: dict, n_layer: int, packed, norm, vector, router, w: GGUFWriter,
                rng: np.random.Generator) -> None:
    """The layers of a recurrent shape (`pattern` and `ffn`, see SHAPES),
    with the tensor names llama.cpp's converter writes. An SSM mixer: the
    in-projection (mamba1 x|z; Mamba-2 z|xBC|dt), the f32 conv kernel
    [width, d_conv] and bias, dt_bias (dt = softplus(dt_bias) log-uniform in
    [1e-3, 0.1], as Mamba initialises it), A (the file holds −exp(A_log):
    mamba1's −1 .. −d_state a row, Mamba-2's −U(1, 16) a head), D = 1, and
    mamba1's ssm_x and ssm_dt (with jamba's dt/B/C norms) or Mamba-2's
    grouped norm; the out-projection. Attention: q, k, v, output. The FFN
    slot: SwiGLU, the gateless ReLU², or a router with expert stacks
    (gateless for nemotron_h_moe, with its selection bias) and the shared
    expert (gated but for nemotron_h_moe)."""
    arch, n_embd, n_ff = cfg["arch"], cfg["n_embd"], cfg["n_ff"]
    d_inner, d_state, rank, groups, d_conv = cfg["ssm"]
    n_head, n_kv = cfg["n_head"], cfg["n_head_kv"]
    head_dim = cfg.get("head_dim", n_embd // max(n_head, 1))
    E, n_exp = cfg.get("n_expert", 0), cfg.get("n_ff_exp", n_ff)
    n_sh, gateless = cfg.get("n_ff_shexp", 0), arch == "nemotron_h_moe"
    width = d_inner + 2 * groups * d_state if groups else d_inner

    def f32(name, a):
        w.add_tensor(name, np.ascontiguousarray(a, dtype=np.float32))

    for i in range(n_layer):
        p, kind, ffn = f"blk.{i}.", cfg["pattern"][i], cfg["ffn"][i]
        norm(p + "attn_norm.weight", n_embd)
        if kind in "MH":
            n_proj = 2 * d_inner + (2 * groups * d_state + rank if groups else 0)
            packed(p + "ssm_in.weight", n_proj, n_embd, i)
            f32(p + "ssm_conv1d.weight", rng.standard_normal((width, d_conv)) * d_conv ** -0.5)
            vector(p + "ssm_conv1d.bias", width, 0.1)
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), rank if groups else d_inner))
            f32(p + "ssm_dt.bias", dt + np.log(-np.expm1(-dt)))  # softplus⁻¹(dt)
            if groups:
                f32(p + "ssm_a", -rng.uniform(1.0, 16.0, rank))
                norm(p + "ssm_d", rank)
                if cfg.get("ssm_norm"):
                    vector(p + "ssm_norm.weight", d_inner, 0.1, base=1.0)
            else:
                packed(p + "ssm_x.weight", rank + 2 * d_state, d_inner, i)
                packed(p + "ssm_dt.weight", d_inner, rank, i)
                f32(p + "ssm_a", -np.tile(np.arange(1.0, d_state + 1.0), (d_inner, 1)))
                norm(p + "ssm_d", d_inner)
                if cfg.get("dt_b_c_norms"):
                    for name, n in (("dt", rank), ("b", d_state), ("c", d_state)):
                        vector(p + f"ssm_{name}_norm.weight", n, 0.1, base=1.0)
            packed(p + "ssm_out.weight", n_embd, d_inner, i)
        if kind in "AH":
            packed(p + "attn_q.weight", n_head * head_dim, n_embd, i)
            packed(p + "attn_k.weight", n_kv * head_dim, n_embd, i)
            packed(p + "attn_v.weight", n_kv * head_dim, n_embd, i)
            packed(p + "attn_output.weight", n_embd, n_head * head_dim, i)
        if ffn == "-":
            continue
        if kind != "F":  # an FFN-only layer runs on its attn_norm
            norm(p + "ffn_norm.weight", n_embd)
        if ffn == "e":
            router(p + "ffn_gate_inp.weight")
            if not gateless:
                packed(p + "ffn_gate_exps.weight", n_exp, n_embd, i, E)
            packed(p + "ffn_up_exps.weight", n_exp, n_embd, i, E)
            packed(p + "ffn_down_exps.weight", n_embd, n_exp, i, E)
            if gateless:
                vector(p + "exp_probs_b.bias", E, 0.1)
            if n_sh:
                if not gateless:
                    packed(p + "ffn_gate_shexp.weight", n_sh, n_embd, i)
                packed(p + "ffn_up_shexp.weight", n_sh, n_embd, i)
                packed(p + "ffn_down_shexp.weight", n_embd, n_sh, i)
            continue
        if ffn == "d":
            packed(p + "ffn_gate.weight", n_ff, n_embd, i)
        packed(p + "ffn_up.weight", n_ff, n_embd, i)
        packed(p + "ffn_down.weight", n_embd, n_ff, i)
