"""GGUF / ggml on-disk format constants (the subset the port reads and writes).

Format facts of the GGUF v3 container and ggml's block layouts: the type
enum (ggml.h), block geometry (ggml-common.h) and the metadata key names the
llama loader and the SPM tokenizer read.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# Superblock size for K-quants (ggml-common.h: QK_K).
QK_K = 256


class GGUFValueType(enum.IntEnum):
    """Metadata value types (gguf.h: enum gguf_type)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (ggml.h, enum ggml_type). Gaps are retired types."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


@dataclass(frozen=True)
class TypeTraits:
    """Block geometry of a ggml tensor type."""

    block_size: int  # elements per block
    type_size: int  # bytes per block
    is_quantized: bool


TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    GGMLType.Q4_0: TypeTraits(32, 18, True),
    GGMLType.Q4_1: TypeTraits(32, 20, True),
    GGMLType.Q5_0: TypeTraits(32, 22, True),
    GGMLType.Q5_1: TypeTraits(32, 24, True),
    GGMLType.Q8_0: TypeTraits(32, 34, True),
    GGMLType.Q8_1: TypeTraits(32, 36, True),
    GGMLType.MXFP4: TypeTraits(32, 17, True),
    GGMLType.Q2_K: TypeTraits(QK_K, 84, True),
    GGMLType.Q3_K: TypeTraits(QK_K, 110, True),
    GGMLType.Q4_K: TypeTraits(QK_K, 144, True),
    GGMLType.Q5_K: TypeTraits(QK_K, 176, True),
    GGMLType.Q6_K: TypeTraits(QK_K, 210, True),
    GGMLType.Q8_K: TypeTraits(QK_K, 292, True),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 66, True),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 74, True),
    GGMLType.IQ2_S: TypeTraits(QK_K, 82, True),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 98, True),
    GGMLType.IQ3_S: TypeTraits(QK_K, 110, True),
    GGMLType.IQ1_S: TypeTraits(QK_K, 50, True),
    GGMLType.IQ1_M: TypeTraits(QK_K, 56, True),
    GGMLType.IQ4_NL: TypeTraits(32, 18, True),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 136, True),
    GGMLType.TQ1_0: TypeTraits(QK_K, 54, True),
    GGMLType.TQ2_0: TypeTraits(QK_K, 66, True),
}


# Nonlinear codebook of IQ4_NL and IQ4_XS (ggml-common.h kvalues_iq4nl).
IQ4_NL_VALUES = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113)

# FP4 (E2M1) codebook of MXFP4, doubled: a block's values are these times
# 2^(e-128) for its exponent byte e (ggml-quants.c GGML_E8M0_TO_FP32_HALF),
# i.e. {0, ±.5, ±1, ±1.5, ±2, ±3, ±4, ±6} × 2^(e-127).
MXFP4_VALUES = (0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12)


def row_size(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes needed to store one row of `n_elements` (must divide block size)."""
    tt = TYPE_TRAITS[ggml_type]
    if n_elements % tt.block_size != 0:
        raise ValueError(
            f"row of {n_elements} elements is not a multiple of {ggml_type.name} "
            f"block size {tt.block_size}"
        )
    return n_elements // tt.block_size * tt.type_size


class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        ALIGNMENT = "general.alignment"

    class LLM:
        """Per-arch keys; format with arch name, e.g. 'llama.context_length'."""

        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        VOCAB_SIZE = "{arch}.vocab_size"
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        KEY_LENGTH = "{arch}.attention.key_length"
        VALUE_LENGTH = "{arch}.attention.value_length"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        MAX_ALIBI_BIAS = "{arch}.attention.max_alibi_bias"
        SLIDING_WINDOW = "{arch}.attention.sliding_window"
        SCALE = "{arch}.attention.scale"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
        SCALING_ORIG_CTX_LEN = "{arch}.rope.scaling.original_context_length"
        SCALING_YARN_EXT_FACTOR = "{arch}.rope.scaling.yarn_ext_factor"
        SCALING_YARN_BETA_FAST = "{arch}.rope.scaling.yarn_beta_fast"
        SCALING_YARN_BETA_SLOW = "{arch}.rope.scaling.yarn_beta_slow"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        EOM_ID = "tokenizer.ggml.eom_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        CLS_ID = "tokenizer.ggml.cls_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        MASK_ID = "tokenizer.ggml.mask_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        CHAT_TEMPLATE = "tokenizer.chat_template"
        FIM_PRE_ID = "tokenizer.ggml.fim_pre_token_id"
        FIM_SUF_ID = "tokenizer.ggml.fim_suf_token_id"
        FIM_MID_ID = "tokenizer.ggml.fim_mid_token_id"


class TokenType(enum.IntEnum):
    """tokenizer.ggml.token_type values."""

    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
