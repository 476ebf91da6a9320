"""GPT-2 and StarCoder decoders (the JAX package's models/gpt2.py;
reference graphs llm_build_gpt2, llm_build_starcoder): models/bloom.py's
graph without ALiBi.

Learned absolute positions added to the token embedding (each position
clamped to the table: models/bloom.py `learned_positions`), no RoPE;
LayerNorms with their biases; q, k and v fused in attn_qkv with its fused
bias, loaded as one linear inside a FusedLinear of those splits
(models/weights.py `load_fused`; StarCoder's 48 query heads share one KV
head, so a decode token is R = 48 rows, which flash's decode regime takes
in row groups); biases on wo, up and down; an un-gated FFN with the tanh
GELU in f32; the final LayerNorm, then the head in f32 (tied to the
embedding where the file has no output.weight). The offsets take the three
forms of llama.forward_offsets and nothing is read back to the host, so
the forward is captured as the llama one is.
"""

from __future__ import annotations

import torch

from ..gguf.reader import GGUFReader
from . import bloom
from .bloom import forward
from .hparams import HParams
from .llama import Params

__all__ = ["build_params", "forward"]


def build_params(r: GGUFReader, hp: HParams, device, dtype=torch.bfloat16,
                 mode: str = "auto") -> Params:
    """models/bloom.py's params (the LayerNorms and their biases, the fused
    qkv and its bias, wo, up and down with their biases, the token and
    position tables, the head: None where tied), with no ALiBi slopes."""
    if "position_embd.weight" not in r.tensors:
        raise ValueError(f"{hp.arch}: the file has no position_embd.weight")
    return {**bloom.build_params(r, hp, device, dtype, mode), "alibi_slopes": None}
