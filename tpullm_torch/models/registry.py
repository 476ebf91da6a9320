"""Architecture registry: GGUF `general.architecture` → (build_params,
forward), the rows of the JAX package's models/registry.py that the port
runs: `llama` with its 22 aliases (models/hparams.py LLAMA_ALIASES, and
LLAMA_OPTION_ALIASES: arcee, apertus, llama-embed, qwen2vl, qwen3vl),
`qwen3moe` with 13 aliases (QWEN_MOE_ALIASES, qwen3vlmoe, its M-RoPE
sections read, text positions only: NEOX RoPE, and olmoe, whose
full-projection q/k norms and unrenormalised softmax top-k the graph
computes as the JAX package's olmoe.forward does), `gemma3` (alias
`gemma2`), `gemma`, `deepseek2` with its aliases `minicpm3` (the MLA graph
with minicpm's multipliers) and `plm` (all-dense MLA, a gateless ReLU²
FFN), `phi3` and `qwen` (their fused tensors loaded by models/phi3.py and
models/qwen.py, the llama forward), `phimoe` (models/phi3.py
build_params_moe / forward_moe), `phi2`, `falcon` with its aliases
`gptneox` and `codeshell` (models/falcon.py), `bloom` with its aliases
`mpt` and `jais` (models/bloom.py: the ALiBi family), `gpt2` with its
alias `starcoder` (models/gpt2.py: learned positions), `llama4`
(models/llama4.py: chunked attention, NoPE layers, sigmoid top-k experts
and a shared expert), and the recurrent-state archs: `mamba` with its alias
`falcon-mamba` and `mamba2` (models/mamba.py on runtime/recurrent.py's
RecurrentCache), `jamba` with its aliases `nemotron_h`, `granitehybrid`
and `nemotron_h_moe`, and `falcon-h1` (models/jamba.py on its
HybridCache): 64 names."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..gguf.reader import GGUFReader
from ..runtime.recurrent import RecurrentCache
from . import (bloom, deepseek2, falcon, gemma, gpt2, jamba, llama, llama4, mamba, phi2, phi3,
               qwen, qwen_moe)
from .hparams import (BLOOM_ARCHS, FALCON_ARCHS, GPT2_ARCHS, LLAMA_ALIASES,
                      LLAMA_OPTION_ALIASES, QWEN_MOE_ALIASES, HParams, hparams_from_gguf)


@dataclass(frozen=True)
class ArchSpec:
    name: str
    build_params: Callable
    forward: Callable
    # interleaved sliding-window attention: the Engine gives it the ring
    # cache (runtime/kvcache.py SWACache) unless asked for swa_full
    iswa: bool = False
    # an arch that brings its own cache: (hp, batch, max_len, kv_dtype,
    # device) → cache (deepseek2: the MLA latent; the recurrent archs)
    make_cache: Callable | None = None
    # recurrent state (SSM layers): exact-length prefills, no speculation,
    # no cache shift (the JAX package's ArchSpec.recurrent)
    recurrent: bool = False


_LLAMA = ArchSpec("llama", llama.build_params, llama.forward)
_QWEN_MOE = ArchSpec("qwen3moe", qwen_moe.build_params, qwen_moe.forward)
_GEMMA3 = ArchSpec("gemma3", gemma.build_params, gemma.forward, iswa=True)
_DEEPSEEK2 = ArchSpec("deepseek2", deepseek2.build_params, deepseek2.forward,
                      make_cache=deepseek2.make_cache)
_FALCON = ArchSpec("falcon", falcon.build_params, falcon.forward)
_BLOOM = ArchSpec("bloom", bloom.build_params, bloom.forward)
_GPT2 = ArchSpec("gpt2", gpt2.build_params, gpt2.forward)
_MAMBA = ArchSpec("mamba", mamba.build_params, mamba.forward,
                  make_cache=RecurrentCache.new, recurrent=True)
_JAMBA = ArchSpec("jamba", jamba.build_params, jamba.forward, make_cache=jamba.HybridCache.new,
                  recurrent=True)
_REGISTRY = {**{name: _LLAMA for name in ("llama", *LLAMA_ALIASES, *LLAMA_OPTION_ALIASES)},
             **{name: _QWEN_MOE for name in ("qwen3moe", *QWEN_MOE_ALIASES, "qwen3vlmoe",
                                             "olmoe")},
             "gemma3": _GEMMA3, "gemma2": _GEMMA3,
             "gemma": ArchSpec("gemma", gemma.build_params, gemma.forward),
             **{name: _DEEPSEEK2 for name in ("deepseek2", "minicpm3", "plm")},
             "phi3": ArchSpec("phi3", phi3.build_params, llama.forward),
             "phimoe": ArchSpec("phimoe", phi3.build_params_moe, phi3.forward_moe),
             "phi2": ArchSpec("phi2", phi2.build_params, phi2.forward),
             "qwen": ArchSpec("qwen", qwen.build_params, llama.forward),
             **{name: _FALCON for name in FALCON_ARCHS},
             **{name: _BLOOM for name in BLOOM_ARCHS},
             **{name: _GPT2 for name in GPT2_ARCHS},
             "llama4": ArchSpec("llama4", llama4.build_params, llama4.forward),
             "mamba": _MAMBA, "falcon-mamba": _MAMBA,
             "mamba2": ArchSpec("mamba2", mamba.build_params, mamba.forward,
                                make_cache=RecurrentCache.new, recurrent=True),
             **{name: _JAMBA for name in ("jamba", "nemotron_h", "granitehybrid",
                                          "nemotron_h_moe")},
             "falcon-h1": ArchSpec("falcon-h1", jamba.build_params, jamba.forward_falcon_h1,
                                   make_cache=jamba.HybridCache.new, recurrent=True)}


def get_arch(name: str) -> ArchSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise NotImplementedError(
            f"architecture {name!r} is not ported (have: {sorted(_REGISTRY)})")
    return spec


def load_hparams(r: GGUFReader) -> HParams:
    get_arch(r.architecture)
    return hparams_from_gguf(r)
