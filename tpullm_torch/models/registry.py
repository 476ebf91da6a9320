"""Architecture registry: GGUF `general.architecture` → (build_params,
forward). Only the `llama` row is ported."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..gguf.reader import GGUFReader
from . import llama
from .hparams import HParams, hparams_from_gguf


@dataclass(frozen=True)
class ArchSpec:
    name: str
    build_params: Callable
    forward: Callable


_REGISTRY = {"llama": ArchSpec("llama", llama.build_params, llama.forward)}


def get_arch(name: str) -> ArchSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise NotImplementedError(
            f"architecture {name!r} is not ported (have: {sorted(_REGISTRY)})")
    return spec


def load_hparams(r: GGUFReader) -> HParams:
    get_arch(r.architecture)
    return hparams_from_gguf(r)
