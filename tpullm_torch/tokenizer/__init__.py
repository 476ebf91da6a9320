"""Tokenizers loaded from GGUF metadata. SPM only; the other families are
not ported."""

from __future__ import annotations

from ..gguf.reader import GGUFReader
from .spm import SPMTokenizer
from .vocab import SpecialIds, Vocab


def from_vocab(vocab: Vocab) -> SPMTokenizer:
    if vocab.model in ("llama", "spm"):
        return SPMTokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r} is not ported")


def from_gguf(r: GGUFReader) -> SPMTokenizer:
    return from_vocab(Vocab.from_gguf(r))


__all__ = ["Vocab", "SpecialIds", "SPMTokenizer", "from_vocab", "from_gguf"]
