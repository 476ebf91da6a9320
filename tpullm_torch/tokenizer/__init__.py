"""Tokenizers loaded from GGUF metadata: SPM (SentencePiece-style) and
byte-level BPE; the other families are not ported."""

from __future__ import annotations

from ..gguf.reader import GGUFReader
from .bpe import BPETokenizer
from .spm import SPMTokenizer
from .vocab import SpecialIds, Vocab

Tokenizer = SPMTokenizer | BPETokenizer


def from_vocab(vocab: Vocab) -> Tokenizer:
    if vocab.model in ("llama", "spm"):
        return SPMTokenizer(vocab)
    if vocab.model in ("gpt2", "bpe"):
        return BPETokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r} is not ported")


def from_gguf(r: GGUFReader) -> Tokenizer:
    return from_vocab(Vocab.from_gguf(r))


def load(path) -> Tokenizer:
    return from_gguf(GGUFReader(path))


__all__ = ["Vocab", "SpecialIds", "SPMTokenizer", "BPETokenizer", "Tokenizer", "from_vocab",
           "from_gguf", "load"]
