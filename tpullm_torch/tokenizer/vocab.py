"""Vocabulary loaded from GGUF metadata: token table with scores/types,
merges and the pretokenizer id of a BPE vocab, special-token ids and flags,
and the special-token partitioner that splits raw text around
control/user-defined tokens before the sub-tokenizer runs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np

from ..gguf.constants import Keys, TokenType
from ..gguf.reader import GGUFReader


@dataclass
class SpecialIds:
    bos: int = -1
    eos: int = -1
    eot: int = -1
    eom: int = -1
    unk: int = -1
    sep: int = -1
    pad: int = -1
    mask: int = -1
    fim_pre: int = -1
    fim_suf: int = -1
    fim_mid: int = -1


@dataclass
class Vocab:
    model: str  # "llama" (SPM) | "gpt2" (byte-level BPE); other families are not ported
    pre: str  # pretokenizer id of a BPE vocab ("default", "llama-bpe", ...)
    tokens: list[str]
    scores: np.ndarray | None
    token_types: np.ndarray | None
    merges: list[str] = field(default_factory=list)
    special: SpecialIds = field(default_factory=SpecialIds)
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    remove_extra_whitespaces: bool = False
    chat_template: str | None = None

    token_to_id: dict[str, int] = field(default_factory=dict, repr=False)
    _special_tokens: list[tuple[str, int]] = field(default_factory=list, repr=False)
    _byte_tokens: dict[int, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        tt = self.token_types
        if tt is not None:
            specials = []
            for i, t in enumerate(self.tokens):
                k = int(tt[i])
                if k in (TokenType.CONTROL, TokenType.USER_DEFINED, TokenType.UNKNOWN):
                    specials.append((t, i))
                if k == TokenType.BYTE and len(t) == 6 and t.startswith("<0x"):
                    self._byte_tokens[int(t[3:5], 16)] = i
            # longest-match-first, like the reference's special-token cache
            specials.sort(key=lambda p: -len(p[0]))
            self._special_tokens = specials

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_eog(self, token_id: int) -> bool:
        """End-of-generation check (eos/eot/eom)."""
        return token_id in (self.special.eos, self.special.eot, self.special.eom) and token_id >= 0

    def token_type(self, token_id: int) -> TokenType:
        if self.token_types is None:
            return TokenType.NORMAL
        return TokenType(int(self.token_types[token_id]))

    def byte_token(self, byte: int) -> int:
        tok = self._byte_tokens.get(byte, -1)
        return tok if tok >= 0 else self.special.unk

    def partition_specials(self, text: str, parse_special: bool) -> list[Union[str, int]]:
        """Split `text` into raw-text fragments and special token ids.

        With parse_special=False only USER_DEFINED tokens are matched."""
        fragments: list[Union[str, int]] = [text]
        for tok_text, tok_id in self._special_tokens:
            if not tok_text:
                continue
            if not parse_special and self.token_type(tok_id) != TokenType.USER_DEFINED:
                continue
            out: list[Union[str, int]] = []
            for frag in fragments:
                if isinstance(frag, int):
                    out.append(frag)
                    continue
                start = 0
                while True:
                    idx = frag.find(tok_text, start)
                    if idx < 0:
                        if start < len(frag):
                            out.append(frag[start:])
                        break
                    if idx > start:
                        out.append(frag[start:idx])
                    out.append(tok_id)
                    start = idx + len(tok_text)
            fragments = out
        return [f for f in fragments if f != ""]

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "Vocab":
        md = r.metadata
        K = Keys.Tokenizer
        scores = md.get(K.SCORES)
        if scores is not None:
            scores = np.asarray(scores, dtype=np.float32)
        token_types = md.get(K.TOKEN_TYPE)
        if token_types is not None:
            token_types = np.asarray(token_types, dtype=np.int32)
        sp = SpecialIds(
            # BERT-family files carry [CLS] under cls_token_id; it plays bos
            bos=int(md.get(K.BOS_ID, md.get(K.CLS_ID, -1))),
            eos=int(md.get(K.EOS_ID, -1)),
            eot=int(md.get(K.EOT_ID, -1)),
            eom=int(md.get(K.EOM_ID, -1)),
            unk=int(md.get(K.UNK_ID, -1)),
            sep=int(md.get(K.SEP_ID, -1)),
            pad=int(md.get(K.PAD_ID, -1)),
            mask=int(md.get(K.MASK_ID, -1)),
            fim_pre=int(md.get(K.FIM_PRE_ID, -1)),
            fim_suf=int(md.get(K.FIM_SUF_ID, -1)),
            fim_mid=int(md.get(K.FIM_MID_ID, -1)),
        )
        model = md.get(K.MODEL, "llama")
        # the reference's defaults: SPM adds bos and a space prefix, BPE neither
        return cls(
            model=model,
            pre=md.get(K.PRE, "default"),
            tokens=list(md.get(K.LIST, [])),
            scores=scores,
            token_types=token_types,
            merges=list(md.get(K.MERGES, [])),
            special=sp,
            add_bos=bool(md.get(K.ADD_BOS, model == "llama")),
            add_eos=bool(md.get(K.ADD_EOS, False)),
            add_space_prefix=bool(md.get(K.ADD_PREFIX, model == "llama")),
            remove_extra_whitespaces=bool(md.get(K.REMOVE_EXTRA_WS, False)),
            chat_template=md.get(K.CHAT_TEMPLATE),
        )
