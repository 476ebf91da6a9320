"""SentencePiece-style (SPM) tokenizer: greedy highest-score bigram merging
over UTF-8 characters with byte fallback and recursive resegmentation."""

from __future__ import annotations

import heapq

from ..gguf.constants import TokenType
from .vocab import Vocab

SPM_SPACE = "▁"  # ▁


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def piece_bytes(self, tid: int) -> bytes:
        """Raw bytes this token contributes to output text (grammar matching;
        llama_token_to_piece with special=false)."""
        vocab = self.vocab
        ttype = vocab.token_type(tid)
        text = vocab.tokens[tid]
        if ttype == TokenType.BYTE:
            return bytes([int(text[3:5], 16)])
        if ttype in (TokenType.CONTROL, TokenType.UNKNOWN):
            return b""
        return text.replace(SPM_SPACE, " ").encode("utf-8")

    def tokenize_fragment(self, text: str) -> list[int]:
        """Tokenize one raw-text fragment (no specials, no bos/eos)."""
        vocab = self.vocab
        if not text:
            return []

        symbols = [c for c in text]
        prev = list(range(-1, len(symbols) - 1))
        nxt = list(range(1, len(symbols) + 1))
        alive = [True] * len(symbols)
        rev_merge: dict[str, tuple[str, str]] = {}
        # candidate merges: (-score, left_index, merged_len, merged)
        heap: list[tuple[float, int, int, str]] = []

        def try_add(left: int, right: int):
            if left < 0 or right >= len(symbols):
                return
            merged = symbols[left] + symbols[right]
            tok = vocab.token_to_id.get(merged)
            if tok is None or vocab.scores is None or tok >= len(vocab.scores):
                return
            heapq.heappush(heap, (-float(vocab.scores[tok]), left, len(merged), merged))

        for i in range(len(symbols) - 1):
            try_add(i, i + 1)

        while heap:
            _, left, mlen, merged = heapq.heappop(heap)
            if not alive[left]:
                continue
            right = nxt[left]
            if right >= len(symbols) or not alive[right]:
                continue
            if len(symbols[left]) + len(symbols[right]) != mlen or symbols[left] + symbols[right] != merged:
                continue  # stale entry
            rev_merge[merged] = (symbols[left], symbols[right])
            symbols[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[left] < len(symbols):
                prev[nxt[left]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        out: list[int] = []

        def resegment(s: str):
            tok = vocab.token_to_id.get(s)
            if tok is not None:
                out.append(tok)
                return
            parts = rev_merge.get(s)
            if parts is None:
                for b in s.encode("utf-8"):
                    out.append(vocab.byte_token(b))
                return
            resegment(parts[0])
            resegment(parts[1])

        i = 0
        while i < len(symbols):
            if alive[i]:
                resegment(symbols[i])
                i = nxt[i]
            else:
                i += 1
        return out

    def tokenize(self, text: str, add_special: bool = True,
                 parse_special: bool = False) -> list[int]:
        vocab = self.vocab
        out: list[int] = []
        if add_special and vocab.add_bos and vocab.special.bos >= 0:
            out.append(vocab.special.bos)
        is_prev_special = True  # first fragment gets the space prefix
        for frag in vocab.partition_specials(text, parse_special):
            if isinstance(frag, int):
                out.append(frag)
                is_prev_special = True
                continue
            raw = frag
            if vocab.add_space_prefix and is_prev_special:
                raw = " " + raw
            out.extend(self.tokenize_fragment(raw.replace(" ", SPM_SPACE)))
            is_prev_special = False
        if add_special and vocab.add_eos and vocab.special.eos >= 0:
            out.append(vocab.special.eos)
        return out

    def detokenize(self, ids: list[int], remove_special: bool = False,
                   unparse_special: bool = False) -> str:
        vocab = self.vocab
        pieces: list[bytes] = []
        ids = list(ids)
        if remove_special:
            if vocab.add_bos and ids and ids[0] == vocab.special.bos:
                ids = ids[1:]
            if vocab.add_eos and ids and ids[-1] == vocab.special.eos:
                ids = ids[:-1]
        for tid in ids:
            ttype = vocab.token_type(tid)
            text = vocab.tokens[tid]
            if ttype == TokenType.BYTE:
                pieces.append(bytes([int(text[3:5], 16)]))
            elif ttype in (TokenType.CONTROL, TokenType.UNKNOWN):
                if unparse_special:
                    pieces.append(text.encode("utf-8"))
            else:
                pieces.append(text.replace(SPM_SPACE, " ").encode("utf-8"))
        s = b"".join(pieces).decode("utf-8", errors="replace")
        # the leading space injected by add_space_prefix comes off again
        if vocab.add_space_prefix and s.startswith(" "):
            s = s[1:]
        return s
