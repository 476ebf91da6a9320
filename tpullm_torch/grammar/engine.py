"""Grammar pushdown-automaton matcher + token-level constraint.

Reference: src/llama-grammar.cpp (llama_grammar_accept / llama_grammar_apply /
llama_grammar_advance_stack). The matcher tracks the set of possible parse
stacks; a stack is a tuple of pending items where the head is always a
char-matching item (refs are expanded eagerly). UTF-8 arrives byte-wise from
token pieces, so a partial-codepoint buffer is carried between tokens
(≡ decode_utf8's partial_utf8 state).
"""

from __future__ import annotations

import numpy as np

from .gbnf import Grammar, parse_gbnf


def _match_char(item, cp: int) -> bool:
    _, ranges, negated = item
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != negated


def _match_char_range(item, lo: int, hi: int) -> bool:
    """True if ANY codepoint in [lo, hi] matches the char item (partial-UTF8
    check, ≡ llama_grammar_match_partial_char)."""
    _, ranges, negated = item
    if not negated:
        return any(rlo <= hi and lo <= rhi for rlo, rhi in ranges)
    # negated: some cp in [lo, hi] must fall outside the union of ranges
    covered = sorted((max(rlo, lo), min(rhi, hi)) for rlo, rhi in ranges
                     if rlo <= hi and lo <= rhi)
    cur = lo
    for rlo, rhi in covered:
        if rlo > cur:
            return True
        cur = max(cur, rhi + 1)
        if cur > hi:
            return False
    return cur <= hi


class GrammarMatcher:
    def __init__(self, grammar: Grammar):
        self.g = grammar
        root_alts = grammar.rules[grammar.root_id]
        stacks: set[tuple] = set()
        for alt in root_alts:
            stacks |= self._expand(alt)
        self.stacks = stacks
        self.partial = b""  # undecoded UTF-8 tail

    # -- stack expansion ----------------------------------------------------------

    def _expand(self, stack: tuple, _depth: int = 0) -> set[tuple]:
        """Expand leading rule-refs until the head is a char item (or empty)."""
        if _depth > 256:
            raise RecursionError("grammar expansion too deep")
        if not stack or stack[0][0] == "char":
            return {stack}
        out: set[tuple] = set()
        rid = stack[0][1]
        rest = stack[1:]
        for alt in self.g.rules[rid]:
            out |= self._expand(alt + rest, _depth + 1)
        return out

    # -- codepoint / byte / text advance -------------------------------------------

    def _advance_cp(self, stacks: set[tuple], cp: int) -> set[tuple]:
        out: set[tuple] = set()
        for st in stacks:
            if st and _match_char(st[0], cp):
                out |= self._expand(st[1:])
        return out

    def _advance_bytes(
        self, stacks: set[tuple], partial: bytes, data: bytes
    ) -> tuple[set[tuple], bytes] | None:
        """Returns (stacks, partial) after consuming data, or None if rejected."""
        buf = partial + data
        i, n = 0, len(buf)
        while i < n:
            b0 = buf[i]
            # valid leads: ascii, 0xC2-0xDF, 0xE0-0xEF, 0xF0-0xF4
            if b0 & 0xC0 == 0x80 or b0 in (0xC0, 0xC1) or b0 > 0xF4:
                return None
            need = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
            if i + need > n:
                # incomplete tail: only keep as partial if some codepoint
                # completing it can match a stack head
                tail = buf[i:]
                k = need - len(tail)  # continuation bytes still missing
                cur = b0 & (0x7F >> need) if need > 1 else b0
                for b in tail[1:]:
                    if b & 0xC0 != 0x80:
                        return None
                    cur = (cur << 6) | (b & 0x3F)
                lo = cur << (6 * k)
                hi = lo | ((1 << (6 * k)) - 1)
                # UTF-8 shortest-form rule: an N-byte sequence encodes at
                # least MIN_CP[N]; reject overlong partials (e.g. E0 81 ...)
                min_cp = (0, 0, 0x80, 0x800, 0x10000)[need]
                lo = max(lo, min_cp)
                if hi < lo:
                    return None
                if not any(
                    st and _match_char_range(st[0], lo, hi) for st in stacks
                ):
                    return None
                return stacks, tail
            try:
                cp = buf[i : i + need].decode("utf-8")
            except UnicodeDecodeError:
                return None
            stacks = self._advance_cp(stacks, ord(cp))
            if not stacks:
                return None
            i += need
        return stacks, b""

    def accept_bytes(self, data: bytes) -> bool:
        res = self._advance_bytes(self.stacks, self.partial, data)
        if res is None:
            return False
        self.stacks, self.partial = res
        return True

    def can_accept_bytes(self, data: bytes) -> bool:
        return self._advance_bytes(self.stacks, self.partial, data) is not None

    def accept_text(self, text: str) -> bool:
        return self.accept_bytes(text.encode("utf-8"))

    @property
    def is_complete(self) -> bool:
        return not self.partial and any(not st for st in self.stacks)

    @property
    def is_stuck(self) -> bool:
        return not self.stacks

    def state_key(self) -> tuple:
        return (frozenset(self.stacks), self.partial)


class GrammarConstraint:
    """Token-level grammar constraint pluggable into Sampler.constraint_fn.

    vocab_pieces: token id → raw bytes of the token (decoded piece). EOG
    tokens are allowed exactly when the grammar can terminate.

    Masking strategy: candidates are checked in descending-logit chunks until
    at least one allowed token is found; unchecked tail is masked. Greedy
    decoding is exact; stochastic sampling is truncated to the checked set
    (the reference checks every candidate in C++; chunking keeps the Python
    hot path bounded).
    """

    def __init__(self, grammar: Grammar | str, vocab_pieces: list[bytes],
                 eog_ids: set[int] | None = None, chunk: int = 512):
        if isinstance(grammar, str):
            grammar = parse_gbnf(grammar)
        self.matcher = GrammarMatcher(grammar)
        self.pieces = vocab_pieces
        self.eog_ids = eog_ids or set()
        self.chunk = chunk

    def __call__(self, logits: np.ndarray) -> np.ndarray:
        order = np.argsort(-logits, kind="stable")
        allowed_any = False
        checked = 0
        n = order.size
        masked = logits
        complete = self.matcher.is_complete
        chunk = self.chunk
        while checked < n:
            hi = min(checked + chunk, n)
            for tid in order[checked:hi]:
                tid = int(tid)
                if tid in self.eog_ids:
                    ok = complete
                elif tid < len(self.pieces) and self.pieces[tid]:
                    ok = self.matcher.can_accept_bytes(self.pieces[tid])
                else:
                    ok = False
                if not ok:
                    masked[tid] = -np.inf
                else:
                    allowed_any = True
            checked = hi
            if allowed_any:
                break
            chunk *= 4
        if checked < n:
            masked[order[checked:]] = -np.inf
        if not allowed_any:
            # dead end (vocab can't continue the grammar): fall back to EOG so
            # the caller terminates instead of emitting garbage
            for tid in self.eog_ids:
                masked[tid] = 0.0
        return masked

    def accept(self, token_id: int):
        if token_id in self.eog_ids:
            return
        if token_id < len(self.pieces):
            if not self.matcher.accept_bytes(self.pieces[token_id]):
                raise ValueError(
                    f"token {token_id} rejected by grammar (constraint out of sync)"
                )

    @classmethod
    def from_tokenizer(cls, grammar: Grammar | str, tokenizer, **kw) -> "GrammarConstraint":
        """Build from a tokenizer of this package: its piece_bytes and the
        vocab's EOG set."""
        vocab = tokenizer.vocab
        n = vocab.n_tokens
        pieces = [tokenizer.piece_bytes(i) for i in range(n)]
        eog = {i for i in range(n) if vocab.is_eog(i)}
        return cls(grammar, pieces, eog_ids=eog, **kw)


class LazyGrammarConstraint(GrammarConstraint):
    """Lazy grammar (≡ llama_sampler_init_grammar_lazy_patterns,
    include/llama.h:1371, and the trigger handling in llama-grammar.cpp):
    decoding runs unconstrained until either a trigger token is sampled or
    the generated text matches a trigger pattern. From that point the
    grammar constrains sampling, fed the content starting at the trigger —
    the first capture group for patterns (the whole match when the pattern
    has no groups), the trigger token itself (included) for tokens.

    Patterns are matched against the full generation output so far, anchored
    at its start (≡ the reference's "matched from the start of the
    generation output"); include a leading ``[\\s\\S]*?`` to float."""

    def __init__(self, grammar, vocab_pieces, *, trigger_patterns=(),
                 trigger_tokens=(), eog_ids=None, chunk: int = 512):
        import re

        super().__init__(grammar, vocab_pieces, eog_ids=eog_ids, chunk=chunk)
        self.patterns = [
            re.compile(p.encode("utf-8") if isinstance(p, str) else p,
                       re.DOTALL)
            for p in trigger_patterns
        ]
        self.trigger_tokens = set(trigger_tokens)
        self.active = False
        self._buf = b""

    def __call__(self, logits: np.ndarray) -> np.ndarray:
        if not self.active:
            return logits
        return super().__call__(logits)

    def _activate(self, fed: bytes):
        self.active = True
        if not self.matcher.accept_bytes(fed):
            raise ValueError(
                f"grammar trigger content {fed[:64]!r} rejected by grammar"
            )

    def accept(self, token_id: int):
        if self.active:
            return super().accept(token_id)
        piece = self.pieces[token_id] if token_id < len(self.pieces) else b""
        if token_id in self.trigger_tokens:
            self._activate(piece)
            return
        self._buf += piece
        for pat in self.patterns:
            m = pat.match(self._buf)
            if m is None:
                continue
            start = m.start()
            if m.groups() and m.start(1) != -1:
                start = m.start(1)
            self._activate(self._buf[start:])
            return
