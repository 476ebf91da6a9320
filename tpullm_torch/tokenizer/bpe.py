"""Byte-level BPE tokenizer with per-model pretokenizers (llama.cpp's
llm_tokenizer_bpe with unicode_regex_split).

Text is split by a per-model chain of patterns (each pattern re-splits
every current segment into its alternation of matches and gaps), each word
is mapped through the GPT-2 byte→unicode table, then merged by merge rank.

The patterns are the tokenizer families' own (from each model's
tokenizer.json), written with Unicode property classes (\\p{L}, \\p{N},
...). The port runs them on the standard library's `re`, which has no
property classes: `translate` rewrites each \\p{X} (in or out of a class,
in negated classes too) as explicit code-point ranges, and \\s/\\S as the
Unicode White_Space set (`re`'s own \\s also takes U+001C..U+001F, which
White_Space does not). The ranges are data, `unicode_props.npz`: the runs
of each class as the JAX package's `regex` module has them (its tables are
newer than the standard library's `unicodedata`), with the `regex` and
Unicode versions they came from (`unicode_props`; written by
tests/torch_unicode_props.py). The compiled patterns are cached.
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np

from .vocab import Vocab


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> dict[int, str]:
    """GPT-2 byte→visible-unicode-char mapping (OpenAI GPT-2 bytes_to_unicode)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1))
          + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in byte_to_unicode().items()}


# ---------------------------------------------------------------------------
# property classes on the standard library's `re`
# ---------------------------------------------------------------------------

# the property classes the patterns use: a one-letter name is a major
# category (every category of that letter), a two-letter name one category
PROPERTY_CLASSES = ("L", "N", "P", "S", "M", "Lu", "Ll", "Lt", "Lm", "Lo")


@functools.lru_cache(maxsize=1)
def unicode_props() -> dict:
    """`unicode_props.npz`: each class's [n, 2] runs, and the `regex` and
    Unicode versions they were taken from ("regex_version",
    "unicode_version")."""
    with np.load(os.path.join(os.path.dirname(__file__), "unicode_props.npz")) as z:
        return {k: (str(z[k]) if k.endswith("_version") else z[k]) for k in z.files}


@functools.lru_cache(maxsize=None)
def property_ranges(name: str) -> tuple[tuple[int, int], ...]:
    """The code-point runs of \\p{name} (a name of PROPERTY_CLASSES), or of
    White_Space for name "space", as `unicode_props.npz` holds them."""
    if name != "space" and name not in PROPERTY_CLASSES:
        raise ValueError(f"property class \\p{{{name}}} is not translated")
    return tuple((int(lo), int(hi)) for lo, hi in unicode_props()[name])


def _class_body(name: str) -> str:
    """The runs of a property as the inside of a character class."""
    def esc(c: int) -> str:
        return f"\\U{c:08x}"
    return "".join(esc(lo) if lo == hi else f"{esc(lo)}-{esc(hi)}"
                   for lo, hi in property_ranges(name))


def translate(pattern: str) -> str:
    """`pattern` with every \\p{X}, \\s and \\S rewritten as explicit
    code-point ranges for the standard library's `re`: outside a class
    \\p{X} becomes [runs] and \\S [^runs of White_Space]; inside a class
    (negated or not) the runs are spliced in. Every other character and
    escape is kept as it is."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False
    class_start = -1  # index in `out` where the current class body began
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 3)
                name = pattern[i + 3:end]
                i = end + 1
                if nxt == "P":
                    if in_class:
                        raise ValueError("\\P{...} inside a class is not translated")
                    out.append(f"[^{_class_body(name)}]")
                else:
                    out.append(_class_body(name) if in_class else f"[{_class_body(name)}]")
                continue
            if nxt in "sS":
                i += 2
                if nxt == "S" and in_class:
                    raise ValueError("\\S inside a class is not translated")
                body = _class_body("space")
                out.append(body if in_class else (f"[{body}]" if nxt == "s" else f"[^{body}]"))
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class:
            # a ']' right after '[' or '[^' is a literal
            if ch == "]" and len(out) > class_start:
                in_class = False
            out.append(ch)
            i += 1
            continue
        if ch == "[":
            in_class = True
            out.append(ch)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            class_start = len(out)
            continue
        out.append(ch)
        i += 1
    if in_class:
        raise ValueError(f"unterminated class in {pattern!r}")
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_pattern(pattern: str) -> re.Pattern:
    """`pattern` (written for the `regex` module's property classes)
    translated and compiled for `re`, once per process."""
    return re.compile(translate(pattern))


# Pretokenizer chains per `tokenizer.ggml.pre` family (llama.cpp
# src/llama-vocab.cpp, from each model's tokenizer.json). Each entry: the
# pattern chain, ignore_merges, add_bos default.
_GPT2_RE = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"""
_LLAMA3_RE = r"""(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
_QWEN2_RE = r"""(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""

PRE_TABLE: dict[str, dict] = {
    "default": {
        "regexes": [
            r"[\p{P}\$\+<=>\^~\|]+",
            _GPT2_RE,
            r"\p{N}+",
            r"[0-9][0-9][0-9]",
        ],
    },
    "llama3": {"regexes": [_LLAMA3_RE], "ignore_merges": True, "add_bos": True},
    "deepseek-llm": {
        "regexes": [
            "[\r\n]",
            # letter class stored escaped: several Greek codepoints have
            # visually-identical lookalikes that editors normalize
            "\\s?[A-Za-z\xb5\xc0-\xd6\xd8-\xf6\xf8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
            r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
            r"\s+$",
            r"[一-龥ࠀ-一가-퟿]+",
            r"\p{N}+",
        ],
        "clean_spaces": False,
    },
    "deepseek-coder": {
        "regexes": [
            "[\r\n]",
            r"\s?\p{L}+",
            r"\s?\p{P}+",
            r"[一-龥ࠀ-一가-퟿]+",
            r"\p{N}",
        ],
        "clean_spaces": False,
    },
    "deepseek-v3": {
        "regexes": [
            r"\p{N}{1,3}",
            r"[一-龥぀-ゟ゠-ヿ]+",
            r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~][A-Za-z]+|[^\r\n\p{L}\p{P}\p{S}]?[\p{L}\p{M}]+| ?[\p{P}\p{S}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
        ],
        "clean_spaces": False,
    },
    "falcon": {
        "regexes": [
            r"[\p{P}\$\+<=>\^~\|`]+",
            _GPT2_RE,
            r"[0-9][0-9][0-9]",
        ],
    },
    "starcoder": {"regexes": [r"\p{N}", _GPT2_RE]},
    "gpt-2": {"regexes": [_GPT2_RE]},
    "qwen2": {"regexes": [_QWEN2_RE], "clean_spaces": False},
    "chatglm-bpe": {"regexes": [_LLAMA3_RE], "add_bos": False},
    "glm4": {"regexes": [_LLAMA3_RE], "add_bos": False},
    "gpt-4o": {
        "regexes": [
            r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
        ],
        "clean_spaces": False,
    },
    "tekken": {
        "regexes": [
            r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+",
        ],
        "clean_spaces": False,
        "ignore_merges": True,
        "add_bos": True,
    },
    "bloom": {"regexes": [r" ?[^(\s|.,!?…。，、।۔،)]+"]},
    "viking": {"regexes": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"]},
    "seed-coder": {
        "regexes": [
            r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}| ?[^\s\p{L}\p{N}\r\n]+|\s*[\r\n]+|\s+(?!\S)|\s+",
        ],
        "clean_spaces": False,
    },
    "grok-2": {"regexes": [_QWEN2_RE], "clean_spaces": False},
    "smaug-bpe": {"regexes": [_LLAMA3_RE]},
    "dbrx": {"regexes": [_LLAMA3_RE]},
}

_ALIASES = {
    "llama-v3": "llama3",
    "llama-bpe": "llama3",
    "falcon3": "llama3",
    "falcon-h1": "llama3",
    "pixtral": "llama3",
    "midm-2.0": "llama3",
    "lfm2": "llama3",
    "mpt": "gpt-2",
    "olmo": "gpt-2",
    "jais": "gpt-2",
    "phi-2": "gpt-2",
    "gigachat": "gpt-2",
    "jina-es": "gpt-2",
    "jina-de": "gpt-2",
    "jina-v2-es": "gpt-2",
    "jina-v2-de": "gpt-2",
    "modern-bert": "gpt-2",
    "refact": "starcoder",
    "command-r": "starcoder",
    "smollm": "starcoder",
    "codeshell": "starcoder",
    "exaone": "starcoder",
    "minerva-7b": "starcoder",
    "stablelm2": "qwen2",
    "deepseek-r1-qwen": "qwen2",
    "kormo": "qwen2",
    "hunyuan": "qwen2",
    "solar-open": "qwen2",
    "llama4": "gpt-4o",
    "minimax-m2": "gpt-4o",
    "poro-chat": "bloom",
    "gpt3-finnish": "bloom",
    "megrez": "gpt-2",
    "trillion": "gpt-2",
    "granite-docling": "gpt-2",
    "hunyuan-dense": "deepseek-v3",
}


def resolve_pre(pre: str) -> dict:
    """The PRE_TABLE entry of a `tokenizer.ggml.pre` id or alias; the
    default family for an id not in the table."""
    return PRE_TABLE.get(_ALIASES.get(pre, pre)) or PRE_TABLE["default"]


def regex_split(text: str, patterns: list[str]) -> list[str]:
    """Apply each pattern in turn; every current segment is re-split into the
    alternation of matches and gaps (llama.cpp unicode_regex_split)."""
    segments = [text]
    for pat in patterns:
        rx = compile_pattern(pat)
        out: list[str] = []
        for seg in segments:
            last = 0
            for m in rx.finditer(seg):
                if m.start() > last:
                    out.append(seg[last:m.start()])
                if m.end() > m.start():
                    out.append(seg[m.start():m.end()])
                last = m.end()
            if last < len(seg):
                out.append(seg[last:])
        segments = out
    return segments


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        cfg = resolve_pre(vocab.pre)
        self.regexes = cfg["regexes"]
        self.ignore_merges = cfg.get("ignore_merges", False)
        self.clean_spaces = cfg.get("clean_spaces", True)
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(vocab.merges):
            a, sep, b = merge.partition(" ")
            if sep:
                self.ranks[(a, b)] = rank
        self._b2u = byte_to_unicode()
        self._u2b = unicode_to_byte()

    def _bpe_word(self, word: str) -> list[int]:
        vocab = self.vocab
        if self.ignore_merges:
            tok = vocab.token_to_id.get(word)
            if tok is not None:
                return [tok]
        parts = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out: list[int] = []
        for p in parts:
            tok = vocab.token_to_id.get(p)
            if tok is not None:
                out.append(tok)
                continue
            # fall back to per-character lookup (each maps to one byte token)
            for ch in p:
                t = vocab.token_to_id.get(ch)
                if t is not None:
                    out.append(t)
                elif vocab.special.unk >= 0:
                    out.append(vocab.special.unk)
        return out

    def tokenize_fragment(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in regex_split(text, self.regexes):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self._bpe_word(mapped))
        return ids

    def _text_bytes(self, text: str) -> bytes:
        """A byte-level token's text back to its raw bytes."""
        raw = bytearray()
        for ch in text:
            b = self._u2b.get(ch)
            if b is not None:
                raw.append(b)
            else:
                raw.extend(ch.encode("utf-8"))
        return bytes(raw)

    def piece_bytes(self, tid: int) -> bytes:
        """Raw output bytes of a token (byte-level decode; control tokens
        contribute nothing)."""
        ttype = self.vocab.token_type(tid).name
        text = self.vocab.tokens[tid]
        if ttype == "CONTROL":
            return b""
        if ttype == "USER_DEFINED":
            return text.encode("utf-8")
        return self._text_bytes(text)

    def tokenize(self, text: str, add_special: bool = True,
                 parse_special: bool = False) -> list[int]:
        vocab = self.vocab
        out: list[int] = []
        if add_special and vocab.add_bos and vocab.special.bos >= 0:
            out.append(vocab.special.bos)
        for frag in vocab.partition_specials(text, parse_special):
            if isinstance(frag, int):
                out.append(frag)
            else:
                out.extend(self.tokenize_fragment(frag))
        if add_special and vocab.add_eos and vocab.special.eos >= 0:
            out.append(vocab.special.eos)
        return out

    def detokenize(self, ids: list[int], remove_special: bool = False,
                   unparse_special: bool = False) -> str:
        vocab = self.vocab
        ids = list(ids)
        if remove_special:
            if vocab.add_bos and ids and ids[0] == vocab.special.bos:
                ids = ids[1:]
            if vocab.add_eos and ids and ids[-1] == vocab.special.eos:
                ids = ids[:-1]
        raw = bytearray()
        for tid in ids:
            ttype = vocab.token_type(tid).name
            text = vocab.tokens[tid]
            if ttype == "CONTROL":
                if unparse_special:
                    raw.extend(text.encode("utf-8"))
            elif ttype == "USER_DEFINED":
                raw.extend(text.encode("utf-8"))
            else:
                raw.extend(self._text_bytes(text))
        return raw.decode("utf-8", errors="replace")
