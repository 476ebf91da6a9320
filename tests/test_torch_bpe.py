"""Port parity of the byte-level BPE tokenizer: the property classes that the
port's patterns spell out for the standard library's `re` against the
`regex` module's, the port's BPETokenizer against the JAX package's on a
synthetic byte-level vocab with merges for every pretokenizer family, and a
tiny model with a Llama-3 style vocab (`vocab="bpe"`) through both Engines.

`regex` carries its own Unicode tables, newer than the standard library's
`unicodedata` (Unicode 15.0 in Python 3.12): code points whose general
category moved between the two versions (KNOWN_SPLITS) are the only ones on
which the two may disagree, and the drawn texts leave them out.
"""

import re
import sys
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm.runtime.engine import Engine as JEngine
from tpullm.tokenizer import bpe as jbpe
from tpullm.tokenizer.vocab import SpecialIds as JSpecialIds
from tpullm.tokenizer.vocab import Vocab as JVocab

from tpullm_torch.gguf.reader import GGUFReader
from tpullm_torch.models.synth import _bpe_vocab, make_synthetic_llama_gguf
from tpullm_torch.runtime.engine import Engine
from tpullm_torch.tokenizer import BPETokenizer, Vocab, bpe, from_gguf
from tpullm_torch.tokenizer.vocab import SpecialIds

# U+0295 LATIN LETTER PHARYNGEAL VOICED FRICATIVE: Ll in Unicode 15.0, Lo
# from Unicode 16.0 (the `regex` module's tables)
KNOWN_SPLITS = {0x0295: ("Ll", "Lo")}

# every code point assigned in unicodedata's Unicode version, as one string
ASSIGNED = "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if unicodedata.category(chr(c)) not in ("Cn", "Cs"))

FAMILIES = sorted(bpe.PRE_TABLE)
ALIASES = sorted(bpe._ALIASES)

FIXED = [
    "Hello world! It's 12345 apples; they're 3.14 and we'VE seen I'M, DON'T, she'd, you'll",
    "digits 1 12 123 1234 12345678901234 0.5 1,000,000 ١٢٣٤٥ ๓๔ ½ ²",
    "a\r\nb\n\n\nc\r\r d \r\n\r\n  e\n",
    "Ünïcödé ÀÉÎ straße 漢字テスト ひらがな 한국어 Ελληνικά русский العربية हिन्दी",
    "emoji 😀👍🏽 done… and ‘quotes’ “double” — dash",
    "   lead, trail   \t tab　ideographic nbsp x\x1cy\x1f z w\u0085v",
    "punct...!!!???$+<=>^~|` (paren) [brack] {brace} @#%&*",
    "<|begin_of_text|>hi<|start_header_id|>user<|end_header_id|>\n\nok<|eot_id|>",
    "camelCaseWord HTTPServer iPhone McDonald's ǅemal ᾈ ß ﬁ",
    "",
    " ",
]


def _class_diff(name: str, form: str) -> set[int]:
    """Code points of ASSIGNED on which `form` (a pattern with {p} for the
    property) matches differently in `regex` and in the port's translation."""
    prop = r"\s" if name == "space" else rf"\p{{{name}}}"
    pat = form.format(p=prop)
    got = set(re.findall(bpe.translate(pat), ASSIGNED))
    want = set(regex.findall(pat, ASSIGNED))
    return {ord(c) for c in got ^ want}


@pytest.mark.parametrize("form", ["{p}", "[{p}]", "[^{p}]", "[a{p}0-9]", "[^\\r\\n{p}]"])
@pytest.mark.parametrize("name", [*bpe.PROPERTY_CLASSES, "space"])
def test_property_class_matches_regex(name, form):
    """Membership of every assigned code point, in and out of a class,
    negated or not: the same in the translated stdlib class as in `regex`,
    but for the code points whose category the newer tables moved."""
    diff = _class_diff(name, form)
    for c in diff:
        assert c in KNOWN_SPLITS, f"U+{c:04X} ({unicodedata.category(chr(c))})"
        assert unicodedata.category(chr(c)) == KNOWN_SPLITS[c][0]


def test_not_space_and_white_space():
    """\\S and \\s as regex reads them: White_Space, without U+001C..U+001F,
    which `re`'s own \\s and str.isspace take."""
    assert _class_diff("space", "{p}") == set()
    assert set(re.findall(bpe.translate(r"\S"), ASSIGNED)) == set(regex.findall(r"\S", ASSIGNED))
    assert re.fullmatch(r"\s", "\x1c") and not re.fullmatch(bpe.translate(r"\s"), "\x1c")


def test_translate_keeps_other_syntax():
    pat = r"(?i:'s|'t)?[^\r\n\p{L}\p{N}]?\p{N}{1,3}|\s+(?!\S)|[\]\\]"
    rx = re.compile(bpe.translate(pat))
    for text in ["'S12345", "  x", "a\\]b", "'t ٣٣٣٣"]:
        assert [m.span() for m in rx.finditer(text)] == \
            [m.span() for m in regex.finditer(pat, text)]
    with pytest.raises(ValueError):
        bpe.translate(r"[\S]")


@pytest.fixture(scope="module")
def bpe_data():
    return _bpe_vocab(4096, seed=0)


def _pair(bpe_data, pre: str):
    tokens, types, merges, special = bpe_data
    kw = dict(model="gpt2", pre=pre, tokens=list(tokens), scores=None,
              token_types=np.asarray(types, np.int32), merges=list(merges), add_bos=True,
              add_space_prefix=False)
    port = BPETokenizer(Vocab(special=SpecialIds(**special), **kw))
    ref = jbpe.BPETokenizer(JVocab(special=JSpecialIds(**special), **kw))
    return port, ref


def _same(port, ref, text: str):
    for parse_special in (False, True):
        for add_special in (False, True):
            ids = port.tokenize(text, add_special=add_special, parse_special=parse_special)
            assert ids == ref.tokenize(text, add_special=add_special,
                                       parse_special=parse_special), (text, parse_special)
            for flags in ((False, False), (True, False), (True, True)):
                assert port.detokenize(ids, *flags) == ref.detokenize(ids, *flags)
    return ids


@pytest.mark.parametrize("pre", FAMILIES + ALIASES + ["not-a-family"])
def test_bpe_matches_jax_on_fixed_strings(bpe_data, pre):
    """Ids (special tokens parsed and not, bos added and not) and detokenized
    text (plain, without bos, with specials spelled out) equal to the JAX
    package's; the family's flags too."""
    port, ref = _pair(bpe_data, pre)
    assert (port.ignore_merges, port.clean_spaces) == (ref.ignore_merges, ref.clean_spaces)
    assert port.regexes == ref.regexes
    for text in FIXED:
        ids = _same(port, ref, text)  # bos added, specials parsed
        assert port.detokenize(ids, remove_special=True, unparse_special=True) == text
    assert [port.piece_bytes(i) for i in range(len(port.vocab.tokens))] == \
        [ref.piece_bytes(i) for i in range(len(ref.vocab.tokens))]


# text drawn from every assigned code point but the surrogates and KNOWN_SPLITS,
# with the ASCII that the patterns single out drawn more often
_TEXT = st.text(
    alphabet=st.one_of(
        st.characters(exclude_categories=("Cs", "Cn"),
                      exclude_characters="".join(map(chr, KNOWN_SPLITS))),
        st.sampled_from(list(" \t\r\n'sStTdDmMlLvVrReE0123456789.,!?$+<=>^~|`/-_\x1c　"))),
    max_size=48)


@pytest.mark.parametrize("pre", FAMILIES)
@settings(max_examples=40, deadline=None, database=None)
@given(text=_TEXT)
def test_bpe_matches_jax_on_drawn_text(bpe_data, pre, text):
    port, ref = _pair(bpe_data, pre)
    ids = _same(port, ref, text)
    assert port.detokenize(ids, remove_special=True, unparse_special=True) == text


@pytest.fixture(scope="module")
def tiny_bpe_gguf(tmp_path_factory):
    return make_synthetic_llama_gguf(tmp_path_factory.mktemp("tiny_bpe") / "tiny-bpe.gguf",
                                     shape="tiny", seed=0, vocab="bpe")


def test_synthetic_bpe_vocab_is_llama3s(tiny_bpe_gguf):
    """The vocab a Llama-3 GGUF carries: model gpt2, pre llama-bpe, the 256
    byte tokens first, merges that spell the test words, Llama-3's special
    tokens at the end as CONTROL."""
    r = GGUFReader(tiny_bpe_gguf)
    assert r.metadata["tokenizer.ggml.model"] == "gpt2"
    assert r.metadata["tokenizer.ggml.pre"] == "llama-bpe"
    tok = from_gguf(r)
    v = tok.vocab
    assert isinstance(tok, BPETokenizer) and tok.ignore_merges and v.add_bos
    assert v.n_tokens == 384 and v.tokens[:256] == [bpe.byte_to_unicode()[b] for b in range(256)]
    assert v.tokens[v.special.bos] == "<|begin_of_text|>"
    assert v.tokens[v.special.eot] == "<|eot_id|>" and v.is_eog(v.special.eot)
    assert "Ġhello" in v.token_to_id and "Ġ hello" not in v.merges
    assert tok.tokenize("hello world") == [v.special.bos, v.token_to_id["hello"],
                                           v.token_to_id["Ġworld"]]


def test_synthetic_bpe_vocab_at_the_8b_width():
    tokens, types, merges, special = _bpe_vocab(128256, seed=0)
    assert len(tokens) == 128256 and len(set(tokens)) == 128256
    assert special == dict(bos=128000, eos=128001, eot=128009, eom=128008)
    assert tokens[128255] == "<|reserved_special_token_247|>"
    assert len(merges) == 128000 - 256


def test_tiny_bpe_model_matches_jax(tiny_bpe_gguf):
    """The tiny model with the Llama-3 style vocab in both Engines: the same
    prompt ids (specials parsed), and the same greedy text up to the context
    end (generate: the device decode in the port, the host loop in JAX)."""
    prompt = "<|start_header_id|>user<|end_header_id|>\n\nthe quick brown fox, 12345!"
    je = JEngine(tiny_bpe_gguf, max_seq=64, kv_dtype=jnp.bfloat16)
    te = Engine(tiny_bpe_gguf, device="cpu", max_seq=64)
    ids = te.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    assert ids == je.tokenizer.tokenize(prompt, add_special=True, parse_special=True)
    assert ids[0] == te.tokenizer.vocab.special.bos and len(ids) < 32
    ref = list(je.generate_tokens(ids, 200))
    got = te.generate_tokens_device(ids, 200, to_end=True)
    assert got == ref and len(got) == 64 - len(ids) + 1
    te.reset()
    je.reset()
    text = te.generate(prompt, 200)
    assert text == je.generate(prompt, 200) == te.tokenizer.detokenize(got)
