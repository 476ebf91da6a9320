"""Port parity of the host generation API: the Sampler chain (numpy, the same
draws as the JAX package's from the same seed), the grammar package
(parse_gbnf, json_schema_to_gbnf, GrammarConstraint masks on the SPM and
BPE tiny vocabs), and the Engine's generate_tokens / generate(sampler=...),
prefill_all_logits and embed_tokens against the JAX Engine."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_presets import one_torch_thread  # noqa: F401 (autouse)
from tpullm import grammar as jgrammar
from tpullm.runtime import sampling as jsampling
from tpullm.runtime.engine import Engine as JEngine

from tpullm_torch import grammar
from tpullm_torch.models.synth import make_synthetic_llama_gguf
from tpullm_torch.runtime import sampling
from tpullm_torch.runtime.engine import Engine

# one configuration per sampler of the chain (and the chain's defaults)
SAMPLERS = {
    "greedy": dict(temp=0.0),
    "default chain": dict(),
    "temp only": dict(temp=0.7, top_k=0, top_p=1.0, min_p=0.0),
    "top_k": dict(temp=1.0, top_k=5, top_p=1.0, min_p=0.0),
    "top_p": dict(temp=1.0, top_k=0, top_p=0.6, min_p=0.0),
    "min_p": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.2),
    "typical": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0, typical_p=0.5),
    "xtc": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0, xtc_probability=0.7,
                xtc_threshold=0.05),
    "top_n_sigma": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0, top_n_sigma=1.0),
    "dynatemp": dict(temp=0.8, dynatemp_range=0.5, dynatemp_exponent=1.5),
    "penalties": dict(temp=0.9, penalty_last_n=16, penalty_repeat=1.3, penalty_freq=0.2,
                      penalty_present=0.4),
    "penalties greedy": dict(temp=0.0, penalty_last_n=-1, penalty_repeat=1.5),
    "dry": dict(temp=0.9, dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2,
                dry_penalty_last_n=-1, dry_sequence_breakers=(3,)),
    "logit_bias": dict(temp=0.9, logit_bias={1: 5.0, 7: -100.0, 50: 2.5}),
    "mirostat v1": dict(temp=0.9, mirostat=1, mirostat_tau=4.0, mirostat_eta=0.2),
    "mirostat v2": dict(temp=0.9, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.1),
}


def _nmse(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.mean((got - ref) ** 2)) / (float(np.mean(ref * ref)) or 1.0)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_chain_draws_as_jax(name):
    """60 draws from numpy-seeded logits (with repeats, so the penalties and
    DRY see history): the same ids and the same mirostat mu as the JAX
    package's Sampler from the same seed."""
    kw = SAMPLERS[name]
    port = sampling.Sampler(sampling.SamplerParams(seed=1234, **kw))
    ref = jsampling.Sampler(jsampling.SamplerParams(seed=1234, **kw))
    rng = np.random.default_rng(7)
    base = rng.standard_normal(96).astype(np.float32) * 3
    for step in range(60):
        logits = base + rng.standard_normal(96).astype(np.float32) * 0.5
        a, b = port.sample(logits.copy()), ref.sample(logits.copy())
        assert a == b, (name, step)
        port.accept(a)
        ref.accept(b)
    assert port.prev == ref.prev and port._mu == ref._mu
    port.reset()
    assert port.prev == [] and port._mu is None


GBNF = [
    'root ::= "yes" | "no"',
    'root ::= (" " [a-z]+)+ "."?',
    'root ::= item ("," item){1,3}\nitem ::= [0-9]+ | "x" [^\\n,]* ',
    'root ::= obj\nobj ::= "{" ws pair (ws "," ws pair)* ws "}"\n'
    'pair ::= "\\"" [a-z]+ "\\"" ws ":" ws [0-9]+\nws ::= [ \\t]*',
    'root ::= [\\u00e0-\\u00ff]+ "€" [^a-z]?',
]

SCHEMAS = [
    {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "string"}},
     "required": ["a"], "additionalProperties": False},
    {"type": "array", "items": {"type": "number"}, "minItems": 1, "maxItems": 3},
    {"enum": ["red", "green", 3]},
    {"anyOf": [{"type": "boolean"}, {"type": "null"}, {"const": {"k": [1, 2]}}]},
    {"$defs": {"p": {"type": "object", "properties": {"x": {"type": "string",
                                                             "maxLength": 4}}}},
     "type": "array", "items": {"$ref": "#/$defs/p"}},
]


@pytest.mark.parametrize("text", GBNF)
def test_parse_gbnf_as_jax(text):
    g, j = grammar.parse_gbnf(text), jgrammar.parse_gbnf(text)
    assert (g.rules, g.names, g.root_id, g.name_to_id) == \
        (j.rules, j.names, j.root_id, j.name_to_id)


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: json.dumps(s)[:40])
def test_json_schema_to_gbnf_as_jax(schema):
    text = grammar.json_schema_to_gbnf(schema)
    assert text == jgrammar.json_schema_to_gbnf(schema)
    assert text == grammar.json_schema_to_gbnf(json.dumps(schema))


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sampling")
    return {vocab: make_synthetic_llama_gguf(d / f"tiny-{vocab}.gguf", shape="tiny", seed=0,
                                             vocab=vocab)
            for vocab in ("spm", "bpe")}


@pytest.fixture(scope="module")
def engines(ggufs):
    """Both Engines on both tiny vocabs, made once for the module."""
    return {vocab: (Engine(path, device="cpu", max_seq=64),
                    JEngine(path, max_seq=64, kv_dtype=jnp.bfloat16))
            for vocab, path in ggufs.items()}


@pytest.mark.parametrize("text", GBNF[1:4] + [grammar.json_schema_to_gbnf(SCHEMAS[0])])
@pytest.mark.parametrize("vocab", ["spm", "bpe"])
def test_grammar_constraint_masks_as_jax(engines, vocab, text):
    """GrammarConstraint.from_tokenizer on each package's tokenizer of the
    same GGUF: the same pieces and EOG set, and along a walk (the allowed
    token of highest drawn logit accepted each step) the same masks."""
    te, je = engines[vocab]
    port = grammar.GrammarConstraint.from_tokenizer(text, te.tokenizer, chunk=64)
    ref = jgrammar.GrammarConstraint.from_tokenizer(text, je.tokenizer, chunk=64)
    assert port.pieces == ref.pieces and port.eog_ids == ref.eog_ids
    rng = np.random.default_rng(3)
    for _ in range(12):
        logits = rng.standard_normal(len(port.pieces)).astype(np.float32)
        a, b = port(logits.copy()), ref(logits.copy())
        assert np.array_equal(a, b)
        tok = int(np.argmax(a))
        if tok in port.eog_ids:
            break
        port.accept(tok)
        ref.accept(tok)
        assert port.matcher.state_key() == ref.matcher.state_key()


def test_lazy_grammar_constraint_as_jax(engines):
    te, je = engines["spm"]
    pieces = [te.tokenizer.piece_bytes(i) for i in range(te.tokenizer.vocab.n_tokens)]
    kw = dict(trigger_patterns=[r"[\s\S]*?(hello)"], eog_ids={2})
    port = grammar.LazyGrammarConstraint('root ::= "hello" (" " [a-z]+)*', pieces, **kw)
    ref = jgrammar.LazyGrammarConstraint('root ::= "hello" (" " [a-z]+)*', pieces, **kw)
    for tok in te.tokenizer.tokenize("the dog hello world", add_special=False):
        port.accept(tok)
        ref.accept(tok)
        assert port.active == ref.active
    assert port.active and port.matcher.state_key() == ref.matcher.state_key()


def _grammar_sampler(pkg, gram, tokenizer, **kw):
    c = gram.GrammarConstraint.from_tokenizer(r'root ::= (" " [a-z]+)+', tokenizer)
    params = pkg.SamplerParams(seed=42, **kw)
    return pkg.Sampler(params, constraint_fn=c, constraint_accept=c.accept)


@pytest.mark.parametrize("kw", [dict(temp=0.0, penalty_repeat=1.5, penalty_last_n=-1),
                                dict(temp=0.9, penalty_repeat=1.3, penalty_freq=0.3,
                                     dry_multiplier=0.5)],
                         ids=["greedy penalised", "sampled penalised with DRY"])
@pytest.mark.parametrize("vocab", ["spm", "bpe"])
def test_generate_tokens_with_grammar_and_penalties_as_jax(engines, vocab, kw):
    """generate_tokens through a grammar of lower-case words and a penalised
    Sampler: the same ids in both Engines, and generate(sampler=...) the
    same text."""
    te, je = engines[vocab]
    te.reset()
    je.reset()
    ids = te.tokenizer.tokenize("hello world", add_special=True)
    got = list(te.generate_tokens(ids, 12, _grammar_sampler(sampling, grammar, te.tokenizer,
                                                            **kw)))
    ref = list(je.generate_tokens(ids, 12, _grammar_sampler(jsampling, jgrammar, je.tokenizer,
                                                            **kw)))
    assert got == ref and len(got) > 0
    text = te.tokenizer.detokenize(got)
    assert text.strip() and all(w.isalpha() and w.islower() for w in text.split())
    te.reset()
    je.reset()
    assert te.generate("hello world", 12, _grammar_sampler(sampling, grammar, te.tokenizer,
                                                           **kw)) == \
        je.generate("hello world", 12, _grammar_sampler(jsampling, jgrammar, je.tokenizer,
                                                        **kw))


def test_generate_without_a_sampler_is_greedy_generate_tokens(engines):
    """generate() without a sampler (the device decode) gives the ids of
    greedy generate_tokens, up to the context end."""
    te, _ = engines["spm"]
    te.reset()
    ids = te.tokenizer.tokenize("hello world", add_special=True)
    want = list(te.generate_tokens(ids, 200))
    assert len(want) == 64 - len(ids) + 1
    te.reset()
    assert te.generate("hello world", 200) == te.tokenizer.detokenize(want)


def test_prefill_all_logits_as_jax(engines):
    """Every row's logits of a 20-token prompt, then of the next 5 tokens
    after it: NMSE ≤ 1e-3 against the JAX Engine's (the teacher-forced
    tolerance of test_torch_slice.py: the embedding table dequantizes
    through bf16 scales here, in f32 on the JAX package's CPU load, and the
    f32 sums run in another order); the last row is prefill's."""
    te, je = engines["spm"]
    te.reset()
    je.reset()
    ids = te.tokenizer.tokenize("the quick brown fox jumps over the lazy dog hello",
                                add_special=True)
    a, b = te.prefill_all_logits(ids), je.prefill_all_logits(ids)
    assert a.shape == b.shape == (len(ids), te.hp.n_vocab)
    assert _nmse(a, b) <= 1e-3
    more = [300, 301, 17, 42, 5]
    a2, b2 = te.prefill_all_logits(more), je.prefill_all_logits(more)
    assert te.n_past == je.n_past == len(ids) + 5 and _nmse(a2, b2) <= 1e-3
    te.reset()
    assert np.array_equal(te.prefill(ids), a[-1])


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", None])
def test_embed_tokens_as_jax(engines, pooling):
    """Pooled final-norm hidden states: NMSE ≤ 1e-3 against the JAX Engine's
    (the tolerance of the logits, for the same reasons), unit norm, and
    n_past back at 0."""
    te, je = engines["spm"]
    te.reset()
    je.reset()
    ids = te.tokenizer.tokenize("hello world the quick brown fox", add_special=True)
    a = te.embed_tokens(ids, pooling=pooling)
    b = je.embed_tokens(ids, pooling=pooling)
    assert a.shape == (te.hp.n_embd,) and abs(float(np.linalg.norm(a)) - 1.0) < 1e-5
    assert _nmse(a, b) <= 1e-3 and te.n_past == 0
    raw = te.embed_tokens(ids, pooling=pooling, normalize=False)
    assert _nmse(raw, je.embed_tokens(ids, pooling=pooling, normalize=False)) <= 1e-3
    assert _nmse(te.embed("hello world the quick brown fox", pooling), a) == 0.0


def test_perf_counters_report(engines):
    te, _ = engines["spm"]
    report = te.perf.report()
    assert report.startswith("load ") and " t/s | gen " in report
