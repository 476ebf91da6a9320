"""Grammar-constrained generation: GBNF parser, PDA matcher, token constraint,
JSON-schema→GBNF compiler (llama.cpp src/llama-grammar.cpp,
common/json-schema-to-grammar.cpp); the JAX package's grammar/, which uses
no JAX, kept as the port's own copy."""

from .engine import GrammarConstraint, GrammarMatcher, LazyGrammarConstraint
from .gbnf import GBNFError, Grammar, parse_gbnf
from .json_schema import json_schema_to_gbnf

__all__ = [
    "Grammar",
    "GBNFError",
    "parse_gbnf",
    "GrammarMatcher",
    "GrammarConstraint",
    "LazyGrammarConstraint",
    "json_schema_to_gbnf",
]
