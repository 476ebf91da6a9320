"""Partial-JSON healing for streaming tool-call output.

Reference: common/json-partial.cpp (common_json_parse) — when a model is
mid-way through emitting a JSON tool call, close all open strings / arrays /
objects so the fragment parses, letting the server stream argument diffs
before the call is complete.

`parse_partial_json(text)` returns (value, healed_suffix) where `value` is
the parsed best-effort object and `healed_suffix` is what was appended to
make it parse (empty when the input was already complete); returns
(None, "") when nothing parseable is present.

The JAX package's grammar/json_partial.py, kept as the port's own copy.
"""

from __future__ import annotations

import json


def _scan(text: str):
    """(closing_suffix, in_string, trailing_escape) of a JSON prefix."""
    stack: list[str] = []
    in_str = False
    escape = False
    for c in text:
        if in_str:
            if escape:
                escape = False
            elif c == "\\":
                escape = True
            elif c == '"':
                in_str = False
        else:
            if c == '"':
                in_str = True
            elif c in "{[":
                stack.append("}" if c == "{" else "]")
            elif c in "}]":
                if stack:
                    stack.pop()
    return "".join(reversed(stack)), in_str, escape


def _is_complete_literal(s: str) -> bool:
    """True for literals json itself can parse (12.5 yes, `12.` no)."""
    try:
        json.loads(s)
        return True
    except json.JSONDecodeError:
        return False


def heal_json(text: str) -> tuple[str, str]:
    """Close any open string/array/object of a JSON prefix; trim or complete
    trailing partial tokens (`tru`, `12.`, a dangling key, `:`) until the
    result parses. Returns (healed_text, appended_suffix — "" when the
    repair had to trim instead of append)."""
    body = text
    closing, in_str, escape = _scan(body)
    if in_str:
        if escape:
            body = body[:-1]
        body += '"'
        closing, _, _ = _scan(body)

    for _ in range(24):
        candidate = body + closing
        try:
            json.loads(candidate)
            return candidate, candidate[len(text):] if candidate.startswith(text) else ""
        except json.JSONDecodeError:
            pass
        b = body.rstrip()
        if not b:
            break
        if b.endswith(","):
            body = b[:-1]
        elif b.endswith(":"):
            body = b + " null"
        elif b.endswith('"'):
            # complete string that still doesn't parse → it's a dangling key;
            # drop the whole string (and any comma before it)
            j = b.rfind('"', 0, len(b) - 1)
            while j > 0 and b[j - 1] == "\\":
                j = b.rfind('"', 0, j)
            if j < 0:
                break
            b = b[:j].rstrip()
            if b.endswith(","):
                b = b[:-1]
            body = b
        else:
            # partial bare literal (tru / 12. / nul) → drop it
            j = len(b)
            while j > 0 and b[j - 1] not in '"}], \t\n:{[':
                j -= 1
            frag = b[j:]
            if frag and _is_complete_literal(frag):
                break  # complete literal; structure is broken elsewhere
            body = b[:j].rstrip()
        closing, _, _ = _scan(body)
    return body + closing, ""


def parse_partial_json(text: str):
    """Best-effort parse of a (possibly incomplete) JSON fragment.

    Returns (value, healed_suffix); (None, "") if unparseable."""
    text = text.strip()
    if not text:
        return None, ""
    try:
        return json.loads(text), ""
    except json.JSONDecodeError:
        pass
    healed, suffix = heal_json(text)
    try:
        return json.loads(healed), suffix
    except json.JSONDecodeError:
        return None, ""
