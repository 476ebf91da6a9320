"""JSON schema → GBNF compiler.

Reference: common/json-schema-to-grammar.cpp. Supported subset: type
(object/array/string/number/integer/boolean/null), enum, const, properties +
required + additionalProperties, items + minItems/maxItems + prefixItems,
anyOf/oneOf/allOf(merged shallowly), $ref → $defs/definitions (local only),
string minLength/maxLength/pattern(literal-safe subset ignored), integer
minimum/maximum (digit-range approximation skipped — full int range used).
Output grammar's root produces a single JSON value matching the schema.
"""

from __future__ import annotations

import json
import re

# primitive building blocks (≡ PRIMITIVE_RULES in the reference)
PRIMITIVE_RULES: dict[str, str] = {
    "space": ' ::= " "?',
    "boolean": ' ::= ("true" | "false") space',
    "null": ' ::= "null" space',
    "number": (
        ' ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? '
        '([eE] [-+]? [0-9]+)? space'
    ),
    "integer": ' ::= ("-"? ([0-9] | [1-9] [0-9]*)) space',
    "string": ' ::= "\\"" char* "\\"" space',
    "char": (
        ' ::= [^"\\\\\\x7F\\x00-\\x1F] | "\\\\" (["\\\\bfnrt/] '
        '| "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F])'
    ),
    "value": " ::= object | array | string | number | boolean | null",
    "object": (
        ' ::= "{" space ( string ":" space value ("," space string ":" '
        'space value)* )? "}" space'
    ),
    "array": ' ::= "[" space ( value ("," space value)* )? "]" space',
}

_PRIM_DEPS = {
    "string": ["char"],
    "value": ["object", "array", "string", "number", "boolean", "null"],
    "object": ["string", "value"],
    "array": ["value"],
}

_NAME_RE = re.compile(r"[^a-zA-Z0-9-]+")


def _gbnf_string_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


def _json_literal_rule(value) -> str:
    """Rule body matching the exact JSON encoding of a value."""
    return _gbnf_string_literal(json.dumps(value, ensure_ascii=False)) + " space"


class _Converter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {}
        self._used_prims: set[str] = set()
        self._counter = 0

    def _prim(self, name: str) -> str:
        if name not in self._used_prims:
            self._used_prims.add(name)
            for dep in _PRIM_DEPS.get(name, []):
                self._prim(dep)
        return name

    def _add_rule(self, name: str, body: str) -> str:
        base = _NAME_RE.sub("-", name) or "rule"
        key = base
        while key in self.rules and self.rules[key] != body:
            self._counter += 1
            key = f"{base}{self._counter}"
        self.rules[key] = body
        return key

    def _resolve_ref(self, ref: str) -> dict:
        if not ref.startswith("#/"):
            raise ValueError(f"only local $ref supported, got {ref!r}")
        node = self.schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict | bool, name: str) -> str:
        """Returns the rule name matching this schema."""
        if schema is True or schema == {}:
            return self._prim("value")
        if schema is False:
            # unsatisfiable: a rule that can never match (empty char class is
            # illegal, so use an impossible literal pair)
            return self._add_rule(name, '"\\x00impossible\\x00"')

        if "$ref" in schema:
            return self.visit(self._resolve_ref(schema["$ref"]), name)

        if "const" in schema:
            return self._add_rule(name, _json_literal_rule(schema["const"]))

        if "enum" in schema:
            body = " | ".join(_json_literal_rule(v) for v in schema["enum"])
            return self._add_rule(name, body)

        if "allOf" in schema:
            merged: dict = {}
            for sub in schema["allOf"]:
                if "$ref" in sub:
                    sub = self._resolve_ref(sub["$ref"])
                for k, v in sub.items():
                    if k == "properties":
                        merged.setdefault("properties", {}).update(v)
                    elif k == "required":
                        merged["required"] = list(
                            dict.fromkeys(merged.get("required", []) + v)
                        )
                    else:
                        merged.setdefault(k, v)
            rest = {k: v for k, v in schema.items() if k != "allOf"}
            merged.update(rest)
            return self.visit(merged, name)

        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                alt_names = [
                    self.visit(sub, f"{name}-{i}")
                    for i, sub in enumerate(schema[comb])
                ]
                return self._add_rule(name, " | ".join(alt_names))

        stype = schema.get("type")
        if isinstance(stype, list):
            alt_names = [
                self.visit({**schema, "type": t}, f"{name}-{t}") for t in stype
            ]
            return self._add_rule(name, " | ".join(alt_names))

        if stype == "object" or (stype is None and "properties" in schema):
            return self._object(schema, name)
        if stype == "array" or (stype is None and ("items" in schema or "prefixItems" in schema)):
            return self._array(schema, name)
        if stype == "string":
            return self._string(schema, name)
        if stype in ("number", "integer", "boolean", "null"):
            return self._prim(stype)
        return self._prim("value")

    def _object(self, schema: dict, name: str) -> str:
        props: dict = schema.get("properties", {})
        required = list(schema.get("required", []))
        additional = schema.get("additionalProperties", not props)

        self._prim("space")
        parts_req = []
        parts_opt = []
        for key, sub in props.items():
            sub_rule = self.visit(sub, f"{name}-{key}")
            kv = f'{_gbnf_string_literal(json.dumps(key))} space ":" space {sub_rule}'
            kv_rule = self._add_rule(f"{name}-{key}-kv", kv)
            (parts_req if key in required else parts_opt).append(kv_rule)

        if additional:
            self._prim("string")
            self._prim("value")
            add_kv = self._add_rule(
                f"{name}-additional-kv", 'string ":" space value'
            )
        else:
            add_kv = None

        # sequence: required kvs in order, each optional kv appended optionally
        seq = ""
        first = True

        def join(piece: str):
            nonlocal seq, first
            if first:
                seq += piece
                first = False
            else:
                seq += f' ("," space {piece})'

        body = '"{" space '
        if parts_req or parts_opt or add_kv:
            for r in parts_req:
                join(r)
            for r in parts_opt:
                if first:
                    seq += f"( {r} )?"
                    first = False
                else:
                    seq += f' ("," space {r})?'
            if add_kv:
                if first:
                    seq += f'( {add_kv} ("," space {add_kv})* )?'
                else:
                    seq += f' ("," space {add_kv})*'
            body += f"{seq} "
        body += '"}" space'
        return self._add_rule(name, body)

    def _array(self, schema: dict, name: str) -> str:
        self._prim("space")
        if "prefixItems" in schema:
            elems = [
                self.visit(sub, f"{name}-{i}")
                for i, sub in enumerate(schema["prefixItems"])
            ]
            inner = ' "," space '.join(elems)
            return self._add_rule(name, f'"[" space {inner} "]" space')
        item_rule = self.visit(schema.get("items", True), f"{name}-item")
        min_n = int(schema.get("minItems", 0))
        max_n = schema.get("maxItems")
        if min_n == 0 and max_n is None:
            inner = f'( {item_rule} ("," space {item_rule})* )?'
        else:
            lo = max(min_n, 1)
            parts = [item_rule] + [f'"," space {item_rule}'] * (lo - 1)
            head = " ".join(parts)
            if max_n is None:
                tail = f' ("," space {item_rule})*'
            else:
                tail = f' ("," space {item_rule})?' * (int(max_n) - lo)
            inner = head + tail
            if min_n == 0:
                inner = f"( {inner} )?"
        return self._add_rule(name, f'"[" space {inner} "]" space')

    def _string(self, schema: dict, name: str) -> str:
        self._prim("char")
        self._prim("space")
        min_l = schema.get("minLength")
        max_l = schema.get("maxLength")
        if min_l is None and max_l is None:
            return self._prim("string")
        lo = int(min_l or 0)
        if max_l is None:
            body = f'"\\"" char{{{lo},}} "\\"" space'
        else:
            body = f'"\\"" char{{{lo},{int(max_l)}}} "\\"" space'
        return self._add_rule(name, body)

    def convert(self) -> str:
        root = self.visit(self.schema, "root")
        self._prim("space")
        lines = []
        if root != "root":
            lines.append(f"root ::= {root}")
        for k, v in self.rules.items():
            lines.append(f"{k} ::= {v}" if " ::= " not in v else k + v)
        for prim in sorted(self._used_prims):
            lines.append(prim + PRIMITIVE_RULES[prim])
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    """Compile a JSON schema to GBNF text (≡ json_schema_to_grammar)."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _Converter(schema).convert()
