"""Minimal Jinja2-subset template engine for chat templates.

Reference: common/jinja/ (the reference ships its own Jinja lexer/parser/
runtime rather than depending on one; same stance here — no external
dependency, just the subset HF chat templates actually use):

  {{ expr }}  {% if / elif / else %}  {% for x in y %}  {% set x = expr %}
  filters via |, `is defined` / `is none` tests, ~ string concat,
  loop.index0/index/first/last/length, raise_exception(), strftime_now().

Expressions are parsed with Python's `ast` (Jinja expression syntax is a
near-subset: `|` arrives as BitOr and is interpreted as filter application)
and evaluated by a small whitelisting interpreter — no eval(), no attribute
escape (dunder access is rejected).

The JAX package's jinja.py (standard library only), kept as the port's own
copy.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from typing import Any


class TemplateError(ValueError):
    pass


class RaisedException(TemplateError):
    """A template called raise_exception()."""


# ---------------------------------------------------------------------------
# lexer: text / {{ output }} / {% statement %} with whitespace control
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"({%-?\s*.*?\s*-?%}|{{-?\s*.*?\s*-?}})", re.DOTALL)


def _lex(src: str) -> list[tuple[str, str]]:
    """Returns [(kind, payload)]: kind in text|out|stmt, already
    whitespace-trimmed per the -'s."""
    parts = _TOKEN_RE.split(src)
    tokens: list[tuple[str, str]] = []
    for part in parts:
        if not part:
            continue
        if part.startswith("{{"):
            body = part[2:-2]
            ltrim = body.startswith("-")
            rtrim = body.endswith("-")
            tokens.append(("out", body.strip("-").strip(), ltrim, rtrim))
        elif part.startswith("{%"):
            body = part[2:-2]
            ltrim = body.startswith("-")
            rtrim = body.endswith("-")
            tokens.append(("stmt", body.strip("-").strip(), ltrim, rtrim))
        else:
            tokens.append(("text", part, False, False))
    # apply whitespace control to neighboring text tokens
    out: list[tuple[str, str]] = []
    for i, tok in enumerate(tokens):
        kind, payload = tok[0], tok[1]
        if kind == "text":
            if i > 0 and tokens[i - 1][3]:  # previous rtrim
                payload = payload.lstrip()
            if i + 1 < len(tokens) and tokens[i + 1][2]:  # next ltrim
                payload = payload.rstrip()
            if payload:
                out.append(("text", payload))
        else:
            out.append((kind, payload))
    return out


# ---------------------------------------------------------------------------
# parser → AST
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    pass


@dataclass
class _Text(_Node):
    s: str


@dataclass
class _Out(_Node):
    expr: ast.expr


@dataclass
class _If(_Node):
    branches: list  # [(cond_expr|None, body)]


@dataclass
class _For(_Node):
    names: list[str]
    it: ast.expr
    body: list
    else_body: list = field(default_factory=list)


@dataclass
class _Set(_Node):
    names: list[str]
    expr: ast.expr


@dataclass
class _Break(_Node):
    pass


@dataclass
class _Continue(_Node):
    pass


# ~ is Jinja string concat; translate to + outside of string literals
_TILDE_RE = re.compile(r"""((?:[^'"~]|'[^']*'|"[^"]*")*?)\s*~\s*""")


def _translate_expr(src: str) -> str:
    out = _TILDE_RE.sub(lambda m: m.group(1) + " + ", src)
    return out


def _escape_newlines_in_strings(src: str) -> str:
    """Jinja string literals may contain raw newlines; Python's don't."""
    out = []
    quote = None
    i = 0
    while i < len(src):
        ch = src[i]
        if quote:
            if ch == "\\" and i + 1 < len(src):
                out.append(src[i : i + 2])
                i += 2
                continue
            if ch == quote:
                quote = None
                out.append(ch)
            elif ch == "\n":
                out.append("\\n")
            elif ch == "\r":
                out.append("\\r")
            elif ch == "\t":
                out.append("\\t")
            else:
                out.append(ch)
        else:
            if ch in "'\"":
                quote = ch
            out.append(ch)
        i += 1
    return "".join(out)


def _parse_expr(src: str) -> ast.expr:
    src = _translate_expr(_escape_newlines_in_strings(src.strip()))
    # jinja allows `if x is defined` etc. — valid python already
    try:
        return ast.parse(src, mode="eval").body
    except SyntaxError as e:
        raise TemplateError(f"bad expression {src!r}: {e}") from None


def _parse(tokens: list, pos: int = 0, until: tuple[str, ...] = ()) -> tuple[list, int, str | None]:
    body: list[_Node] = []
    while pos < len(tokens):
        kind, payload = tokens[pos]
        if kind == "text":
            body.append(_Text(payload))
            pos += 1
        elif kind == "out":
            body.append(_Out(_parse_expr(payload)))
            pos += 1
        else:  # stmt
            word = payload.split(None, 1)[0] if payload else ""
            if word in until:
                return body, pos, payload
            if word == "if":
                branches = []
                cond = _parse_expr(payload[2:])
                while True:
                    inner, pos, stop = _parse(tokens, pos + 1,
                                              ("elif", "else", "endif"))
                    branches.append((cond, inner))
                    stop_word = stop.split(None, 1)[0]
                    if stop_word == "elif":
                        cond = _parse_expr(stop[4:])
                        continue
                    if stop_word == "else":
                        inner, pos, stop = _parse(tokens, pos + 1, ("endif",))
                        branches.append((None, inner))
                    break
                body.append(_If(branches))
                pos += 1
            elif word == "for":
                m = re.match(r"for\s+(.+?)\s+in\s+(.+)$", payload, re.DOTALL)
                if not m:
                    raise TemplateError(f"bad for: {payload!r}")
                names = [n.strip() for n in m.group(1).split(",")]
                it = _parse_expr(m.group(2))
                inner, pos, stop = _parse(tokens, pos + 1, ("endfor", "else"))
                else_body = []
                if stop.split(None, 1)[0] == "else":
                    else_body, pos, _ = _parse(tokens, pos + 1, ("endfor",))
                body.append(_For(names, it, inner, else_body))
                pos += 1
            elif word == "set":
                m = re.match(r"set\s+(.+?)\s*=\s*(.+)$", payload, re.DOTALL)
                if not m:
                    raise TemplateError(f"bad set: {payload!r}")
                names = [n.strip() for n in m.group(1).split(",")]
                body.append(_Set(names, _parse_expr(m.group(2))))
                pos += 1
            elif word == "break":
                body.append(_Break())
                pos += 1
            elif word == "continue":
                body.append(_Continue())
                pos += 1
            elif word == "generation" or word == "endgeneration":
                pos += 1  # assistant-masking markers: ignored for rendering
            else:
                raise TemplateError(f"unsupported statement {payload!r}")
    if until:
        raise TemplateError(f"missing closer {until}")
    return body, pos, None


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------

class _Undefined:
    """Jinja undefined: falsy, renders empty, equality-comparable."""

    def __bool__(self):
        return False

    def __str__(self):
        return ""

    def __eq__(self, other):
        return isinstance(other, _Undefined)

    def __ne__(self, other):
        return not isinstance(other, _Undefined)

    def __iter__(self):
        return iter(())


UNDEFINED = _Undefined()


def _tojson(x, indent=None):
    return json.dumps(x, ensure_ascii=False, indent=indent)


_FILTERS = {
    "trim": lambda s, *a: str(s).strip(*a),
    "strip": lambda s: str(s).strip(),
    "lstrip": lambda s: str(s).lstrip(),
    "rstrip": lambda s: str(s).rstrip(),
    "lower": lambda s: str(s).lower(),
    "upper": lambda s: str(s).upper(),
    "title": lambda s: str(s).title(),
    "capitalize": lambda s: str(s).capitalize(),
    "length": len,
    "count": len,
    "first": lambda s: s[0] if len(s) else UNDEFINED,
    "last": lambda s: s[-1] if len(s) else UNDEFINED,
    "join": lambda s, sep="": sep.join(str(x) for x in s),
    "replace": lambda s, a, b, cnt=-1: str(s).replace(a, b, cnt),
    "default": lambda v, d="", boolean=False: (
        d if isinstance(v, _Undefined) or v is None or (boolean and not v) else v
    ),
    "tojson": _tojson,
    "safe": lambda s: s,
    "e": lambda s: str(s),
    "escape": lambda s: str(s),
    "string": str,
    "int": lambda s, default=0: int(s) if str(s).lstrip("-").isdigit() else default,
    "float": float,
    "list": list,
    "unique": lambda s: list(dict.fromkeys(s)),
    "reverse": lambda s: list(reversed(s)),
    "sort": lambda s, **kw: sorted(s, **kw),
    "abs": abs,
    "items": lambda d: list(d.items()),
    "dictsort": lambda d: sorted(d.items()),
    "selectattr": lambda seq, attr, *a: [
        x for x in seq
        if (x.get(attr) if isinstance(x, dict) else getattr(x, attr, None))
        == (a[1] if len(a) > 1 else True)
    ],
    "map": lambda seq, attr_kw=None, **kw: [
        (x.get(kw["attribute"]) if isinstance(x, dict) else getattr(x, kw["attribute"]))
        for x in seq
    ] if "attribute" in kw else list(seq),
}

_SAFE_METHODS = {
    "strip", "lstrip", "rstrip", "upper", "lower", "title", "split",
    "rsplit", "startswith", "endswith", "replace", "join", "find", "rfind",
    "format", "capitalize", "items", "keys", "values", "get", "append",
    "count", "index", "lstrip", "pop", "insert", "copy", "update",
}


class _BreakLoop(Exception):
    pass


class _ContinueLoop(Exception):
    pass


class _Eval:
    def __init__(self, env: dict):
        self.scopes = [dict(env)]

    # -- variable scopes --------------------------------------------------------

    def lookup(self, name: str):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return UNDEFINED

    def assign(self, name: str, value):
        # jinja set writes the innermost scope but persists across loop
        # iterations via namespace-less semantics; write outermost-existing
        for scope in reversed(self.scopes):
            if name in scope:
                scope[name] = value
                return
        self.scopes[-1][name] = value

    # -- expression evaluation ----------------------------------------------------

    def expr(self, node: ast.expr):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            # jinja lowercase literals
            if node.id == "true":
                return True
            if node.id == "false":
                return False
            if node.id == "none":
                return None
            if node.id == "namespace":
                return _Namespace
            return self.lookup(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("__"):
                raise TemplateError("dunder access rejected")
            obj = self.expr(node.value)
            if isinstance(obj, dict):
                return obj.get(node.attr, UNDEFINED)
            if isinstance(obj, _Undefined):
                return UNDEFINED
            if isinstance(obj, _Namespace):
                return obj.vals.get(node.attr, UNDEFINED)
            if isinstance(obj, str) and node.attr in _SAFE_METHODS:
                return getattr(obj, node.attr)
            if isinstance(obj, (list, dict)) and node.attr in _SAFE_METHODS:
                return getattr(obj, node.attr)
            return getattr(obj, node.attr, UNDEFINED) if not callable(
                getattr(obj, node.attr, None)
            ) or node.attr in _SAFE_METHODS else UNDEFINED
        if isinstance(node, ast.Subscript):
            obj = self.expr(node.value)
            if isinstance(node.slice, ast.Slice):
                lo = self.expr(node.slice.lower) if node.slice.lower else None
                hi = self.expr(node.slice.upper) if node.slice.upper else None
                st = self.expr(node.slice.step) if node.slice.step else None
                return obj[lo:hi:st]
            key = self.expr(node.slice)
            try:
                if isinstance(obj, dict):
                    return obj.get(key, UNDEFINED)
                return obj[key]
            except (KeyError, IndexError, TypeError):
                return UNDEFINED
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.BitOr):  # jinja filter pipe
                return self._filter(node.left, node.right)
            left, right = self.expr(node.left), self.expr(node.right)
            if isinstance(node.op, ast.Add):
                if isinstance(left, str) or isinstance(right, str):
                    return _str(left) + _str(right)
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Div):
                return left / right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.Mod):
                if isinstance(left, str):
                    return left % right
                return left % right
            raise TemplateError(f"unsupported operator {ast.dump(node.op)}")
        if isinstance(node, ast.UnaryOp):
            val = self.expr(node.operand)
            if isinstance(node.op, ast.Not):
                return not val
            if isinstance(node.op, ast.USub):
                return -val
            if isinstance(node.op, ast.UAdd):
                return +val
            raise TemplateError("unsupported unary op")
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                val = True
                for v in node.values:
                    val = self.expr(v)
                    if not val:
                        return val
                return val
            val = False
            for v in node.values:
                val = self.expr(v)
                if val:
                    return val
            return val
        if isinstance(node, ast.Compare):
            left = self.expr(node.left)
            for op, comp in zip(node.ops, node.comparators):
                # `x is defined` / `is not none` style tests
                if isinstance(op, (ast.Is, ast.IsNot)):
                    test = comp.id if isinstance(comp, ast.Name) else None
                    if test in ("defined", "undefined", "none", "true", "false",
                                "string", "mapping", "iterable", "number"):
                        res = _test(left, test)
                        ok = res if isinstance(op, ast.Is) else not res
                    else:
                        right = self.expr(comp)
                        ok = (left is right) if isinstance(op, ast.Is) else (left is not right)
                else:
                    right = self.expr(comp)
                    ok = _compare(op, left, right)
                if not ok:
                    return False
                left = self.expr(comp) if not isinstance(op, (ast.Is, ast.IsNot)) else left
            return True
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) if self.expr(node.test) else self.expr(node.orelse)
        if isinstance(node, ast.List):
            return [self.expr(e) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return {self.expr(k): self.expr(v) for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.JoinedStr):
            return "".join(
                _str(self.expr(v.value)) if isinstance(v, ast.FormattedValue)
                else v.value for v in node.values
            )
        if isinstance(node, ast.FormattedValue):
            return _str(self.expr(node.value))
        raise TemplateError(f"unsupported expression {ast.dump(node)[:80]}")

    def _filter(self, left_node: ast.expr, right: ast.expr):
        value = self.expr(left_node)
        if isinstance(right, ast.Name):
            name, args, kwargs = right.id, [], {}
        elif isinstance(right, ast.Call) and isinstance(right.func, ast.Name):
            name = right.func.id
            args = [self.expr(a) for a in right.args]
            kwargs = {kw.arg: self.expr(kw.value) for kw in right.keywords}
        else:
            raise TemplateError("bad filter")
        fn = _FILTERS.get(name)
        if fn is None:
            raise TemplateError(f"unknown filter {name!r}")
        return fn(value, *args, **kwargs)

    def _call(self, node: ast.Call):
        args = [self.expr(a) for a in node.args]
        kwargs = {kw.arg: self.expr(kw.value) for kw in node.keywords}
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name == "raise_exception":
                raise RaisedException(str(args[0]) if args else "template error")
            if name == "range":
                return range(*args)
            if name == "len":
                return len(args[0])
            if name == "namespace":
                return _Namespace(kwargs)
            if name == "strftime_now":
                import datetime

                return datetime.datetime.now().strftime(args[0] if args else "%Y-%m-%d")
            fn = _FILTERS.get(name)
            if fn is not None:  # filters usable as functions
                return fn(*args, **kwargs)
            raise TemplateError(f"unknown function {name!r}")
        if isinstance(node.func, ast.Attribute):
            if node.func.attr.startswith("__"):
                raise TemplateError("dunder call rejected")
            obj = self.expr(node.func.value)
            if isinstance(obj, _Undefined):
                return UNDEFINED
            if node.func.attr in _SAFE_METHODS:
                return getattr(obj, node.func.attr)(*args, **kwargs)
            raise TemplateError(f"method {node.func.attr!r} not allowed")
        raise TemplateError("unsupported call")

    # -- statement execution -------------------------------------------------------

    def render(self, body: list, out: list):
        for node in body:
            if isinstance(node, _Text):
                out.append(node.s)
            elif isinstance(node, _Out):
                out.append(_str(self.expr(node.expr)))
            elif isinstance(node, _Set):
                val = self.expr(node.expr)
                if len(node.names) == 1:
                    # namespace attr: ns.x = ...
                    if "." in node.names[0]:
                        ns_name, attr = node.names[0].split(".", 1)
                        ns = self.lookup(ns_name)
                        if isinstance(ns, _Namespace):
                            ns.vals[attr] = val
                        else:
                            raise TemplateError(f"{ns_name} is not a namespace")
                    else:
                        self.assign(node.names[0], val)
                else:
                    for nm, v in zip(node.names, val):
                        self.assign(nm, v)
            elif isinstance(node, _If):
                for cond, branch in node.branches:
                    if cond is None or self.expr(cond):
                        self.render(branch, out)
                        break
            elif isinstance(node, _For):
                seq = self.expr(node.it)
                if isinstance(seq, _Undefined):
                    seq = []
                seq = list(seq.items()) if isinstance(seq, dict) else list(seq)
                if not seq and node.else_body:
                    self.render(node.else_body, out)
                    continue
                n = len(seq)
                for i, item in enumerate(seq):
                    scope = {}
                    if len(node.names) == 1:
                        scope[node.names[0]] = item
                    else:
                        for nm, v in zip(node.names, item):
                            scope[nm] = v
                    scope["loop"] = {
                        "index0": i, "index": i + 1, "first": i == 0,
                        "last": i == n - 1, "length": n,
                        "previtem": seq[i - 1] if i > 0 else UNDEFINED,
                        "nextitem": seq[i + 1] if i + 1 < n else UNDEFINED,
                    }
                    self.scopes.append(scope)
                    try:
                        self.render(node.body, out)
                    except _ContinueLoop:
                        pass
                    except _BreakLoop:
                        self.scopes.pop()
                        break
                    self.scopes.pop()
            elif isinstance(node, _Break):
                raise _BreakLoop()
            elif isinstance(node, _Continue):
                raise _ContinueLoop()


class _Namespace:
    def __init__(self, vals=None):
        self.vals = dict(vals or {})


def _str(v) -> str:
    if v is None:
        return "None"
    if v is True:
        return "True"
    if v is False:
        return "False"
    if isinstance(v, _Undefined):
        return ""
    if isinstance(v, (dict, list)):
        return _tojson(v)
    return str(v)


def _test(v, test: str) -> bool:
    if test == "defined":
        return not isinstance(v, _Undefined)
    if test == "undefined":
        return isinstance(v, _Undefined)
    if test == "none":
        return v is None
    if test == "true":
        return v is True
    if test == "false":
        return v is False
    if test == "string":
        return isinstance(v, str)
    if test == "mapping":
        return isinstance(v, dict)
    if test == "iterable":
        return hasattr(v, "__iter__")
    if test == "number":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    raise TemplateError(f"unknown test {test!r}")


def _compare(op: ast.cmpop, left, right) -> bool:
    if isinstance(op, ast.Eq):
        return left == right
    if isinstance(op, ast.NotEq):
        return left != right
    if isinstance(op, ast.Lt):
        return left < right
    if isinstance(op, ast.LtE):
        return left <= right
    if isinstance(op, ast.Gt):
        return left > right
    if isinstance(op, ast.GtE):
        return left >= right
    if isinstance(op, ast.In):
        if isinstance(right, _Undefined):
            return False
        return left in right
    if isinstance(op, ast.NotIn):
        if isinstance(right, _Undefined):
            return True
        return left not in right
    raise TemplateError("unsupported comparison")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class Template:
    def __init__(self, source: str):
        self.body, _, _ = _parse(_lex(source))

    def render(self, **env) -> str:
        out: list[str] = []
        _Eval(env).render(self.body, out)
        return "".join(out)


def render(source: str, **env) -> str:
    return Template(source).render(**env)
