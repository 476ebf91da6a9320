"""GBNF grammar parser (reference: src/llama-grammar.cpp llama_grammar_parser,
grammars/README.md syntax).

Parses GBNF text into a rule table:
  rules: list[list[alternate]] indexed by rule id; each alternate is a tuple
  of items; item is
    ("char", ranges, negated)  ranges = tuple[(lo, hi)] over unicode codepoints
    ("ref", rule_id)
Repetition operators (* + ? {m,n}) are lowered to fresh helper rules, the same
strategy the reference uses (llama-grammar.cpp parse_sequence rewrite).
"""

from __future__ import annotations

from dataclasses import dataclass, field

CharItem = tuple  # ("char", ranges, negated)
RefItem = tuple  # ("ref", rule_id)
Alternate = tuple  # tuple of items
MAX_CODEPOINT = 0x10FFFF


@dataclass
class Grammar:
    rules: list[list[Alternate]]
    names: list[str]
    root_id: int
    name_to_id: dict[str, int] = field(default_factory=dict)


class GBNFError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: list[list[Alternate] | None] = []
        self.names: list[str] = []
        self.name_to_id: dict[str, int] = {}

    # -- low-level lexing ------------------------------------------------------

    def _ws(self, newlines: bool = True):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, s: str):
        if not self.text.startswith(s, self.pos):
            raise GBNFError(f"expected {s!r} at offset {self.pos}")
        self.pos += len(s)

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.text) and (
            self.text[self.pos].isalnum() or self.text[self.pos] in "-_"
        ):
            self.pos += 1
        if self.pos == start:
            raise GBNFError(f"expected rule name at offset {self.pos}")
        return self.text[start : self.pos]

    def _rule_id(self, name: str) -> int:
        rid = self.name_to_id.get(name)
        if rid is None:
            rid = len(self.rules)
            self.rules.append(None)
            self.names.append(name)
            self.name_to_id[name] = rid
        return rid

    def _fresh_rule(self, base: str, alternates: list[Alternate]) -> int:
        rid = len(self.rules)
        name = f"{base}_{rid}"
        self.rules.append(alternates)
        self.names.append(name)
        self.name_to_id[name] = rid
        return rid

    def _char_escape(self) -> int:
        c = self._peek()
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self._peek()
        self.pos += 1
        table = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91, "]": 93,
                 "^": 94, "-": 45, "'": 39}
        if e in table:
            return table[e]
        if e in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[e]
            hexs = self.text[self.pos : self.pos + n]
            if len(hexs) != n:
                raise GBNFError(f"bad \\{e} escape at offset {self.pos}")
            self.pos += n
            return int(hexs, 16)
        raise GBNFError(f"unknown escape \\{e} at offset {self.pos}")

    # -- grammar constructs ------------------------------------------------------

    def _char_class(self) -> CharItem:
        self._expect("[")
        negated = False
        if self._peek() == "^":
            negated = True
            self.pos += 1
        ranges = []
        while self._peek() and self._peek() != "]":
            lo = self._char_escape()
            if self._peek() == "-" and self.text[self.pos + 1 : self.pos + 2] != "]":
                self.pos += 1
                hi = self._char_escape()
            else:
                hi = lo
            ranges.append((lo, hi))
        self._expect("]")
        if not ranges:
            raise GBNFError("empty char class")
        return ("char", tuple(ranges), negated)

    def _literal(self) -> list[CharItem]:
        self._expect('"')
        items = []
        while self._peek() and self._peek() != '"':
            cp = self._char_escape()
            items.append(("char", ((cp, cp),), False))
        self._expect('"')
        return items

    def _repeat(self, items: list, base: str, min_n: int, max_n: int | None) -> list:
        """Lower items{min_n, max_n} into helper-rule refs (≡ reference's
        rewrite: S* → S' ::= S S' |  etc.)."""
        seq = tuple(items)
        out: list = []
        for _ in range(min_n):
            out.extend(seq)
        if max_n is None:
            # unlimited tail: R ::= seq R | ε
            rid = self._fresh_rule(base, [])
            self.rules[rid] = [seq + (("ref", rid),), ()]
            out.append(("ref", rid))
        elif max_n > min_n:
            # optional tail of depth (max-min): R_k ::= seq R_{k-1} | ε
            rid = None
            for _ in range(max_n - min_n):
                inner = seq + ((("ref", rid),) if rid is not None else ())
                rid = self._fresh_rule(base, [inner, ()])
            out.append(("ref", rid))
        return out

    def _sequence(self, rule_name: str) -> Alternate:
        items: list = []
        last: list | None = None  # last atom (for repetition operators)
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == '"':
                lit = self._literal()
                items.extend(lit)
                # repetition applies to the whole literal (reference:
                # parse_sequence's last_sym_start spans the quoted string)
                last = lit
            elif c == "[":
                item = self._char_class()
                items.append(item)
                last = [item]
            elif c == "(":
                self.pos += 1
                rid = self._fresh_rule(rule_name, self._alternates(rule_name))
                self._ws()
                self._expect(")")
                item = ("ref", rid)
                items.append(item)
                last = [item]
            elif c == ".":
                self.pos += 1
                item = ("char", ((0, MAX_CODEPOINT),), False)
                items.append(item)
                last = [item]
            elif c and (c.isalnum() or c in "-_"):
                name = self._name()
                item = ("ref", self._rule_id(name))
                items.append(item)
                last = [item]
            elif c and c in "*+?{":
                if not last:
                    raise GBNFError(f"repetition with no operand at offset {self.pos}")
                n = len(last)
                del items[len(items) - n :]
                if c == "*":
                    self.pos += 1
                    items.extend(self._repeat(last, rule_name, 0, None))
                elif c == "+":
                    self.pos += 1
                    items.extend(self._repeat(last, rule_name, 1, None))
                elif c == "?":
                    self.pos += 1
                    items.extend(self._repeat(last, rule_name, 0, 1))
                else:
                    self.pos += 1
                    start = self.pos
                    while self._peek() and self._peek() != "}":
                        self.pos += 1
                    spec = self.text[start : self.pos]
                    self._expect("}")
                    if "," in spec:
                        lo_s, hi_s = spec.split(",", 1)
                        lo = int(lo_s) if lo_s.strip() else 0
                        hi = int(hi_s) if hi_s.strip() else None
                    else:
                        lo = hi = int(spec)
                    items.extend(self._repeat(last, rule_name, lo, hi))
                last = None
            else:
                break
        return tuple(items)

    def _alternates(self, rule_name: str) -> list[Alternate]:
        alts = [self._sequence(rule_name)]
        while True:
            self._ws(newlines=False)
            if self._peek() == "|":
                self.pos += 1
                self._ws()
                alts.append(self._sequence(rule_name))
            else:
                break
        return alts

    def parse(self) -> Grammar:
        self._ws()
        while self.pos < len(self.text):
            name = self._name()
            rid = self._rule_id(name)
            self._ws(newlines=False)
            self._expect("::=")
            self._ws()
            alts = self._alternates(name)
            if self.rules[rid] is not None:
                raise GBNFError(f"duplicate rule {name!r}")
            self.rules[rid] = alts
            self._ws()
        undefined = [self.names[i] for i, r in enumerate(self.rules) if r is None]
        if undefined:
            raise GBNFError(f"undefined rule(s): {undefined}")
        if "root" not in self.name_to_id:
            raise GBNFError("grammar has no 'root' rule")
        g = Grammar(
            rules=self.rules,  # type: ignore[arg-type]
            names=self.names,
            root_id=self.name_to_id["root"],
            name_to_id=self.name_to_id,
        )
        _check_left_recursion(g)
        return g


def _check_left_recursion(g: Grammar):
    """Reject left-recursive grammars (the PDA would loop; same restriction
    as the reference, llama-grammar.cpp detect_left_recursion)."""
    # can_be_empty fixpoint
    empty = [False] * len(g.rules)
    changed = True
    while changed:
        changed = False
        for rid, alts in enumerate(g.rules):
            if empty[rid]:
                continue
            for alt in alts:
                if all(it[0] == "ref" and empty[it[1]] for it in alt):
                    empty[rid] = True
                    changed = True
                    break

    # leftmost reachable refs
    import collections

    first = collections.defaultdict(set)
    for rid, alts in enumerate(g.rules):
        for alt in alts:
            for it in alt:
                if it[0] != "ref":
                    break
                first[rid].add(it[1])
                if not empty[it[1]]:
                    break

    state = [0] * len(g.rules)  # 0 unvisited, 1 in-stack, 2 done

    def dfs(r):
        if state[r] == 1:
            raise GBNFError(f"left recursion detected via rule {g.names[r]!r}")
        if state[r] == 2:
            return
        state[r] = 1
        for nxt in first[r]:
            dfs(nxt)
        state[r] = 2

    for rid in range(len(g.rules)):
        dfs(rid)


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()
