"""Recursive-descent PQL parser implementing reference pql/pql.peg.

Handles the special call forms (Set, SetRowAttrs, SetColumnAttrs, Clear,
TopN, Range with timerange / `a < field < b` conditionals) plus generic
calls with nested children, lists, quoted strings, and comparison args.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from .ast import BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition, Query

_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_UINT_RE = re.compile(r"[0-9]+")
_NUM_RE = re.compile(r"-?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)")
_BAREWORD_RE = re.compile(r"[A-Za-z0-9\-_:]+")
_TIMESTAMP_RE = re.compile(r"[0-9]{4}-[01][0-9]-[0-3][0-9]T[0-9]{2}:[0-9]{2}")
_COND_OPS = [("><", BETWEEN), ("<=", LTE), (">=", GTE), ("==", EQ),
             ("!=", NEQ), ("<", LT), (">", GT)]
_RESERVED_FIELDS = {"_row", "_col", "_start", "_end", "_timestamp", "_field"}


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    # ----------------------------------------------------------- utilities

    def error(self, msg: str):
        raise ParseError(f"{msg} at position {self.pos}: {self.text[self.pos:self.pos+30]!r}")

    def ws(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n\r":
            self.pos += 1

    def sp(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def accept(self, s: str) -> bool:
        if self.text.startswith(s, self.pos):
            self.pos += len(s)
            return True
        return False

    def expect(self, s: str):
        if not self.accept(s):
            self.error(f"expected {s!r}")

    def match(self, regex) -> Optional[str]:
        m = regex.match(self.text, self.pos)
        if m:
            self.pos = m.end()
            return m.group(0)
        return None

    def comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.accept(","):
            self.ws()
            return True
        self.pos = save
        return False

    # -------------------------------------------------------------- values

    def parse_quoted(self, quote: str) -> str:
        out = []
        while True:
            ch = self.peek()
            if ch == "":
                self.error("unterminated string")
            if ch == quote:
                self.pos += 1
                return "".join(out)
            if ch == "\\":
                self.pos += 1
                esc = self.peek()
                self.pos += 1
                out.append({"n": "\n", '"': '"', "'": "'", "\\": "\\"}.get(esc, esc))
            else:
                out.append(ch)
                self.pos += 1

    def parse_item(self) -> Any:
        for lit, val in (("null", None), ("true", True), ("false", False)):
            save = self.pos
            if self.accept(lit):
                nxt = self.peek()
                if nxt in ",) \t\n]" or nxt == "":
                    return val
                self.pos = save
        if self.peek() == '"':
            self.pos += 1
            return self.parse_quoted('"')
        if self.peek() == "'":
            self.pos += 1
            return self.parse_quoted("'")
        # Numbers before barewords; a bareword can also start with a digit
        # (e.g. timestamps), so try the longer bareword if it extends past
        # the number (pql.peg item ordering).
        save = self.pos
        num = self.match(_NUM_RE)
        if num is not None:
            after = self.peek()
            if after not in ",) \t\n]" and after != "":
                self.pos = save  # part of a bareword like 2010-01-01T00:00
            else:
                return float(num) if "." in num else int(num)
        word = self.match(_BAREWORD_RE)
        if word is not None:
            return word
        self.error("expected value")

    def parse_value(self) -> Any:
        if self.accept("["):
            self.sp()
            items: List[Any] = []
            if not self.accept("]"):
                while True:
                    items.append(self.parse_item())
                    if not self.comma():
                        break
                self.sp()
                self.expect("]")
            self.sp()
            return items
        return self.parse_item()

    # ---------------------------------------------------------------- args

    def try_parse_arg(self) -> Optional[Tuple[str, Any]]:
        """field (= | COND) value — or None if not an arg at this position."""
        save = self.pos
        fld = self.match(_FIELD_RE)
        if fld is None and self.peek() == "_":
            for r in _RESERVED_FIELDS:
                if self.text.startswith(r, self.pos):
                    fld = r
                    self.pos += len(r)
                    break
        if fld is None:
            return None
        self.sp()
        for op_str, op in _COND_OPS:  # before '=': '==' must not match as '='
            if self.accept(op_str):
                self.sp()
                return fld, Condition(op, self.parse_value())
        if self.accept("="):
            self.sp()
            return fld, self.parse_value()
        self.pos = save
        return None

    # --------------------------------------------------------------- calls

    def parse_call(self) -> Call:
        name = self.match(_IDENT_RE)
        if name is None:
            self.error("expected call name")
        special = {
            "Set": lambda: self.parse_set(name),
            "SetRowAttrs": self.parse_set_row_attrs,
            "SetColumnAttrs": self.parse_set_column_attrs,
            "Clear": lambda: self.parse_clear(name),
            "TopN": self.parse_topn,
            "Range": self.parse_range,
        }.get(name)
        if special is not None:
            # PEG ordered choice (pql.peg:9-15): if the special form fails,
            # fall back to the generic IDENT branch — this is what makes
            # canonical re-serializations like Set(_col=1, f=9) parseable.
            save = self.pos
            try:
                call = special()
            except ParseError:
                self.pos = save
                call = self.parse_generic(name)
            return call
        # Old (pre-v1) call names parse as generic calls and are rejected by
        # the executor with "unknown call: SetBit" — matching the surveyed
        # reference, which dropped the old PQL syntax
        # (executor_test.go:379-390 TestExecutor_Execute_OldPQL).
        return self.parse_generic(name)

    def open(self):
        self.expect("(")
        self.sp()

    def close(self):
        self.sp()
        self.expect(")")
        self.sp()

    def parse_col(self) -> Any:
        if self.peek() == '"':
            self.pos += 1
            return self.parse_quoted('"')
        u = self.match(_UINT_RE)
        if u is None:
            self.error("expected column")
        return int(u)

    def parse_set(self, name: str) -> Call:
        call = Call("Set")
        self.open()
        call.args["_col"] = self.parse_col()
        while self.comma():
            arg = self.try_parse_arg()
            if arg is not None:
                call.args[arg[0]] = arg[1]
                continue
            ts = self.match(_TIMESTAMP_RE)
            if ts is None and self.peek() in "\"'":
                q = self.peek()
                self.pos += 1
                ts = self.parse_quoted(q)
                if not _TIMESTAMP_RE.fullmatch(ts):
                    self.error("invalid timestamp")
            if ts is None:
                self.error("expected argument or timestamp")
            call.args["_timestamp"] = ts
        self.close()
        return call

    def parse_set_row_attrs(self) -> Call:
        call = Call("SetRowAttrs")
        self.open()
        fld = self.match(_FIELD_RE)
        if fld is None:
            self.error("expected field")
        call.args["_field"] = fld
        if not self.comma():
            self.error("expected ','")
        row = self.match(_UINT_RE)
        if row is None:
            self.error("expected row id")
        call.args["_row"] = int(row)
        while self.comma():
            arg = self.try_parse_arg()
            if arg is None:
                self.error("expected argument")
            call.args[arg[0]] = arg[1]
        self.close()
        return call

    def parse_set_column_attrs(self) -> Call:
        call = Call("SetColumnAttrs")
        self.open()
        call.args["_col"] = self.parse_col()
        while self.comma():
            arg = self.try_parse_arg()
            if arg is None:
                self.error("expected argument")
            call.args[arg[0]] = arg[1]
        self.close()
        return call

    def parse_clear(self, name: str) -> Call:
        call = Call("Clear")
        self.open()
        call.args["_col"] = self.parse_col()
        while self.comma():
            arg = self.try_parse_arg()
            if arg is None:
                self.error("expected argument")
            call.args[arg[0]] = arg[1]
        self.close()
        return call

    def parse_topn(self) -> Call:
        call = Call("TopN")
        self.open()
        fld = self.match(_FIELD_RE)
        if fld is None:
            self.error("expected field")
        call.args["_field"] = fld
        while self.comma():
            self.parse_allarg(call)
        self.close()
        return call

    def parse_range(self) -> Call:
        call = Call("Range")
        self.open()
        # conditional: int <[=] field <[=] int
        save = self.pos
        if self.try_parse_conditional(call):
            self.close()
            return call
        self.pos = save
        arg = self.try_parse_arg()
        if arg is None:
            self.error("expected Range argument")
        call.args[arg[0]] = arg[1]
        # timerange: field=value, start_ts, end_ts
        if self.comma():
            for key in ("_start", "_end"):
                ts = self.match(_TIMESTAMP_RE)
                if ts is None and self.peek() in "\"'":
                    q = self.peek()
                    self.pos += 1
                    ts = self.parse_quoted(q)
                if ts is None:
                    self.error("expected timestamp")
                call.args[key] = ts
                if key == "_start" and not self.comma():
                    self.error("expected ','")
        self.close()
        return call

    def try_parse_conditional(self, call: Call) -> bool:
        def cond_int():
            m = re.compile(r"-?[0-9]+").match(self.text, self.pos)
            if m is None:
                return None
            self.pos = m.end()
            self.sp()
            return int(m.group(0))

        def cond_lt():
            if self.accept("<="):
                self.sp()
                return "<="
            if self.accept("<"):
                self.sp()
                return "<"
            return None

        low = cond_int()
        if low is None:
            return False
        op1 = cond_lt()
        if op1 is None:
            return False
        fld = self.match(_FIELD_RE)
        if fld is None:
            return False
        self.sp()
        op2 = cond_lt()
        if op2 is None:
            return False
        high = cond_int()
        if high is None:
            return False
        # pql/ast.go endConditional: strict low bumps up, inclusive high bumps up.
        if op1 == "<":
            low += 1
        if op2 == "<=":
            high += 1
        call.args[fld] = Condition(BETWEEN, [low, high])
        return True

    def parse_generic(self, name: str) -> Call:
        call = Call(name)
        self.open()
        if not self.accept(")"):
            while True:
                self.parse_allarg(call)
                if not self.comma():
                    break
            self.close()
        else:
            self.sp()
        return call

    def parse_allarg(self, call: Call):
        """One element of allargs: a child Call or a field arg."""
        save = self.pos
        name = self.match(_IDENT_RE)
        if name is not None:
            self.sp()
            if self.peek() == "(":
                self.pos = save
                call.children.append(self.parse_call())
                return
            self.pos = save
        arg = self.try_parse_arg()
        if arg is None:
            self.error("expected call or argument")
        call.args[arg[0]] = arg[1]

    # ---------------------------------------------------------------- query

    def parse_query(self) -> Query:
        q = Query()
        self.ws()
        while self.pos < len(self.text):
            q.calls.append(self.parse_call())
            self.ws()
        return q


def parse(text: str) -> Query:
    return Parser(text).parse_query()
