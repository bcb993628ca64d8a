"""PQL AST (port of reference pql/ast.go).

Query = list of Calls; Call = name + args dict + child calls; Condition
wraps a comparison op for Range() conditions. Ops are lowercase strings:
eq, neq, lt, lte, gt, gte, between.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from ..errors import QueryError

# Condition ops.
EQ = "eq"
NEQ = "neq"
LT = "lt"
LTE = "lte"
GT = "gt"
GTE = "gte"
BETWEEN = "between"

_OP_STRINGS = {
    EQ: "==",
    NEQ: "!=",
    LT: "<",
    LTE: "<=",
    GT: ">",
    GTE: ">=",
    BETWEEN: "><",
}

# Reserved positional arg keys (pql.peg:58 reserved).
RESERVED = {"_row", "_col", "_start", "_end", "_timestamp", "_field"}


@dataclass
class Condition:
    op: str
    value: Any

    def int_slice_value(self) -> List[int]:
        if not isinstance(self.value, list):
            raise ValueError(f"unexpected condition value: {self.value!r}")
        return [int(v) for v in self.value]

    def __str__(self):
        return f"{_OP_STRINGS[self.op]} {format_value(self.value)}"


@dataclass
class Call:
    name: str
    args: Dict[str, Any] = field(default_factory=dict)
    children: List["Call"] = field(default_factory=list)

    def field_arg(self) -> str:
        """The (single) non-reserved argument key (ast.go Call.FieldArg)."""
        for key in sorted(self.args):
            if key not in RESERVED:
                return key
        raise QueryError(f"{self.name}() argument required: field")

    def uint_arg(self, key: str):
        v = self.args.get(key)
        if v is None:
            return 0, False
        if isinstance(v, bool) or not isinstance(v, int):
            raise QueryError(f"argument {key!r} is not an integer: {v!r}")
        return v, True

    def has_condition_arg(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def keys(self) -> List[str]:
        return sorted(self.args)

    def __str__(self):
        parts = [str(c) for c in self.children]
        for key in self.keys():
            v = self.args[key]
            if isinstance(v, Condition):
                parts.append(f"{key} {v}")
            else:
                parts.append(f"{key}={format_value(v)}")
        return f"{self.name}({', '.join(parts)})"


@dataclass
class Query:
    calls: List[Call] = field(default_factory=list)

    def write_calls(self) -> List[Call]:
        return [c for c in self.calls if c.name in WRITE_CALLS]

    def __str__(self):
        return "\n".join(str(c) for c in self.calls)


WRITE_CALLS = {"Set", "Clear", "SetValue", "SetRowAttrs", "SetColumnAttrs"}


def format_value(v) -> str:
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    return str(v)
