"""The plain reference: the answers the generated columns give, in plain
PyTorch and NumPy, from the configuration and the seed alone. It makes
the columns again block by block, histograms them jointly over the fields
each kind of call filters on (counts, and sums of the summed field), and
answers each call by adding the cells its predicates select. It reads
nothing the program made.

A call is {"agg": "Count" | "Sum", "field": summed field, "where":
[[field, op, a, b]]}, op "row", "==", "<" or "between" (a <= v <= b)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Group = Tuple[Tuple[str, ...], Optional[str]]


def group_of(call: dict) -> Group:
    return tuple(sorted({w[0] for w in call["where"]})), call.get("field")


def _select(values: np.ndarray, op: str, a: int, b) -> np.ndarray:
    if op in ("row", "=="):
        return values == a
    if op == "<":
        return values < a
    if op == "between":
        return (values >= a) & (values <= b)
    raise ValueError(f"unknown predicate {op!r}")


class Reference:
    def __init__(self, columns, groups: Sequence[Group]):
        self.columns = columns
        self.groups = sorted(set(groups), key=lambda g: (g[0], g[1] or ""))
        self.domain: Dict[str, np.ndarray] = {}
        for g, _ in self.groups:
            for f in g:
                self.domain.setdefault(f, self._domain(f))
        self.count: Dict[Group, np.ndarray] = {}
        self.sum: Dict[Group, np.ndarray] = {}

    def _domain(self, name: str) -> np.ndarray:
        f = self.columns.field(name)["field"]
        if f["type"] == "set":
            return np.asarray(sorted(self.columns.rows(name)), dtype=np.int64)
        return np.arange(f["min"], f["max"] + 1, dtype=np.int64)

    def build(self) -> None:
        """One pass over the columns, made again from the seed."""
        dev = self.columns.device
        doms = {f: torch.as_tensor(d, device=dev) for f, d in self.domain.items()}
        acc_n = {g: None for g in self.groups}
        acc_s = {g: None for g in self.groups}
        for _, _, _, cols in self.columns.iter_blocks():
            for g in self.groups:
                fields, summed = g
                size = int(np.prod([len(self.domain[f]) for f in fields], dtype=np.int64))
                key = torch.zeros(cols[self.columns.fields[0]["name"]].shape[0],
                                  dtype=torch.int64, device=dev)
                for f in fields:
                    d = doms[f]
                    key = key * len(d) + torch.searchsorted(d, cols[f].to(torch.int64))
                n = torch.bincount(key, minlength=size)
                acc_n[g] = n if acc_n[g] is None else acc_n[g] + n
                if summed is not None:
                    s = torch.zeros(size, dtype=torch.int64, device=dev).index_add_(
                        0, key, cols[summed].to(torch.int64))
                    acc_s[g] = s if acc_s[g] is None else acc_s[g] + s
            del cols
        for g in self.groups:
            shape = [len(self.domain[f]) for f in g[0]]
            self.count[g] = acc_n[g].cpu().numpy().reshape(shape)
            if g[1] is not None:
                self.sum[g] = acc_s[g].cpu().numpy().reshape(shape)

    def answer(self, call: dict) -> Tuple[int, int]:
        """(count, sum) of the columns the call selects; sum is 0 for a Count."""
        g = group_of(call)
        fields = g[0]
        picks = []
        for f in fields:
            keep = np.ones(len(self.domain[f]), dtype=bool)
            for wf, op, a, b in call["where"]:
                if wf == f:
                    keep &= _select(self.domain[f], op, a, b)
            picks.append(np.flatnonzero(keep))
        ix = np.ix_(*picks) if picks else ()
        n = int(self.count[g][ix].sum(dtype=np.int64))
        s = int(self.sum[g][ix].sum(dtype=np.int64)) if g[1] is not None else 0
        return n, s


def ride_matches(call: dict, rides: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """(match (R,) bool, summed values (R,) int64) of each ride for a call."""
    m = np.ones(len(rides), dtype=bool)
    for f, op, a, b in call["where"]:
        m &= _select(np.asarray([r["values"][f] for r in rides], dtype=np.int64), op, a, b)
    summed = call.get("field")
    vals = (np.asarray([r["values"][summed] for r in rides], dtype=np.int64)
            if summed is not None else np.zeros(len(rides), dtype=np.int64))
    return m, vals


def expected(call: dict, base: Tuple[int, int]):
    """The answer as the port's JSON gives it."""
    n, s = base
    return n if call["agg"] == "Count" else {"value": s, "count": n}
