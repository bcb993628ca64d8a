"""The general generator of PQL traffic: read requests made of templates
and an open-loop ingest of new columns, all from the cell file's
parameters and the seed.

A template (cell file, "requests"): a `share` of the requests, `params`
with their domains ({"rows_of": field} or {"range": [lo, hi]}), a `draw`
("permutation": each reader walks its own seeded permutation of the whole
parameter grid; "uniform": each request draws every parameter), and its
`calls`: {"agg": "Count" | "Sum", "field": summed field, "where": [[field,
op, operand]]}, op "row" (a set field's Row), "==" or "<" (a Range), or
"between" (a Range >< [a, b], operand [a, b]); an operand is a number, a
parameter's name, or "name+k".

Readers are given the templates in blocks: each block holds every
template the number of times its share asks for, in a seeded order, so
every seed asks for the same mix.

The ingest ("ingest"): `rate_per_s` new columns a second from
`first_column`, for as long as the run offers traffic, each one request
that sets every field of the configuration ("Set" for a set field,
"SetValue" for an int field), its values drawn as the configuration
draws them, in chunks of RIDE_CHUNK seeded apart, so a ride's values do
not depend on the run's length.
"""

from __future__ import annotations

import itertools
import math
from fractions import Fraction
from typing import Dict, List

import numpy as np
import torch

RIDE_CHUNK = 1024


def _operand(tok, params):
    if isinstance(tok, (int, float)):
        return int(tok)
    name, _, k = tok.partition("+")
    return params[name] + (int(k) if k else 0)


def _domain(spec, columns) -> List[int]:
    if "rows_of" in spec:
        return list(columns.rows(spec["rows_of"]))
    lo, hi = spec["range"]
    return list(range(lo, hi + 1))


def resolve(call: dict, params: Dict[str, int]) -> dict:
    """A template call with its parameters filled in: where clauses of
    [field, op, a, b] (b is None but for "between")."""
    where = []
    for field, op, tok in call["where"]:
        if op == "between":
            where.append([field, op, _operand(tok[0], params), _operand(tok[1], params)])
        else:
            where.append([field, op, _operand(tok, params), None])
    return {"agg": call["agg"], "field": call.get("field"), "where": where}


def render(call: dict) -> str:
    """The PQL text of a resolved call."""
    parts = []
    for field, op, a, b in call["where"]:
        if op == "row":
            parts.append(f"Row({field}={a})")
        elif op == "between":
            parts.append(f"Range({field} >< [{a}, {b}])")
        else:
            parts.append(f"Range({field} {op} {a})")
    inner = parts[0] if len(parts) == 1 else "Intersect(" + ", ".join(parts) + ")"
    if call["agg"] == "Count":
        return f"Count({inner})"
    return f"Sum({inner}, field={call['field']})"


def _template_block(templates) -> List[int]:
    shares = [Fraction(str(t["share"])) for t in templates]
    scale = np.lcm.reduce([s.denominator for s in shares])
    return [i for i, s in enumerate(shares) for _ in range(int(s * scale))]


def plan(cell: dict, columns, seed: int, seconds: float) -> dict:
    """{"requests": [{"template", "calls": [resolved call]}], "readers":
    [[[tag, pql]] per reader], "rides": [{"column", "values", "pql"}]};
    a tag indexes "requests"; the rides cover `seconds` of traffic."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    templates = cell["requests"]
    per_reader = cell["requests_per_reader"]
    block = _template_block(templates)
    grids = {}
    for ti, t in enumerate(templates):
        names = list(t["params"])
        doms = [_domain(t["params"][n], columns) for n in names]
        grids[ti] = (names, doms, list(itertools.product(*doms))
                     if t.get("draw") == "permutation" else None)
    requests, readers = [], []
    for _ in range(cell["readers"]):
        order = {ti: rng.permutation(len(g[2])) for ti, g in grids.items() if g[2] is not None}
        walked = {ti: 0 for ti in grids}
        work = []
        while len(work) < per_reader:
            for ti in rng.permutation(block):
                names, doms, grid = grids[ti]
                if grid is not None:
                    vals = grid[order[ti][walked[ti] % len(grid)]]
                else:
                    vals = [d[rng.integers(len(d))] for d in doms]
                walked[ti] += 1
                params = dict(zip(names, (int(v) for v in vals)))
                calls = [resolve(c, params) for c in templates[ti]["calls"]]
                tag = len(requests)
                requests.append({"template": templates[ti]["name"], "calls": calls})
                work.append([tag, " ".join(render(c) for c in calls)])
        readers.append(work[:per_reader])
    return {"requests": requests, "readers": readers,
            "rides": rides(cell, columns, seed, seconds)}


def _ride_values(columns, seed: int, chunk: int) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device="cpu")
    g.manual_seed(int(np.random.SeedSequence([int(seed) % (1 << 64), 11, chunk])
                      .generate_state(1)[0]))
    vals: Dict[str, torch.Tensor] = {}
    for c in columns.specs:
        vals[c["name"]] = columns.kinds[c["kind"]].generate(c, RIDE_CHUNK, g,
                                                            torch.device("cpu"), vals)
    return vals


def rides(cell: dict, columns, seed: int, seconds: float) -> List[dict]:
    """The ingest's new columns in due order, with every field's value."""
    ing = cell.get("ingest")
    if not ing:
        return []
    n = math.ceil(ing["rate_per_s"] * seconds)
    out = []
    for k in range(n):
        if k % RIDE_CHUNK == 0:
            vals = {name: v.tolist()
                    for name, v in _ride_values(columns, seed, k // RIDE_CHUNK).items()}
        col = ing["first_column"] + k
        values, calls = {}, []
        for c in columns.fields:
            v = vals[c["name"]][k % RIDE_CHUNK]
            values[c["name"]] = v
            calls.append(f"Set({col}, {c['name']}={v})" if c["field"]["type"] == "set"
                         else f"SetValue(col={col}, {c['name']}={v})")
        out.append({"column": col, "values": values, "pql": " ".join(calls)})
    return out
