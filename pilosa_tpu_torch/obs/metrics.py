"""Prometheus text exposition (GET /metrics).

Renders the /debug/vars counter groups — the same dict the JSON endpoint
serves, so the two surfaces can never disagree — plus the trace
recorder's per-stage latency histograms, as Prometheus text format
version 0.0.4. Numeric scalars flatten into `pilosa_<group>_<key>`
gauges; dicts shaped like stats.Histogram.snapshot() render as proper
histogram families (cumulative `le` buckets + `_sum` + `_count`), and
the stage histograms share one family labeled by stage. Non-numeric
leaves (strings, lists, peer maps of strings) are skipped — Prometheus
has no type for them and the JSON endpoint keeps serving the detail.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..stats import Histogram

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
_PREFIX = "pilosa"

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _metric_name(*parts: str) -> str:
    name = "_".join(_NAME_BAD.sub("_", str(p)) for p in parts if p != "")
    if not name or not (name[0].isalpha() or name[0] == "_"):
        name = "_" + name
    return f"{_PREFIX}_{name}".lower()


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _is_hist_snapshot(v) -> bool:
    return (isinstance(v, dict) and "count" in v and "sum" in v
            and isinstance(v.get("buckets"), dict))


class _Writer:
    """Accumulates families so each emits exactly one # TYPE line."""

    def __init__(self):
        self._order: List[str] = []
        self._families: Dict[str, List[str]] = {}
        self._types: Dict[str, str] = {}

    def sample(self, family: str, labels: Optional[Dict[str, str]], value,
               suffix: str = "", mtype: str = "gauge") -> None:
        if family not in self._families:
            self._order.append(family)
            self._families[family] = []
            self._types[family] = mtype
        label_s = ""
        if labels:
            inner = ",".join(
                f'{k}="{_escape_label(str(v))}"' for k, v in labels.items())
            label_s = "{" + inner + "}"
        self._families[family].append(
            f"{family}{suffix}{label_s} {_fmt_value(value)}")

    def histogram(self, family: str, labels: Optional[Dict[str, str]],
                  snap: dict) -> None:
        """One histogram series from a stats.Histogram.snapshot()."""
        buckets = snap.get("buckets", {})
        per_bound = {}
        for key, n in buckets.items():
            per_bound[key] = per_bound.get(key, 0) + int(n)
        cum = 0
        for bound in Histogram.BOUNDS:
            cum += per_bound.get(repr(bound), 0)
            lab = dict(labels or {})
            lab["le"] = f"{bound:g}"
            self.sample(family, lab, cum, suffix="_bucket", mtype="histogram")
        lab = dict(labels or {})
        lab["le"] = "+Inf"
        self.sample(family, lab, snap.get("count", 0), suffix="_bucket",
                    mtype="histogram")
        self.sample(family, labels, snap.get("sum", 0.0), suffix="_sum",
                    mtype="histogram")
        self.sample(family, labels, snap.get("count", 0), suffix="_count",
                    mtype="histogram")

    def render(self) -> str:
        lines: List[str] = []
        for family in self._order:
            lines.append(f"# TYPE {family} {self._types[family]}")
            lines.extend(self._families[family])
        return "\n".join(lines) + "\n"


def _walk(w: _Writer, prefix: List[str], obj) -> None:
    if _is_hist_snapshot(obj):
        w.histogram(_metric_name(*prefix), None, obj)
        return
    if isinstance(obj, bool) or isinstance(obj, (int, float)):
        w.sample(_metric_name(*prefix), None, obj)
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _walk(w, prefix + [str(k)], v)
    # strings / lists / None: no Prometheus representation — skipped.


def render_prometheus(groups: dict,
                      stage_hists: Optional[Dict[str, dict]] = None) -> str:
    """`groups` is the /debug/vars dict; `stage_hists` the recorder's
    per-stage Histogram snapshots ({stage_name: snapshot})."""
    w = _Writer()
    for group, val in groups.items():
        _walk(w, [str(group)], val)
    for stage, snap in (stage_hists or {}).items():
        w.histogram(_metric_name("stage", "duration", "ms"),
                    {"stage": stage}, snap)
    return w.render()
