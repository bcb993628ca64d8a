"""Span sums of the window's read requests, per read call, for the
per-layer metrics that read the engine's spans inside `device.dispatch`.
A trace is (pql, start s, duration s, [(name, start s, duration s,
tags)]), as probes.Traces keeps it."""

from __future__ import annotations

from typing import List, Optional, Tuple

# The spans inside `device.dispatch` (parallel/engine.py, ops/kernels.py):
# a program that records none of them has nothing to explain a dispatch.
ENGINE_SPANS = ("engine.fingerprint", "engine.stack", "k1.stage", "device.sync")


def _calls(rec) -> int:
    return sum(rec["calls_of"](pql) for pql, _t0, _d, _s in rec["read_traces"])


def per_call_ms(rec, name: str) -> Optional[float]:
    """Milliseconds of the spans named `name` per read call, or None where
    no such span was recorded."""
    durs = [sp[2] for _pql, _t0, _d, spans in rec["read_traces"] for sp in spans
            if sp[0] == name]
    calls = _calls(rec)
    return 1e3 * sum(durs) / calls if durs and calls else None


def _covered(lo: float, hi: float, parts: List[Tuple[float, float]]) -> float:
    """Seconds of [lo, hi] that the union of `parts` covers."""
    out, at = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in parts):
        if e > at:
            out += e - max(s, at)
            at = e
    return out


def dispatch_self_ms(rec) -> Optional[float]:
    """Per read call, the time inside the device rung's `device.dispatch`
    spans that no span nested in them covers: the spans of the same trace
    that start inside a dispatch span and are shorter than it, their
    union clipped to it. (A span recorded after the fact, such as
    `executor.fanout`, can start a hair inside the dispatch span it
    encloses; it is longer, so not nested.) None where there is no such
    dispatch span, or none of ENGINE_SPANS."""
    total, found, engine = 0.0, False, False
    for _pql, _t0, _d, spans in rec["read_traces"]:
        for i, (name, lo, dur, tags) in enumerate(spans):
            engine = engine or name in ENGINE_SPANS
            if name != "device.dispatch" or tags.get("rung") != "device":
                continue
            found = True
            hi = lo + dur
            inner = [(s, s + d) for j, (_n, s, d, _t) in enumerate(spans)
                     if j != i and lo <= s < hi and d < dur]
            total += dur - _covered(lo, hi, inner)
    calls = _calls(rec)
    return 1e3 * total / calls if found and engine and calls else None
