"""Share of the engine's result and aux memo probes that hit over the
window (parallel/engine.py counters memo_hits, memo_misses)."""


def read(rec):
    e = rec["counters"]["engine"]
    probes = e.get("memo_hits", 0) + e.get("memo_misses", 0)
    return 100.0 * e.get("memo_hits", 0) / probes if probes > 0 else None
