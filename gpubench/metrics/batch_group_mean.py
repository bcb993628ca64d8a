"""Queries per micro-batcher launch over the window: (launches +
coalesced) / launches of sched/batcher.py's counters."""


def read(rec):
    b = rec["counters"]["batcher"]
    launches = b.get("launches", 0)
    return (launches + b.get("coalesced", 0)) / launches if launches > 0 else None
