"""The mean admission wait: the recorder's `sched.wait` spans of the
window's read requests (sched/scheduler.py)."""


def read(rec):
    waits = [sp[2] for _pql, _t0, _d, spans in rec["read_traces"] for sp in spans
             if sp[0] == "sched.wait"]
    return 1e3 * sum(waits) / len(waits) if waits else None
