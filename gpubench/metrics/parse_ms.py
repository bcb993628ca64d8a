"""Parse and plan time per read request: the recorder's `parse` and
`plan.compile` spans of the window's read requests, over their number."""


def read(rec):
    traces = rec["read_traces"]
    if not traces:
        return None
    total = sum(sp[2] for _pql, _t0, _d, spans in traces for sp in spans
                if sp[0] in ("parse", "plan.compile"))
    return 1e3 * total / len(traces)
