"""Share of the window's read calls that the collective plane answered:
100 x the requests' marks of the executor's CollectiveCount counter
(each a `gpubench.collective_count` span in the request's trace, put
there by the rank's probe, gpubench/deployments/collective_rank.py) in
the traces of the window's read requests, over their Count calls. The
rest went through the HTTP fan-out; the `collective` snapshot of each
rank in the result's `run` counts them by reason. Silent where no trace
holds a span of the collective plane."""


def read(rec):
    traces = rec["read_traces"]
    names = [sp[0] for _pql, _t0, _d, spans in traces for sp in spans]
    if not any(n.startswith(("collective.", "gpubench.collective")) for n in names):
        return None
    calls = sum(rec["calls_of"](pql) for pql, _t0, _d, _s in traces)
    served = sum(1 for n in names if n == "gpubench.collective_count")
    return 100.0 * served / calls if calls else None
