"""Engine time per read call: the recorder's `device.dispatch` spans on
the device rung (executor.py: the engine call, its fingerprint walk and
device wait included) of the window's read requests, over their calls."""


def read(rec):
    traces = rec["read_traces"]
    calls = sum(rec["calls_of"](pql) for pql, _t0, _d, _s in traces)
    total = sum(sp[2] for _pql, _t0, _d, spans in traces for sp in spans
                if sp[0] == "device.dispatch" and sp[3].get("rung") == "device")
    return 1e3 * total / calls if calls and total > 0 else None
