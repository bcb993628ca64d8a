"""The readers of the engine's spans inside `device.dispatch`, against
hand-made traces: sums per read call, the dispatch span's time that no
nested span covers, and silence where the spans are absent."""

import pytest

from gpubench import spec


def _rec(traces, calls=1):
    return {"read_traces": traces, "calls_of": lambda pql: calls}


def _disp(start, dur, rung="device"):
    return ("device.dispatch", start, dur, {"rung": rung})


SUMS = {"fingerprint_ms": "engine.fingerprint", "stack_ms": "engine.stack",
        "k1_host_ms": "k1.stage", "device_wait_ms": "device.sync"}


@pytest.mark.parametrize("metric,span", sorted(SUMS.items()))
def test_each_sum_is_its_spans_per_read_call(metric, span):
    traces = [("Count(x)", 0.0, 1.0, [_disp(0.1, 0.5), (span, 0.2, 0.004, {}),
                                      (span, 0.3, 0.002, {"site": "leaf"}),
                                      ("gather", 0.2, 0.1, {})]),
              ("Count(y)", 0.0, 1.0, [_disp(0.1, 0.1), (span, 0.15, 0.006, {})])]
    # 12 ms over 2 requests of 2 calls each.
    assert spec.metric(metric).read(_rec(traces, calls=2)) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(SUMS) + ["dispatch_self_ms"])
def test_each_reader_is_silent_without_its_spans(metric):
    # The parent's trace shape: a dispatch span with batch.hold and gather
    # inside, and none of the engine's own spans.
    old = [("Count(x)", 0.0, 1.0, [_disp(0.1, 0.5), ("batch.hold", 0.1, 0.2, {}),
                                   ("gather", 0.3, 0.1, {})])]
    assert spec.metric(metric).read(_rec(old)) is None
    assert spec.metric(metric).read(_rec([])) is None


def test_dispatch_self_time_is_what_nested_spans_leave_uncovered():
    spans = [
        ("executor.fanout", 0.95, 0.2, {}),       # encloses: not nested
        ("executor.fanout", 1.0001, 0.2, {}),     # recorded late, encloses
        _disp(1.0, 0.1),                          # [1.0, 1.1]
        ("batch.hold", 1.0, 0.01, {}),            # [1.00, 1.01]
        ("engine.stack", 1.02, 0.03, {}),         # [1.02, 1.05]
        ("engine.fingerprint", 1.02, 0.01, {}),   # nested in the stack
        ("gather", 1.04, 0.02, {}),               # overlaps the stack: to 1.06
        ("k1.stage", 1.08, 0.05, {}),             # sticks out: clipped at 1.1
        ("parse", 0.9, 0.01, {}),                 # before the dispatch
        ("reduce", 1.1, 0.001, {}),               # starts at its end
    ]
    # Uncovered: [1.01, 1.02] and [1.06, 1.08] = 30 ms.
    rec = _rec([("Count(x)", 0.9, 0.3, spans)])
    assert spec.metric("dispatch_self_ms").read(rec) == pytest.approx(30.0)
    # Per read call, and over every device-rung dispatch of the window;
    # the host rung is not the engine's.
    other = ("Count(y)", 2.0, 0.5, [_disp(2.0, 0.05), ("device.sync", 2.01, 0.01, {}),
                                    _disp(2.1, 0.2, rung="host")])
    rec = _rec([("Count(x)", 0.9, 0.3, spans), other], calls=2)
    assert spec.metric("dispatch_self_ms").read(rec) == pytest.approx((30.0 + 40.0) / 4)


def test_the_new_metrics_are_declared_beside_the_old():
    bench = spec.benchmark()
    names = [m["name"] for m in bench["per_layer"]]
    for name in ("fingerprint_ms", "stack_ms", "k1_host_ms", "device_wait_ms",
                 "dispatch_self_ms"):
        m = bench["per_layer"][names.index(name)]
        assert m["source"] == "program_span" and m["moves"] == "peak_mem_gib"
        # Every cell whose requests pass through `device.dispatch` reads
        # them: the one-node cell (the collective plane's cell does not).
        assert "taxi-1b.groupby-live" in m.get("workloads", ["taxi-1b.groupby-live"])
        assert names.index(name) > names.index("device_idle_pct")
