"""The arithmetic of the metrics: the union idle share, the p95 over all
requests, the roofline bytes against hand-computed values, and the
readers' silence where they find nothing."""

import numpy as np
import pytest

from gpubench import bounds, devtrace, spec


def test_the_kernel_bytes_are_the_frozen_formulas():
    # K1 at the serving shape: 126 distinct slots x 256 shards x 32768 words.
    assert bounds.k1_bytes(126, 256, 32768) == 4_227_858_432
    # K2, a TopN chunk: 64 rows and the mask read, 64 x 256 counts written.
    assert bounds.k2_bytes(64, 256, 32768, True) == 65 * 256 * 32768 * 4 + 64 * 256 * 4
    assert bounds.k2_bytes(25, 573, 32768, False) == 25 * 573 * 32768 * 4 + 25 * 573 * 4
    # K3 depth 17 with a mask: 637.5 MB.
    assert bounds.k3_bytes(17, 256, 32768, True) == 637_534_208
    # 3.35 GB in 1 ms is the peak; in 2 ms half of it.
    assert bounds.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert bounds.roofline_pct(3.35e9, 2e-3) == pytest.approx(50.0)
    assert bounds.roofline_pct(3.35e9, 0.0) is None


def test_busy_time_is_the_union_of_overlapping_intervals():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0), ("d", 9.0, 12.0)]
    assert devtrace.busy_s(iv, 0.0, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert devtrace.gaps(iv, 0.0, 10.0) == [(1.5, 3.0), (4.0, 9.0)]
    assert devtrace.kernel_s(iv, "^[ab]$", 0.0, 10.0) == pytest.approx(2.0)


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    idle = [(1.0, 2.0), (5.0, 5.00001), (7.0, 8.0)]
    spans = [("device.dispatch", 0.5, 2.0), ("gather", 1.2, 0.5), ("parse", 6.0, 0.1)]
    got = dict(devtrace.label_gaps(idle, spans))
    assert got["gather"] == pytest.approx(1.0)
    assert got["no span"] == pytest.approx(1.0)
    assert got["gaps under 50 us"] == pytest.approx(1e-5)


def test_short_names_drop_template_arguments():
    assert devtrace.short_name("void k1_staged_kernel<2, false, true>(uint4 const*)") == \
        "k1_staged_kernel"
    assert devtrace.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(x)") == \
        "at::native::CatArrayBatchedCopy"


def _rec(**kw):
    rec = {"reads": [], "read_traces": [], "counters": {"engine": {}, "batcher": {}},
           "launch_bytes": {}, "device": None, "peak_window_bytes": 0,
           "calls_of": lambda pql: 1, "good_calls": 0, "seconds": 10.0, "setup_s": 1.0}
    rec.update(kw)
    return rec


def test_the_p95_is_over_every_request():
    lat = np.arange(1, 101) / 1e3  # 1..100 ms
    reads = [[0, 0, 10.0, 10.0 + x, 200, "", 1] for x in lat]
    got = spec.metric("request_p95_ms").read(_rec(reads=reads))
    assert got == pytest.approx(np.percentile(np.arange(1, 101), 95))


def test_the_write_p95_runs_from_each_rides_due_time_to_its_answer():
    # [tag, due, sent, answered, status, body]: sent 1 s late, answered
    # 1..100 ms after it was sent.
    writes = [[k, 5.0, 6.0, 6.0 + (k + 1) / 1e3, 200, ""] for k in range(100)]
    got = spec.metric("write_p95_ms").read(_rec(writes=writes))
    assert got == pytest.approx(1000 + np.percentile(np.arange(1, 101), 95))
    assert spec.metric("write_p95_ms").read(_rec()) is None


def test_the_span_and_counter_metrics():
    traces = [("Count(x)", 0.0, 0.01, [("parse", 0.0, 0.001, {}), ("plan.compile", 0.001, 0.001, {}),
                                       ("sched.wait", 0.002, 0.004, {}),
                                       ("device.dispatch", 0.006, 0.003, {"rung": "device"})]),
              ("Count(y)", 0.0, 0.01, [("parse", 0.0, 0.001, {}),
                                       ("device.dispatch", 0.006, 0.001, {"rung": "host"})])]
    rec = _rec(read_traces=traces,
               counters={"engine": {"memo_hits": 1, "memo_misses": 3},
                         "batcher": {"launches": 4, "coalesced": 6}})
    assert spec.metric("parse_ms").read(rec) == pytest.approx(1.5)
    assert spec.metric("sched_wait_ms").read(rec) == pytest.approx(4.0)
    assert spec.metric("dispatch_ms").read(rec) == pytest.approx(1.5)
    assert spec.metric("memo_hit_pct").read(rec) == pytest.approx(25.0)
    assert spec.metric("batch_group_mean").read(rec) == pytest.approx(2.5)


def test_the_rate_and_the_memory_peak():
    rec = _rec(good_calls=25, peak_window_bytes=3 * 2 ** 29)
    assert spec.metric("read_calls_per_s").read(rec) == pytest.approx(2.5)
    assert spec.metric("peak_mem_gib").read(rec) == pytest.approx(1.5)


def test_device_metrics_need_a_device_and_rooflines_their_launches():
    rec = _rec()
    for name in ("device_idle_pct", "k1_roofline", "peak_mem_gib",
                 "batch_group_mean", "memo_hit_pct", "dispatch_ms", "parse_ms"):
        assert spec.metric(name).read(rec) is None, name
    dev = {"intervals": [("void k1_staged_kernel<2>(x)", 0.0, 0.002),
                         ("masked_plane_counts_kernel(x)", 1.0, 1.001)],
           "t0": 0.0, "t1": 10.0, "busy_s": 0.003, "window_s": 10.0}
    rec = _rec(device=dev, launch_bytes={"k1": 3.35e9})
    assert spec.metric("device_idle_pct").read(rec) == pytest.approx(99.97)
    assert spec.metric("k1_roofline").read(rec) == pytest.approx(50.0)
