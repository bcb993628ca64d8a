"""The port's query scheduler and micro-batcher against pilosa_tpu's.

Mirrors tests/test_sched.py's micro-batch cases on the port's engine
(the batcher's injectable window: batch_max = the number of queries, so
the last arrival wakes the leader), plus bitmap_batch against per-call
bitmaps, a kernel fault reaching every member of a group, and the HTTP
admission cases (429 + Retry-After, X-Pilosa-Deadline 503, the QoS
tenant header) on a port server on the CPU. Counts are held against the
JAX executor over the same planted data.
"""

import json
import threading

import numpy as np
import pytest

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.executor import ExecOptions, Executor
from pilosa_tpu_torch.parallel.device_health import DeviceKernelFault
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.sched import (
    Deadline,
    DeadlineExceededError,
    MicroBatcher,
    QosConfig,
    SchedulerConfig,
)


def plant(holder, n_shards=3, n_rows=8, seed=7):
    """Rows 1..n_rows of field f over n_shards shards, from a seed."""
    idx = holder.create_index_if_not_exists("i")
    idx.create_field_if_not_exists("f")
    fld = idx.field("f")
    rng = np.random.default_rng(seed)
    expected = {}
    for row in range(1, n_rows + 1):
        cols = []
        for s in range(n_shards):
            local = np.flatnonzero(rng.random(2048) < 0.3)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        fld.import_bits([row] * len(cols), cols)
        expected[row] = len(set(cols))
    return expected


@pytest.fixture
def holder(tmp_path):
    h = pilosa_tpu_torch.Holder(str(tmp_path / "t"), device="cpu")
    h.open()
    yield h
    h.close()


@pytest.fixture
def jax_truth(tmp_path):
    """The JAX executor's answers over the same planted data."""
    h = pilosa_tpu.Holder(str(tmp_path / "j"))
    h.open()
    plant(h)
    ex = pilosa_tpu.Executor(h, workers=0)
    yield lambda q: ex.execute("i", q)[0]
    ex.close()
    h.close()


def coalescing(holder, monkeypatch, n):
    """Executor wired to a batcher whose group closes once n queries
    have enqueued (batch_max = n); memo off, so each query needs the
    device."""
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    ex = Executor(holder)
    engine = ex.engine
    batcher = MicroBatcher(lambda: engine, window=2.0, window_max=10.0,
                           batch_max=n, depth_fn=lambda: n)
    ex.batcher = batcher
    return ex, engine, batcher


def run_concurrently(fns):
    results = [None] * len(fns)
    errors = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def client(i):
        barrier.wait(timeout=10)
        try:
            results[i] = fns[i]()
        except BaseException as e:  # handed back to the test
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results, errors


@pytest.mark.parametrize("distinct", [False, True], ids=["identical", "distinct"])
def test_microbatch_coalesces_counts_like_jax(holder, monkeypatch, jax_truth, distinct):
    """8 concurrent Counts ride fewer K1 launches than queries and equal
    the unbatched JAX answers; the batcher's counters add up."""
    plant(holder)
    n = 8
    ex, engine, batcher = coalescing(holder, monkeypatch, n)
    qs = [f"Count(Row(f={r if distinct else 1}))" for r in range(1, n + 1)]
    before = engine.counters["count_dispatches"]
    results, errors = run_concurrently([lambda q=q: ex.execute("i", q)[0] for q in qs])
    assert errors == [None] * n
    assert results == [jax_truth(q) for q in qs]
    assert engine.counters["count_dispatches"] - before < n
    snap = batcher.snapshot()
    assert snap["enqueued"] == n and snap["launches"] >= 1
    assert snap["coalesced"] == n - snap["launches"]
    ex.close()


def test_microbatch_coalesces_two_leaf_trees_like_jax(holder, monkeypatch, jax_truth):
    """Distinct two-leaf Intersects (the serving shape) in one group: one
    count_batch over a stack of their distinct leaves."""
    plant(holder)
    n = 6
    ex, engine, batcher = coalescing(holder, monkeypatch, n)
    qs = [f"Count(Intersect(Row(f={a}), Row(f={a % 8 + 1})))" for a in range(1, n + 1)]
    results, errors = run_concurrently([lambda q=q: ex.execute("i", q)[0] for q in qs])
    assert errors == [None] * n
    assert results == [jax_truth(q) for q in qs]
    assert batcher.snapshot()["coalesced"] > 0
    ex.close()


def test_microbatch_group_key_carries_write_epoch(holder):
    """The write epoch in the group key moves with every write."""
    plant(holder)
    ex = Executor(holder)
    engine = ex.engine
    g1 = engine.stack_generation("i")
    holder.field("i", "f").set_bit(1, 5)
    assert engine.stack_generation("i") > g1
    assert engine.stack_generation("missing") == -1
    ex.close()


def test_microbatch_write_splits_groups(holder):
    """A write between two arrivals of the same query starts a new group:
    the second query sees the write."""
    plant(holder)
    ex = Executor(holder)
    engine = ex.engine
    waits = []
    batcher = MicroBatcher(lambda: engine, window=1.0, window_max=1.0,
                           depth_fn=lambda: 2,
                           wait_window=lambda group, w: waits.append(w))
    call = parse("Count(Row(f=1))").calls[0].children[0]
    shards = [0, 1, 2]
    first = batcher.count("i", call, shards)
    holder.field("i", "f").set_bit(1, 2 * SHARD_WIDTH + 2047 + 5)
    second = batcher.count("i", call, shards)
    assert second == first + 1
    assert batcher.snapshot()["launches"] == 2
    ex.close()


def test_microbatch_single_query_no_window(holder):
    """A lone query (pressure <= 1) dispatches at once: no window."""
    plant(holder)
    ex = Executor(holder)
    waited = []
    ex.batcher = MicroBatcher(lambda: ex.engine, depth_fn=lambda: 1,
                              wait_window=lambda group, w: waited.append(w))
    assert ex.execute("i", "Count(Row(f=1))")[0] > 0
    assert waited == []
    assert ex.batcher.counters["enqueued"] == 0
    ex.close()


def test_microbatch_memo_hit_skips_the_window(holder):
    """A repeated Count is answered by the memo before any group forms."""
    plant(holder)
    ex = Executor(holder)
    waited = []
    ex.batcher = MicroBatcher(lambda: ex.engine, window=1.0, window_max=1.0,
                              depth_fn=lambda: 4,
                              wait_window=lambda group, w: waited.append(w))
    a = ex.execute("i", "Count(Row(f=2))")[0]
    assert ex.execute("i", "Count(Row(f=2))")[0] == a
    assert len(waited) == 1 and ex.batcher.counters["enqueued"] == 1
    ex.close()


def test_bitmap_batch_equals_per_call_bitmaps(holder):
    """bitmap_batch's planes equal per-call engine.bitmap: flat and nested
    set-op trees and a duplicate query (deduped), each batch one
    dispatch."""
    plant(holder)
    ex = Executor(holder)
    eng = ex.engine
    shards = [0, 1, 2]
    for template in ("Row(f={a})", "Intersect(Row(f={a}), Row(f={b}))",
                     "Difference(Union(Row(f={a}), Row(f={b})), Xor(Row(f={b}), Row(f=8)))"):
        qs = [template.format(a=a, b=a % 7 + 2) for a in (1, 2, 3, 1)]
        calls = [parse(q).calls[0] for q in qs]
        before = eng.counters["bitmap_dispatches"]
        rows = eng.bitmap_batch("i", calls, shards)
        assert eng.counters["bitmap_dispatches"] - before == 1
        for c, r in zip(calls, rows):
            want = eng.bitmap("i", c, shards)
            assert sorted(r.segments) == sorted(want.segments)
            for s in want.segments:
                assert bool((r.segments[s] == want.segments[s]).all())
    ex.close()


def test_bitmap_batch_through_the_batcher_like_jax(holder, monkeypatch, tmp_path):
    """8 concurrent Rows coalesce into bitmap_batch and return the JAX
    executor's columns."""
    plant(holder)
    jh = pilosa_tpu.Holder(str(tmp_path / "j2"))
    jh.open()
    plant(jh)
    jex = pilosa_tpu.Executor(jh, workers=0)
    n = 8
    ex, engine, batcher = coalescing(holder, monkeypatch, n)
    qs = [f"Intersect(Row(f={r}), Row(f={r % 8 + 1}))" for r in range(1, n + 1)]
    before = engine.counters["bitmap_dispatches"]
    results, errors = run_concurrently([lambda q=q: ex.execute("i", q)[0] for q in qs])
    assert errors == [None] * n
    for q, r in zip(qs, results):
        assert r.columns().tolist() == jex.execute("i", q)[0].columns().tolist()
    assert engine.counters["bitmap_dispatches"] - before < n
    ex.close()
    jex.close()
    jh.close()


def test_kernel_fault_in_a_group_reaches_every_member(holder, monkeypatch):
    """A DeviceKernelFault inside a coalesced launch is raised to every
    request of the group: none is answered from the host."""
    plant(holder)
    n = 4
    ex, engine, batcher = coalescing(holder, monkeypatch, n)

    def faulted(*a, **kw):
        raise DeviceKernelFault("runtime", None, "planted launch failure")

    monkeypatch.setattr(engine, "count_batch", faulted)
    qs = [f"Count(Row(f={r}))" for r in range(1, n + 1)]
    results, errors = run_concurrently([lambda q=q: ex.execute("i", q)[0] for q in qs])
    assert results == [None] * n
    assert all(isinstance(e, DeviceKernelFault) for e in errors), errors
    assert engine.counters["host_counts"] == 0
    ex.close()


def test_follower_timeout_falls_back_to_a_device_dispatch(holder, fake_clock):
    """A follower whose leader never answers dispatches directly on the
    engine (the device path), not on the host."""
    from pilosa_tpu_torch.sched.batcher import _Group, _Item

    plant(holder)
    ex = Executor(holder)
    eng = ex.engine
    batcher = MicroBatcher(lambda: eng, window=0.001, window_max=0.001,
                           depth_fn=lambda: 2)
    call = parse("Count(Row(f=3))").calls[0].children[0]
    plan = eng.plan("i", call)
    key = ("count", "i", (0, 1, 2), plan.sig_tuple, eng.stack_generation("i"))
    wedged = _Group()
    wedged.items.append(_Item(call, plan))
    batcher._pending[key] = wedged  # a leader that never runs the group
    got = batcher.count("i", call, [0, 1, 2], plan=plan,
                        deadline=Deadline(0.01, clock=fake_clock))
    assert got == ex.execute("i", "Count(Row(f=3))")[0]
    assert batcher.snapshot()["fallbacks"] == 1
    assert eng.counters["host_counts"] == 0
    ex.close()


def test_expired_deadline_aborts_before_device_dispatch(holder, fake_clock):
    plant(holder)
    ex = Executor(holder)
    before = ex.engine.counters["count_dispatches"]
    d = Deadline(0.0, clock=fake_clock)
    with pytest.raises(DeadlineExceededError):
        ex.execute("i", "Count(Row(f=1))", opt=ExecOptions(deadline=d))
    assert ex.engine.counters["count_dispatches"] == before
    ex.close()


# ------------------------------------------------------------- HTTP layer


@pytest.fixture
def server(tmp_path):
    from pilosa_tpu_torch.server.server import Server

    s = Server(data_dir=str(tmp_path / "node0"), cache_flush_interval=0,
               executor_workers=0, device="cpu",
               scheduler_config=SchedulerConfig(
                   max_queue=0, interactive_concurrency=1, retry_after=3.0))
    s.open()
    yield s
    s.close()


def post(port, path, body, headers=None):
    import http.client

    conn = http.client.HTTPConnection(f"localhost:{port}", timeout=30)
    try:
        conn.request("POST", path, body=body.encode(), headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def setup_index(port):
    for path, body in (("/index/i", "{}"), ("/index/i/field/f", "{}")):
        assert post(port, path, body)[0] == 200
    assert post(port, "/index/i/query", "Set(1, f=1)")[0] == 200


def test_http_429_with_retry_after_when_full(server):
    setup_index(server.port)
    hold, entered = threading.Event(), threading.Event()
    real_execute = server.executor.execute

    def slow_execute(*a, **kw):
        entered.set()
        hold.wait(timeout=10)
        return real_execute(*a, **kw)

    server.executor.execute = slow_execute
    try:
        t = threading.Thread(target=post, args=(server.port, "/index/i/query",
                                                "Count(Row(f=1))"))
        t.start()
        assert entered.wait(timeout=10)
        status, headers, body = post(server.port, "/index/i/query", "Count(Row(f=1))")
        assert status == 429
        assert headers.get("Retry-After") in ("3", "4")
        assert "queue full" in json.loads(body)["error"]
    finally:
        hold.set()
        t.join(timeout=10)
        server.executor.execute = real_execute
    snap = server.scheduler.snapshot()
    assert snap["shed"] >= 1 and snap["admitted"] >= 1


def test_http_deadline_header_503(server):
    setup_index(server.port)
    status, _, body = post(server.port, "/index/i/query", "Count(Row(f=1))",
                           {"X-Pilosa-Deadline": "30"})
    assert status == 200 and json.loads(body)["results"][0] == 1
    before = server.scheduler.snapshot()["deadline_exceeded"]
    status, _, body = post(server.port, "/index/i/query", "Count(Row(f=1))",
                           {"X-Pilosa-Deadline": "0"})
    assert status == 503 and "deadline" in json.loads(body)["error"]
    assert server.scheduler.snapshot()["deadline_exceeded"] == before + 1


def test_http_tenant_header_and_qos_shedding(tmp_path):
    from pilosa_tpu_torch.server.server import Server

    s = Server(data_dir=str(tmp_path / "q"), cache_flush_interval=0,
               executor_workers=0, device="cpu",
               qos_config=QosConfig(rate=0.001, burst=5.0, interactive_cap=2.0,
                                    estimate_ms=5.0))
    s.open()
    try:
        setup_index(s.port)
        status, _, body = post(s.port, "/index/i/query", "Count(Row(f=1))",
                               {"X-Pilosa-Tenant": "acme"})
        assert status == 200 and json.loads(body)["results"][0] == 1
        snap = s.qos.snapshot()
        assert snap["top"]["acme"]["queries"] == 1
        traces = [t for t in s.trace_recorder.traces()
                  if t.get("tags", {}).get("tenant") == "acme"]
        assert traces and any(sp["name"] == "qos.charge" for sp in traces[0]["spans"])
        s.qos.charge_estimate("i")
        s.qos.charge_estimate("i")
        assert post(s.port, "/index/i/query", "Count(Row(f=1))")[0] == 200
        status, headers, _ = post(
            s.port, "/index/i/field/f/import",
            json.dumps({"shard": 0, "rowIDs": [2], "columnIDs": [9]}),
            {"Content-Type": "application/json"})
        assert status == 429 and headers.get("X-Pilosa-Tenant") == "i"
        for _ in range(4):
            s.qos.charge_estimate("i")
        status, headers, _ = post(s.port, "/index/i/query", "Count(Row(f=1))")
        assert status == 429 and headers.get("X-Pilosa-Tenant") == "i"
    finally:
        s.close()


def test_trace_records_dispatch_rung_and_batch_hold(server):
    """The query trace carries the parse span, the batch.hold stage and a
    device.dispatch span naming its rung."""
    setup_index(server.port)
    status, _, _ = post(server.port, "/index/i/query?profile=true", "Count(Row(f=1))")
    assert status == 200
    names = {sp["name"] for t in server.trace_recorder.traces() for sp in t["spans"]}
    assert {"parse", "batch.hold", "device.dispatch"} <= names, names


def test_scheduler_defaults_match_jax_package():
    """The copied scheduler keeps the reference's config defaults."""
    from pilosa_tpu.sched import SchedulerConfig as JConfig

    assert SchedulerConfig() == SchedulerConfig(**vars(JConfig()))


def test_http_errors_are_typed(server):
    setup_index(server.port)
    status, _, body = post(server.port, "/index/nosuch/query", "Count(Row(f=1))")
    assert status == 400 and "not found" in json.loads(body)["error"]
