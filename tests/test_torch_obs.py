"""The cases of tests/test_obs.py, run against the port on the CPU.

Per-query tracing tests (docs/observability.md): recorder units,
cross-node propagation/splicing, trace-shaped chaos assertions (host
rung under an open plane breaker, two dispatch spans across a 409
re-route), the /debug/traces + /metrics HTTP surface, slow-query log,
and the bounded stats histograms that replaced raw timing lists."""

import json
import socket
import time
import urllib.request

import numpy as np
import pytest

from pilosa_tpu_torch import failpoints, obs
from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.health import ResilienceConfig
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.holder import Holder as _Holder
from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.logger import BufferLogger
from pilosa_tpu_torch.obs import NOP_SPAN, ObsConfig, TraceRecorder
from pilosa_tpu_torch.obs.metrics import render_prometheus
from pilosa_tpu_torch.server.client import ClientError, InternalClient
from pilosa_tpu_torch.server.server import Server as _Server
from pilosa_tpu_torch.stats import Histogram, InMemoryStatsClient


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


def Holder(*args, **kw):
    """The port's holder on the CPU."""
    kw.setdefault("device", "cpu")
    return _Holder(*args, **kw)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------- trace assertions
#
# THE helpers trace-shaped tests go through: pilint R7b validates every
# constant span name passed to them against the real recording sites, so
# a typo'd assertion cannot silently become a no-op test.


def _walk_spans(trace_dict):
    for sp in trace_dict.get("spans", []):
        yield sp
        for ch in sp.get("children", []) or []:
            yield ch


def find_spans(trace_dict, name):
    """Spans (incl. spliced remote children) named exactly `name`."""
    return [sp for sp in _walk_spans(trace_dict) if sp["name"] == name]


def find_span(trace_dict, name):
    spans = find_spans(trace_dict, name)
    assert spans, (
        f"span {name!r} missing from trace; have "
        f"{sorted({s['name'] for s in _walk_spans(trace_dict)})}")
    return spans[0]


def remote_spans(trace_dict):
    return [sp for sp in trace_dict.get("spans", [])
            if sp["name"].startswith("remote:")]


# ------------------------------------------------------------- histograms


def test_histogram_log_buckets_bounded():
    h = Histogram()
    for v in (0.01, 0.5, 3.0, 3.9, 100.0, 1e9):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 6
    assert snap["sum"] == pytest.approx(0.01 + 0.5 + 3.0 + 3.9 + 100.0 + 1e9)
    assert snap["min"] == 0.01 and snap["max"] == 1e9
    # 3.0 and 3.9 land in the le=4.0 bucket; 1e9 overflows to +Inf.
    assert snap["buckets"][repr(4.0)] == 2
    assert snap["buckets"]["+Inf"] == 1
    # Memory stays O(buckets) no matter how many observations land.
    for _ in range(10000):
        h.observe(1.0)
    assert len(h.buckets) == len(Histogram.BOUNDS) + 1
    assert h.count == 10006


def test_stats_timings_are_bounded_histograms():
    """The old per-key list grew forever (stats.py:91 leak); timings are
    now fixed log-bucketed histograms and snapshot() serves the
    count/sum/buckets shape /metrics needs."""
    s = InMemoryStatsClient()
    for i in range(5000):
        s.timing("QueryMs", float(i % 7))
    snap = s.snapshot()["timings"]["QueryMs"]
    assert snap["count"] == 5000
    assert "buckets" in snap and "sum" in snap
    # Bounded: the histogram object holds buckets, not 5000 floats.
    hist = s.timings["QueryMs"]
    assert len(hist.buckets) == len(Histogram.BOUNDS) + 1


# ----------------------------------------------------------- nop fast path


def test_disabled_span_is_shared_nop_singleton():
    """Disabled-mode fast path: with no active trace, span() returns the
    ONE module-level no-op object — zero allocation per stage site."""
    assert obs.current() is None
    assert obs.span("parse") is NOP_SPAN
    assert obs.span("gather") is NOP_SPAN  # same object every call
    with obs.span("device.dispatch") as sp:
        sp.tag(rung="device")  # all methods are no-ops
    obs.record("reduce", 1.0)  # no trace: silently dropped

    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=7)
    t = rec.maybe_start("i", "q")
    token = obs.activate(t)
    try:
        assert obs.span("parse") is not NOP_SPAN
    finally:
        obs.deactivate(token)


def test_sample_rate_zero_starts_nothing():
    rec = TraceRecorder(ObsConfig(sample_rate=0.0))
    assert not rec.enabled
    assert rec.maybe_start("i", "q") is None


# ---------------------------------------------------------------- sampler


def test_sampler_deterministic_under_seed():
    cfg = ObsConfig(sample_rate=0.5)
    a = TraceRecorder(cfg, seed=1234)
    b = TraceRecorder(cfg, seed=1234)
    decisions_a = [a.maybe_start("i", "q") is not None for _ in range(64)]
    decisions_b = [b.maybe_start("i", "q") is not None for _ in range(64)]
    assert decisions_a == decisions_b
    assert any(decisions_a) and not all(decisions_a)
    # Sampled traces get deterministic ids too.
    c = TraceRecorder(cfg, seed=1234)
    ids_a = [t.trace_id for t in
             filter(None, (a.maybe_start("i", "q") for _ in range(64)))]
    ids_c0 = [t.trace_id for t in
              filter(None, (c.maybe_start("i", "q") for _ in range(128)))]
    assert ids_a == ids_c0[len(ids_a):] or ids_a  # ids are non-empty hex
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids_a)


# ------------------------------------------------------------------- ring


def test_ring_bounded_newest_first_and_filters():
    rec = TraceRecorder(ObsConfig(sample_rate=1.0, ring_size=4), seed=9)
    for i in range(10):
        t = rec.maybe_start("idx-even" if i % 2 == 0 else "idx-odd", f"q{i}")
        t.record("parse", float(i))
        rec.finish(t)
    out = rec.traces()
    assert len(out) == 4  # ring bound
    assert [o["pql"] for o in out] == ["q9", "q8", "q7", "q6"]  # newest first
    assert all(find_span(o, "parse") for o in out)
    only_even = rec.traces(index="idx-even")
    assert {o["index"] for o in only_even} == {"idx-even"}
    assert len(rec.traces(limit=2)) == 2
    assert rec.snapshot()["traces_finished"] == 10


def test_straggler_span_after_finish_is_dropped():
    """An abandoned hedge leg completing AFTER the winning leg's finish
    must not mutate the published trace: two /debug/traces scrapes of
    one trace id must agree."""
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=4)
    t = rec.maybe_start("i", "q")
    straggler = t.span("remote:slow-peer")
    straggler.__enter__()
    with t.span("remote:fast-peer"):
        pass
    rec.finish(t)
    published = t.to_dict()
    straggler.__exit__(None, None, None)  # hedge loser answers late
    assert t.to_dict()["spans"] == published["spans"]
    assert t.to_dict()["spans_dropped"] == 1
    # Histograms saw only the published span set.
    assert set(rec.stage_histograms()) == {"remote:fast-peer"}


def test_trace_span_cap():
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=3)
    t = rec.maybe_start("i", "q")
    for i in range(600):
        t.record("parse", 0.1)
    rec.finish(t)
    d = t.to_dict()
    assert len(d["spans"]) == 512
    assert d["spans_dropped"] == 88


# ------------------------------------------------------- summary + splice


def test_summary_header_bounded_and_truncating():
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=5)
    t = rec.maybe_start("i", "q")
    for i in range(50):
        t.record("gather", 1.0, kind="cold", n=i)
    rec.finish(t)
    full = t.summary_header(100000)
    assert len(json.loads(full)["spans"]) == 50
    small = t.summary_header(400)
    assert len(small) <= 400
    parsed = json.loads(small)  # still valid JSON after truncation
    assert parsed["truncated"] > 0
    assert parsed["id"] == t.trace_id


def test_splice_valid_oversized_and_garbage():
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=6)
    t = rec.maybe_start("i", "q")
    sp = t.span("remote:peer1")
    with sp:
        pass
    good = json.dumps({"id": "x", "ms": 3.0,
                       "spans": [["gather", 0.1, 2.0, {"kind": "cold"}]]})
    sp.splice(good)
    assert sp.children == [("gather", 0.1, 2.0, {"kind": "cold"})]

    # Oversized peer summary: truncated (tagged), never an error.
    sp2 = t.span("remote:peer2")
    with sp2:
        pass
    sp2.splice("x" * 100000)
    assert sp2.children is None
    assert sp2.tags["summary_truncated"] is True

    # Garbage: dropped with a tag, never an error.
    sp3 = t.span("remote:peer3")
    with sp3:
        pass
    sp3.splice("{not json")
    assert sp3.children is None
    assert "summary_error" in sp3.tags


def test_adopt_header_validation():
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=8)
    t = rec.adopt("deadbeefcafe0123:1", index="i")
    assert t is not None and t.trace_id == "deadbeefcafe0123" and t.adopted
    assert rec.adopt("") is None
    assert rec.adopt("x" * 200) is None  # id too long
    assert rec.adopt("bad id!:1") is None  # junk chars
    assert rec.adopt("abc123:0") is None  # explicit not-sampled flag


# --------------------------------------------------------- slow-query log


def test_slow_query_log_fires_once_with_breakdown(fake_clock):
    log = BufferLogger()
    rec = TraceRecorder(ObsConfig(sample_rate=1.0, slow_query_ms=20.0),
                        logger=log, clock=fake_clock, seed=11)
    fast = rec.maybe_start("i", "Count(Row(f=1))")
    fake_clock.advance(0.005)
    rec.finish(fast)
    assert rec.snapshot()["slow_queries"] == 0
    assert not [l for l in log.lines if "[obs]" in l[1]]

    slow = rec.maybe_start("i", "Count(Row(f=2))")
    token = obs.activate(slow)
    try:
        with obs.span("gather") as sp:
            fake_clock.advance(0.030)
            sp.tag(kind="cold")
    finally:
        obs.deactivate(token)
    rec.finish(slow)
    rec.finish(slow)  # idempotent: logged once
    lines = [l[1] for l in log.lines if "[obs] slow query" in l[1]]
    assert len(lines) == 1
    assert "Count(Row(f=2))" in lines[0]
    assert "gather=30.0ms" in lines[0]
    assert slow.trace_id in lines[0]
    assert rec.snapshot()["slow_queries"] == 1


# ------------------------------------------------------------- prometheus


_PROM_LINE = (
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z0-9_]+="[^"]*"(,[a-zA-Z0-9_]+="[^"]*")*\})? '
    r"[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|inf|nan)$"
)


def _assert_valid_prometheus(text):
    import re

    families = set()
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            fam = line.split()[2]
            assert fam not in families, f"duplicate TYPE for {fam}"
            families.add(fam)
            continue
        assert re.match(_PROM_LINE, line), f"bad exposition line: {line!r}"
    return families


def test_render_prometheus_shapes():
    h = Histogram()
    for v in (0.5, 3.0, 1e9):
        h.observe(v)
    groups = {
        "scheduler": {"admitted": 7, "waiting": {"interactive": 0},
                      "peers": {"n1": "closed"}},  # strings skipped
        "timings": {"SchedulerWaitMs": h.snapshot()},
        "counters": {"Weird|name:1": 2.5},
        "flags": {"on": True},
    }
    text = render_prometheus(groups, {"parse": h.snapshot()})
    fams = _assert_valid_prometheus(text)
    assert "pilosa_scheduler_admitted" in fams
    assert "pilosa_scheduler_waiting_interactive" in fams
    assert "pilosa_counters_weird_name_1" in fams
    assert "pilosa_timings_schedulerwaitms" in fams
    assert "pilosa_stage_duration_ms" in fams
    # Histogram series are cumulative and end at +Inf == count.
    assert 'pilosa_stage_duration_ms_bucket{stage="parse",le="+Inf"} 3' in text
    assert 'pilosa_stage_duration_ms_count{stage="parse"} 3' in text
    assert "pilosa_flags_on 1" in text
    assert "pilosa_scheduler_peers" not in text  # non-numeric leaf skipped


# ------------------------------------------------------------ HTTP surface


@pytest.fixture
def one_node():
    s = Server(cache_flush_interval=0, member_monitor_interval=0)
    s.open()
    try:
        idx = s.holder.create_index("t")
        fld = idx.create_field("f")
        fld.import_bits(np.zeros(64, dtype=np.uint64),
                        np.arange(64, dtype=np.uint64))
        yield s
    finally:
        s.close()


def _get_json(host, path):
    with urllib.request.urlopen(f"http://{host}{path}") as r:
        return json.load(r)


def test_single_node_trace_surface(one_node):
    h = f"localhost:{one_node.port}"
    c = InternalClient()
    assert c.query(h, "t", "Count(Row(f=0))")["results"] == [64]
    traces = _get_json(h, "/debug/traces")["traces"]
    assert len(traces) == 1
    tr = traces[0]
    assert tr["index"] == "t" and tr["pql"] == "Count(Row(f=0))"
    assert tr["status"] == "ok" and tr["duration_ms"] > 0
    for name in ("parse", "sched.wait", "batch.hold", "gather",
                 "device.dispatch", "executor.fanout", "reduce"):
        find_span(tr, name)
    assert find_span(tr, "gather")["tags"]["kind"] == "cold"
    assert find_span(tr, "device.dispatch")["tags"]["rung"] == "device"
    # min-ms filter: an impossible threshold returns nothing.
    assert _get_json(h, "/debug/traces?min-ms=1e9")["traces"] == []
    # /debug/vars obs group.
    dv = _get_json(h, "/debug/vars")
    assert dv["obs"]["traces_finished"] == 1
    # /metrics: valid exposition covering existing groups + stage hists.
    with urllib.request.urlopen(f"http://{h}/metrics") as r:
        assert "text/plain" in r.headers["Content-Type"]
        text = r.read().decode()
    fams = _assert_valid_prometheus(text)
    assert "pilosa_scheduler_admitted" in fams
    assert "pilosa_engine_cache_count_dispatches" in fams
    assert "pilosa_obs_traces_finished" in fams
    assert 'stage="parse"' in text and 'stage="gather"' in text


def test_client_stamped_header_cannot_force_tracing(one_node):
    """Adoption is for coordinator-forwarded (remote=true) sub-queries
    only: an ordinary client stamping X-Pilosa-Trace must not bypass the
    sampler (with sample-rate 0 it would force span recording, ring
    retention of attacker PQL, and slow-query log lines the operator
    turned off)."""
    one_node.trace_recorder.config.sample_rate = 0.0
    h = f"localhost:{one_node.port}"
    req = urllib.request.Request(
        f"http://{h}/index/t/query", data=b"Count(Row(f=0))",
        headers={"X-Pilosa-Trace": "deadbeefcafe0123:1"}, method="POST")
    with urllib.request.urlopen(req) as r:
        assert json.load(r)["results"] == [64]
    dv = _get_json(h, "/debug/vars")["obs"]
    assert dv["traces_adopted"] == 0 and dv["traces_started"] == 0
    assert _get_json(h, "/debug/traces")["traces"] == []


def test_debug_traces_bad_params_are_400(one_node):
    h = f"localhost:{one_node.port}"
    for qs in ("min-ms=abc", "limit=xyz"):
        try:
            urllib.request.urlopen(f"http://{h}/debug/traces?{qs}")
            raise AssertionError("expected HTTPError")
        except urllib.error.HTTPError as e:
            assert e.code == 400, (qs, e.code)


def test_sampling_disabled_serves_untraced():
    s = Server(cache_flush_interval=0, member_monitor_interval=0,
               obs_config=ObsConfig(sample_rate=0.0))
    s.open()
    try:
        idx = s.holder.create_index("t")
        idx.create_field("f").import_bits(
            np.zeros(8, dtype=np.uint64), np.arange(8, dtype=np.uint64))
        h = f"localhost:{s.port}"
        c = InternalClient()
        assert c.query(h, "t", "Count(Row(f=0))")["results"] == [8]
        assert _get_json(h, "/debug/traces")["traces"] == []
        assert _get_json(h, "/debug/vars")["obs"]["traces_started"] == 0
    finally:
        s.close()


# -------------------------------------------------- cross-node (3 nodes)


@pytest.fixture
def cluster3(tmp_path):
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        s = Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=1,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,
            executor_workers=0,
        )
        s.open()
        servers.append(s)
    yield servers
    for s in servers:
        s.close()


def test_three_node_fanout_single_trace_tree(cluster3):
    """THE acceptance trace: a fan-out Count over 3 nodes yields ONE
    tree on the coordinator — local stage spans plus a remote:<peer>
    span per hop whose children are the peer's own spans, spliced from
    the size-bounded summary header (offsets relative to the hop, so
    peer clock skew cannot corrupt the tree)."""
    c = InternalClient()
    h0 = f"localhost:{cluster3[0].port}"
    c.create_index(h0, "t")
    c.create_field(h0, "t", "f")
    time.sleep(0.05)
    # One bit per shard 0..2: with ModHasher the three shards spread
    # across the three nodes, so the Count must fan out.
    c.import_bits(h0, "t", "f", [(1, s * SHARD_WIDTH + 5) for s in range(3)])
    time.sleep(0.05)
    assert c.query(h0, "t", "Count(Row(f=1))")["results"] == [3]

    traces = _get_json(h0, "/debug/traces?index=t")["traces"]
    tree = next(t for t in traces if remote_spans(t)
                and t["pql"] == "Count(Row(f=1))")
    # Coordinator stages.
    for name in ("parse", "sched.wait", "executor.fanout", "reduce"):
        find_span(tree, name)
    # Remote hops: at least one peer served shards, each hop carries the
    # peer's spliced sub-spans (the peer ran the device path).
    hops = remote_spans(tree)
    assert hops, tree
    for hop in hops:
        child_names = {ch["name"] for ch in hop.get("children", [])}
        assert "parse" in child_names, hop
        assert "device.dispatch" in child_names, hop
        assert "gather" in child_names, hop
    # The whole tree covers every acceptance stage.
    all_names = {sp["name"] for sp in _walk_spans(tree)}
    for name in ("parse", "sched.wait", "batch.hold", "gather",
                 "device.dispatch", "reduce"):
        assert name in all_names, (name, sorted(all_names))

    # Peer rings hold the ADOPTED twin under the same trace id: one
    # logical trace across nodes.
    tid = tree["id"]
    adopted = []
    for s in cluster3[1:]:
        hp = f"localhost:{s.port}"
        adopted += [t for t in _get_json(hp, "/debug/traces")["traces"]
                    if t["id"] == tid]
    assert adopted, "no peer recorded the forwarded trace id"


# ------------------------------------------- trace-shaped chaos assertions


def test_breaker_open_trace_shows_host_rung(tmp_path):
    """DEGRADE-shaped: once the plane breaker opens, a served query's
    trace must show the HOST rung — the evidence that degraded serving
    took the ladder, not the device."""
    s = Server(
        data_dir=str(tmp_path / "n0"), cache_flush_interval=0,
        member_monitor_interval=0,
        resilience_config=ResilienceConfig(
            device_breaker_failures=1, device_breaker_backoff=60.0),
    )
    s.open()
    try:
        idx = s.holder.create_index("t")
        idx.create_field("f").import_bits(
            np.zeros(32, dtype=np.uint64), np.arange(32, dtype=np.uint64))
        h = f"localhost:{s.port}"
        c = InternalClient()
        failpoints.configure("device-dispatch", "error")
        try:
            # Opens the plane breaker; the request itself serves one rung
            # down (host) in-flight.
            assert c.query(h, "t", "Count(Row(f=0))")["results"] == [32]
            # Routed to host BEFORE any dispatch now.
            assert c.query(h, "t", "Count(Row(f=0))")["results"] == [32]
        finally:
            failpoints.reset()
        traces = _get_json(h, "/debug/traces")["traces"]
        routed = traces[0]  # newest: the breaker-open query
        dispatches = find_spans(routed, "device.dispatch")
        assert dispatches and all(
            d["tags"]["rung"] == "host" for d in dispatches), routed
        # The first (fallback) trace shows BOTH rungs: the failed device
        # attempt and the host rung that answered.
        fallback = traces[1]
        rungs = {d["tags"]["rung"]
                 for d in find_spans(fallback, "device.dispatch")}
        assert rungs == {"device", "host"}, fallback
    finally:
        s.close()


def test_409_reroute_trace_shows_two_dispatch_spans(fake_clock):
    """FAULT/rebalance-shaped: a routing-conflict 409 re-route must leave
    TWO dispatch spans in the trace — the refused hop and the re-routed
    one — so an operator can see the re-route happened and what it cost."""

    class RerouteClient:
        def __init__(self):
            self.calls = []

        def query_node(self, node, index, query, shards=None, remote=True,
                       **kw):
            self.calls.append(node.id)
            if len(self.calls) == 1:
                raise ClientError("shard moved", status=409)
            return [len(shards or [])]

    nodes = [Node(id="n0"), Node(id="n1"), Node(id="n2")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=2,
                      hasher=ModHasher())
    cluster.health.configure(ResilienceConfig().validate(), clock=fake_clock)
    holder = Holder(None)
    holder.open()
    holder.create_index("hx").create_field("f")
    client = RerouteClient()
    ex = Executor(holder, cluster=cluster, client=client, workers=0)
    # A shard owned by n1+n2 (never n0) so the dispatch is remote.
    shard = next(
        s for s in range(8)
        if not any(n.id == "n0" for n in cluster.shard_nodes("hx", s)))

    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=13)
    trace = rec.maybe_start("hx", "Count(Row(f=1))")
    token = obs.activate(trace)
    try:
        ex.execute("hx", "Count(Row(f=1))", shards=[shard])
    finally:
        obs.deactivate(token)
        rec.finish(trace)
    assert len(client.calls) == 2 and client.calls[0] != client.calls[1]
    tree = trace.to_dict()
    hops = remote_spans(tree)
    assert len(hops) == 2, tree
    # First hop carries the routing-conflict error tag; second answered.
    assert hops[0]["tags"].get("error") == "ClientError", hops
    assert "error" not in (hops[1].get("tags") or {}), hops


# ------------------------------------------------------------ config knobs


def test_obs_config_toml_env_flag_precedence(tmp_path, monkeypatch):
    from pilosa_tpu_torch.config import Config

    p = tmp_path / "c.toml"
    p.write_text("[obs]\nsample-rate = 0.25\nring-size = 32\n"
                 "slow-query-ms = 15.0\n")
    cfg = Config.load(str(p))
    assert cfg.obs.sample_rate == 0.25
    assert cfg.obs.ring_size == 32
    assert cfg.obs.slow_query_ms == 15.0
    monkeypatch.setenv("PILOSA_TPU_OBS_SAMPLE_RATE", "0.5")
    cfg = Config.load(str(p))
    assert cfg.obs.sample_rate == 0.5  # env beats file
    cfg = Config.load(str(p), flags={"obs_sample_rate": 1.0,
                                     "obs_ring_size": 8})
    assert cfg.obs.sample_rate == 1.0 and cfg.obs.ring_size == 8
    # Round-trips through to_toml (env cleared: it would rightly win).
    monkeypatch.delenv("PILOSA_TPU_OBS_SAMPLE_RATE")
    (tmp_path / "dump.toml").write_text(cfg.to_toml())
    cfg2 = Config.load(str(tmp_path / "dump.toml"))
    assert cfg2.obs.sample_rate == 1.0 and cfg2.obs.ring_size == 8
    # Validation rejects nonsense at build time.
    with pytest.raises(ValueError):
        ObsConfig(sample_rate=2.0).validate()
    with pytest.raises(ValueError):
        ObsConfig(ring_size=-1).validate()
    with pytest.raises(ValueError):
        ObsConfig(slow_query_ms=-1.0).validate()


# -------------------------------------- inside device.dispatch (the port)


# Spans only the port records. pilint R7b checks every name a test file
# passes to find_span() against the reference's recording sites
# (tests/test_pilint.py), where these do not exist, so each assertion on
# one carries `allow-span`; test_port_span_names_are_recorded_and_documented
# holds each name to a recording site of the port and a row of the port's
# span table.
ENGINE_SPANS = ("engine.fingerprint", "engine.stack", "k1.stage", "device.sync")


def test_port_span_names_are_recorded_and_documented():
    import ast
    import os

    from tools.pilint.rules import collect_span_names, parse_span_docs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    recorded = set()
    for dp, _, names in os.walk(os.path.join(root, "pilosa_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dp, n)) as f:
                    recorded |= collect_span_names(ast.parse(f.read()))
    with open(os.path.join(root, "pilosa_tpu_torch", "obs", "README.md")) as f:
        documented = parse_span_docs(f.read())
    for name in ENGINE_SPANS + ("gc.pause",):
        assert name in recorded and name in documented, name


def _inside(sp, outer, slack=0.002):
    """`sp` lies within `outer` (to_dict rounds both to microseconds)."""
    return (outer["start_ms"] - slack <= sp["start_ms"]
            and sp["start_ms"] + sp["dur_ms"]
            <= outer["start_ms"] + outer["dur_ms"] + slack)


def _engine_node(tmp_path, **kw):
    s = Server(data_dir=str(tmp_path / "node"), cache_flush_interval=0,
               member_monitor_interval=0, **kw)
    s.open()
    idx = s.holder.create_index("t")
    for name, step in (("f", 1), ("g", 2)):
        fld = idx.create_field(name)
        for row in range(4):
            fld.import_bits(np.full(64, row, dtype=np.uint64),
                            np.arange(0, 64 * step, step, dtype=np.uint64))
    return s


def _assert_engine_spans_inside_dispatch(tr):
    disp = [sp for sp in find_spans(tr, "device.dispatch")
            if sp["tags"]["rung"] == "device"]
    assert len(disp) == 1, tr
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
    fingerprints = find_spans(tr, "engine.fingerprint")
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
    stacks = find_spans(tr, "engine.stack")
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/ops/kernels.py)
    stages = find_spans(tr, "k1.stage")
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
    syncs = find_spans(tr, "device.sync")
    for spans in (fingerprints, stacks, stages, syncs):
        assert spans and all(_inside(sp, disp[0]) for sp in spans), tr
    sites = {sp["tags"]["site"] for sp in fingerprints}
    assert {"memo", "stack", "leaf"} <= sites, sites
    assert [sp["tags"]["outcome"] for sp in stacks] == ["build"]
    assert [sp["tags"] for sp in stages] == [{"variant": "plain", "q": 1, "blocks": 1}]


def test_http_count_traces_the_engine_inside_device_dispatch(tmp_path):
    s = _engine_node(tmp_path)
    try:
        h = f"localhost:{s.port}"
        c = InternalClient()
        assert c.query(h, "t", "Count(Intersect(Row(f=1), Row(g=1)))")["results"] == [32]
        tr = _get_json(h, "/debug/traces")["traces"][0]
        _assert_engine_spans_inside_dispatch(tr)
        # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
        assert find_span(tr, "engine.fingerprint")["tags"]["leaves"] == 2
        # Another query over the same leaves misses the memo and finds
        # the stack resident; a write to a member fragment refreshes the
        # stack by a scatter.
        assert c.query(h, "t", "Count(Union(Row(f=1), Row(g=1)))")["results"] == [96]
        tr = _get_json(h, "/debug/traces?limit=1")["traces"][0]
        # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
        assert find_span(tr, "engine.stack")["tags"]["outcome"] == "hit"
        c.query(h, "t", "Set(5000, g=3)")
        assert c.query(h, "t", "Count(Intersect(Row(f=1), Row(g=1)))")["results"] == [32]
        tr = _get_json(h, "/debug/traces?limit=1")["traces"][0]
        # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
        assert find_span(tr, "engine.stack")["tags"]["outcome"] == "delta"
    finally:
        s.close()


def test_a_stack_built_by_another_thread_is_tagged_waited(one_node, monkeypatch):
    import threading

    from pilosa_tpu_torch.plan.signature import Leaf

    eng = one_node.executor.engine
    leaves = [Leaf("f", "standard", 0)]
    building = threading.Event()
    slow = eng._leaf_tensor

    def leaf_tensor(*a):
        building.set()
        time.sleep(0.3)
        return slow(*a)

    monkeypatch.setattr(eng, "_leaf_tensor", leaf_tensor)
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=23)
    traces = {}

    def stack(who):
        t = traces[who] = rec.maybe_start("t", who)
        token = obs.activate(t)
        try:
            eng._stacked_leaf_tensor("t", leaves, (0,))
        finally:
            obs.deactivate(token)
            rec.finish(t)

    first = threading.Thread(target=stack, args=("first",))
    first.start()
    assert building.wait(10)
    stack("second")
    first.join(10)
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/parallel/engine.py)
    outcomes = {who: find_span(t.to_dict(), "engine.stack")["tags"]["outcome"]
                for who, t in traces.items()}
    assert outcomes == {"first": "build", "second": "waited"}


def test_watchdog_dispatch_still_records_into_the_request_trace(tmp_path):
    from pilosa_tpu_torch.parallel import EngineConfig

    s = _engine_node(tmp_path, engine_config=EngineConfig(dispatch_watchdog=30.0))
    try:
        h = f"localhost:{s.port}"
        assert InternalClient().query(h, "t", "Count(Intersect(Row(f=2), Row(g=2)))")[
            "results"] == [32]
        # The dispatch ran on the watchdog's pool thread.
        assert s.executor.engine._watchdog_pool is not None
        _assert_engine_spans_inside_dispatch(_get_json(h, "/debug/traces")["traces"][0])
    finally:
        s.close()


def test_sample_rate_zero_records_no_engine_span(tmp_path, monkeypatch):
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import engine as engine_mod

    seen = []

    def spy(name, **tags):
        sp = obs.span(name, **tags)
        seen.append((name, sp))
        return sp

    monkeypatch.setattr(kernels, "obs_span", spy)
    monkeypatch.setattr(engine_mod, "obs_span", spy)
    s = _engine_node(tmp_path, obs_config=ObsConfig(sample_rate=0.0))
    try:
        h = f"localhost:{s.port}"
        assert InternalClient().query(h, "t", "Count(Intersect(Row(f=3), Row(g=3)))")[
            "results"] == [32]
        assert {n for n, _ in seen} >= set(ENGINE_SPANS)
        assert all(sp is NOP_SPAN for _, sp in seen)
        assert _get_json(h, "/debug/traces")["traces"] == []
        assert _get_json(h, "/debug/vars")["obs"]["traces_started"] == 0
    finally:
        s.close()


def test_gc_collect_inside_a_trace_records_gc_pause():
    import gc

    hook = obs.GcHook()
    hook.open()
    try:
        rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=21)
        t = rec.maybe_start("i", "q")
        token = obs.activate(t)
        try:
            with obs.span("parse"):
                gc.collect()
        finally:
            obs.deactivate(token)
        rec.finish(t)
        # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/obs/trace.py)
        pause = find_span(t.to_dict(), "gc.pause")
        assert pause["tags"] == {"gen": 2}
        assert _inside(pause, find_span(t.to_dict(), "parse"))
        snap = hook.snapshot()
        assert snap["gcCollectionsGen2"] >= 1 and snap["gcPauseMsGen2"] > 0
        assert snap["gcPauseMs"] == pytest.approx(
            sum(snap[f"gcPauseMsGen{g}"] for g in range(3)))
    finally:
        hook.close()
    before = dict(hook.snapshot())
    gc.collect()
    assert hook.snapshot() == before  # closed: counts nothing


def test_gc_under_a_held_trace_lock_does_not_deadlock():
    """A collection can start inside Trace._append with the trace's lock
    held: the hook notes the pause without taking it, and the pause lands
    at the trace's finish."""
    import gc
    import threading

    hook = obs.GcHook()
    hook.open()
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=22)
    t = rec.maybe_start("i", "q")

    def run():
        token = obs.activate(t)
        try:
            with t._lock:
                gc.collect()
        finally:
            obs.deactivate(token)
        rec.finish(t)

    th = threading.Thread(target=run, daemon=True)
    try:
        th.start()
        th.join(timeout=30)
        assert not th.is_alive(), "a collection under the trace lock deadlocked"
    finally:
        hook.close()
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/obs/trace.py)
    assert find_span(t.to_dict(), "gc.pause")["tags"]["gen"] == 2


def test_gc_pause_noted_on_one_thread_lands_when_another_finishes():
    """The pause is noted on the trace itself: a collection on a worker
    thread with no later span exit there still lands when the request's
    thread finishes the trace, and is not counted as a dropped span."""
    import gc
    import threading

    hook = obs.GcHook()
    hook.open()
    rec = TraceRecorder(ObsConfig(sample_rate=1.0), seed=24)
    t = rec.maybe_start("i", "q")

    def worker():
        token = obs.activate(t)
        try:
            gc.collect()
        finally:
            obs.deactivate(token)

    try:
        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
        rec.finish(t)
    finally:
        hook.close()
    # pilint: allow-span(port-only span, recorded in pilosa_tpu_torch/obs/trace.py)
    assert find_span(t.to_dict(), "gc.pause")["tags"]["gen"] == 2
    assert rec.snapshot()["spans_dropped"] == 0


def test_every_open_gc_hook_counts_every_collection():
    import gc

    first, second = obs.GcHook(), obs.GcHook()
    first.open()
    second.open()
    try:
        gc.collect()
        assert first.snapshot()["gcCollectionsGen2"] >= 1
        assert second.snapshot()["gcCollectionsGen2"] >= 1
        first.close()
        # The callback stays installed while a hook is open.
        frozen = dict(first.snapshot())
        n = second.snapshot()["gcCollectionsGen2"]
        gc.collect()
        assert second.snapshot()["gcCollectionsGen2"] >= n + 1
        assert first.snapshot() == frozen
    finally:
        first.close()
        second.close()


def test_server_gc_gauges_and_trace_start_on_the_recorder_clock(one_node):
    import gc

    t0 = time.monotonic()
    trace = one_node.trace_recorder.maybe_start("t", "q")
    assert t0 <= trace.start_mono <= time.monotonic()
    gc.collect()
    gauges = _get_json(f"localhost:{one_node.port}", "/debug/vars")["gauges"]
    assert gauges["gcCollectionsGen2"] >= 1 and gauges["gcPauseMs"] > 0


def test_debug_profile_shows_the_spans_as_ranges(tmp_path):
    import threading

    s = _engine_node(tmp_path)
    try:
        h = f"localhost:{s.port}"
        got = {}

        def capture():
            req = urllib.request.Request(f"http://{h}/debug/profile?seconds=2",
                                         data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got.update(json.load(r))

        th = threading.Thread(target=capture)
        th.start()
        c = InternalClient()
        deadline = time.monotonic() + 60
        row = 0
        while th.is_alive() and time.monotonic() < deadline:
            c.query(h, "t", f"Count(Intersect(Row(f={row % 4}), Row(g={row // 4 % 4})))")
            c.query(h, "t", f"Set({10000 + row}, g=3)")  # defeats the memo
            row += 1
        th.join(timeout=60)
        with open(f"{got['path']}/trace.json") as f:
            names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
        for name in ("device.dispatch",) + ENGINE_SPANS[:3]:
            assert name in names, name
        # Outside a capture no range is opened.
        from pilosa_tpu_torch.obs import trace as trace_mod

        assert trace_mod._profile_range is None
    finally:
        s.close()
