"""tests/test_replication.py against the port (servers on the CPU).

Durable write replication: hinted handoff, tunable write consistency,
hint-aware anti-entropy (docs/durability.md "Write-path consistency",
`pilosa_tpu/cluster/hints.py`).

Three tiers of proof:
  - unit: hint record codec + torn tails, TTL/budget/marker lifecycle,
    delivery state machine against a fake client, consistency math, the
    typed retryable 503 shape;
  - integration: a 3-node replica_n=3 cluster where a replica flaps
    dead -> alive under write-consistency=quorum (THE tier-1 chaos
    test, seed-pinned, fake breaker clock) — every ack met its level,
    hints drain to byte-identical fragments, breakers/health converge;
  - the subprocess kill -9 durability twin lives in
    tests/test_durability.py (torn hint tail truncates, never replays
    garbage).
"""

import io
import os
import socket
import time

import numpy as np
import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.health import CLOSED, HealthRegistry, ResilienceConfig
from pilosa_tpu_torch.cluster.hints import (
    HintRecord,
    HintStore,
    ReplicationConfig,
    decode_records,
    encode_record,
)
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.errors import WriteConsistencyError
from pilosa_tpu_torch.server.client import ClientError, InternalClient
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    return _Server(*args, device="cpu", **kw)
from pilosa_tpu_torch.storage.bitmap import (
    OP_ADD,
    OP_REMOVE,
    decode_op_records,
    encode_bulk_op,
    encode_op,
)

from .conftest import FakeClock


class _Frag:
    """Fragment-shaped identity carrier for HintStore.add."""

    def __init__(self, index="i", field="f", view="standard", shard=0):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard


class _Node:
    def __init__(self, node_id, uri=None):
        self.id = node_id
        self.uri = uri or node_id


# ------------------------------------------------------------- unit: config


def test_replication_config_validation_and_levels():
    cfg = ReplicationConfig().validate()
    assert cfg.write_consistency == "one"
    assert cfg.required_owners(3) == 1
    assert ReplicationConfig(
        write_consistency="quorum").required_owners(3) == 2
    assert ReplicationConfig(
        write_consistency="quorum").required_owners(2) == 2
    assert ReplicationConfig(
        write_consistency="quorum").required_owners(5) == 3
    assert ReplicationConfig(write_consistency="all").required_owners(3) == 3
    with pytest.raises(ValueError):
        ReplicationConfig(write_consistency="most").validate()
    with pytest.raises(ValueError):
        ReplicationConfig(hint_ttl=0).validate()
    with pytest.raises(ValueError):
        ReplicationConfig(deliver_batch_bytes=0).validate()


# -------------------------------------------------------------- unit: codec


def test_hint_record_roundtrip_and_torn_tail():
    rec = HintRecord(1234.5, "idx", "fld", "standard_2020", 42,
                     encode_op(OP_ADD, 7))
    blob = encode_record(rec) + encode_record(
        HintRecord(1.0, "i2", "", "", 3, b""))  # marker
    out = list(decode_records(blob))
    assert len(out) == 2
    got, end1 = out[0]
    assert (got.index, got.field, got.view, got.shard) == (
        "idx", "fld", "standard_2020", 42)
    assert got.ops == rec.ops and not got.marker
    assert out[1][0].marker and out[1][0].shard == 3
    # A torn tail (half a record) stops the decode cleanly at the last
    # whole boundary; corrupt bytes stop it too.
    assert [r.shard for r, _ in decode_records(blob[:end1 + 5])] == [42]
    flipped = blob[:end1] + bytes([blob[end1] ^ 0xFF]) + blob[end1 + 1:]
    assert [r.shard for r, _ in decode_records(flipped)] == [42]


def test_decode_op_records_orders_and_strictness():
    data = (encode_op(OP_ADD, 5) + encode_bulk_op([1, 2], [3])
            + encode_op(OP_REMOVE, 5))
    recs = decode_op_records(data)
    assert [(a.tolist(), r.tolist()) for a, r in recs] == [
        ([5], []), ([1, 2], [3]), ([], [5])]
    from pilosa_tpu_torch.errors import CorruptFragmentError

    with pytest.raises(CorruptFragmentError):
        decode_op_records(data + b"\x01\x02")  # trailing garbage = fault


# -------------------------------------------------------------- unit: store


def test_hint_store_reload_truncates_torn_tail(tmp_path):
    hs = HintStore(str(tmp_path), ReplicationConfig())
    assert hs.add("peer:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    assert hs.add("peer:1", "i", 1, [(_Frag(shard=1), encode_op(OP_ADD, 2))])
    hs.close()
    log = os.path.join(str(tmp_path), "peer%3A1", "log")
    whole = os.path.getsize(log)
    with open(log, "ab") as f:
        f.write(b"\x00gar\xffbage")
    hs2 = HintStore(str(tmp_path), ReplicationConfig())
    assert hs2.pending("peer:1") == 2
    assert hs2.snapshot()["hints_truncated"] == 1
    assert os.path.getsize(log) == whole  # garbage cut, records kept
    assert [r.shard for r in hs2.records("peer:1")] == [0, 1]
    hs2.close()


def test_hint_store_budget_overflow_flags_shard(tmp_path):
    hs = HintStore(str(tmp_path),
                   ReplicationConfig(hint_max_bytes=200))
    big = encode_bulk_op(np.arange(64, dtype=np.uint64), None)
    assert hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    assert not hs.add("p:1", "i", 5, [(_Frag(shard=5), big)])
    snap = hs.snapshot()
    assert snap["hints_overflow"] == 1
    assert ("i", 5) in hs.priority_shards()
    assert ("i", 0) in hs.priority_shards()  # pending hints count too
    hs.note_synced("i", 5)
    assert ("i", 5) not in hs.priority_shards()
    hs.close()


def test_oversize_record_refused_not_wedged(tmp_path, monkeypatch):
    """A record the decoder would classify as a torn tail must be
    refused at APPEND time: once in the log it could never be decoded,
    the cursor could never pass it, and the FIFO pre-check would queue
    every later write behind a permanently wedged drain."""
    from pilosa_tpu_torch.cluster import hints as hints_mod

    monkeypatch.setattr(hints_mod, "_MAX_RECORD", 64)
    hs = HintStore(str(tmp_path), ReplicationConfig())
    big = encode_bulk_op(np.arange(32, dtype=np.uint64), None)
    assert not hs.add("p:1", "i", 3, [(_Frag(shard=3), big)])
    assert hs.pending("p:1") == 0  # nothing undecodable was appended
    assert hs.snapshot()["hints_overflow"] == 1
    assert ("i", 3) in hs.priority_shards()  # sweep owns the repair
    assert hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    hs.close()


def test_hint_append_failpoint_refuses_durably(tmp_path):
    hs = HintStore(str(tmp_path), ReplicationConfig())
    try:
        failpoints.configure("hint-append", "error", count=1)
        assert not hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
        assert hs.snapshot()["append_errors"] == 1
        assert ("i", 0) in hs.priority_shards()  # sweep backstop flagged
        assert hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    finally:
        failpoints.reset()
        hs.close()


def test_marker_hint_without_capture(tmp_path):
    hs = HintStore(str(tmp_path), ReplicationConfig())
    assert hs.add("p:1", "i", 9, None)  # no local replica -> marker
    assert hs.snapshot()["hints_markers"] == 1
    assert ("i", 9) in hs.priority_shards()
    recs = hs.records("p:1")
    assert len(recs) == 1 and recs[0].marker
    hs.close()


class _FakeHintClient:
    def __init__(self, fail=None):
        self.sent = []  # (peer_uri, index, field, view, shard, ops)
        self.fail = fail  # None | ClientError to raise

    def send_hint_ops(self, node, index, field, view, shard, data):
        if self.fail is not None:
            raise self.fail
        self.sent.append((node.uri, index, field, view, shard, data))


class _FakeCluster:
    def __init__(self, nodes, health):
        self._nodes = {n.id: n for n in nodes}
        self.health = health

    def node_by_id(self, node_id):
        return self._nodes.get(node_id)


def test_delivery_order_checkpoint_and_drain(tmp_path):
    clock = FakeClock()
    hs = HintStore(str(tmp_path), ReplicationConfig(), clock=clock)
    health = HealthRegistry(ResilienceConfig(), clock=clock)
    cluster = _FakeCluster([_Node("p:1")], health)
    for i in range(5):
        assert hs.add("p:1", "i", i % 2,
                      [(_Frag(shard=i % 2), encode_op(OP_ADD, i))])
    client = _FakeHintClient()
    assert hs.deliver_once(cluster, client) == 5
    # In order, correct addressing, drained + compacted.
    assert [s for (_, _, _, _, s, _) in client.sent] == [0, 1, 0, 1, 0]
    assert [decode_op_records(d)[0][0].tolist()
            for (*_, d) in client.sent] == [[0], [1], [2], [3], [4]]
    assert hs.pending("p:1") == 0
    snap = hs.snapshot()
    assert snap["hints_delivered"] == 5 and snap["drains"] == 1
    assert os.path.getsize(os.path.join(str(tmp_path), "p%3A1", "log")) == 0
    # Drained shards keep ONE verifying-priority-sweep flag: the FIFO
    # covers writes that saw the backlog, but a write racing the very
    # first in-flight failing forward can land newer state on the peer
    # before its hint — the sweep closes that window.
    assert {("i", 0), ("i", 1)} <= hs.priority_shards()
    hs.note_synced("i", 0)
    hs.note_synced("i", 1)
    assert hs.priority_shards() == set()
    hs.close()


def test_delivery_transport_failure_drives_breaker_and_retries(tmp_path):
    clock = FakeClock()
    hs = HintStore(str(tmp_path), ReplicationConfig(), clock=clock)
    health = HealthRegistry(
        ResilienceConfig(breaker_failures=1, breaker_backoff=1.0),
        clock=clock)
    cluster = _FakeCluster([_Node("p:1")], health)
    hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    bad = _FakeHintClient(fail=ClientError("conn refused", status=0))
    assert hs.deliver_once(cluster, bad) == 0
    assert hs.pending("p:1") == 1  # cursor NOT advanced
    assert health.state("p:1") != CLOSED  # failure recorded -> breaker
    # While the breaker backs off, delivery doesn't even try.
    good = _FakeHintClient()
    assert hs.deliver_once(cluster, good) == 0
    assert good.sent == []
    # Backoff elapses: the delivery attempt IS the half-open probe and
    # its success re-closes the breaker.
    clock.advance(1.5)
    assert hs.deliver_once(cluster, good) == 1
    assert health.state("p:1") == CLOSED
    assert hs.pending("p:1") == 0
    hs.close()


def test_delivery_4xx_skips_unreplayable_record(tmp_path):
    clock = FakeClock()
    hs = HintStore(str(tmp_path), ReplicationConfig(), clock=clock)
    health = HealthRegistry(ResilienceConfig(), clock=clock)
    cluster = _FakeCluster([_Node("p:1")], health)
    hs.add("p:1", "i", 0, [(_Frag(field="deleted"), encode_op(OP_ADD, 1))])
    hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 2))])

    class _Picky(_FakeHintClient):
        def send_hint_ops(self, node, index, field, view, shard, data):
            if field == "deleted":
                raise ClientError("field not found", status=400)
            super().send_hint_ops(node, index, field, view, shard, data)

    client = _Picky()
    assert hs.deliver_once(cluster, client) == 1
    assert hs.pending("p:1") == 0  # rejected record skipped, not wedged
    snap = hs.snapshot()
    assert snap["hints_rejected"] == 1 and snap["hints_delivered"] == 1
    assert health.state("p:1") == CLOSED  # 4xx is transport success
    hs.close()


def test_delivery_ttl_expiry_flags_for_sync(tmp_path):
    clock = FakeClock()
    hs = HintStore(str(tmp_path), ReplicationConfig(hint_ttl=10.0),
                   clock=clock)
    health = HealthRegistry(ResilienceConfig(), clock=clock)
    cluster = _FakeCluster([_Node("p:1")], health)
    hs.add("p:1", "i", 4, [(_Frag(shard=4), encode_op(OP_ADD, 1))])
    clock.advance(11.0)
    client = _FakeHintClient()
    assert hs.deliver_once(cluster, client) == 0
    assert client.sent == []  # never replays a stale op
    assert hs.pending("p:1") == 0
    assert hs.snapshot()["hints_expired"] == 1
    assert ("i", 4) in hs.priority_shards()
    hs.close()


def test_hint_deliver_failpoint_targets_peer(tmp_path):
    clock = FakeClock()
    hs = HintStore(str(tmp_path), ReplicationConfig(), clock=clock)
    health = HealthRegistry(
        ResilienceConfig(breaker_failures=1, breaker_backoff=0.1),
        clock=clock)
    cluster = _FakeCluster([_Node("p:1", uri="peer-a:1")], health)
    hs.add("p:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    client = _FakeHintClient()
    try:
        failpoints.configure("hint-deliver@peer-a:1", "drop")
        assert hs.deliver_once(cluster, client) == 0
        assert hs.pending("p:1") == 1
        assert hs.snapshot()["deliver_errors"] == 1
    finally:
        failpoints.reset()
    clock.advance(0.5)
    assert hs.deliver_once(cluster, client) == 1
    hs.close()


def test_departed_peer_hints_pruned(tmp_path):
    hs = HintStore(str(tmp_path), ReplicationConfig())
    health = HealthRegistry(ResilienceConfig())
    hs.add("gone:1", "i", 0, [(_Frag(), encode_op(OP_ADD, 1))])
    cluster = _FakeCluster([], health)  # peer no longer in membership
    assert hs.deliver_once(cluster, _FakeHintClient()) == 0
    assert hs.pending("gone:1") == 0
    assert not os.path.exists(os.path.join(str(tmp_path), "gone%3A1", "log"))
    hs.close()


# ------------------------------------------------ unit: typed 503 semantics


def test_write_consistency_error_is_node_alive_shaped():
    from pilosa_tpu_torch.executor import _is_node_failure

    e = ClientError("POST ...: 503 "
                    '{"error": "write consistency not met: ..."}', status=503)
    assert not _is_node_failure(e)
    assert _is_node_failure(ClientError("boom", status=503))
    assert _is_node_failure(ClientError("conn", status=0))


def test_handler_maps_write_consistency_to_retryable_503():
    from pilosa_tpu_torch.server.handler import Handler

    class _API:
        class server:
            long_query_time = 0

    h = Handler.__new__(Handler)
    h.api = _API()
    h.logger = None
    h.internal_key = None

    class _Route:
        method = "POST"

        import re
        regex = re.compile(r"^/x$")

        @staticmethod
        def fn(**kw):
            raise WriteConsistencyError(
                "applied on 1/3 owners", level="quorum", required=2,
                applied=1)

    h.routes = [_Route()]
    status, ctype, payload, extra = h.dispatch("POST", "/x", {}, b"")
    assert status == 503
    assert extra.get("Retry-After") == "1"
    assert b"write consistency" in payload


# -------------------------------------------------- integration: cluster


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def quorum_cluster(tmp_path):
    """3-node replica_n=3 cluster under write-consistency=quorum with a
    shared fake breaker clock and manual monitors (background hint
    delivery stays ON — it is part of what's under test)."""
    clock = FakeClock()
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]

    def mk(i, port):
        return Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=3,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,
            member_monitor_interval=0,
            executor_workers=0,
            resilience_config=ResilienceConfig(
                breaker_backoff=0.2, breaker_backoff_max=1.0),
            replication_config=ReplicationConfig(
                write_consistency="quorum", deliver_interval=0.1),
        )

    servers = [mk(i, p).open() for i, p in enumerate(ports)]
    for s in servers:
        s.cluster.health.clock = clock
    yield servers, hosts, clock, mk
    failpoints.reset()
    for s in servers:
        try:
            s.close()
        except Exception:
            pass


@pytest.mark.chaos
def test_quorum_writes_replica_flap_hints_drain(quorum_cluster, tmp_path):
    """THE replication chaos test (tier-1, seed-pinned by construction —
    no randomness — fake breaker clock): a replica flaps dead -> alive
    under write-consistency=quorum writes. Every ack met its level (2/3
    owners applied, zero WriteConsistencyUnmet), misses cost hint
    appends (never a connect timeout per write once the breaker opened),
    the hint log drains to byte-identical fragments on the returned
    replica, and breakers/health converge CLOSED."""
    servers, hosts, clock, mk = quorum_cluster
    client = InternalClient(timeout=10.0)
    s0 = servers[0]
    h0 = hosts[0]
    client.create_index(h0, "qr")
    client.create_field(h0, "qr", "f")
    time.sleep(0.05)

    def counter(name):
        return s0.stats.snapshot()["counters"].get(name, 0)

    # Phase 1: healthy quorum writes across 2 shards.
    cols = [s * SHARD_WIDTH + 10 + k for s in range(2) for k in range(3)]
    for col in cols[:3]:
        assert client.query(h0, "qr", f"Set({col}, f=1)")["results"][0]

    # Phase 2: one replica dies. replica_n=3 quorum=2: local + one
    # forward still ack every write; the dead peer's misses hint.
    dead = servers[2]
    dead_id, dead_port = dead.node.id, dead.port
    dead.close()
    for col in cols[3:]:
        assert client.query(h0, "qr", f"Set({col}, f=1)")["results"][0]
    assert counter("WriteConsistencyUnmet") == 0
    assert counter("WriteForwardHinted") >= 2
    # After breaker detection, writes stop paying transport failures:
    # one detection failure, the rest are O(batch) hint appends.
    assert counter("WriteForwardFailed") <= 1 + 1  # probe expiry slack
    assert s0.hints.pending(dead_id) >= 2
    # The dead peer's shards are first in line for anti-entropy.
    assert any(idx == "qr" for idx, _ in s0.hints.priority_shards())

    # Phase 3: replica returns. Breaker re-closes (monitor probe), the
    # delivery daemon drains the log, and fragments converge
    # byte-identically WITHOUT waiting for an anti-entropy sweep.
    revived = mk(2, dead_port)
    revived.open()
    revived.cluster.health.clock = clock
    try:
        clock.advance(2.0)  # any breaker backoff has elapsed
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and s0.hints.pending(dead_id):
            for s in servers[:2]:
                s._monitor_members()
            time.sleep(0.05)
        assert s0.hints.pending(dead_id) == 0

        for shard in range(2):
            frag0 = s0.holder.fragment("qr", "f", "standard", shard)
            fragX = revived.holder.fragment("qr", "f", "standard", shard)
            if frag0 is None:
                assert fragX is None
                continue
            assert fragX is not None
            b0, bX = io.BytesIO(), io.BytesIO()
            frag0.write_to(b0)
            fragX.write_to(bX)
            assert b0.getvalue() == bX.getvalue(), f"shard {shard} diverged"
        # Every owner answers the full count: no lost acked writes.
        for h in (hosts[0], hosts[1], f"localhost:{revived.port}"):
            got = client.query(h, "qr", "Count(Row(f=1))")
            assert got["results"][0] == len(cols)

        # Health converged: every breaker CLOSED, nobody unavailable.
        for s in servers[:2] + [revived]:
            snap = s.cluster.health.snapshot()
            for pid, p in snap["peers"].items():
                assert p["state"] == CLOSED, (pid, snap)
            assert s.cluster.unavailable == set()
        snap = s0.hints.snapshot()
        assert snap["drains"] >= 1
        assert snap["hints_delivered"] >= 2
    finally:
        revived.close()


def test_unmet_quorum_is_retryable_503_over_http(quorum_cluster):
    """With TWO of three owners dead, quorum (2) cannot be met: the
    write surfaces as a retryable 503 whose body names the level — and
    the local apply stands (no rollback), so a later recovered cluster
    converges from hints/anti-entropy rather than losing the bit."""
    servers, hosts, clock, _ = quorum_cluster
    client = InternalClient(timeout=10.0)
    s0 = servers[0]
    h0 = hosts[0]
    client.create_index(h0, "q2")
    client.create_field(h0, "q2", "f")
    time.sleep(0.05)
    assert client.query(h0, "q2", "Set(1, f=3)")["results"][0]
    servers[1].close()
    servers[2].close()
    with pytest.raises(ClientError) as ei:
        # Two forwards fail/hint -> applied=1 < quorum=2.
        client.query(h0, "q2", "Set(2, f=3)")
    assert ei.value.status == 503
    assert "write consistency" in str(ei.value)
    assert "quorum" in str(ei.value)
    # No rollback: the local apply stands, hints cover the dead peers.
    frag = s0.holder.fragment("q2", "f", "standard", 0)
    assert frag.row_count(3) == 2
    assert s0.stats.snapshot()["counters"].get("WriteConsistencyUnmet") >= 1


def test_total_owner_loss_is_retryable_503(quorum_cluster):
    """Satellite regression: 'write failed on all owners' used to raise
    a plain QueryError (400, client-error shaped). Total owner loss is
    transient — it must surface as the same typed retryable 503 so
    clients and retry budgets treat it as such."""
    servers, hosts, clock, _ = quorum_cluster
    client = InternalClient(timeout=10.0)
    s0 = servers[0]
    h0 = hosts[0]
    client.create_index(h0, "tl")
    client.create_field(h0, "tl", "f")
    time.sleep(0.05)
    # replica_n == n_nodes: every node owns every shard, so make the
    # OTHER two nodes the only live appliers impossible — kill them and
    # fail the local apply path by... simplest: ask a node that owns the
    # shard while the other owners are dead under level=all.
    servers[1].close()
    servers[2].close()
    # Direct executor-level proof of the degenerate case: zero owners
    # applied (local_fn raising the same transport shape is not a real
    # path — instead drive a non-owner coordinator via a fake cluster).
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor

    nodes = [Node(id="n0"), Node(id="n1")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=1,
                      hasher=ModHasher())

    class _DeadClient:
        def query_node(self, node, index, query, shards=None, remote=True):
            raise ClientError("conn refused", status=0)

    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("tl")
    idx.create_field("f")
    remote_shard = next(
        s for s in range(4)
        if cluster.shard_nodes("tl", s)[0].id == "n1")
    ex = Executor(holder, cluster=cluster, client=_DeadClient(), workers=0)
    with pytest.raises(WriteConsistencyError) as ei:
        ex.execute("tl", f"Set({remote_shard * SHARD_WIDTH + 1}, f=1)",
                   shards=[remote_shard])
    assert ei.value.applied == 0
    holder.close()


# -------------------------------------------- hint-aware anti-entropy order


def test_syncer_orders_hinted_shards_first(quorum_cluster):
    """The anti-entropy sweep visits shards with pending/expired hints
    FIRST instead of their stable position in the full-holder walk, and
    settles the priority flags afterwards."""
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer

    servers, hosts, clock, _ = quorum_cluster
    client = InternalClient(timeout=10.0)
    s0 = servers[0]
    h0 = hosts[0]
    client.create_index(h0, "sy")
    client.create_field(h0, "sy", "f")
    time.sleep(0.05)
    n_shards = 4
    for shard in range(n_shards):
        client.query(h0, "sy", f"Set({shard * SHARD_WIDTH + 1}, f=1)")

    # Flag a LATE shard as hint-priority (marker: no captured bytes).
    # The marker's peer is a real member so the delivery daemon can
    # drain the record; the needs-sync flag outlives the drain and is
    # what the sweep both orders on and settles.
    target = n_shards - 1
    s0.hints.add(servers[1].node.id, "sy", target, None)
    assert ("sy", target) in s0.hints.priority_shards()

    order = []
    syncer = HolderSyncer(s0)
    orig = syncer._sync_fragment

    def spy(index, field, view, shard, replicas):
        order.append((index, shard))
        return orig(index, field, view, shard, replicas)

    syncer._sync_fragment = spy
    syncer.sync_holder()
    assert order, "sweep visited nothing"
    assert order[0] == ("sy", target), order
    # The completed sweep settled the needs-sync flag; the background
    # daemon drains the marker record itself (idempotent), after which
    # nothing flags the shard anymore.
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            ("sy", target) in s0.hints.priority_shards()):
        time.sleep(0.05)
    assert ("sy", target) not in s0.hints.priority_shards()


def test_syncer_keeps_flag_when_no_replica_reachable(quorum_cluster):
    """Review fix: a sweep that SKIPS a hint-flagged shard because every
    remote replica is down must not settle its flag — the outage that
    created the divergence would otherwise erase its priority ordering
    for the sweep that finally can repair it."""
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer

    servers, hosts, clock, _ = quorum_cluster
    client = InternalClient(timeout=10.0)
    s0 = servers[0]
    h0 = hosts[0]
    client.create_index(h0, "nr")
    client.create_field(h0, "nr", "f")
    time.sleep(0.05)
    client.query(h0, "nr", f"Set(1, f=1)")
    s0.hints.add(servers[1].node.id, "nr", 0, None)  # flag shard 0
    assert ("nr", 0) in s0.hints.priority_shards()
    for peer in (servers[1], servers[2]):
        s0.cluster.health.force_down(peer.node.id)
    HolderSyncer(s0).sync_holder()  # zero reachable replicas: no repair
    assert ("nr", 0) in s0.hints.priority_shards()
    for peer in (servers[1], servers[2]):
        s0.cluster.health.force_up(peer.node.id)
    HolderSyncer(s0).sync_holder()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            ("nr", 0) in s0.hints.priority_shards()):
        time.sleep(0.05)  # daemon drains the marker record itself
    assert ("nr", 0) not in s0.hints.priority_shards()


def test_spawn_jitter_clamped(tmp_path):
    """Review fix: jitter is a FRACTION — a percent-vs-fraction slip
    (jitter=20) must clamp rather than make the sweep wait negative
    (back-to-back sweeps: the stampede the knob exists to prevent)."""
    s = Server(data_dir=str(tmp_path / "n0"), port=0,
               anti_entropy_jitter=20.0)
    try:
        assert s.anti_entropy_jitter == 1.0
    finally:
        s.close()


def test_anti_entropy_jitter_and_pace_plumbing(tmp_path):
    """[anti-entropy] jitter/pace ride Config -> Server -> HolderSyncer;
    jitter=0 restores the fixed timer (exactness matters for tests)."""
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer
    from pilosa_tpu_torch.config import Config

    cfg = Config()
    cfg._apply_dict({"anti-entropy":
                     {"interval": 5.0, "jitter": 0.25, "pace": 0.5}})
    assert cfg.anti_entropy.jitter == 0.25
    assert cfg.anti_entropy.pace == 0.5
    s = Server(data_dir=str(tmp_path / "n0"), port=0,
               anti_entropy_jitter=0.25, anti_entropy_pace=0.5)
    try:
        assert s.anti_entropy_jitter == 0.25
        assert s.anti_entropy_pace == 0.5
        assert HolderSyncer(s).pace == 0.5
    finally:
        s.close()


# ------------------------------------------------------- capture mechanics


def test_capture_hint_ops_is_thread_local_and_scoped():
    from pilosa_tpu_torch.core.fragment import Fragment, capture_hint_ops

    frag = Fragment(None, "i", "f", "standard", 0)
    frag.open()
    grabbed: list = []
    with capture_hint_ops(grabbed):
        frag.set_bit(1, 3)
        frag.bulk_import(np.array([2], dtype=np.uint64),
                         np.array([4], dtype=np.uint64))
    frag.set_bit(1, 5)  # outside the capture: not recorded
    assert len(grabbed) == 2
    assert all(f is frag for f, _ in grabbed)
    ops = b"".join(b for _, b in grabbed)
    recs = decode_op_records(ops)
    assert recs[0][0].tolist() == [1 * SHARD_WIDTH + 3]
    assert recs[1][0].tolist() == [2 * SHARD_WIDTH + 4]
    frag.close()


def test_apply_hint_positions_is_idempotent():
    from pilosa_tpu_torch.core.fragment import Fragment

    frag = Fragment(None, "i", "f", "standard", 0)
    frag.open()
    adds = np.array([5, SHARD_WIDTH + 6], dtype=np.uint64)
    rems = np.array([7], dtype=np.uint64)
    frag.apply_hint_positions(adds, rems)
    before = frag.row_count(0), frag.row_count(1)
    frag.apply_hint_positions(adds, rems)  # redelivery: harmless
    assert (frag.row_count(0), frag.row_count(1)) == before
    assert frag.bit(0, 5) and frag.bit(1, 6) and not frag.bit(0, 7)
    frag.close()
