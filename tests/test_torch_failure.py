"""tests/test_failure.py against the port (servers on the CPU): failure
detection + query-time replica retry, and a legacy topology file that
still lets a restarting coordinator solicit its prior members.

Model: reference executor.go:1498-1508 (mapReduce retry on replicas) and
memberlist gossip failure surfacing. A 3-node replica_n=2 cluster keeps
answering full queries after one node dies.
"""

import socket
import time

import pytest

from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.server.client import ClientError, InternalClient
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    return _Server(*args, device="cpu", **kw)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def cluster3r(tmp_path):
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        s = Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=2,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,
            member_monitor_interval=0,  # tests trigger probes manually
            executor_workers=0,
        )
        s.open()
        servers.append(s)
    yield servers
    for s in servers:
        try:
            s.close()
        except Exception:
            pass


def test_query_survives_node_death(cluster3r):
    client = InternalClient()
    h0 = f"localhost:{cluster3r[0].port}"
    client.create_index(h0, "fi")
    client.create_field(h0, "fi", "f")
    time.sleep(0.05)
    # Pick a shard node0 does NOT replicate (exists with overwhelming
    # probability within 64 shards; placement depends on ephemeral ports).
    s0 = cluster3r[0]
    target_shard = target_id = None
    for shard in range(64):
        owners = s0.cluster.shard_nodes("fi", shard)
        if all(n.id != s0.node.id for n in owners):
            target_shard, target_id = shard, owners[0].id
            break
    assert target_id is not None, "placement gave node0 every shard in 0..63"
    cols = [1, SHARD_WIDTH + 2, target_shard * SHARD_WIDTH + 3]
    for col in cols:
        client.query(h0, "fi", f"Set({col}, f=1)")
    cols = sorted(set(cols))
    assert client.query(h0, "fi", "Count(Row(f=1))")["results"][0] == len(cols)
    dead = next(s for s in cluster3r if s.node.id == target_id)
    dead.close()

    # Query from node0: remote call to the dead node fails, the executor
    # marks it unavailable and retries its shards on replicas.
    resp = client.query(h0, "fi", "Count(Row(f=1))")
    assert resp["results"][0] == len(cols)
    assert dead.node.id in s0.cluster.unavailable
    resp = client.query(h0, "fi", "Row(f=1)")
    assert resp["results"][0]["columns"] == cols


def test_member_monitor_detects_death_and_recovery(cluster3r):
    s0, s1, _ = cluster3r
    s0._monitor_members()
    assert s0.cluster.unavailable == set()
    port = s1.port
    s1.close()
    # Flap damping (gossip.probe-failures, default 3): one or two failed
    # probes are a blip, not a death — routing must not flap.
    s0._monitor_members()
    assert s1.node.id not in s0.cluster.unavailable
    s0._monitor_members()
    assert s1.node.id not in s0.cluster.unavailable
    s0._monitor_members()
    assert s1.node.id in s0.cluster.unavailable
    # Restart on the same port -> recovery detected.
    s1b = Server(
        data_dir=s1.data_dir,
        port=port,
        cluster_hosts=[n.uri for n in s0.cluster.nodes],
        replica_n=2,
        hasher=ModHasher(),
        cache_flush_interval=0,
        member_monitor_interval=0,
        executor_workers=0,
    )
    s1b.open()
    try:
        s0._monitor_members()
        assert s1b.node.id not in s0.cluster.unavailable
    finally:
        s1b.close()


def test_writes_survive_replica_death(cluster3r):
    """Write fan-out tolerates a dead peer the way the read path does:
    Set/SetRowAttrs/SetValue succeed when one replica of the target shard is
    down (anti-entropy repairs it later), instead of raising after a client
    timeout. The dead node gets marked unavailable by the failed forward."""
    client = InternalClient()
    s0 = cluster3r[0]
    h0 = f"localhost:{s0.port}"
    client.create_index(h0, "wr")
    client.create_field(h0, "wr", "f")
    client.create_field(h0, "wr", "v", {"type": "int", "min": 0, "max": 100})
    time.sleep(0.05)
    # Find a shard node0 owns whose OTHER replica is some other node.
    target_shard = dead_id = None
    for shard in range(64):
        owners = s0.cluster.shard_nodes("wr", shard)
        if any(n.id == s0.node.id for n in owners):
            others = [n.id for n in owners if n.id != s0.node.id]
            if others:
                target_shard, dead_id = shard, others[0]
                break
    assert dead_id is not None
    dead = next(s for s in cluster3r if s.node.id == dead_id)
    dead.close()

    col = target_shard * SHARD_WIDTH + 7
    # Bit write: local apply + dead-replica forward -> still succeeds.
    assert client.query(h0, "wr", f"Set({col}, f=2)")["results"][0] is True
    assert dead_id in s0.cluster.unavailable
    # Attr + BSI writes fan to ALL nodes; the dead one is now skipped fast.
    client.query(h0, "wr", 'SetRowAttrs(f, 2, tag="x")')
    client.query(h0, "wr", f"SetValue(col={col}, v=42)")
    assert s0.holder.field("wr", "f").row_attr_store.attrs(2) == {"tag": "x"}
    assert client.query(h0, "wr", "Count(Row(f=2))")["results"][0] == 1

    # The surviving replica set still answers for the written bit.
    live = [s for s in cluster3r if s.node.id != dead_id and s is not s0]
    for s in live:
        resp = client.query(f"localhost:{s.port}", "wr", "Count(Row(f=2))")
        assert resp["results"][0] == 1


def test_write_fails_when_all_owners_dead(cluster3r):
    """If every owner of the target shard is unreachable the write raises
    instead of silently dropping (no false ack)."""
    client = InternalClient()
    s0 = cluster3r[0]
    h0 = f"localhost:{s0.port}"
    client.create_index(h0, "wx")
    client.create_field(h0, "wx", "f")
    time.sleep(0.05)
    # Find a shard node0 does NOT own.
    target_shard = None
    for shard in range(64):
        owners = s0.cluster.shard_nodes("wx", shard)
        if all(n.id != s0.node.id for n in owners):
            target_shard = shard
            break
    assert target_shard is not None
    cluster3r[1].close()
    cluster3r[2].close()
    with pytest.raises(ClientError):
        client.query(h0, "wx", f"Set({target_shard * SHARD_WIDTH + 1}, f=1)")


def test_no_available_replica_errors(cluster3r):
    client = InternalClient()
    h0 = f"localhost:{cluster3r[0].port}"
    client.create_index(h0, "fx")
    client.create_field(h0, "fx", "f")
    time.sleep(0.05)
    client.query(h0, "fx", f"Set({SHARD_WIDTH + 1}, f=1)")
    # Kill both non-local nodes; shards owned only by them are unreachable.
    cluster3r[1].close()
    cluster3r[2].close()
    # Some shard will have no available owner -> error, not silent data loss.
    s0 = cluster3r[0]
    unreachable = [
        sh for sh in range(2)
        if all(n.id != s0.node.id for n in s0.cluster.shard_nodes("fx", sh))
    ]
    if unreachable:
        with pytest.raises(ClientError):
            client.query(h0, "fx", "Count(Row(f=1))")


def test_4xx_replica_error_not_misclassified_as_node_death():
    """ADVICE r3: a deterministic application error (4xx) from a replica
    must surface to the caller, not mark the healthy node unavailable."""
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor

    nodes = [Node(id="n0"), Node(id="n1")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=1, hasher=ModHasher())

    class FakeClient:
        def __init__(self, status):
            self.status = status
            self.calls = 0

        def query_node(self, node, index, query, shards=None, remote=True):
            self.calls += 1
            raise ClientError("boom", status=self.status)

    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("fz")
    idx.create_field("f")
    # Ensure some shard in 0..3 is owned by the remote node (ModHasher).
    remote_shard = next(
        s for s in range(4)
        if cluster.shard_nodes("fz", s)[0].id == "n1"
    )

    # 400: surfaces, node stays available.
    client = FakeClient(400)
    ex = Executor(holder, cluster=cluster, client=client, workers=0)
    with pytest.raises(ClientError):
        ex.execute("fz", "Count(Row(f=1))", shards=[remote_shard])
    assert "n1" not in cluster.unavailable
    assert client.calls == 1

    # Transport failure (status 0): marked unavailable, shards re-mapped
    # (single replica here, so the retry exhausts owners and errors).
    cluster.unavailable.clear()
    client = FakeClient(0)
    ex = Executor(holder, cluster=cluster, client=client, workers=0)
    with pytest.raises(PilosaError):
        ex.execute("fz", "Count(Row(f=1))", shards=[remote_shard])
    assert "n1" in cluster.unavailable


def test_import_tolerates_dead_replica(cluster3r):
    """Bulk import succeeds when a replica is down (the dead node is
    marked unavailable and skipped, matching the executor's tolerant
    write fan-out); previously the first ClientError failed the whole
    import even though the primary had applied it."""
    import numpy as np

    client = InternalClient()
    h0 = f"localhost:{cluster3r[0].port}"
    client.create_index(h0, "imp")
    client.create_field(h0, "imp", "f")
    time.sleep(0.05)

    owners = cluster3r[0].cluster.shard_nodes("imp", 0)
    primary = next(s for s in cluster3r if s.node.id == owners[0].id)
    replica = next(s for s in cluster3r if s.node.id == owners[1].id)
    replica.close()  # replica dies

    rows = np.zeros(100, dtype=np.uint64)
    cols = np.arange(100, dtype=np.uint64)
    primary.api.import_bits("imp", "f", 0, rows.tolist(), cols.tolist())
    assert primary.holder.fragment("imp", "f", "standard", 0).row_count(0) == 100
    assert replica.node.id in primary.cluster.unavailable


def test_write_fanout_replica_flap_converges(cluster3r, tmp_path):
    """tolerant_owner_fanout under a replica that flaps mid-write-stream
    (alive -> dead -> alive): the surviving owner applies every acked
    write exactly once, missed forwards are HINTED (breaker open, zero
    connect attempts — cluster/hints.py), the hint log drains to the
    returned replica, and anti-entropy finds byte-identical fragment
    state with nothing left to push."""
    import io

    from pilosa_tpu_torch.cluster.health import CLOSED
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer

    client = InternalClient()
    s0 = cluster3r[0]
    h0 = f"localhost:{s0.port}"
    client.create_index(h0, "flap")
    client.create_field(h0, "flap", "f")
    time.sleep(0.05)

    # A shard s0 owns whose OTHER replica is some other node.
    target_shard = flap_id = None
    for shard in range(64):
        owners = s0.cluster.shard_nodes("flap", shard)
        if any(n.id == s0.node.id for n in owners):
            others = [n.id for n in owners if n.id != s0.node.id]
            if others:
                target_shard, flap_id = shard, others[0]
                break
    assert flap_id is not None
    flapper = next(s for s in cluster3r if s.node.id == flap_id)
    base = target_shard * SHARD_WIDTH

    def counter(name):
        return s0.stats.snapshot()["counters"].get(name, 0)

    # Phase 1: both owners alive.
    assert client.query(h0, "flap", f"Set({base + 1}, f=9)")["results"][0]

    # Phase 2: replica dies mid-stream. The first write pays the failed
    # forward and lands in the peer's hint log; later writes queue behind
    # it (per-peer FIFO) without a connect attempt.
    flap_port, flap_dir = flapper.port, flapper.data_dir
    flapper.close()
    assert client.query(h0, "flap", f"Set({base + 2}, f=9)")["results"][0]
    assert counter("WriteForwardFailed") >= 1
    assert counter("WriteForwardHinted") >= 1
    assert flap_id in s0.cluster.unavailable
    hinted_before = counter("WriteForwardHinted")
    assert client.query(h0, "flap", f"Set({base + 3}, f=9)")["results"][0]
    assert counter("WriteForwardHinted") > hinted_before
    assert s0.hints.pending(flap_id) >= 2

    # Phase 3: replica returns (same id, same data dir). The monitor's
    # successful probe recloses the breaker; the delivery daemon drains
    # the hint log; writes forward directly again.
    flapper2 = Server(
        data_dir=flap_dir,
        port=flap_port,
        cluster_hosts=[n.uri for n in s0.cluster.nodes],
        replica_n=2,
        hasher=ModHasher(),
        cache_flush_interval=0,
        anti_entropy_interval=0,
        member_monitor_interval=0,
        executor_workers=0,
    )
    flapper2.open()
    try:
        s0._monitor_members()
        assert flap_id not in s0.cluster.unavailable
        assert s0.cluster.health.state(flap_id) == CLOSED
        # The delivery daemon (deliver-interval default 1s) replays the
        # missed Sets in order; poll until the backlog clears.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and s0.hints.pending(flap_id):
            time.sleep(0.05)
        assert s0.hints.pending(flap_id) == 0
        assert client.query(h0, "flap", f"Set({base + 4}, f=9)")["results"][0]

        # No double-apply on the surviving owner: exactly the 4 distinct
        # bits, each applied once (a replayed Set would return False and
        # not change the count, a double-applied forward would diverge
        # replicas — both show up as a count mismatch somewhere below).
        frag0 = s0.holder.fragment("flap", "f", "standard", target_shard)
        assert frag0.row_count(9) == 4
        # The flapped replica got bits 2 and 3 from the hint drain and
        # bit 4 as a direct forward — no anti-entropy sweep needed.
        fragX = flapper2.holder.fragment("flap", "f", "standard", target_shard)
        assert fragX is not None and fragX.row_count(9) == 4

        # Phase 4: anti-entropy finds nothing left to repair; state is
        # byte-identical with the survivor.
        HolderSyncer(s0).sync_holder()
        time.sleep(0.05)
        fragX = flapper2.holder.fragment("flap", "f", "standard", target_shard)
        assert fragX.row_count(9) == 4
        b0, bX = io.BytesIO(), io.BytesIO()
        frag0.write_to(b0)
        fragX.write_to(bX)
        assert b0.getvalue() == bX.getvalue()
    finally:
        flapper2.close()


def test_write_forward_counters_survive_statsless_holder():
    """Regression (pilint R10, a crash class): the write-forward
    fan-out's breaker counters ride the _count_stat guard, so a
    stats-less holder (Holder(None, device="cpu"), library embedders) skips the count
    instead of crashing the degraded path — pre-fix,
    self.holder.stats.count raised AttributeError the moment a peer
    failed or its breaker opened."""
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import ExecOptions, Executor
    from pilosa_tpu_torch.pql.parser import parse

    nodes = [Node(id="n0"), Node(id="n1")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=1,
                      hasher=ModHasher())

    class FakeClient:
        def __init__(self):
            self.calls = 0

        def query_node(self, node, index, query, shards=None, remote=True):
            self.calls += 1
            raise ClientError("boom", status=0)  # transport failure

    holder = Holder(None, device="cpu")
    holder.open()
    assert holder.stats is None
    client = FakeClient()
    ex = Executor(holder, cluster=cluster, client=client, workers=0)
    call = parse('SetRowAttrs(f, 1, x="y")').calls[0]

    # Failed-forward path: WriteForwardFailed rides the guard.
    ex._forward_to_all("fz", call, ExecOptions())
    assert client.calls == 1
    # Breaker now open: the skip path counts WriteForwardSkipped through
    # the guard and issues zero connect attempts.
    ex._forward_to_all("fz", call, ExecOptions())
    assert client.calls == 1

    # The single-target tolerant step takes the same guard on both arms.
    errors = []
    res = ex._forward_tolerant(nodes[1], lambda n: True, errors,
                               lambda e: None)
    assert res is None
    assert errors and "breaker open" in errors[0]


def test_legacy_topology_without_node_records_still_solicits():
    """ADVICE r3: topology files that predate full node records (nodeIDs
    only) must still let a restarting coordinator dial prior members —
    ids are URIs in static mode."""
    import json
    import tempfile

    from pilosa_tpu_torch.cluster.topology import Topology

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/.topology"
        with open(path, "w") as f:
            json.dump({"nodeIDs": ["localhost:1001", "localhost:1002"]}, f)
        t = Topology.load(path)
        assert [n.id for n in t.nodes] == ["localhost:1001", "localhost:1002"]
        assert [n.uri for n in t.nodes] == ["localhost:1001", "localhost:1002"]
