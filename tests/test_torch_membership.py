"""tests/test_membership.py against the port: dynamic membership — join
through a seed, coordinator admission, topology persistence and the
startup quorum, node leave — with port servers on the CPU."""

import socket
import time

import pytest

from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.node import Node
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.server.client import InternalClient
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


def make_server(tmp_path, name, port, **kw):
    kw.setdefault("cache_flush_interval", 0)
    kw.setdefault("member_monitor_interval", 0)
    kw.setdefault("executor_workers", 0)
    kw.setdefault("hasher", ModHasher())
    s = Server(data_dir=str(tmp_path / name), port=port, **kw)
    s.open()
    return s


def wait_for(cond, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_join_empty_cluster(tmp_path):
    """A node joins a single-node cluster with no data: status-only path."""
    port0 = free_port()
    s0 = make_server(tmp_path, "n0", port0, cluster_hosts=[f"localhost:{port0}"])
    servers = [s0]
    try:
        s1 = make_server(tmp_path, "n1", free_port(), join_addr=s0.node.uri)
        servers.append(s1)
        assert len(s1.cluster.nodes) == 2
        assert wait_for(lambda: len(s0.cluster.nodes) == 2)
        assert {n.id for n in s0.cluster.nodes} == {s0.node.id, s1.node.id}
        # Schema created after the join propagates to both.
        client = InternalClient()
        client.create_index(s0.node.uri, "j")
        client.create_field(s0.node.uri, "j", "f")
        assert wait_for(lambda: s1.holder.field("j", "f") is not None)
    finally:
        for s in servers:
            s.close()


def test_join_with_data_triggers_resize(tmp_path):
    port0 = free_port()
    s0 = make_server(tmp_path, "n0", port0, cluster_hosts=[f"localhost:{port0}"])
    servers = [s0]
    client = InternalClient()
    try:
        client.create_index(s0.node.uri, "jd")
        client.create_field(s0.node.uri, "jd", "f")
        cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3]
        for col in cols:
            client.query(s0.node.uri, "jd", f"Set({col}, f=1)")

        s1 = make_server(tmp_path, "n1", free_port(), join_addr=s0.node.uri)
        servers.append(s1)
        assert wait_for(lambda: len(s0.cluster.nodes) == 2 and s0.cluster.state == "NORMAL")
        # Schema moved to the new node and it holds the shards it now owns.
        assert s1.holder.field("jd", "f") is not None
        owned = [
            sh for sh in range(3)
            if any(n.id == s1.node.id for n in s0.cluster.shard_nodes("jd", sh))
        ]
        for sh in owned:
            assert s1.holder.fragment("jd", "f", "standard", sh) is not None, sh
        # Full query still answers from either node.
        for s in servers:
            assert client.query(s.node.uri, "jd", "Count(Row(f=1))")["results"][0] == 3
    finally:
        for s in servers:
            s.close()


def test_remove_node(tmp_path):
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts)
        for i in range(3)
    ]
    client = InternalClient()
    try:
        h0 = servers[0].node.uri
        client.create_index(h0, "rm")
        client.create_field(h0, "rm", "f")
        time.sleep(0.05)
        cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 3 * SHARD_WIDTH + 4]
        for col in cols:
            client.query(h0, "rm", f"Set({col}, f=1)")

        # Remove a non-coordinator node through the public endpoint.
        victim = servers[2]
        import json
        import urllib.request

        req = urllib.request.Request(
            f"http://{h0}/cluster/resize/remove-node",
            data=json.dumps({"id": victim.node.id}).encode(),
            method="POST",
        )
        urllib.request.urlopen(req)
        assert wait_for(
            lambda: len(servers[0].cluster.nodes) == 2
            and servers[0].cluster.state == "NORMAL"
        )
        assert all(n.id != victim.node.id for n in servers[0].cluster.nodes)
        victim.close()
        # All data still answerable from the remaining nodes.
        assert client.query(h0, "rm", "Count(Row(f=1))")["results"][0] == 4
        row = client.query(servers[1].node.uri, "rm", "Row(f=1)")
        assert row["results"][0]["columns"] == cols
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_coordinator_startup_quorum(tmp_path):
    """A restarting coordinator with a persisted multi-node topology stays
    STARTING (rejecting queries) until the previously-known nodes rejoin
    (reference considerTopology, cluster.go:1582-1613)."""
    from pilosa_tpu_torch.errors import PilosaError

    port0, port1 = free_port(), free_port()
    s0 = make_server(tmp_path, "n0", port0)
    client = InternalClient()
    client.create_index(s0.node.uri, "q")
    client.create_field(s0.node.uri, "q", "f")
    client.query(s0.node.uri, "q", "Set(1, f=1)")
    s1 = make_server(tmp_path, "n1", port1, join_addr=s0.node.uri)
    assert wait_for(lambda: len(s0.cluster.nodes) == 2 and s0.cluster.state == "NORMAL")
    s1_id = s1.node.id
    s1.close()
    s0.close()

    # Coordinator restarts alone: topology on disk lists both nodes.
    s0 = make_server(tmp_path, "n0", port0)
    try:
        assert s0.cluster.state == "STARTING"
        with pytest.raises(PilosaError):
            s0.api.query("q", "Count(Row(f=1))")
        # The previously-known node rejoins (same port -> same id): NORMAL.
        s1 = make_server(tmp_path, "n1", port1, join_addr=s0.node.uri)
        assert wait_for(lambda: s0.cluster.state == "NORMAL")
        assert {n.id for n in s0.cluster.nodes} == {s0.node.id, s1_id}
        assert s0.api.query("q", "Count(Row(f=1))")
        s1.close()
    finally:
        s0.close()


def test_coordinator_restart_recovers_without_peer_restart(tmp_path):
    """Only the coordinator restarts: it must solicit the still-healthy
    peer back into the cluster instead of wedging in STARTING until every
    peer process is also bounced (ADVICE r2 medium; the reference recovers
    via memberlist gossip re-join events, cluster.go:1615 nodeJoin)."""
    port0, port1 = free_port(), free_port()
    s0 = make_server(tmp_path, "n0", port0)
    client = InternalClient()
    client.create_index(s0.node.uri, "cr")
    client.create_field(s0.node.uri, "cr", "f")
    client.query(s0.node.uri, "cr", "Set(1, f=1)")
    s1 = make_server(tmp_path, "n1", port1, join_addr=s0.node.uri)
    assert wait_for(lambda: len(s0.cluster.nodes) == 2 and s0.cluster.state == "NORMAL")
    s0.close()

    # s1 keeps running; the restarted coordinator comes up STARTING and
    # must discover s1 on its own.
    s0 = make_server(tmp_path, "n0", port0)
    try:
        assert wait_for(lambda: s0.cluster.state == "NORMAL", timeout=15)
        assert {n.id for n in s0.cluster.nodes} == {s0.node.id, s1.node.id}
        assert s0.api.query("cr", "Count(Row(f=1))")
    finally:
        s1.close()
        s0.close()


def test_schema_converges_after_missed_broadcast(tmp_path):
    """A node that was down during create-field converges via the member
    monitor's NodeStatus schema merge after it comes back, without a restart
    of anything else (reference gossip push/pull sync, gossip.go:240-273)."""
    ports = [free_port(), free_port()]
    hosts = [f"localhost:{p}" for p in ports]
    s0 = make_server(tmp_path, "n0", ports[0], cluster_hosts=hosts,
                     member_monitor_interval=0.2)
    s1 = make_server(tmp_path, "n1", ports[1], cluster_hosts=hosts,
                     is_coordinator=False, member_monitor_interval=0.2)
    client = InternalClient()
    try:
        client.create_index(s0.node.uri, "sc")
        assert wait_for(lambda: s1.holder.index("sc") is not None)
        s1.close()

        # s1 is down: the create-field broadcast never reaches it.
        client.create_field(s0.node.uri, "sc", "missed")

        s1 = make_server(tmp_path, "n1", ports[1], cluster_hosts=hosts,
                         is_coordinator=False, member_monitor_interval=0.2)
        # No broadcast is replayed — only the monitor's schema pull can
        # deliver the field.
        assert wait_for(lambda: s1.holder.field("sc", "missed") is not None)
        client.query(s0.node.uri, "sc", "Set(1, missed=1)")
        assert client.query(
            s1.node.uri, "sc", "Count(Row(missed=1))"
        )["results"][0] == 1
    finally:
        s1.close()
        s0.close()


def test_startup_quorum_refuses_unknown_host(tmp_path):
    port0 = free_port()
    s0 = make_server(tmp_path, "n0", port0)
    client = InternalClient()
    client.create_index(s0.node.uri, "q2")
    s1 = make_server(tmp_path, "n1", free_port(), join_addr=s0.node.uri)
    assert wait_for(lambda: len(s0.cluster.nodes) == 2)
    s1.close()
    s0.close()

    s0 = make_server(tmp_path, "n0", port0)
    try:
        assert s0.cluster.state == "STARTING"
        # A brand-new host (different port/id) is refused while STARTING.
        from pilosa_tpu_torch.errors import PilosaError

        with pytest.raises(PilosaError):
            make_server(tmp_path, "n2", free_port(), join_addr=s0.node.uri)
        assert s0.cluster.state == "STARTING"
    finally:
        s0.close()


def test_resize_aborts_on_failed_fetch(tmp_path):
    """A node that cannot retrieve a source fragment must abort the whole
    resize (reference cluster.go followResizeInstruction error -> job
    abort): completing with holes would lose the fragment at replica_n=1
    when the old owner garbage-collects. The membership must stay on the
    OLD topology and return to NORMAL."""
    from pilosa_tpu_torch.cluster.node import Node, STATE_NORMAL, STATE_RESIZING
    from pilosa_tpu_torch.cluster.resize import (
        ResizeCoordinator,
        ResizeJob,
        follow_resize_instruction,
    )

    s = Server(data_dir=str(tmp_path / "n0"), cache_flush_interval=0,
               member_monitor_interval=0, executor_workers=0)
    s.open()
    try:
        idx = s.holder.create_index("r")
        idx.create_field("f")
        s.executor.execute("r", "Set(1, f=1)")
        coord = ResizeCoordinator(s)
        s.resize_coordinator = coord
        old_nodes = list(s.cluster.nodes)

        # Path 1: an undeliverable instruction aborts begin() itself
        # (otherwise the cluster hangs in RESIZING forever).
        coord.begin(old_nodes + [Node(id="zz-new", uri="localhost:1")])
        assert coord.job is None
        assert s.cluster.state == STATE_NORMAL
        assert [n.id for n in s.cluster.nodes] == [n.id for n in old_nodes]

        # Path 2: a follower whose source fetch fails acks with an error;
        # the coordinator aborts instead of completing with holes.
        coord.job = ResizeJob("j1", {s.cluster.node.id: []}, old_nodes)
        s.cluster.state = STATE_RESIZING
        instr = {
            "type": "resize-instruction",
            "jobID": "j1",
            "coordinatorID": s.cluster.node.id,
            "schema": [],
            "sources": [{
                "index": "r", "field": "f", "view": "standard", "shard": 0,
                "sourceNodeID": "dead-node",
            }],
            "nodeURIs": {"dead-node": "localhost:9"},  # nothing listening
            "maxShards": {},
        }
        follow_resize_instruction(s, instr)  # acks with error -> abort

        assert coord.job is None
        assert s.cluster.state == STATE_NORMAL
        assert [n.id for n in s.cluster.nodes] == [n.id for n in old_nodes]
        # Data untouched.
        assert s.executor.execute("r", "Count(Row(f=1))") == [1]
    finally:
        s.close()


def test_coordinator_failover_and_join_via_successor(tmp_path):
    """Kill the coordinator of a 3-node cluster: the surviving node with
    the lowest id must assume coordinatorship on its own (no manual
    set-coordinator — the reference blocks here, api.go:777), the other
    survivor must learn the new coordinator, and a brand-new node must
    then be able to join via EITHER survivor."""
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    coord_host = min(hosts)  # make the DYING node the lowest id: the
    # successor choice (lowest alive) then provably re-evaluates
    servers = {}
    try:
        for i, port in enumerate(ports):
            servers[hosts[i]] = make_server(
                tmp_path, f"n{i}", port,
                cluster_hosts=hosts,
                is_coordinator=hosts[i] == coord_host,
                member_monitor_interval=0.2,
                member_probe_timeout=0.5,
                coordinator_failover_probes=2,
            )
        survivors = sorted(h for h in hosts if h != coord_host)
        # Everyone learns the configured coordinator via status probes.
        assert wait_for(lambda: all(
            (servers[h].cluster.coordinator_node() or Node(id="")).id == coord_host
            for h in survivors
        )), "peers never learned the configured coordinator"

        servers.pop(coord_host).close()

        successor = survivors[0]  # lowest surviving id
        assert wait_for(lambda: servers[successor].node.is_coordinator, 15), \
            "successor never assumed coordinatorship"
        # The other survivor learns it via the set-coordinator broadcast.
        other = survivors[1]
        assert wait_for(lambda: (
            servers[other].cluster.coordinator_node() or Node(id="")
        ).id == successor, 15)

        # A new node can now join via the NON-coordinator survivor (the
        # join is forwarded to the successor).
        s3 = make_server(tmp_path, "n3", free_port(), join_addr=other)
        servers["n3"] = s3
        assert wait_for(
            lambda: servers[successor].cluster.node_by_id(s3.node.id) is not None
        ), "join via successor failed"
    finally:
        for s in servers.values():
            s.close()


def test_failover_survivor_that_missed_broadcast_self_heals(tmp_path):
    """A survivor that missed the set-coordinator broadcast must still
    converge: probing the successor (an alive self-claimer) clears the
    dead coordinator's stale flag, and coordinator_node() prefers the
    alive claimant meanwhile."""
    ports = [free_port() for _ in range(3)]
    hosts = sorted(f"localhost:{p}" for p in ports)
    coord, succ, other = hosts[0], hosts[1], hosts[2]
    servers = {}
    try:
        for h in hosts:
            servers[h] = make_server(
                tmp_path, h.replace(":", "_"), int(h.rsplit(":", 1)[1]),
                cluster_hosts=hosts, is_coordinator=h == coord,
                member_monitor_interval=0.2, member_probe_timeout=0.5,
                coordinator_failover_probes=2,
            )
        assert wait_for(lambda: all(
            (servers[h].cluster.coordinator_node() or Node(id="")).id == coord
            for h in (succ, other)
        ))
        # Simulate the missed broadcast: drop set-coordinator sends to
        # `other` by making the successor's client fail for that node.
        real_send = servers[succ].client.send_message

        def lossy_send(node, msg):
            if msg.get("type") == "set-coordinator" and node.id == other:
                from pilosa_tpu_torch.server.client import ClientError
                raise ClientError("injected drop", status=0)
            return real_send(node, msg)

        servers[succ].client.send_message = lossy_send
        servers.pop(coord).close()
        assert wait_for(lambda: servers[succ].node.is_coordinator, 15)
        # `other` never got the broadcast, but its probe of the successor
        # sees the self-claim, clears the dead holdover, and routes to the
        # live coordinator.
        assert wait_for(lambda: (
            servers[other].cluster.coordinator_node() or Node(id="")
        ).id == succ, 15)
        dead = servers[other].cluster.node_by_id(coord)
        assert wait_for(lambda: not dead.is_coordinator, 15)
    finally:
        for s in servers.values():
            s.close()


def test_failover_promotion_survives_restart(tmp_path):
    """A promoted successor restarting on its original (non-coordinator)
    config must re-assume the role from the persisted topology — else the
    cluster converges to zero coordinators."""
    ports = [free_port() for _ in range(3)]
    hosts = sorted(f"localhost:{p}" for p in ports)
    coord, succ, other = hosts[0], hosts[1], hosts[2]
    servers = {}
    try:
        for h in hosts:
            servers[h] = make_server(
                tmp_path, h.replace(":", "_"), int(h.rsplit(":", 1)[1]),
                cluster_hosts=hosts, is_coordinator=h == coord,
                member_monitor_interval=0.2, member_probe_timeout=0.5,
                coordinator_failover_probes=2,
            )
        assert wait_for(lambda: all(
            (servers[h].cluster.coordinator_node() or Node(id="")).id == coord
            for h in (succ, other)
        ))
        servers.pop(coord).close()
        assert wait_for(lambda: servers[succ].node.is_coordinator, 15)
        # Restart the successor with its ORIGINAL config (is_coordinator
        # False): the persisted topology must restore the claim.
        servers.pop(succ).close()
        servers[succ] = make_server(
            tmp_path, succ.replace(":", "_"), int(succ.rsplit(":", 1)[1]),
            cluster_hosts=hosts, is_coordinator=False,
            member_monitor_interval=0.2, member_probe_timeout=0.5,
            coordinator_failover_probes=2,
        )
        assert servers[succ].node.is_coordinator, \
            "promotion did not survive restart"
    finally:
        for s in servers.values():
            s.close()


def test_late_starter_learns_coordinator_third_party(tmp_path):
    """A node that starts while knowing no coordinator must adopt a peer's
    view of who holds the role (third-party claim), so failover can still
    identify whose death to detect."""
    ports = [free_port() for _ in range(3)]
    hosts = sorted(f"localhost:{p}" for p in ports)
    coord, mid, late = hosts[0], hosts[1], hosts[2]
    servers = {}
    try:
        for h in (coord, mid):
            servers[h] = make_server(
                tmp_path, h.replace(":", "_"), int(h.rsplit(":", 1)[1]),
                cluster_hosts=hosts, is_coordinator=h == coord,
                member_monitor_interval=0.2, member_probe_timeout=0.5,
                coordinator_failover_probes=0,  # no promotion racing the
                # third-party adoption this test asserts
            )
        assert wait_for(lambda: (
            servers[mid].cluster.coordinator_node() or Node(id="")
        ).id == coord)
        # Kill the coordinator BEFORE the late node starts: the late node
        # can only learn the role third-party, from mid's view.
        servers.pop(coord).close()
        servers[late] = make_server(
            tmp_path, late.replace(":", "_"), int(late.rsplit(":", 1)[1]),
            cluster_hosts=hosts, is_coordinator=False,
            member_monitor_interval=0.2, member_probe_timeout=0.5,
        )
        assert wait_for(lambda: (
            servers[late].cluster.node_by_id(coord) or Node(id="")
        ).is_coordinator, 15), "late starter never learned the coordinator"
    finally:
        for s in servers.values():
            s.close()


def test_failover_requires_strict_majority(tmp_path):
    """In a 2-node cluster the survivor is NOT a strict majority (1 of 2):
    it must never self-promote — a network partition would otherwise
    elect a second coordinator on each side."""
    ports = sorted(free_port() for _ in range(2))
    hosts = [f"localhost:{p}" for p in ports]
    coord, other = hosts[0], hosts[1]
    servers = {}
    try:
        for h in hosts:
            servers[h] = make_server(
                tmp_path, h.replace(":", "_"), int(h.rsplit(":", 1)[1]),
                cluster_hosts=hosts, is_coordinator=h == coord,
                member_monitor_interval=0.2, member_probe_timeout=0.5,
                coordinator_failover_probes=2,
            )
        assert wait_for(lambda: (
            servers[other].cluster.coordinator_node() or Node(id="")
        ).id == coord)
        servers.pop(coord).close()
        # Give the survivor ample probe rounds to (wrongly) promote.
        time.sleep(3.0)
        assert not servers[other].node.is_coordinator, \
            "survivor promoted without a strict majority"
    finally:
        for s in servers.values():
            s.close()
