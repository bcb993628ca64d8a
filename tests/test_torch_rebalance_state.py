"""Device state across a changing cluster, on port servers on the CPU.

- A shard moves away from a node (a node joins) and back (the node is
  removed), with writes to it while it is away: the first node's engine
  (memo on) must answer every Count as numpy does before and after each
  move, never from a stale memo entry or a cached stack of the old
  fragment incarnation.
- A two-rank collective job that a third node (not a rank) joins: the
  new membership's placement is refused with reason `placement` and the
  leader refuses an entry with reason `inactive` (three nodes, two
  ranks), as in the JAX package; queries are answered right by the
  fan-out from every node, no barrier times out, and the plane's
  breakers stay closed.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from pilosa_tpu_torch.cluster.hash import ModHasher, partition
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.server.client import InternalClient
from pilosa_tpu_torch.server.server import Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 4


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(cond, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_shard_moved_away_and_back_recounts(tmp_path):
    def owner(hosts, shard):
        return sorted(hosts)[partition("i", shard, 256) % len(hosts)]

    for _ in range(64):
        ports = [free_port(), free_port()]
        hosts = [f"localhost:{p}" for p in ports]
        moving = [s for s in range(N_SHARDS) if owner(hosts, s) == hosts[1]]
        if moving:
            break
    kw = dict(cache_flush_interval=0, anti_entropy_interval=0,
              member_monitor_interval=0, executor_workers=0,
              hasher=ModHasher(), device="cpu")
    a = Server(data_dir=str(tmp_path / "a"), port=ports[0],
               cluster_hosts=hosts[:1], **kw).open()
    servers = [a]
    client = InternalClient()
    rng = np.random.default_rng(3)
    bits = {1: set(), 2: set()}

    def write(pql_op, row, col):
        client.query(hosts[0], "i", f"{pql_op}({col}, f={row})")
        (bits[row].add if pql_op == "Set" else bits[row].discard)(col)

    def check(server):
        want = len(bits[1] & bits[2])
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        for _ in range(2):  # the repeat is a memo hit
            assert client.query(server.node.uri, "i", q)["results"][0] == want
        assert client.query(server.node.uri, "i", "Count(Row(f=1))")[
            "results"][0] == len(bits[1])

    try:
        client.create_index(hosts[0], "i")
        client.create_field(hosts[0], "i", "f")
        for col in rng.integers(0, N_SHARDS * W, 200):
            write("Set", int(rng.integers(1, 3)), int(col))
        for col in rng.integers(0, N_SHARDS * W, 100):
            write("Set", 1, int(col))
            write("Set", 2, int(col))
        check(a)
        hits = a.executor.engine.snapshot()["memo_hits"]
        assert hits >= 1

        # Away: b joins and receives `moving`; writes land on b.
        b = Server(data_dir=str(tmp_path / "b"), port=ports[1],
                   join_addr=hosts[0], is_coordinator=False, **kw).open()
        servers.append(b)
        assert wait_for(lambda: len(a.cluster.nodes) == 2
                        and a.cluster.next_nodes is None
                        and b.cluster.state == "NORMAL")
        for s in moving:
            assert b.holder.fragment("i", "f", "standard", s) is not None
        for s in moving:
            for col in rng.integers(0, W, 20):
                write("Set", 1, s * W + int(col))
                write("Set", 2, s * W + int(col))
            gone = sorted(c for c in bits[1] & bits[2] if c // W == s)[:5]
            for col in gone:
                write("Clear", 2, col)
        check(a)
        check(b)

        # Back: b is removed; its shards (with the writes) return to a.
        req = {"id": hosts[1]}
        client._request("POST", f"http://{hosts[0]}/cluster/resize/remove-node",
                        json.dumps(req).encode())
        assert wait_for(lambda: len(a.cluster.nodes) == 1
                        and a.cluster.next_nodes is None
                        and a.cluster.state == "NORMAL")
        misses = a.executor.engine.snapshot()["memo_misses"]
        check(a)
        assert a.executor.engine.snapshot()["memo_misses"] > misses
        for s in moving:
            col = s * W + 5
            write("Set", 1, col)
            write("Set", 2, col)
        check(a)
    finally:
        for s in servers:
            s.close()


WORKER = textwrap.dedent("""
    import json, os, sys, time

    role, coord, p0, p1, p2, tmp = sys.argv[1:7]
    ports = [int(p0), int(p1), int(p2)]
    hosts = [f"localhost:{p}" for p in ports]
    if role != "joiner":
        os.environ["PILOSA_JAX_COORDINATOR"] = coord
        os.environ["PILOSA_JAX_NUM_PROCESSES"] = "2"
        os.environ["PILOSA_JAX_PROCESS_ID"] = role
        os.environ["PILOSA_COLLECTIVE_TIMEOUT_MS"] = "3000"

    from pilosa_tpu_torch.parallel.collective import (
        CollectiveUnavailable, placement)
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.server.client import InternalClient
    from pilosa_tpu_torch.server.server import Server

    SW = 1 << 20
    kw = dict(cache_flush_interval=0, anti_entropy_interval=0,
              member_monitor_interval=0.2, executor_workers=0, device="cpu")
    if role == "joiner":
        while not os.path.exists(f"{tmp}/join"):
            time.sleep(0.05)
        s = Server(data_dir=f"{tmp}/node2", port=ports[2], join_addr=hosts[0],
                   is_coordinator=False, **kw)
    else:
        pid = int(role)
        s = Server(data_dir=f"{tmp}/node{pid}", port=ports[pid],
                   cluster_hosts=hosts[:2], replica_n=1, **kw)
    s.open()
    try:
        if role != "0":
            while not os.path.exists(f"{tmp}/done"):
                time.sleep(0.05)
            print(f"WORKER_{role}_OK")
            sys.exit(0)
        client = InternalClient()
        h = hosts[0]
        deadline = time.time() + 30
        while time.time() < deadline and not s.collective.active():
            time.sleep(0.1)
        assert s.collective.active()
        client.create_index(h, "ci")
        client.create_field(h, "ci", "f")
        row1 = [5, SW + 1, 2 * SW + 9, 3 * SW + 7, 4 * SW + 3, 5 * SW + 2, 11]
        row2 = [5, SW + 1, 4 * SW + 3, 9]
        for col in row1:
            client.query(h, "ci", f"Set({col}, f=1)")
        for col in row2:
            client.query(h, "ci", f"Set({col}, f=2)")
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        assert client.query(h, "ci", q)["results"][0] == 3
        assert s.collective.snapshot()["served_count"] >= 1

        open(f"{tmp}/join", "w").close()
        deadline = time.time() + 60
        while time.time() < deadline and not (
                len(s.cluster.nodes) == 3 and s.cluster.next_nodes is None
                and s.cluster.state == "NORMAL"):
            time.sleep(0.05)
        assert len(s.cluster.nodes) == 3, [n.id for n in s.cluster.nodes]
        joined = s.cluster.node_by_id(hosts[2])
        assert joined.process_idx is None
        moved = [sh for sh in range(6)
                 if s.cluster.shard_nodes("ci", sh)[0].id == hosts[2]]
        assert moved, "the join moved no shard"
        try:
            placement(s.cluster, "ci", 6, 2)
            raise AssertionError("placement accepted a node outside the job")
        except CollectiveUnavailable as e:
            assert e.reason == "placement", e.reason
        try:
            s.collective.count("ci", parse(q).calls[0].children[0])
            raise AssertionError("the plane served a node outside the job")
        except CollectiveUnavailable as e:
            # Three nodes, two ranks: the leader refuses before placing,
            # as the JAX package does.
            assert e.reason == "inactive", e.reason
        for host in hosts:
            assert client.query(host, "ci", q)["results"][0] == 3
            got = client.query(host, "ci", "TopN(f, n=2)")["results"][0]
            assert {p["id"]: p["count"] for p in got} == {1: 7, 2: 4}, got
        snap = s.collective.snapshot()
        assert snap["barrier_timeouts"] == 0, snap
        assert set(snap["fallbacks"]) <= {"placement", "epoch", "inactive"}, snap
        assert snap["broken"] is None, snap
        assert s.collective.health.allow([0, 1]), snap["health"]
        print("WORKER_0_OK " + json.dumps(snap["fallbacks"]))
    finally:
        open(f"{tmp}/done", "w").close()
        s.close()
""")


def test_collective_job_refuses_a_joined_node(tmp_path):
    coord = f"localhost:{free_port()}"
    for _ in range(64):
        # Ports whose node ids give the third node shards of "ci".
        ports = [free_port() for _ in range(3)]
        nodes = [Node(id=f"localhost:{p}", uri=f"localhost:{p}") for p in ports]
        cluster = Cluster(node=nodes[0], nodes=sorted(nodes, key=lambda n: n.id),
                          replica_n=1)
        if any(cluster.shard_nodes("ci", sh)[0].id == nodes[2].id for sh in range(6)):
            break
    path = tmp_path / "worker.py"
    path.write_text(WORKER)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, str(path), role, coord] + [str(p) for p in ports] + [str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path)) for role in ("0", "1", "joiner")]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
    assert "WORKER_0_OK" in outs[0][1]


def test_fan_out_reroutes_shards_of_a_departed_node():
    """A leave that commits between a fan-out's shard assignment and its
    dispatch: the departed node is no longer in the membership, so its
    shards re-route on the refreshed placement (here: this node) instead
    of failing the query."""
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.stats import InMemoryStatsClient

    holder = Holder(None, stats=InMemoryStatsClient(), device="cpu")
    holder.open()
    fld = holder.create_index("i").create_field("f")
    cols = [3, W + 4, 2 * W + 5]
    fld.import_bits([1] * len(cols), cols)
    ex = Executor(holder, workers=0)
    real = ex._assign_shards
    calls = []

    def assign(index, shards, exclude=()):
        calls.append((list(shards), set(exclude)))
        if len(calls) == 1:
            return [], {"gone:1": list(shards)}
        return real(index, shards, exclude=exclude)

    ex._assign_shards = assign
    try:
        assert ex.execute("i", "Count(Row(f=1))") == [3]
        assert calls[1] == ([0, 1, 2], {"gone:1"})
        counters = holder.stats.snapshot()["counters"]
        assert counters.get("DepartedNodeReroute") == 1, counters
        assert "StaleEpochReroute" not in counters, counters
    finally:
        ex.close()
        holder.close()


@pytest.mark.parametrize("epoch_moves", [True, False])
def test_fan_out_reroutes_a_409_on_a_newer_epoch(epoch_moves):
    """A peer refuses a forwarded read with a 409 (it applied a cutover
    commit that this node has not): the re-route waits until this node's
    routing epoch moves, up to `cutover_wait`, and then reads the
    refreshed placement with the peer still eligible; if the epoch does
    not move, it re-routes without the peer once the wait is over."""
    import threading

    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.server.client import ClientError
    from pilosa_tpu_torch.stats import InMemoryStatsClient

    holder = Holder(None, stats=InMemoryStatsClient(), device="cpu")
    holder.open()
    fld = holder.create_index("i").create_field("f")
    cols = [3, W + 4, 2 * W + 5]
    fld.import_bits([1] * len(cols), cols)
    ex = Executor(holder, workers=0)
    ex.cutover_wait = 0.5
    peer = Node(id="peer:1", uri="peer:1")
    ex.cluster.node_by_id = lambda nid: peer if nid == peer.id else None
    real = ex._assign_shards
    epoch0 = ex.cluster.routing_epoch
    seen = []

    def assign(index, shards, exclude=()):
        seen.append((ex.cluster.routing_epoch, set(exclude)))
        if len(seen) == 1:
            return [], {peer.id: list(shards)}
        return real(index, shards, exclude=exclude)

    def bump():
        ex.cluster.routing_epoch += 1

    def dispatch(node, index, c, shards, kw):
        if epoch_moves:
            threading.Timer(0.1, bump).start()
        raise ClientError("409 stale routing epoch", status=409)

    ex._assign_shards = assign
    ex._remote_dispatch = dispatch
    try:
        t0 = time.monotonic()
        assert ex.execute("i", "Count(Row(f=1))") == [3]
        waited = time.monotonic() - t0
        assert seen == [(epoch0, set()), (epoch0 + 1, set()) if epoch_moves
                        else (epoch0, {peer.id})]
        assert (waited < 0.4) if epoch_moves else (waited >= 0.5), waited
        assert holder.stats.snapshot()["counters"]["StaleEpochReroute"] == 1
    finally:
        ex.close()
        holder.close()
