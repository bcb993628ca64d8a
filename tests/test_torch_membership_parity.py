"""Clusters that change shape answer alike on both packages.

A node of one package joins a two-node cluster of the other package
(replica_n = 1, so every answer crosses the packages through the wire and
the placement): the coordinator's live rebalance moves the joiner's
shards to it while a writer keeps issuing Sets and Clears. Once the
rebalance is done, every node answers Count, nested set-ops, Row, TopN
and Sum/Min/Max exactly as one pilosa_tpu node that holds all the data
(the same writes plus every acknowledged live write). Then
`/cluster/resize/remove-node` takes the joiner out, its shards move back,
and the answers hold again. Port nodes run on the CPU.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.cluster.hash import ModHasher as JModHasher
from pilosa_tpu.cluster.hash import partition
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cluster.hash import ModHasher as TModHasher
from pilosa_tpu_torch.server.server import Server as TServer

W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 5

SCHEMA = [
    ("/index/i", "{}"),
    ("/index/i/field/f", "{}"),
    ("/index/i/field/v", '{"options": {"type": "int", "min": -1000, "max": 1000}}'),
]
READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Difference(Row(f=0), Row(f=3)), Xor(Row(f=4), Row(f=9))))",
    "Row(f=1)",
    "Row(f=9)",
    "TopN(f, n=4)",
    "TopN(f, Row(f=2), n=4)",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Sum(Row(f=1), field=v)",
    "Count(Range(v > 0))",
]


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def migration_ports():
    """Three free ports whose host:port node ids give a 2 -> 3 placement
    that moves shards onto the third node (ModHasher over sorted ids)."""
    def owner(hosts, shard):
        ordered = sorted(hosts)
        return ordered[partition("i", shard, 256) % len(ordered)]

    for _ in range(64):
        ports = free_ports(3)
        hosts = [f"localhost:{p}" for p in ports]
        if any(owner(hosts, sh) == hosts[2] for sh in range(N_SHARDS)):
            return ports, hosts
    raise RuntimeError("could not find a migrating port triple")


def make_server(pkg, data_dir, port, **kw):
    kw.update(data_dir=data_dir, port=port, cache_flush_interval=0,
              anti_entropy_interval=0, member_monitor_interval=0,
              executor_workers=0)
    if pkg == "jax":
        return JServer(engine_config=JEngineConfig(gather_workers=1),
                       hasher=JModHasher(), **kw).open()
    return TServer(device="cpu", hasher=TModHasher(), **kw).open()


def request(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=120)
    try:
        conn.request(method, path, body=body.encode() if isinstance(body, str) else body)
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    return resp.status, json.loads(raw)


def query(port, pql):
    return request(port, "POST", "/index/i/query", pql)


def seeded_writes(seed=11):
    """Set bits over N_SHARDS shards and int values, from a numpy seed."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, 300)
    cols = rng.integers(0, N_SHARDS * W, 300)
    sets = [f"Set({c}, f={r})" for r, c in zip(rows, cols)]
    vcols = rng.choice(N_SHARDS * W, 40, replace=False)
    vals = rng.integers(-1000, 1001, 40)
    values = [f"SetValue(col={c}, v={v})" for c, v in zip(vcols, vals)]
    return [" ".join(sets[i:i + 100]) for i in range(0, len(sets), 100)] + [
        " ".join(values), "Clear(%d, f=%d)" % (cols[0], rows[0])]


def live_writes(seed=12, n=60):
    """A writer's sequence: Sets of row 9 over every shard, and every
    fourth op a Clear of an earlier Set."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, N_SHARDS * W, n)
    out = []
    for i, c in enumerate(cols):
        out.append(f"Set({c}, f=9)")
        if i % 4 == 3:
            out.append(f"Clear({cols[i - 2]}, f=9)")
    return out


def wait_for(cond, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def answers(port):
    got = []
    for pql in READS:
        status, body = query(port, pql)
        assert status == 200, (pql, body)
        got.append(body)
    return got


@pytest.mark.parametrize("base,joiner", [("jax", "torch"), ("torch", "jax")])
def test_join_and_leave_across_packages(tmp_path, base, joiner):
    ports, hosts = migration_ports()
    servers = [make_server(base, str(tmp_path / f"n{i}"), ports[i],
                           cluster_hosts=hosts[:2]) for i in range(2)]
    ref = make_server("jax", str(tmp_path / "ref"), free_ports(1)[0])
    try:
        for path, body in SCHEMA:
            assert request(ports[0], "POST", path, body)[0] == 200
            assert request(ref.port, "POST", path, body)[0] == 200
        time.sleep(0.05)
        for pql in seeded_writes():
            assert query(ports[0], pql)[0] == 200
            assert query(ref.port, pql)[0] == 200

        acked = []
        stop = threading.Event()
        writes = live_writes()

        def writer():
            for i, pql in enumerate(writes):
                if stop.is_set():
                    return
                status, _ = query(ports[i % 2], pql)
                if status == 200:
                    acked.append(pql)
                time.sleep(0.003)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        servers.append(make_server(joiner, str(tmp_path / "n2"), ports[2],
                                   join_addr=hosts[0], is_coordinator=False))
        assert wait_for(lambda: len(servers[0].cluster.nodes) == 3
                        and servers[0].cluster.next_nodes is None
                        and all(s.cluster.state == "NORMAL" for s in servers))
        t.join(timeout=60)
        assert not t.is_alive()
        assert len(acked) == len(writes)
        for pql in acked:
            assert query(ref.port, pql)[0] == 200
        moved = [sh for sh in range(N_SHARDS)
                 if servers[0].cluster.shard_nodes("i", sh)[0].id == hosts[2]]
        assert moved
        for sh in moved:
            assert servers[2].holder.fragment("i", "f", "standard", sh) is not None
        want = answers(ref.port)
        for s in servers:
            assert answers(s.port) == want, s.node.id

        status, _ = request(ports[0], "POST", "/cluster/resize/remove-node",
                            json.dumps({"id": hosts[2]}))
        assert status == 200
        assert wait_for(lambda: len(servers[0].cluster.nodes) == 2
                        and servers[0].cluster.next_nodes is None
                        and servers[0].cluster.state == "NORMAL"
                        and servers[1].cluster.state == "NORMAL")
        for s in servers[:2]:
            assert answers(s.port) == want, s.node.id
    finally:
        stop.set()
        for s in servers + [ref]:
            s.close()
