"""Static clusters of port nodes answer as clusters of pilosa_tpu nodes.

A 3-node replica_n = 2 cluster of each package (port nodes on the CPU)
gets the same HTTP writes; then every node of each cluster answers the
same reads (Count, nested set-ops, Row, TopN with and without a filter,
Sum/Min/Max, BSI and time Range) with the same JSON body, exactly:
- with every node up;
- after one node's fragment diverges and its anti-entropy sweep repairs
  the replica;
- with one node closed, its shards served by their other replica.
Each cluster's data directories then reopen as a cluster of the other
package on the same hosts, and answer the same.

Mixed clusters: two nodes, one pilosa_tpu and one pilosa_tpu_torch, with
replica_n = 1, so that each answer crosses the packages through the wire
and the placement; queried through each node, they answer as an all-
pilosa_tpu cluster of two does.
"""

import json
import socket
import time

import numpy as np
import pytest

from pilosa_tpu.cluster.syncer import HolderSyncer as JSyncer
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cluster.syncer import HolderSyncer as TSyncer
from pilosa_tpu_torch.server.server import Server as TServer

W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 5


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def make_server(pkg, data_dir, port, hosts, replica_n):
    kw = dict(data_dir=data_dir, port=port, cluster_hosts=hosts, replica_n=replica_n,
              cache_flush_interval=0, anti_entropy_interval=0,
              member_monitor_interval=0, executor_workers=0)
    if pkg == "jax":
        return JServer(engine_config=JEngineConfig(gather_workers=1), **kw)
    return TServer(device="cpu", **kw)


def open_cluster(pkgs, dirs, ports, replica_n):
    hosts = [f"localhost:{p}" for p in ports]
    return [make_server(pkg, d, p, hosts, replica_n).open()
            for pkg, d, p in zip(pkgs, dirs, ports)]


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


def query(port, pql, params=""):
    return request(port, "POST", f"/index/i/query{params}", pql)


def seeded_writes(seed=7):
    """Set bits over N_SHARDS shards, int values and timestamped bits,
    made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, 400)
    cols = rng.integers(0, N_SHARDS * W, 400)
    sets = [f"Set({c}, f={r})" for r, c in zip(rows, cols)]
    vcols = rng.choice(N_SHARDS * W, 60, replace=False)
    vals = rng.integers(-1000, 1001, 60)
    values = [f"SetValue(col={c}, v={v})" for c, v in zip(vcols, vals)]
    tcols = rng.integers(0, N_SHARDS * W, 40)
    days = rng.integers(1, 28, 40)
    times = [f"Set({c}, t={i % 2}, 2018-0{1 + i % 3}-{d:02d}T00:00)"
             for i, (c, d) in enumerate(zip(tcols, days))]
    return [" ".join(sets[i:i + 100]) for i in range(0, len(sets), 100)] + [
        " ".join(values), " ".join(times), "Clear(%d, f=%d)" % (cols[0], rows[0]),
        'SetRowAttrs(f, 1, color="red")', 'SetColumnAttrs(%d, name="x")' % cols[1]]


SCHEMA = [
    ("/index/i", "{}"),
    ("/index/i/field/f", "{}"),
    ("/index/i/field/v", '{"options": {"type": "int", "min": -1000, "max": 1000}}'),
    ("/index/i/field/t", '{"options": {"type": "time", "timeQuantum": "YMD"}}'),
]
# One import request per shard: a request carries one shard's bits.
IMPORTS = [{"shard": 0, "rowIDs": [7, 8], "columnIDs": [3, 9]},
           {"shard": 1, "rowIDs": [7], "columnIDs": [W + 4]},
           {"shard": 4, "rowIDs": [7, 7], "columnIDs": [4 * W + 5, 4 * W + 6]}]
READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Difference(Row(f=0), Row(f=3)), Xor(Row(f=4), Intersect(Row(f=5), Row(f=1)))))",
    "Row(f=1)",
    "Row(f=7)",
    "Union(Row(f=2), Intersect(Row(f=3), Row(f=4)))",
    "TopN(f, n=3)",
    "TopN(f, n=10)",
    "TopN(f, Row(f=2), n=4)",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Sum(Row(f=1), field=v)",
    "Max(Row(f=2), field=v)",
    "Min(Row(f=3), field=v)",
    "Count(Range(v > 0))",
    "Range(v >< [-100, 500])",
    "Count(Intersect(Row(f=0), Range(v < 200)))",
    "Range(t=0, 2018-01-01T00:00, 2018-02-15T00:00)",
    "Count(Range(t=1, 2018-01-01T00:00, 2018-04-01T00:00))",
]


def write_script(port):
    for path, body in SCHEMA:
        assert request(port, "POST", path, body)[0] == 200
    time.sleep(0.05)
    for pql in seeded_writes():
        status, body = query(port, pql)
        assert status == 200, body
    for imp in IMPORTS:
        status, body = request(port, "POST", "/index/i/field/f/import", json.dumps(imp))
        assert status == 200, body


def read_all(servers, skip=(), only=None):
    nodes = [i for i in range(len(servers)) if i not in skip and only in (None, i)]
    return {(i, pql): query(servers[i].port, pql) for i in nodes for pql in READS} | {
        (i, "Row(f=1) columnAttrs"): query(servers[i].port, "Row(f=1)", "?columnAttrs=true")
        for i in nodes}


def diverge_and_repair(servers, syncer):
    """Plant a bit in one owner's fragment of shard 2 only, then run
    that node's anti-entropy sweep."""
    owner_id = servers[0].cluster.shard_nodes("i", 2)[0].id
    owner = next(s for s in servers if s.node.id == owner_id)
    owner.holder.fragment("i", "f", "standard", 2).set_bit(1, 2 * W + 999)
    syncer(owner).sync_holder()


def run_cluster(pkg, other, base):
    """One package's cluster through the phases; returns the answers of
    each phase and the answers of its directories reopened by `other`."""
    dirs = [str(base / f"{pkg}{i}") for i in range(3)]
    ports = free_ports(3)
    servers = open_cluster([pkg] * 3, dirs, ports, 2)
    syncer = JSyncer if pkg == "jax" else TSyncer
    out = {}
    try:
        write_script(ports[0])
        out["up"] = read_all(servers)
        diverge_and_repair(servers, syncer)
        out["repaired"] = read_all(servers)
        servers[1].close()
        out["one_down"] = read_all(servers, skip=(1,))
    finally:
        for s in servers:
            if s.opened:
                s.close()
    servers = open_cluster([other] * 3, dirs, ports, 2)
    try:
        # Node 0 fans out to the other two: every directory is read.
        out["reopened"] = read_all(servers, only=0)
    finally:
        for s in servers:
            s.close()
    return out


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    base = tmp_path_factory.mktemp("clusters")
    return {"jax": run_cluster("jax", "torch", base),
            "torch": run_cluster("torch", "jax", base)}


KEYS = [(i, pql) for i in range(3) for pql in READS] + [
    (i, "Row(f=1) columnAttrs") for i in range(3)]
# Node 1 is the one closed in phase "one_down".
PHASE_KEYS = [(phase, key) for phase in ("up", "repaired", "one_down")
              for key in KEYS if not (phase == "one_down" and key[0] == 1)]


@pytest.mark.parametrize("phase, key", PHASE_KEYS,
                         ids=lambda v: v if isinstance(v, str) else f"node{v[0]}:{v[1]}"[:70])
def test_port_cluster_answers_like_jax(clusters, phase, key):
    want = clusters["jax"][phase][key]
    assert want[0] == 200, want
    assert clusters["torch"][phase][key] == want


@pytest.mark.parametrize("pql", READS)
def test_answers_agree_across_nodes_and_phases(clusters, pql):
    """Every node gives the one answer; the repair adds the planted bit
    and the dead replica changes nothing."""
    for pkg in ("jax", "torch"):
        ans = clusters[pkg]
        up = {ans["up"][(i, pql)][1]["results"][0].__repr__() for i in range(3)}
        assert len(up) == 1, (pkg, pql)
        rep = {ans["repaired"][(i, pql)][1]["results"][0].__repr__() for i in range(3)}
        down = {ans["one_down"][(i, pql)][1]["results"][0].__repr__() for i in (0, 2)}
        assert len(rep) == 1 and down == rep, (pkg, pql)
    assert clusters["torch"]["repaired"][(0, "Count(Row(f=1))")][1]["results"][0] == \
        clusters["torch"]["up"][(0, "Count(Row(f=1))")][1]["results"][0] + 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("key", [k for k in KEYS if k[0] == 0],
                         ids=lambda k: f"node{k[0]}:{k[1]}"[:70])
def test_data_directories_reopen_in_the_other_package(clusters, pkg, key):
    """A cluster's data directories, reopened as a cluster of the other
    package on the same hosts, answer as the writer did after repair."""
    assert clusters[pkg]["reopened"][key] == clusters[pkg]["repaired"][key]


# ------------------------------------------------------------ mixed nodes

MIXED_READS = READS + ["Row(f=1) columnAttrs"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A pilosa_tpu + pilosa_tpu_torch cluster and an all-pilosa_tpu one
    on the same hosts, so that placement is the same; writes go through
    the JAX node, half the reads through each node."""
    base = tmp_path_factory.mktemp("mixed")
    ports = free_ports(2)
    out = {}
    for name, pkgs in (("mixed", ["jax", "torch"]), ("jax", ["jax", "jax"]),
                       ("mixed_rev", ["torch", "jax"])):
        servers = open_cluster(pkgs, [str(base / f"{name}{i}") for i in range(2)],
                               ports, 1)
        try:
            write_script(ports[0])
            out[name] = read_all(servers)
            out[name + "_placement"] = sorted(
                (s, servers[0].cluster.shard_nodes("i", s)[0].id) for s in range(N_SHARDS))
        finally:
            for s in servers:
                s.close()
    return out


@pytest.mark.parametrize("name", ["mixed", "mixed_rev"])
@pytest.mark.parametrize("node", [0, 1])
@pytest.mark.parametrize("pql", MIXED_READS)
def test_mixed_cluster_answers_like_all_jax(mixed, name, node, pql):
    assert mixed[name + "_placement"] == mixed["jax_placement"]
    assert len({n for _, n in mixed["jax_placement"]}) == 2  # answers cross nodes
    want = mixed["jax"][(node, pql)]
    assert want[0] == 200, want
    assert mixed[name][(node, pql)] == want


def test_anti_entropy_repair_reaches_the_engine(tmp_path):
    """A replica repaired by anti-entropy recounts through the engine's
    Count path (K1's twin on the CPU) from a delta refresh of its
    resident planes: the merge moves the fragment's generation and
    journal, so no cache serves the pre-repair count and nothing is
    re-gathered whole."""
    ports = free_ports(2)
    a, b = open_cluster(["torch"] * 2, [str(tmp_path / f"n{i}") for i in range(2)],
                        ports, 2)
    try:
        for path, body in SCHEMA[:2]:
            assert request(ports[0], "POST", path, body)[0] == 200
        rng = np.random.default_rng(12)
        cols = rng.choice(3 * W, 200, replace=False)
        for row in (1, 2):
            pql = " ".join(f"Set({c}, f={row})" for c in cols[row * 50:row * 50 + 100])
            assert query(ports[0], pql)[0] == 200
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        want = a.executor.execute("i", q)[0]
        eng = b.executor.engine
        with eng.memos_off():
            assert b.executor.execute("i", q) == [want]
            col = next(int(c) for c in cols[150:] if c // W == 1)
            a.holder.fragment("i", "f", "standard", 1).set_bit(1, col)
            assert b.executor.execute("i", q) == [want]  # b has not seen it
            before = eng.snapshot()
            TSyncer(a).sync_holder()
            assert b.executor.execute("i", q) == [want + 1]
            after = eng.snapshot()
        assert after["full_refresh_bytes"] == before["full_refresh_bytes"]
        assert (after["leaf_delta_hits"] + after["stack_delta_hits"]
                > before["leaf_delta_hits"] + before["stack_delta_hits"])
    finally:
        a.close()
        b.close()
