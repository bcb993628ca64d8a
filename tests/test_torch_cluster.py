"""tests/test_cluster.py against the port: placement math, replication,
anti-entropy sync, the resize planner's fragment sources and the
coordinator-driven resize of a live cluster, with port servers on the
CPU; plus tests/test_server.py's keyed import through a translation
replica (translate replication)."""

import socket
import time

import numpy as np
import pytest

from pilosa_tpu_torch.cluster.hash import JmpHasher, ModHasher, jump_hash, partition
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.cluster.resize import ResizeCoordinator, fragment_sources
from pilosa_tpu_torch.cluster.syncer import HolderSyncer
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


# ----------------------------------------------------------- placement math


def test_jump_hash_distribution():
    # Keys spread over buckets; consistent: changing n only moves ~1/n keys.
    n_keys = 1000
    h3 = [jump_hash(k, 3) for k in range(n_keys)]
    h4 = [jump_hash(k, 4) for k in range(n_keys)]
    assert set(h3) == {0, 1, 2}
    moved = sum(1 for a, b in zip(h3, h4) if a != b)
    assert moved < n_keys / 2  # only keys moving to the new bucket move
    assert all(b == 3 for a, b in zip(h3, h4) if a != b)


def test_partition_deterministic():
    assert partition("i", 0) == partition("i", 0)
    assert partition("i", 0) != partition("other", 0) or True  # may collide
    assert 0 <= partition("i", 12345) < 256


def test_replica_placement():
    nodes = [Node(id=f"node{i}") for i in range(4)]
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=2)
    owners = c.shard_nodes("i", 7)
    assert len(owners) == 2
    assert owners[0].id != owners[1].id
    # Replicas are consecutive on the ring.
    i0 = nodes.index(c.node_by_id(owners[0].id))
    assert owners[1].id == nodes[(i0 + 1) % 4].id


def test_contains_shards():
    nodes = [Node(id=f"node{i}") for i in range(3)]
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=1, hasher=ModHasher())
    all_shards = set()
    for n in nodes:
        all_shards.update(c.contains_shards("i", 9, n))
    assert all_shards == set(range(10))


# -------------------------------------------------------------- replication


@pytest.fixture
def cluster2r(tmp_path):
    """2 nodes, replica_n=2: every shard lives on both nodes."""
    ports = [free_port() for _ in range(2)]
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
            anti_entropy_interval=0,  # manual sync in tests
            executor_workers=0,
        )
        s.open()
        servers.append(s)
    yield servers
    for s in servers:
        s.close()


def test_replicated_write(cluster2r):
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "r")
    client.create_field(h0, "r", "f")
    time.sleep(0.05)
    client.query(h0, "r", "Set(5, f=1)")
    # Both replicas hold the bit.
    for s in cluster2r:
        frag = s.holder.fragment("r", "f", "standard", 0)
        assert frag is not None and frag.bit(1, 5), s.node.id


def test_anti_entropy_repairs_divergence(cluster2r):
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "r")
    client.create_field(h0, "r", "f")
    time.sleep(0.05)
    client.query(h0, "r", "Set(5, f=1)")
    # Diverge: plant a bit directly in node0's holder only.
    frag0 = cluster2r[0].holder.fragment("r", "f", "standard", 0)
    frag0.set_bit(1, 99)
    frag1 = cluster2r[1].holder.fragment("r", "f", "standard", 0)
    assert not frag1.bit(1, 99)
    # Run anti-entropy on node0: even-split consensus keeps the bit and
    # pushes it to the replica.
    HolderSyncer(cluster2r[0]).sync_holder()
    assert frag1.bit(1, 99)
    assert frag0.bit(1, 99)


def test_anti_entropy_syncs_nonstandard_views(cluster2r):
    """Divergent bsig and time-quantum views converge: the blocks RPC is
    view-addressed (the reference's is standard-only, http/handler.go:1058)
    and non-standard diffs are pushed via the view-exact block endpoint
    since Set/Clear PQL can only reach the standard view."""
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "vw")
    client.create_field(h0, "vw", "t", {"type": "time", "timeQuantum": "YMD"})
    time.sleep(0.05)
    client.query(h0, "vw", "Set(5, t=1, 2018-01-02T00:00)")

    # Diverge a time view: plant a raw bit in node0's fragment only.
    tview = next(n for n in cluster2r[0].holder.field("vw", "t").view_names()
                 if n.startswith("standard_"))
    tf0 = cluster2r[0].holder.fragment("vw", "t", tview, 0)
    tf0.set_bit(1, 42)
    tf1 = cluster2r[1].holder.fragment("vw", "t", tview, 0)
    assert not tf1.bit(1, 42)

    # A whole view the replica has never heard of must also converge.
    bview = cluster2r[0].holder.field("vw", "t").create_view_if_not_exists("bsig_t")
    bfrag = bview.create_fragment_if_not_exists(0, broadcast=False)
    bfrag.set_bit(2, 99)
    assert cluster2r[1].holder.fragment("vw", "t", "bsig_t", 0) is None

    HolderSyncer(cluster2r[0]).sync_holder()
    assert tf1.bit(1, 42)
    bfrag1 = cluster2r[1].holder.fragment("vw", "t", "bsig_t", 0)
    assert bfrag1 is not None and bfrag1.bit(2, 99)
    # The replicated time bit survived the sweep on both nodes.
    assert client.query(h0, "vw", "Count(Row(t=1))")["results"][0] == 1


def test_anti_entropy_creates_missing_replica_fragment(cluster2r):
    """A replica that never saw a fragment receives it via anti-entropy:
    remote 404 on the blocks RPC counts as an empty block set so diffs are
    pushed (client.go:666-668 ErrFragmentNotFound -> empty)."""
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "mf")
    client.create_field(h0, "mf", "f")
    time.sleep(0.05)
    # Create the fragment only on node0, bypassing replication.
    fld0 = cluster2r[0].holder.field("mf", "f")
    view0 = fld0.create_view_if_not_exists("standard")
    frag0 = view0.create_fragment_if_not_exists(0, broadcast=False)
    frag0.set_bit(3, 17)
    assert cluster2r[1].holder.fragment("mf", "f", "standard", 0) is None

    HolderSyncer(cluster2r[0]).sync_holder()
    frag1 = cluster2r[1].holder.fragment("mf", "f", "standard", 0)
    assert frag1 is not None and frag1.bit(3, 17)


def test_anti_entropy_attr_sync(cluster2r):
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "r")
    client.create_field(h0, "r", "f")
    time.sleep(0.05)
    # Set attrs only on node1 directly.
    cluster2r[1].holder.field("r", "f").row_attr_store.set_attrs(3, {"tag": "x"})
    HolderSyncer(cluster2r[0]).sync_holder()
    assert cluster2r[0].holder.field("r", "f").row_attr_store.attrs(3) == {"tag": "x"}


# ------------------------------------------------------------------- resize


def test_fragment_sources_diff():
    old_nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    new_nodes = old_nodes + [Node(id="c", uri="c")]
    old = Cluster(node=old_nodes[0], nodes=old_nodes, hasher=ModHasher())
    new = Cluster(node=old_nodes[0], nodes=new_nodes, hasher=ModHasher())
    schema = [{"name": "i", "fields": [{"name": "f", "views": [{"name": "standard"}]}]}]
    sources = fragment_sources(old, new, schema, {"i": 5})
    # Node c must fetch every shard it now owns, from an old owner.
    c_fetches = {s["shard"] for s in sources["c"]}
    expected = {
        shard for shard in range(6)
        if any(n.id == "c" for n in new.shard_nodes("i", shard))
    }
    assert c_fetches == expected
    assert all(s["sourceNodeID"] in ("a", "b") for s in sources["c"])


_SCHEMA_1F = [
    {"name": "i", "fields": [{"name": "f", "views": [{"name": "standard"}]}]}
]


def test_fragment_sources_node_removal():
    """Removing a node: every shard it exclusively held is fetched by its
    new owner, sourced from an OLD owner (the leaver stays reachable as a
    source during the job)."""
    old_nodes = [Node(id="a", uri="a"), Node(id="b", uri="b"),
                 Node(id="c", uri="c")]
    new_nodes = old_nodes[:2]
    old = Cluster(node=old_nodes[0], nodes=old_nodes, hasher=ModHasher())
    new = Cluster(node=old_nodes[0], nodes=new_nodes, hasher=ModHasher())
    sources = fragment_sources(old, new, _SCHEMA_1F, {"i": 7})
    fetched = {s["shard"] for lst in sources.values() for s in lst}
    changed = {
        sh for sh in range(8)
        if [n.id for n in old.shard_nodes("i", sh)]
        != [n.id for n in new.shard_nodes("i", sh)]
    }
    assert fetched == changed
    for lst in sources.values():
        for s in lst:
            assert s["sourceNodeID"] in {
                n.id for n in old.shard_nodes("i", s["shard"])}


def test_fragment_sources_replica_overlap():
    """replica_n=2: a node that already holds a shard as a replica in the
    OLD placement never re-fetches it in the new one."""
    old_nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    new_nodes = old_nodes + [Node(id="c", uri="c")]
    old = Cluster(node=old_nodes[0], nodes=old_nodes, replica_n=2,
                  hasher=ModHasher())
    new = Cluster(node=old_nodes[0], nodes=new_nodes, replica_n=2,
                  hasher=ModHasher())
    sources = fragment_sources(old, new, _SCHEMA_1F, {"i": 7})
    for node_id, lst in sources.items():
        for s in lst:
            old_owners = {n.id for n in old.shard_nodes("i", s["shard"])}
            # Only genuinely-NEW owners appear; an overlap owner is never
            # instructed to fetch what it already has.
            assert node_id not in old_owners
            assert s["sourceNodeID"] in old_owners


def test_fragment_sources_noop_resize_is_empty():
    """Identical topologies produce zero instructions for every node."""
    nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    old = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    new = Cluster(node=nodes[0], nodes=list(nodes), hasher=ModHasher())
    sources = fragment_sources(old, new, _SCHEMA_1F, {"i": 9})
    assert all(lst == [] for lst in sources.values())


def test_fragment_sources_empty_old_owners():
    """A shard with NO old owner (empty prior cluster) is skipped instead
    of raising IndexError on old_owners[0]."""
    nodes = [Node(id="a", uri="a")]
    old = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    old.nodes = []  # constructor refuses an empty list; force it
    new = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    sources = fragment_sources(old, new, _SCHEMA_1F, {"i": 3})
    assert sources == {"a": []}


def test_fragment_sources_prefers_healthy_source():
    """source_ok steers selection to a healthy replica; when it rejects
    every old owner, placement order wins (a degraded source beats no
    source)."""
    old_nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    new_nodes = old_nodes + [Node(id="c", uri="c")]
    old = Cluster(node=old_nodes[0], nodes=old_nodes, replica_n=2,
                  hasher=ModHasher())
    new = Cluster(node=old_nodes[0], nodes=new_nodes, replica_n=2,
                  hasher=ModHasher())

    sources = fragment_sources(
        old, new, _SCHEMA_1F, {"i": 7},
        source_ok=lambda nid, *frag: nid != "a")
    entries = [s for lst in sources.values() for s in lst]
    assert entries
    assert all(s["sourceNodeID"] == "b" for s in entries)

    sources = fragment_sources(
        old, new, _SCHEMA_1F, {"i": 7},
        source_ok=lambda nid, *frag: False)
    for lst in sources.values():
        for s in lst:
            # Fallback: first old owner in placement order.
            assert s["sourceNodeID"] == old.shard_nodes("i", s["shard"])[0].id


def test_anti_entropy_syncs_oversized_divergence(cluster2r):
    """A divergence larger than max_writes_per_request (5000) must still
    converge: the pushed Set/Clear diff is chunked, where a single giant
    PQL request would be rejected by the peer's write cap and previously
    aborted the whole sweep."""
    client = InternalClient()
    h0 = f"localhost:{cluster2r[0].port}"
    client.create_index(h0, "big")
    client.create_field(h0, "big", "f")
    time.sleep(0.05)
    client.query(h0, "big", "Set(1, f=1)")  # both replicas have the seed

    # Diverge node 0 by 6500 bits applied directly to its fragment.
    frag0 = cluster2r[0].holder.fragment("big", "f", "standard", 0)
    cols = np.arange(10, 6510, dtype=np.uint64)
    frag0.bulk_import(np.ones(len(cols), dtype=np.uint64), cols)
    frag1 = cluster2r[1].holder.fragment("big", "f", "standard", 0)
    assert frag1.row_count(1) == 1  # replica lagging

    HolderSyncer(cluster2r[0]).sync_holder()
    assert frag1.row_count(1) == frag0.row_count(1) == 6501


def test_keyed_cluster_end_to_end(tmp_path):
    """A cluster with a shared gossip key: replication, remote fan-out,
    and anti-entropy all authenticate through the keyed /internal/* plane
    (public clients need no key)."""
    keyfile = tmp_path / "key"
    keyfile.write_text("cluster-secret-1")
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        s = Server(
            data_dir=str(tmp_path / f"kn{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=2,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,
            executor_workers=0,
            internal_key_path=str(keyfile),
        )
        s.open()
        servers.append(s)
    try:
        client = InternalClient()  # public plane: no key required
        h0 = hosts[0]
        client.create_index(h0, "k")
        client.create_field(h0, "k", "f")
        time.sleep(0.05)
        for col in (1, 2, 3):
            client.query(h0, "k", f"Set({col}, f=9)")
        for s in servers:
            frag = s.holder.fragment("k", "f", "standard", 0)
            assert frag is not None and frag.row_count(9) == 3, s.node.id
        # Diverge one replica; anti-entropy repairs through keyed routes.
        frag0 = servers[0].holder.fragment("k", "f", "standard", 0)
        frag0.bulk_import(np.full(50, 9, dtype=np.uint64),
                          np.arange(100, 150, dtype=np.uint64))
        HolderSyncer(servers[0]).sync_holder()
        assert servers[1].holder.fragment(
            "k", "f", "standard", 0).row_count(9) == 53
    finally:
        for s in servers:
            s.close()


def test_resize_add_node_moves_data(tmp_path):
    """Add a third node to a 2-node cluster with data; moved shards must be
    queryable from the new topology (reference ClusterResize_AddNode)."""
    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i in range(2):
        s = Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=ports[i],
            cluster_hosts=hosts[:2],
            hasher=ModHasher(),
            cache_flush_interval=0,
            executor_workers=0,
        )
        s.open()
        servers.append(s)
    client = InternalClient()
    h0 = hosts[0]
    try:
        client.create_index(h0, "rz")
        client.create_field(h0, "rz", "f")
        time.sleep(0.05)
        cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 3 * SHARD_WIDTH + 4]
        for col in cols:
            client.query(h0, "rz", f"Set({col}, f=1)")
        assert client.query(h0, "rz", "Count(Row(f=1))")["results"][0] == 4

        # Boot node2 (empty, same static membership limited to itself for now).
        s2 = Server(
            data_dir=str(tmp_path / "node2"),
            port=ports[2],
            cluster_hosts=[hosts[2]],
            hasher=ModHasher(),
            cache_flush_interval=0,
            executor_workers=0,
        )
        s2.open()
        servers.append(s2)

        # Coordinator (node0) runs the resize to the 3-node topology.
        coordinator = ResizeCoordinator(servers[0])
        servers[0].resize_coordinator = coordinator
        new_nodes = [Node(id=h, uri=h) for h in hosts]
        coordinator.begin(new_nodes)
        deadline = time.time() + 10
        while coordinator.job is not None and time.time() < deadline:
            time.sleep(0.05)
        assert coordinator.job is None, "resize did not complete"
        assert servers[0].cluster.state == "NORMAL"
        assert len(servers[0].cluster.nodes) == 3

        # All data still answerable through node0 with the new placement.
        assert client.query(h0, "rz", "Count(Row(f=1))")["results"][0] == 4
        row = client.query(h0, "rz", "Row(f=1)")
        assert row["results"][0]["columns"] == cols
        # node2 actually received the shards it now owns.
        owned = [
            s for s in range(4)
            if any(n.id == hosts[2] for n in servers[0].cluster.shard_nodes("rz", s))
        ]
        got = [
            s for s in owned
            if servers[2].holder.fragment("rz", "f", "standard", s) is not None
        ]
        assert got == owned
    finally:
        for s in servers:
            s.close()


def test_key_import_forwarding_to_translation_primary(tmp_path):
    """Key-mode bit AND value imports against a translation replica are
    forwarded to the primary (reference PrimaryTranslateStore semantics)."""
    primary = Server(data_dir=str(tmp_path / "pri"), cache_flush_interval=0)
    primary.open()
    c = InternalClient()
    try:
        c.create_index(f"localhost:{primary.port}", "ki", {"keys": True})
        c.create_field(f"localhost:{primary.port}", "ki", "b", {"keys": True})
        c.create_field(f"localhost:{primary.port}", "ki", "v", {"type": "int", "min": 0, "max": 100})
        replica = Server(
            data_dir=str(tmp_path / "rep"), cache_flush_interval=0,
            primary_translate_store_url=f"http://{f"localhost:{primary.port}"}",
        )
        replica.open()
        try:
            assert replica.translate_store.read_only
            # Schema must exist on the replica too (it forwards, but the
            # field lookup happens first).
            c.create_index(f"localhost:{replica.port}", "ki", {"keys": True})
            c.create_field(f"localhost:{replica.port}", "ki", "b", {"keys": True})
            c.create_field(f"localhost:{replica.port}", "ki", "v", {"type": "int", "min": 0, "max": 100})
            c.import_bits(f"localhost:{replica.port}", "ki", "b", [("r1", "alice"), ("r1", "bob")])
            c.import_values(f"localhost:{replica.port}", "ki", "v", [("alice", 42), ("bob", 58)])
            resp = c.query(f"localhost:{primary.port}", "ki", 'Count(Row(b="r1"))')
            assert resp["results"][0] == 2
            resp = c.query(f"localhost:{primary.port}", "ki", "Sum(field=v)")
            assert resp["results"][0] == {"value": 100, "count": 2}
        finally:
            replica.close()
    finally:
        primary.close()
