"""tests/test_rebalance.py against the port: live online rebalance
(image, catch-up ops, cutover seal), routing epochs and 409 re-routes,
hinted writes across a move, the legacy resize path and crash recovery,
with port servers on the CPU."""

import json
import os
import socket
import threading
import time

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.cluster.rebalance import (
    RebalanceConfig, pack_framed, unpack_framed,
)
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.errors import PilosaError, ShardMovedError
from pilosa_tpu_torch.server.client import ClientError, InternalClient
from pilosa_tpu_torch.server.server import Server as _Server

pytestmark = pytest.mark.chaos

N_SHARDS = 4


def Server(*args, **kw):
    """The port's server on the CPU."""
    return _Server(*args, device="cpu", **kw)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def migration_ports(index="rb", n_shards=N_SHARDS):
    """Three free ports whose host:port node ids produce a 2->3 placement
    that actually MOVES shards onto the third node. Node ids are derived
    from random ports, so an arbitrary triple occasionally yields a
    no-op resize — these tests exist to exercise migration, not to win a
    placement lottery."""
    from pilosa_tpu_torch.cluster.hash import partition as partition_of

    def owner(hosts, shard):
        ordered = sorted(hosts)
        return ordered[partition_of(index, shard, 256) % len(ordered)]

    for _ in range(64):
        ports = [free_port() for _ in range(3)]
        hosts = [f"localhost:{p}" for p in ports]
        gains = [sh for sh in range(n_shards)
                 if owner(hosts, sh) == hosts[2]
                 and owner(hosts[:2], sh) != hosts[2]]
        if gains:
            return ports, hosts
    raise RuntimeError("could not find a migrating port triple")


def make_server(tmp_path, name, port, **kw):
    from pilosa_tpu_torch.cluster.health import ResilienceConfig

    kw.setdefault("cache_flush_interval", 0)
    kw.setdefault("member_monitor_interval", 0)
    kw.setdefault("anti_entropy_interval", 0)
    kw.setdefault("executor_workers", 0)
    kw.setdefault("hasher", ModHasher())
    kw.setdefault("rebalance_config", RebalanceConfig(
        catchup_threshold_bytes=256, max_catchup_rounds=8,
        cutover_pause_max=2.0,
    ))
    # Short breaker backoffs + a generous retry budget: the brown-out
    # phase opens breakers, and recovery must not wait out production
    # backoffs (same tuning as the test_chaos harness).
    kw.setdefault("resilience_config", ResilienceConfig(
        breaker_backoff=0.1, breaker_backoff_max=0.5,
        retry_budget=100.0, retry_refill=1.0,
    ))
    s = Server(data_dir=str(tmp_path / name), port=port, **kw)
    s.open()
    return s


def wait_for(cond, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def load_base(client, h0, index="rb", field="f"):
    """Deterministic dataset: one row-1 bit per shard; returns its cols."""
    client.ensure_index(h0, index)
    client.ensure_field(h0, index, field)
    time.sleep(0.05)
    cols = [s * SHARD_WIDTH + 7 for s in range(N_SHARDS)]
    for col in cols:
        client.query(h0, index, f"Set({col}, {field}=1)")
    assert client.query(
        h0, index, f"Count(Row({field}=1))")["results"][0] == N_SHARDS
    return cols


# --------------------------------------------------------------- tier-1 chaos


def test_join_live_writes_brownout(tmp_path):
    """THE rebalance chaos test: a node joins a 2-node serving cluster
    while (a) a writer keeps issuing Set()s, (b) a reader keeps issuing
    Count()s, and (c) one peer link runs a seed-pinned flaky brown-out.
    Asserts zero lost acked writes (final fragment contents == the acked
    set, byte-identically), correct-or-clean-error reads throughout, and
    a completed job on the 3-node topology with data GC'd off the old
    owners."""
    ports, hosts = migration_ports()
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts[:2])
        for i in range(2)
    ]
    client = InternalClient(timeout=10.0)
    h0 = servers[0].node.uri
    try:
        load_base(client, h0)

        stop = threading.Event()
        acked = []  # columns whose Set() returned success
        read_stats = {"ok": 0, "err": 0, "wrong": 0}
        writer_client = InternalClient(timeout=10.0)
        reader_client = InternalClient(timeout=10.0)

        def writer():
            col = 100
            while not stop.is_set():
                shard = col % N_SHARDS
                target = shard * SHARD_WIDTH + col
                try:
                    writer_client.query(h0, "rb", f"Set({target}, f=9)")
                    acked.append(target)
                except (ClientError, PilosaError):
                    pass  # not acked: allowed to be absent
                col += 1
                time.sleep(0.002)

        def reader():
            while not stop.is_set():
                try:
                    got = reader_client.query(
                        h0, "rb", "Count(Row(f=1))")["results"][0]
                except (ClientError, PilosaError):
                    read_stats["err"] += 1
                else:
                    if got == N_SHARDS:
                        read_stats["ok"] += 1
                    else:
                        read_stats["wrong"] += 1
                        # Capture the cluster state the wrong count was
                        # served under — it rides the assert message (this
                        # is how the stale-epoch-stamp hole was diagnosed).
                        read_stats.setdefault("wrong_detail", []).append({
                            "got": got,
                            "epochs": {s.node.id: s.cluster.routing_epoch
                                       for s in list(servers)},
                            "mid": {s.node.id: s.cluster.next_nodes is not None
                                    for s in list(servers)},
                        })
                time.sleep(0.002)

        threads = [threading.Thread(target=writer, daemon=True),
                   threading.Thread(target=reader, daemon=True)]
        for t in threads:
            t.start()
        time.sleep(0.1)

        # Scripted brown-out on the second member's links (never the
        # harness -> query-head link), pinned seed for replay.
        failpoints.seed(int(os.environ.get("PILOSA_TPU_CHAOS_SEED", "4211")))
        failpoints.configure(f"client-send@{hosts[1]}", "flaky", arg=0.2)

        # Join node2 mid-brown-out: coordinator runs the live rebalance.
        s2 = make_server(tmp_path, "n2", ports[2], join_addr=h0,
                         is_coordinator=False)
        servers.append(s2)
        assert wait_for(
            lambda: len(servers[0].cluster.nodes) == 3
            and servers[0].cluster.next_nodes is None, timeout=30,
        ), "live rebalance did not complete under brown-out"

        failpoints.reset()
        # Faults cleared: converge routing (breakers re-close on monitor
        # probes / elapsed backoff) before the final verification reads.
        def converged():
            for s in servers:
                s._monitor_members()
            try:
                return client.query(
                    h0, "rb", "Count(Row(f=1))")["results"][0] == N_SHARDS
            except (ClientError, PilosaError):
                return False

        # Generous margin: under lockcheck instrumentation each poll's 3
        # monitor sweeps + probe round-trips slow by several x, and the
        # reader/writer threads are still running.
        assert wait_for(converged, timeout=20)
        time.sleep(0.1)  # a few post-rebalance reads/writes on clean links
        stop.set()
        for t in threads:
            t.join(timeout=5)

        # Reads stayed correct-or-clean-error the whole time.
        assert read_stats["wrong"] == 0, read_stats
        assert read_stats["ok"] > 0, read_stats
        assert len(acked) > 0

        # Zero lost acked writes: the union of row-9 columns across the
        # final owners equals the acked set exactly (byte-identical
        # fragment convergence — no missing bit, no phantom bit beyond
        # unacked writes that may have partially applied).
        got = client.query(h0, "rb", "Row(f=9)")["results"][0]["columns"]
        assert set(acked) <= set(got), (
            f"lost {len(set(acked) - set(got))} acked writes")
        # Whatever extra bits exist came from writes that were issued but
        # errored mid-fanout — they must at least be from the writer's
        # column stream, never corruption.
        assert all(
            c % SHARD_WIDTH >= 100 and (c // SHARD_WIDTH) < N_SHARDS
            for c in set(got) - set(acked))

        # The joiner serves the shards it owns; old owners GC'd theirs.
        for sh in range(N_SHARDS):
            owners = {n.id for n in servers[0].cluster.shard_nodes("rb", sh)}
            for s in servers:
                frag = s.holder.fragment("rb", "f", "standard", sh)
                if s.node.id in owners:
                    assert frag is not None, (s.node.id, sh)
                else:
                    assert frag is None, (s.node.id, sh)
        # The epoch advanced and every node converged on it.
        epochs = {s.cluster.routing_epoch for s in servers}
        assert len(epochs) == 1 and epochs.pop() > 0
        assert servers[0].rebalance_stats.counters["jobs_completed"] == 1
        # Fragments moved whenever placement actually handed the joiner
        # (or anyone) new shards; jump-hash placement over random test
        # ports occasionally moves nothing — then zero moves is correct.
        shards_moved = servers[0].rebalance_stats.counters["shards_cut_over"]
        moved = sum(
            s.rebalance_stats.counters["fragments_moved"] for s in servers)
        assert (moved > 0) == (shards_moved > 0)
    finally:
        failpoints.reset()
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_source_fault_mid_stream_aborts_clean(tmp_path):
    """A source that faults every migration stream aborts the job: the
    cluster reverts to the old topology with all data intact and the
    joiner's half-fetched state cleaned up."""
    ports, hosts = migration_ports()
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts[:2])
        for i in range(2)
    ]
    client = InternalClient(timeout=10.0)
    h0 = servers[0].node.uri
    try:
        load_base(client, h0)
        failpoints.configure("migrate-begin", "error",
                             message="injected source fault")
        s2 = make_server(tmp_path, "n2", ports[2], join_addr=h0,
                         is_coordinator=False)
        servers.append(s2)
        assert wait_for(
            lambda: servers[0].rebalance_stats.counters["jobs_aborted"] == 1,
            timeout=30,
        ), "job did not abort on source fault"
        failpoints.reset()
        # Old topology, fully reverted routing, all data still served.
        assert len(servers[0].cluster.nodes) == 2
        assert servers[0].cluster.next_nodes is None
        assert servers[0].cluster.migrated == set()
        assert client.query(
            h0, "rb", "Count(Row(f=1))")["results"][0] == N_SHARDS
        # No source fragment froze (abort pre-cutover): writes still land.
        client.query(h0, "rb", f"Set({2 * SHARD_WIDTH + 99}, f=1)")
        assert client.query(
            h0, "rb", "Count(Row(f=1))")["results"][0] == N_SHARDS + 1
    finally:
        failpoints.reset()
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_coordinator_crash_resumes_from_checkpoint(tmp_path):
    """The job checkpoint makes a rebalance resumable: a 'crashed'
    coordinator (simulated by a checkpoint with no live job) picks the
    job back up with maybe_resume_rebalance() and completes it."""
    ports, hosts = migration_ports()
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts[:2])
        for i in range(2)
    ]
    client = InternalClient(timeout=10.0)
    h0 = servers[0].node.uri
    try:
        load_base(client, h0)
        s2 = make_server(tmp_path, "n2", ports[2],
                         cluster_hosts=[hosts[2]], is_coordinator=True)
        servers.append(s2)
        # Simulate the crash artifact: a job checkpoint naming the target
        # topology with nothing committed yet, and no in-memory job.
        new_nodes = [Node(id=h, uri=h).to_dict() for h in hosts]
        state_path = os.path.join(servers[0].data_dir, ".rebalance.json")
        with open(state_path, "w") as f:
            json.dump({"jobID": "deadbeef", "newNodes": new_nodes,
                       "committed": []}, f)
        assert servers[0].maybe_resume_rebalance()
        # Wait on jobs_completed, not just the topology commit: the
        # counter bump happens-after _clear_state in _complete, so the
        # checkpoint assertion below cannot race the cleanup.
        assert wait_for(
            lambda: len(servers[0].cluster.nodes) == 3
            and servers[0].cluster.next_nodes is None
            and servers[0].rebalance_stats.counters.get(
                "jobs_completed", 0) >= 1, timeout=30,
        ), "resumed rebalance did not complete"
        assert servers[0].rebalance_stats.counters["jobs_resumed"] == 1
        assert not os.path.exists(state_path)
        assert client.query(
            h0, "rb", "Count(Row(f=1))")["results"][0] == N_SHARDS
        # Every shard the joiner now owns was actually moved onto it
        # (placement may or may not hand it one of these 4 shards —
        # jump-hash only moves ~1/n of the keyspace).
        owned = [
            sh for sh in range(N_SHARDS)
            if any(n.id == s2.node.id
                   for n in servers[0].cluster.shard_nodes("rb", sh))
        ]
        for sh in owned:
            assert s2.holder.fragment("rb", "f", "standard", sh) is not None
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_resume_skips_committed_shards(tmp_path):
    """A checkpoint with every movable shard already committed completes
    immediately without re-streaming anything."""
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    s0 = make_server(tmp_path, "n0", ports[0], cluster_hosts=[hosts[0]])
    servers = [s0]
    client = InternalClient()
    try:
        load_base(client, s0.node.uri)
        s1 = make_server(tmp_path, "n1", ports[1],
                         cluster_hosts=[hosts[1]], is_coordinator=True)
        servers.append(s1)
        committed = [["rb", sh] for sh in range(N_SHARDS)]
        state_path = os.path.join(s0.data_dir, ".rebalance.json")
        new_nodes = [Node(id=h, uri=h).to_dict() for h in hosts]
        with open(state_path, "w") as f:
            json.dump({"jobID": "cafecafe", "newNodes": new_nodes,
                       "committed": committed}, f)
        before = s0.rebalance_stats.counters["bytes_streamed"]
        assert s0.maybe_resume_rebalance()
        assert wait_for(lambda: s0.cluster.next_nodes is None
                        and len(s0.cluster.nodes) == 2
                        and s0.rebalance_stats.counters.get(
                            "jobs_completed", 0) >= 1, timeout=15)
        assert s0.rebalance_stats.counters["bytes_streamed"] == before
        assert not os.path.exists(state_path)
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_fanout_stamps_epoch_of_placement_decision(tmp_path):
    """The remote fan-out must stamp the routing epoch its PLACEMENT
    decision was made under, not the epoch at send time: a cutover
    landing between assign and dispatch advances the local epoch, and a
    current-epoch stamp would slip the stale placement past the
    receiver's 409 gate (it would serve a shard whose fragment it
    already GC'd as silently empty)."""
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts)
        for i in range(2)
    ]
    client = InternalClient()
    try:
        load_base(client, servers[0].node.uri)
        ex = servers[0].executor
        # A prior rebalance advanced both nodes to epoch 5.
        servers[0].cluster.routing_epoch = 5
        servers[1].cluster.routing_epoch = 5

        stamped = []
        real_client = ex.client

        class RecordingClient:
            def query_node(self, node, index, query, **kw):
                stamped.append(kw.get("epoch"))
                return real_client.query_node(node, index, query, **kw)

            def __getattr__(self, name):
                return getattr(real_client, name)

        orig_assign = ex._assign_shards

        def assign_then_cutover(*a, **kw):
            out = orig_assign(*a, **kw)
            # A cutover commits right after the placement read.
            servers[0].cluster.routing_epoch += 1
            return out

        ex.client = RecordingClient()
        ex._assign_shards = assign_then_cutover
        try:
            got = client.query(
                servers[0].node.uri, "rb", "Count(Row(f=1))")["results"][0]
        finally:
            ex.client = real_client
            ex._assign_shards = orig_assign
        assert got == N_SHARDS
        assert stamped and all(e == 5 for e in stamped), stamped
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_receiver_gate_treats_unstamped_as_epoch_zero(tmp_path):
    """A remote query with NO X-Pilosa-Epoch stamp was routed by the
    stalest possible placement (a sender that never saw the rebalance):
    a receiver that has advanced past epoch 0 must 409 for a shard it
    does not serve — never read a missing fragment as silently empty."""
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts)
        for i in range(2)
    ]
    client = InternalClient()
    try:
        load_base(client, servers[0].node.uri)
        s1 = servers[1]
        not_served = next(
            sh for sh in range(N_SHARDS)
            if all(n.id != s1.node.id
                   for n in s1.cluster.shard_nodes("rb", sh)))
        # A rebalance advanced the receiver's epoch; the sender below
        # never saw it and sends unstamped.
        s1.cluster.routing_epoch = 3
        with pytest.raises(ClientError) as ei:
            client.query_node(
                s1.cluster.node_by_id(s1.node.id), "rb",
                "Count(Row(f=1))", shards=[not_served], remote=True)
        assert getattr(ei.value, "status", 0) == 409, ei.value
        # A shard the receiver DOES serve still answers unstamped
        # requests (single-node tools, older senders).
        served = next(
            sh for sh in range(N_SHARDS)
            if any(n.id == s1.node.id
                   for n in s1.cluster.shard_nodes("rb", sh)))
        res = client.query_node(
            s1.cluster.node_by_id(s1.node.id), "rb",
            "Count(Row(f=1))", shards=[served], remote=True)
        assert res[0] == 1
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_monitor_adopts_missed_complete(tmp_path):
    """A follower that LOST the rebalance-complete broadcast (a brown-out
    can eat all transport retries) converges via the member monitor's
    epoch sync: probing a peer whose /status reports a newer COMMITTED
    routing epoch, it adopts that topology and GCs fragments for shards
    it no longer owns."""
    from pilosa_tpu_torch.cluster.hash import partition as partition_of

    def owner(hosts, shard):
        ordered = sorted(hosts)
        return ordered[partition_of("rb", shard, 256) % len(ordered)]

    # A port triple where the 2->3 transition moves a shard OFF hosts[1]
    # (the follower whose GC the lost broadcast would orphan).
    for _ in range(256):
        ports = [free_port() for _ in range(3)]
        hosts = [f"localhost:{p}" for p in ports]
        lost = [sh for sh in range(N_SHARDS)
                if owner(hosts[:2], sh) == hosts[1]
                and owner(hosts, sh) == hosts[2]]
        if lost:
            break
    else:
        raise RuntimeError("no port triple moves a shard off hosts[1]")

    servers = [
        make_server(tmp_path, f"n{i}", ports[i], cluster_hosts=hosts[:2])
        for i in range(2)
    ]
    client = InternalClient()
    try:
        load_base(client, servers[0].node.uri)
        s1 = servers[1]
        assert s1.holder.fragment("rb", "f", "standard", lost[0]) is not None

        # Simulate the peer having completed a rebalance whose complete
        # broadcast never reached s1: n0 commits the 3-node topology
        # (preserving its coordinator claim, as a real job's new_nodes
        # do) and advances its epoch; s1 still routes on the 2-node view.
        s0 = servers[0]
        s0.cluster.commit_topology(
            [Node(id=h, uri=h, is_coordinator=(h == s0.node.id))
             for h in hosts],
            epoch=s0.cluster.routing_epoch + 1)
        assert len(s1.cluster.nodes) == 2
        assert s1.cluster.routing_epoch < s0.cluster.routing_epoch

        # Adoption is COORDINATOR-only: with n0's claim suppressed, a
        # sweep must NOT adopt (a non-coordinator at a high epoch may
        # just have seen a cutover-commit mid-job and still carry the
        # old nodes list).
        s0_entry = s0.cluster.node_by_id(s0.node.id)
        s0_entry.is_coordinator = False
        s1._monitor_members()
        assert len(s1.cluster.nodes) == 2
        s0_entry.is_coordinator = True

        # One monitor sweep against the coordinator converges it.
        s1._monitor_members()
        assert s1.cluster.routing_epoch == s0.cluster.routing_epoch
        assert len(s1.cluster.nodes) == 3
        for sh in lost:
            assert s1.holder.fragment("rb", "f", "standard", sh) is None, sh
        kept = [sh for sh in range(N_SHARDS)
                if owner(hosts, sh) == hosts[1]]
        for sh in kept:
            assert s1.holder.fragment("rb", "f", "standard", sh) is not None
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# --------------------------------------------------- follower resize watchdog


def test_follower_watchdog_reverts_when_coordinator_dies(tmp_path):
    """Legacy stop-the-world path: a coordinator that broadcast RESIZING
    and died before delivering instructions must not strand followers —
    the watchdog probes the coordinator and reverts to NORMAL on the old
    topology."""
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = [
        make_server(
            tmp_path, f"n{i}", ports[i], cluster_hosts=hosts,
            is_coordinator=(i == 0),
            rebalance_config=RebalanceConfig(follower_timeout=0.2),
        )
        for i in range(2)
    ]
    try:
        follower = next(s for s in servers if not s.node.is_coordinator)
        coordinator = next(s for s in servers if s.node.is_coordinator)
        follower.cluster.node_by_id(coordinator.node.id).is_coordinator = True
        # The coordinator broadcast RESIZING ... then died before any
        # instruction arrived.
        follower.receive_message({
            "type": "cluster-status", "state": "RESIZING",
            "nodes": [n.to_dict() for n in follower.cluster.nodes],
        })
        assert follower.cluster.state == "RESIZING"
        assert follower._resizing_since is not None
        coordinator.close()
        time.sleep(0.25)
        follower._check_resize_watchdog()
        assert follower.cluster.state == "NORMAL"
        assert follower._resizing_since is None
        assert len(follower.cluster.nodes) == 2  # old topology intact
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


def test_follower_watchdog_respects_live_coordinator(tmp_path):
    """A coordinator that is alive and still RESIZING resets the watchdog
    timer instead of being deposed by an impatient follower."""
    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = [
        make_server(
            tmp_path, f"n{i}", ports[i], cluster_hosts=hosts,
            is_coordinator=(i == 0),
            rebalance_config=RebalanceConfig(follower_timeout=0.1),
        )
        for i in range(2)
    ]
    try:
        follower = next(s for s in servers if not s.node.is_coordinator)
        coordinator = next(s for s in servers if s.node.is_coordinator)
        follower.cluster.node_by_id(coordinator.node.id).is_coordinator = True
        coordinator.cluster.state = "RESIZING"
        follower.receive_message({
            "type": "cluster-status", "state": "RESIZING",
            "nodes": [n.to_dict() for n in follower.cluster.nodes],
        })
        time.sleep(0.15)
        follower._check_resize_watchdog()
        assert follower.cluster.state == "RESIZING"  # job still live
        assert follower._resizing_since is not None
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# ------------------------------------------------------- routing epoch units


def _cluster_with_cutover(local_id="a"):
    nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    c = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    new = nodes + [Node(id="c", uri="c")]
    c.begin_rebalance(new)
    return c


def test_routing_epoch_overrides_placement():
    c = _cluster_with_cutover()
    base_epoch = c.routing_epoch
    assert base_epoch > 0
    # Find a shard whose owner changes between topologies.
    moved = None
    for sh in range(16):
        before = [n.id for n in c.shard_nodes("i", sh)]
        c.migrated.add(("i", sh))
        after = [n.id for n in c.shard_nodes("i", sh)]
        c.migrated.discard(("i", sh))
        if before != after:
            moved = sh
            break
    assert moved is not None
    before = [n.id for n in c.shard_nodes("i", moved)]
    c.apply_cutover("i", moved)
    assert c.routing_epoch == base_epoch + 1
    assert [n.id for n in c.shard_nodes("i", moved)] != before
    # Idempotent re-commit (freeze + broadcast) bumps only once.
    c.apply_cutover("i", moved, epoch=c.routing_epoch)
    assert c.routing_epoch == base_epoch + 1
    # Completion collapses the overrides.
    c.commit_topology()
    assert c.next_nodes is None and c.migrated == set()
    assert len(c.nodes) == 3


def test_adoption_loses_to_concurrent_begin():
    """The anti-entropy topology adoption re-validates under the routing
    lock: a rebalance-begin landing between the monitor's probe decision
    and the commit keeps its next_nodes/migrated overrides — a late
    adopt commit wiping them would route cut-over shards back to their
    old owners until the job's complete broadcast."""
    nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    cluster = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    target = nodes + [Node(id="c", uri="c")]
    # A begin wins the race: overrides installed, epoch merged to 7.
    cluster.begin_rebalance(target, epoch=7)
    cluster.apply_cutover("i", 3)
    # The adoption loses even with a numerically newer epoch: overrides
    # are in flight and must survive.
    assert not cluster.adopt_topology_if_ahead(nodes, 9)
    assert cluster.next_nodes is not None
    assert ("i", 3) in cluster.migrated
    # A caught-up epoch is also a losing race, overrides or not.
    cluster.abort_rebalance()
    assert not cluster.adopt_topology_if_ahead(target,
                                               cluster.routing_epoch)
    # Quiescent and genuinely ahead: the adoption commits.
    epoch = cluster.routing_epoch
    assert cluster.adopt_topology_if_ahead(target, epoch + 1)
    assert cluster.routing_epoch == epoch + 1
    assert [n.id for n in cluster.nodes] == ["a", "b", "c"]
    assert cluster.next_nodes is None


def test_abort_keeps_committed_cutovers():
    c = _cluster_with_cutover()
    c.apply_cutover("i", 3)
    fully = c.abort_rebalance(committed=[("i", 3)])
    assert fully is False
    assert c.migrated == {("i", 3)} and c.next_nodes is not None
    c2 = _cluster_with_cutover()
    assert c2.abort_rebalance(committed=[]) is True
    assert c2.next_nodes is None and c2.migrated == set()


def test_stale_epoch_rejects_unowned_remote_shards():
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.errors import StaleRoutingEpochError
    from pilosa_tpu_torch.executor import ExecOptions, Executor

    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.set_remote_max_shard(7)
    nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    cluster = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    ex = Executor(holder, cluster=cluster, workers=0)
    # This node stops owning some shard after a (simulated) cutover.
    cluster.begin_rebalance(nodes + [Node(id="c", uri="c")])
    moved = None
    for sh in range(8):
        cluster.migrated.add(("i", sh))
        owned = any(n.id == "a" for n in cluster.shard_nodes("i", sh))
        cluster.migrated.discard(("i", sh))
        if not owned:
            moved = sh
            break
    assert moved is not None
    cluster.apply_cutover("i", moved)
    stale = ExecOptions(remote=True, epoch=cluster.routing_epoch - 1)
    with pytest.raises(StaleRoutingEpochError):
        ex.execute("i", "Count(Row(f=1))", shards=[moved], opt=stale)
    # A request stamped with the CURRENT epoch is served (the executor
    # trusts the sender's shard list, reference executor.go:1476-1480).
    fresh = ExecOptions(remote=True, epoch=cluster.routing_epoch)
    ex.execute("i", "Count(Row(f=1))", shards=[moved], opt=fresh)
    ex.close()
    holder.close()


def test_moved_fragment_rejects_writes(tmp_path):
    from pilosa_tpu_torch.core.fragment import Fragment

    frag = Fragment(str(tmp_path / "frag.0"), "i", "f", "standard", 0)
    frag.open()
    try:
        frag.set_bit(1, 5)
        frag._moved = True
        with pytest.raises(ShardMovedError):
            frag.set_bit(1, 6)
        with pytest.raises(ShardMovedError):
            frag.clear_bit(1, 5)
        import numpy as np

        with pytest.raises(ShardMovedError):
            frag.bulk_import(np.array([1], dtype=np.uint64),
                             np.array([9], dtype=np.uint64))
        # Reads still serve (the source keeps answering until GC).
        assert frag.bit(1, 5)
    finally:
        frag.close()


def test_cutover_write_wait_follows_commit():
    """A write caught in the freeze->commit window re-routes until the
    commit lands instead of failing: tolerant_owner_fanout retries on
    ShardMovedError within cutover_pause_max."""
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.executor import Executor

    holder = Holder(None, device="cpu")
    holder.open()
    holder.create_index("i").create_field("f")
    ex = Executor(holder, workers=0)
    ex.cutover_wait = 2.0
    attempts = {"n": 0}

    def local_fn():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise ShardMovedError("i/f/standard/0")

    ex.tolerant_owner_fanout("i", 0, False, local_fn, lambda node: None)
    assert attempts["n"] == 3
    # Past the cap the clean error surfaces.
    ex.cutover_wait = 0.0
    attempts["n"] = -100  # never succeeds within one attempt
    with pytest.raises(ShardMovedError):
        ex.tolerant_owner_fanout(
            "i", 0, False,
            lambda: (_ for _ in ()).throw(ShardMovedError("i")),
            lambda node: None)
    ex.close()
    holder.close()


def test_abort_unfreezes_uncommitted_shards(tmp_path):
    """An abort after a freeze thaws the source's fragments for shards
    whose cutover never committed — routing reverts to this node, and a
    lingering freeze would leave the shard permanently write-dead.
    Committed shards stay frozen (their data moved)."""
    port = free_port()
    s = make_server(tmp_path, "n0", port, cluster_hosts=[f"localhost:{port}"])
    try:
        client = InternalClient()
        load_base(client, s.node.uri)
        s.cluster.begin_rebalance(list(s.cluster.nodes))
        s.migration_source.freeze("rb", 0)
        s.migration_source.freeze("rb", 1)
        frag0 = s.holder.fragment("rb", "f", "standard", 0)
        frag1 = s.holder.fragment("rb", "f", "standard", 1)
        assert frag0._moved and frag1._moved
        with pytest.raises(ShardMovedError):
            frag0.set_bit(9, 1)
        s._handle_rebalance_abort({
            "jobID": "jx", "reason": "test", "committed": [["rb", 1]],
        })
        assert not frag0._moved  # reverted shard thawed: writes flow again
        assert frag0.set_bit(9, 1)
        assert frag1._moved  # committed shard stays frozen
    finally:
        s.close()


def test_complete_thaws_replica_kept_fragments(tmp_path):
    """The coordinator's _complete must thaw fragments still frozen after
    the holder cleaner runs: with replicas >= 2 the coordinator can be a
    migration SOURCE for a shard it keeps owning as a replica — the
    cleaner keeps that fragment, and a lingering _moved flag would leave
    it permanently write-dead. (Followers already thaw the same way in
    _adopt_committed_topology.)"""
    from pilosa_tpu_torch.cluster.rebalance import (RebalanceCoordinator,
                                              RebalanceJob)

    port = free_port()
    s = make_server(tmp_path, "n0", port, cluster_hosts=[f"localhost:{port}"])
    try:
        client = InternalClient()
        load_base(client, s.node.uri)
        s.cluster.begin_rebalance(list(s.cluster.nodes))
        s.migration_source.freeze("rb", 0)
        frag = s.holder.fragment("rb", "f", "standard", 0)
        assert frag._moved
        coord = RebalanceCoordinator(s)
        job = RebalanceJob("jt", list(s.cluster.nodes), moves={})
        coord.job = job
        # The single node keeps owning shard 0 under the new topology, so
        # the cleaner keeps the fragment — exactly the replica-kept shape.
        coord._complete(job)
        assert not frag._moved
        assert frag.set_bit(9, 1)
    finally:
        s.close()


def test_forwarded_execution_rechecks_epoch_after_gather():
    """A cutover committing DURING a forwarded (opt.remote) gather can GC
    a moved shard's fragment mid-read so it reads as silently empty — the
    entry gate in execute_query ran too early to see it. The receiver
    re-checks the routing epoch after the gather and raises
    StaleRoutingEpochError (-> 409, sender gets its free re-route)
    instead of returning a result with a hole. An epoch bump that leaves
    every shard still owned here stays transparent."""
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.errors import StaleRoutingEpochError
    from pilosa_tpu_torch.executor import ExecOptions, Executor

    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.set_remote_max_shard(7)
    nodes = [Node(id="a", uri="a"), Node(id="b", uri="b")]
    cluster = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    ex = Executor(holder, cluster=cluster, workers=0)
    cluster.begin_rebalance(nodes + [Node(id="c", uri="c")])
    moved = None
    for sh in range(8):
        cluster.migrated.add(("i", sh))
        owned = any(n.id == "a" for n in cluster.shard_nodes("i", sh))
        cluster.migrated.discard(("i", sh))
        if not owned:
            moved = sh
            break
    assert moved is not None

    pre_epoch = cluster.routing_epoch
    opt = ExecOptions(remote=True, epoch=pre_epoch)

    def gather_racing_cutover(shards_):
        # The cutover moving this very shard off node 'a' commits while
        # the gather is running (post-commit GC could have emptied it).
        cluster.apply_cutover("i", moved)
        return 0

    with pytest.raises(StaleRoutingEpochError):
        ex._fan_out("i", [moved], None, opt,
                    gather_racing_cutover, lambda a, b: a + b)

    # The cutover can also land BEFORE _fan_out but after execute()'s
    # entry gate (during translation, or an earlier call of a multi-call
    # query): the epoch anchor execute() captures before the gate still
    # flags it, where a snapshot taken inside _fan_out would already be
    # post-cutover and wave the hole through.
    opt_anchored = ExecOptions(remote=True, epoch=pre_epoch,
                               entry_epoch=pre_epoch)
    with pytest.raises(StaleRoutingEpochError):
        ex._fan_out("i", [moved], None, opt_anchored,
                    lambda shards_: 0, lambda a, b: a + b)

    # Epoch advanced mid-gather but the shard stayed local: the result is
    # sound and must flow through, no spurious 409.
    kept = next(
        sh for sh in range(8)
        if sh != moved and any(
            n.id == "a" for n in cluster.shard_nodes("i", sh)))
    opt2 = ExecOptions(remote=True, epoch=cluster.routing_epoch)

    def gather_with_unrelated_bump(shards_):
        cluster.routing_epoch += 1
        return 42

    assert ex._fan_out("i", [kept], None, opt2,
                       gather_with_unrelated_bump, lambda a, b: a + b) == 42
    ex.close()
    holder.close()


# ------------------------------------------------------------ health grace


def test_copy_grace_damps_breaker():
    from pilosa_tpu_torch.cluster.health import (
        CLOSED, OPEN, HealthRegistry, ResilienceConfig,
    )

    clock = [0.0]
    reg = HealthRegistry(ResilienceConfig(breaker_failures=1),
                         clock=lambda: clock[0])
    reg.set_copy_grace("peer")
    for _ in range(reg.COPY_GRACE_MULT - 1):
        reg.record_failure("peer")
    assert reg.state("peer") == CLOSED  # graced: not dead yet
    reg.record_failure("peer")
    assert reg.state("peer") == OPEN  # 4x the threshold finally opens
    # Without grace, one failure opens.
    reg.clear_copy_grace()
    reg2 = HealthRegistry(ResilienceConfig(breaker_failures=1),
                          clock=lambda: clock[0])
    reg2.record_failure("peer")
    assert reg2.state("peer") == OPEN
    # Grace expires on its TTL.
    reg3 = HealthRegistry(ResilienceConfig(breaker_failures=1),
                          clock=lambda: clock[0])
    reg3.set_copy_grace("peer", ttl=5.0)
    assert reg3.in_copy_grace("peer")
    clock[0] = 6.0
    assert not reg3.in_copy_grace("peer")


# ------------------------------------------------------------------ framing


def test_migration_frame_roundtrip():
    hdr, payload = unpack_framed(pack_framed({"pos": 42}, b"\x00\x01binary"))
    assert hdr == {"pos": 42} and payload == b"\x00\x01binary"
    with pytest.raises(PilosaError):
        unpack_framed(b"\x01")
    with pytest.raises(PilosaError):
        unpack_framed(pack_framed({"a": 1})[:5])


def test_replay_ops_rejects_torn_stream():
    import numpy as np

    from pilosa_tpu_torch.errors import CorruptFragmentError
    from pilosa_tpu_torch.storage.bitmap import (
        Bitmap, OP_ADD, encode_bulk_op, encode_op, replay_ops,
    )

    b = Bitmap()
    stream = encode_op(OP_ADD, 5) + encode_bulk_op(
        np.array([9, 10], dtype=np.uint64), None)
    replay_ops(b, stream)
    assert b.contains(5) and b.contains(9) and b.contains(10)
    with pytest.raises(CorruptFragmentError):
        replay_ops(Bitmap(), stream[:-3])
