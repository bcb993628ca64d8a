"""The port's collective plane (pilosa_tpu_torch/parallel/collective.py),
mirroring tests/test_collective.py.

Unit level: placement follows the real jump-hash cluster placement,
ownership is verified at entry, the runner executes descriptors in
cluster-wide seq order, the resident blocks refresh by delta and demote
to the tier, the epoch gates refuse, the breakers open and re-close,
and the batcher coalesces collective Counts. Plus the port's own: the
store barrier decides once for every rank (a late arriver reads `abort`
and never enters the reduce), a rank that fails after the barrier makes
every rank raise, and a kernel fault inside an entry raises out of
Executor.execute instead of being served by the fan-out.

Integration level: TWO real port Server processes joined in one gloo
job, data written through the normal cluster write path, Count / TopN /
Sum / Min / Max answered through the collective backend; then a peer
that receives descriptors late (after the leader's barrier timed out)
never enters them, and a peer that drops descriptors makes the leader
fall back to the HTTP fan-out instead of hanging. A second pair of
ranks stalls one reduce past the group's timeout: both re-form the
group and the plane serves again.

A failed reduce re-forms the reduce group at the generation the next
barrier carries (in process, with the job stood in for), a group that
does not form turns the plane off with the reason, and with the reduce
on the device the reduced result is copied to the host once per entry.

A rank holds its k slots as Blocks over its own partitions (its
engine's `[engine] mesh-devices`; one-process jobs take the backend's
`mesh_devices`, as the reference's does): the mesh width is part of every
resident key (the mirror of test_mesh_width_never_aliases_resident_
planes), a write refreshes only its slot's block, and a rank whose
partition count differs from the descriptor's refuses as a placement
error.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.parallel import distributed
from pilosa_tpu_torch.parallel.collective import (
    CollectiveUnavailable,
    _Runner,
    combine_minmax,
    placement,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ----------------------------------------------------------------- placement


def test_placement_follows_jump_hash():
    nodes = [
        Node(id="n0", process_idx=0),
        Node(id="n1", process_idx=1),
        Node(id="n2", process_idx=2),
    ]
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=1)
    n_shards = 64
    slots = placement(c, "i", n_shards, 3)
    assert sorted(s for lst in slots for s in lst) == list(range(n_shards))
    for p, lst in enumerate(slots):
        for s in lst:
            owners = c.shard_nodes("i", s)
            assert owners[0].process_idx == p, (s, p, owners[0].id)


def test_placement_prefers_available_replica():
    nodes = [
        Node(id="n0", process_idx=0),
        Node(id="n1", process_idx=1),
    ]
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=2, hasher=ModHasher())
    c.mark_unavailable("n0")
    slots = placement(c, "i", 8, 2)
    assert slots[0] == []  # nothing assigned to the dead node's process
    assert sorted(slots[1]) == list(range(8))


def test_placement_requires_process_idx():
    nodes = [Node(id="n0", process_idx=0), Node(id="n1")]  # n1 unknown
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=1, hasher=ModHasher())
    with pytest.raises(CollectiveUnavailable, match="process index"):
        placement(c, "i", 8, 2)


def test_ownership_verification_refuses_unowned_shard():
    """A process must never silently contribute zeros for shards it does
    not own: entry refuses instead."""
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.logger import NopLogger
    from pilosa_tpu_torch.parallel.collective import CollectiveBackend

    nodes = [Node(id="n0", process_idx=0), Node(id="n1", process_idx=1)]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=1, hasher=ModHasher())
    holder = Holder(None, device="cpu")
    holder.open()
    backend = CollectiveBackend(SimpleNamespace(
        holder=holder, logger=NopLogger(), cluster=cluster, client=None,
    ))
    try:
        # ModHasher, 2 nodes: n0 owns even partitions' shards only.
        owned = [s for s in range(8) if cluster.owns_shard("n0", "i", s)]
        unowned = [s for s in range(8) if not cluster.owns_shard("n0", "i", s)]
        assert owned and unowned
        backend._verify_ownership("i", owned)  # fine
        with pytest.raises(CollectiveUnavailable, match="placement mismatch"):
            backend._verify_ownership("i", [unowned[0]])
    finally:
        backend.close()
        holder.close()


# -------------------------------------------------------------------- runner


class _StubBackend:
    def __init__(self):
        self.order = []

    def _enter(self, desc):
        self.order.append(desc["seq"])
        return desc["seq"] * 10


def test_runner_executes_in_seq_order():
    b = _StubBackend()
    r = _Runner(b)
    try:
        # Submit out of order; runner must execute 1, 2, 3.
        futs = {}
        futs[2] = r.submit({"seq": 2})
        futs[3] = r.submit({"seq": 3})
        futs[1] = r.submit({"seq": 1})
        for seq, fut in futs.items():
            assert fut.result(timeout=10) == seq * 10
        assert b.order == sorted(b.order)
    finally:
        r.close()


def test_runner_advances_past_seq_gap():
    """A leader that died between seq allocation and broadcast must not
    stall the queue forever: bounded gap wait, then proceed."""
    b = _StubBackend()
    r = _Runner(b)
    r.GAP_TIMEOUT = 0.2
    try:
        fut = r.submit({"seq": 5})  # seqs 1-4 never arrive
        assert fut.result(timeout=10) == 50
    finally:
        r.close()


def test_runner_rejects_stale_seq():
    """A gap-skipped descriptor arriving late must be rejected, not
    executed — its barrier peers already timed out."""
    b = _StubBackend()
    r = _Runner(b)
    r.GAP_TIMEOUT = 0.2
    try:
        assert r.submit({"seq": 5}).result(timeout=10) == 50
        fut = r.submit({"seq": 3})  # late arrival from a slow broadcast
        with pytest.raises(CollectiveUnavailable, match="stale"):
            fut.result(timeout=10)
        assert b.order == [5]
    finally:
        r.close()


# ------------------------------------------------- the store barrier


@pytest.fixture
def store_server():
    """A rendezvous store on a free port (this process hosts it), and a
    factory of client connections to it, one per simulated rank."""
    port = free_port()
    master = torch.distributed.TCPStore(
        "localhost", port, 1, True, timeout=datetime.timedelta(seconds=10),
        wait_for_workers=False)

    def client():
        return torch.distributed.TCPStore(
            "localhost", port, 1, False, timeout=datetime.timedelta(seconds=10))

    yield client
    del master


def _arrive(store, name, world, timeout_ms, out, rank):
    try:
        distributed.barrier(store, name, world, timeout_ms)
        out[rank] = "ok"
    except distributed.BarrierAborted:
        out[rank] = "abort"


@pytest.mark.parametrize("world", [2, 3, 5])
def test_barrier_passes_when_every_rank_arrives(store_server, world):
    out = {}
    threads = [threading.Thread(target=_arrive, args=(
        store_server(), "b1", world, 5000, out, r)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert out == {r: "ok" for r in range(world)}


def test_barrier_decides_once_for_a_late_arriver(store_server):
    """Two of three ranks arrive and time out: the barrier is decided
    `abort` for everyone. The third rank, arriving afterwards as the
    last of the count, reads that decision and raises at once; it never
    passes, so it never enters the reduce behind the barrier."""
    out = {}
    early = [threading.Thread(target=_arrive, args=(
        store_server(), "late", 3, 300, out, r)) for r in range(2)]
    for t in early:
        t.start()
    for t in early:
        t.join(timeout=20)
    assert out == {0: "abort", 1: "abort"}
    t0 = time.monotonic()
    _arrive(store_server(), "late", 3, 5000, out, 2)
    assert out[2] == "abort"
    assert time.monotonic() - t0 < 2.0  # read the decision, did not wait


def test_barrier_timeout_and_completion_race_one_decision(store_server):
    """Ranks whose timeouts expire as the last rank arrives: whatever
    the interleaving, every rank reads the same outcome."""
    for trial in range(8):
        out = {}
        threads = [threading.Thread(target=_arrive, args=(
            store_server(), f"race{trial}", 4, 20 + 5 * r, out, r))
            for r in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        _arrive(store_server(), f"race{trial}", 4, 5000, out, 3)
        for t in threads:
            t.join(timeout=20)
        assert len(set(out.values())) == 1, out


def test_forgotten_barrier_keys_are_gone(store_server):
    st = store_server()
    distributed.barrier(st, "gone", 1, 1000)
    done = f"{distributed.BARRIER_PREFIX}/gone/done"
    assert st.check([done])
    distributed.forget_barrier(st, "gone")
    assert not st.check([done])


# ------------------------------------------------------ min/max combine


@pytest.mark.parametrize("maximize", [True, False], ids=["max", "min"])
@pytest.mark.parametrize("case", [
    # (per-rank (value, count) with count 0 meaning "no column"), want
    ([(5, 2), (9, 1), (9, 3)], {"max": (9, 4), "min": (5, 2)}),
    ([(7, 0), (3, 1), (3, 2)], {"max": (3, 3), "min": (3, 3)}),
    ([(0, 0), (0, 0)], {"max": None, "min": None}),
    ([(0, 4), (12, 1)], {"max": (12, 1), "min": (0, 4)}),
], ids=["tie-on-max", "empty-rank-drops-out", "no-column", "zero-value"])
def test_combine_minmax(case, maximize):
    depth = 4
    ranks = []
    for value, count in case[0]:
        if count == 0:  # K3's answer over no column
            bits = [0 if maximize else 1] * depth
        else:
            bits = [(value >> i) & 1 for i in range(depth)]
        ranks.append([count] + bits)
    bits, count = combine_minmax(np.array(ranks, dtype=np.int64), depth, maximize)
    want = case[1]["max" if maximize else "min"]
    if want is None:
        assert count == 0 and bits.tolist() == [0 if maximize else 1] * depth
    else:
        assert (sum(int(b) << i for i, b in enumerate(bits)), count) == want


# ------------------------------------------- resident blocks / batching / health


def _pod(holder, **cfg_kw):
    """One-process, one-node backend over `holder` (the reference tests'
    one-pod mode, `[collective] single-process`): the barrier is a
    no-op and the reduce is the rank's own result."""
    from pilosa_tpu_torch.logger import NopLogger
    from pilosa_tpu_torch.parallel import CollectiveConfig
    from pilosa_tpu_torch.parallel.collective import CollectiveBackend

    node = Node(id="n0", process_idx=0)
    cluster = Cluster(node=node, nodes=[node], replica_n=1)
    server = SimpleNamespace(
        holder=holder, logger=NopLogger(), cluster=cluster, client=None,
    )
    cfg_kw.setdefault("single_process", 1)
    backend = CollectiveBackend(server, CollectiveConfig(**cfg_kw))
    return backend, server


def _plant(holder, n_shards=4, rows=(1, 2, 3)):
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    idx = holder.create_index_if_not_exists("ci")
    idx.create_field_if_not_exists("f")
    rng = np.random.default_rng(7)
    exp = {}
    for row in rows:
        cols = []
        for s in range(n_shards):
            local = np.flatnonzero(rng.random(2048) < 0.1)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        idx.field("f").import_bits([row] * len(cols), cols)
        exp[row] = set(cols)
    return idx, exp


def _call(q):
    from pilosa_tpu_torch.pql.parser import parse

    return parse(q).calls[0].children[0]


@pytest.fixture
def holder():
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(None, device="cpu")
    h.open()
    yield h
    h.close()


def test_single_process_active_requires_single_node(holder):
    backend, server = _pod(holder)
    try:
        assert backend.active()
        server.cluster.nodes.append(Node(id="n1", process_idx=None))
        # Two nodes, one process: remote shards would read as silently
        # empty — the plane must refuse.
        assert not backend.active()
    finally:
        backend.close()


def test_disabled_plane_is_never_active(holder):
    backend, _ = _pod(holder, enabled=0)
    try:
        assert not backend.active()
    finally:
        backend.close()


def test_respellings_share_descriptor_sig_and_program(holder):
    """The descriptor signature is the CANONICAL plan signature, so
    commutative respellings share one descriptor signature and ONE
    lowered program."""
    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        a = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        b = _call("Count(Intersect(Row(f=2), Row(f=1)))")
        assert backend._call_sig("ci", a) == backend._call_sig("ci", b)
        want = len(exp[1] & exp[2])
        assert backend.count("ci", a) == want
        assert backend.count("ci", b) == want
        count_fns = [k for k in backend._fn_cache if k[0] == "count"]
        assert len(count_fns) == 1, count_fns
    finally:
        backend.close()


def test_count_batch_is_one_entry(holder):
    """A batch of N same-signature queries costs ONE collective entry
    (one seq slot, one barrier, one K1 launch, one reduce), with
    duplicates deduped and fanned back out."""
    from pilosa_tpu_torch.ops import kernels

    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        c12 = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        c13 = _call("Count(Intersect(Row(f=1), Row(f=3)))")
        before = kernels.PLAIN_CALLS["gather_expr_count"]
        got = backend.count_batch("ci", [c12, c13, c12, c13])
        assert got == [len(exp[1] & exp[2]), len(exp[1] & exp[3])] * 2
        assert backend.counters["entries"] == 1
        assert backend.counters["reduces"] == 1
        assert backend.counters["batched_entries"] == 4
        assert backend.counters["batched_launches"] == 1
        # On the CPU, K1's plain twin served the entry, once.
        assert kernels.PLAIN_CALLS["gather_expr_count"] == before + 1
    finally:
        backend.close()


def test_resident_stack_delta_refresh(holder):
    """A write to a resident plane refreshes it by a scattered delta
    (dirty-word journal), not a full re-assembly — and the refreshed
    count is bit-exact."""
    idx, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        c = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        assert backend.count("ci", c) == len(exp[1] & exp[2])
        full0 = backend.counters["full_refreshes"]
        assert backend.count("ci", c) == len(exp[1] & exp[2])
        assert backend.counters["resident_hits"] >= 2  # warm: no refresh
        assert backend.counters["full_refreshes"] == full0
        # One-bit write: delta path, not re-assembly.
        idx.field("f").import_bits([1], [5])
        exp[1].add(5)
        assert backend.count("ci", c) == len(exp[1] & exp[2])
        assert backend.counters["delta_hits"] >= 1
        assert backend.counters["full_refreshes"] == full0
    finally:
        backend.close()


def test_resident_stack_delta_disabled(holder):
    """delta-max-fraction=0 turns deltas off: every staleness is a full
    re-assembly, still bit-exact."""
    idx, exp = _plant(holder)
    backend, _ = _pod(holder, delta_max_fraction=0.0)
    try:
        c = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        assert backend.count("ci", c) == len(exp[1] & exp[2])
        full0 = backend.counters["full_refreshes"]
        idx.field("f").import_bits([1], [5])
        exp[1].add(5)
        assert backend.count("ci", c) == len(exp[1] & exp[2])
        assert backend.counters["delta_hits"] == 0
        assert backend.counters["full_refreshes"] > full0
    finally:
        backend.close()


def test_resident_topn_stack_delta_refresh(holder):
    """The (R, k, W) candidate stack refreshes by delta too: a write to
    one candidate row scatters into a clone of the resident stack."""
    idx, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        rows = [1, 2, 3]
        assert backend.topn_counts("ci", "f", rows).tolist() == [len(exp[r]) for r in rows]
        full0 = backend.counters["full_refreshes"]
        idx.field("f").import_bits([2], [9])
        exp[2].add(9)
        assert backend.topn_counts("ci", "f", rows).tolist() == [len(exp[r]) for r in rows]
        assert backend.counters["delta_hits"] >= 1
        assert backend.counters["full_refreshes"] == full0
    finally:
        backend.close()


def test_bsi_stack_resident_across_queries(holder):
    """The BSI plane stack is resident: a repeat Sum re-uses the cached
    (D+1, k, W) stack instead of re-walking containers."""
    from pilosa_tpu_torch.core.field import FieldOptions

    idx, _ = _plant(holder)
    idx.create_field_if_not_exists(
        "v", FieldOptions(type="int", min=0, max=255))
    for col, val in [(3, 10), (9, 20), (700, 30)]:
        idx.field("v").set_value(col, val)
    backend, _ = _pod(holder)
    try:
        depth = idx.field("v").bsi_group("v").bit_depth()
        counts = backend.bsi_val_count("ci", "v", "sum", depth)
        full0 = backend.counters["full_refreshes"]
        counts2 = backend.bsi_val_count("ci", "v", "sum", depth)
        assert list(counts) == list(counts2)
        assert backend.counters["full_refreshes"] == full0
        assert backend.counters["resident_hits"] >= 1
    finally:
        backend.close()


def test_delete_recreate_never_aliases_resident_planes(holder):
    """The incarnation half of the fingerprint means a deleted-and-
    recreated index whose fresh generation counters climb back can never
    alias the old index's resident planes."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    idx, exp = _plant(holder, n_shards=2)
    backend, _ = _pod(holder)
    try:
        c = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        old = backend.count("ci", c)
        assert old == len(exp[1] & exp[2]) and old > 0
        holder.delete_index("ci")
        idx = holder.create_index_if_not_exists("ci")
        idx.create_field_if_not_exists("f")
        cols1 = [1, 9, SHARD_WIDTH + 4]
        cols2 = [9, 70, SHARD_WIDTH + 8]
        idx.field("f").import_bits([1] * len(cols1), cols1)
        idx.field("f").import_bits([2] * len(cols2), cols2)
        got = backend.count("ci", _call("Count(Intersect(Row(f=1), Row(f=2)))"))
        assert got == 1, got  # the old answer would be `old`
    finally:
        backend.close()


def test_enter_refuses_epoch_divergence(holder):
    """A peer whose routing epoch diverges from the descriptor's refuses
    BEFORE computing (the leader's fan-out serves the query)."""
    _plant(holder)
    backend, server = _pod(holder)
    try:
        c = _call("Count(Row(f=1))")
        desc = backend._descriptor("count", "ci", queries=[str(c)],
                                   sig=backend._call_sig("ci", c))
        desc["seq"] = 1
        desc["epoch"] = server.cluster.routing_epoch + 3  # leader is ahead
        with pytest.raises(CollectiveUnavailable, match="epoch") as ei:
            backend._enter(desc)
        assert ei.value.reason == "epoch"
        assert backend.counters["stale_epoch_refusals"] == 1
        # Topology churn must NOT advance the plane breaker.
        assert backend.health.plane_state() == "closed"
    finally:
        backend.close()


def test_enter_refuses_a_descriptor_of_another_job_size(holder):
    """The counterpart of the reference's mesh-layout check: a
    descriptor placed for another world size refuses as a placement
    error."""
    _plant(holder)
    backend, _ = _pod(holder)
    try:
        c = _call("Count(Row(f=1))")
        desc = backend._descriptor("count", "ci", queries=[str(c)],
                                   sig=backend._call_sig("ci", c))
        desc.update(seq=1, processes=2, slots=desc["slots"] + [[]])
        with pytest.raises(CollectiveUnavailable, match="processes") as ei:
            backend._enter(desc)
        assert ei.value.reason == "placement"
    finally:
        backend.close()


def test_mesh_width_never_aliases_resident_planes(holder):
    """The resident-cache key carries the mesh width. n_shards=4 pads to
    k=4 at both mesh_devices=4 and =2, so without the width in the key
    the second count would resident-hit the 4-partition layout's blocks."""
    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        c = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        want = len(exp[1] & exp[2])
        backend.mesh_devices = 4
        assert backend.count("ci", c) == want
        full0 = backend.counters["full_refreshes"]
        backend.mesh_devices = 2
        assert backend.count("ci", c) == want
        assert backend.counters["full_refreshes"] > full0
    finally:
        backend.close()


def test_resident_blocks_split_over_partitions_and_refresh_one_block(holder):
    """At mesh width 3, 4 shards pad to k = 6: each resident leaf is three
    blocks of two slots (slot s in block s // 2, padding zero), and a Set
    in shard 3 refreshes block 1 alone by a delta."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.parallel.engine import Blocks, Leaf

    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    try:
        backend.mesh_devices = 3
        c = _call("Count(Row(f=1))")
        assert backend.count("ci", c) == len(exp[1])
        desc = backend._descriptor("count", "ci", queries=[str(c)])
        assert (desc["k"], desc["dLocal"], desc["meshDevices"]) == (6, 3, 3)
        mesh = backend.partitions(3)
        leaf = Leaf("f", "standard", 1)
        before = backend._global_leaf("ci", leaf, [0, 1, 2, 3], 6, mesh)
        assert isinstance(before, Blocks) and [tuple(b.shape) for b in before] == \
            [(2, 32768)] * 3
        assert not before[2][1].any()  # padding slot 5
        col = next(x for x in range(2048) if 3 * SHARD_WIDTH + x not in exp[1])
        holder.index("ci").field("f").set_bit(1, 3 * SHARD_WIDTH + col)
        deltas = backend.counters["delta_hits"]
        after = backend._global_leaf("ci", leaf, [0, 1, 2, 3], 6, mesh)
        assert backend.counters["delta_hits"] == deltas + 1
        assert [p for p in range(3) if after[p] is not before[p]] == [1]
        assert backend.count("ci", c) == len(exp[1]) + 1
    finally:
        backend.close()


def test_resident_stack_refreshes_the_written_partition_only(holder):
    """A BSI stack at mesh width 2 (4 shards, k = 4, two per block): a
    SetValue in shard 2 refreshes block 1 by a delta, block 0 is the same
    tensor, and Sum and Max see the write."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.core.field import FieldOptions

    idx, _ = _plant(holder)
    v = idx.create_field_if_not_exists("v", FieldOptions(type="int", min=0, max=1000))
    rng = np.random.default_rng(5)
    cols = [int(s * SHARD_WIDTH + c) for s in range(4) for c in rng.choice(2048, 40, False)]
    vals = [int(x) for x in rng.integers(0, 900, len(cols))]
    v.import_value(cols, vals)
    backend, _ = _pod(holder)
    try:
        backend.mesh_devices = 2
        depth = v.bsi_group("v").bit_depth()
        assert backend.bsi_val_count("ci", "v", "sum", depth).tolist()[-1] == len(cols)
        planes = list(backend._stack_cache.values())[0][1]
        deltas = backend.counters["delta_hits"]
        v.set_value(2 * SHARD_WIDTH + 4095, 999)
        bits, count = backend.bsi_val_count("ci", "v", "max", depth)
        assert (int(sum(int(b) << i for i, b in enumerate(bits))), count) == (999, 1)
        assert backend.counters["delta_hits"] == deltas + 1
        after = list(backend._stack_cache.values())[0][1]
        assert after[0] is planes[0] and after[1] is not planes[1]
        sums = backend.bsi_val_count("ci", "v", "sum", depth).tolist()
        assert sums[-1] == len(cols) + 1
    finally:
        backend.close()


def test_a_rank_with_another_partition_count_refuses(holder, monkeypatch):
    """In the reference every process has the same local device count; a
    port rank's partitions come from its own server, so a rank whose
    count differs from the descriptor's d_local refuses as a placement
    error (the counterpart of the mesh-layout check)."""
    _plant(holder)
    backend, server = _pod(holder)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    server.cluster.nodes.append(Node(id="n1", process_idx=1))
    server.cluster.node.process_idx = 0
    monkeypatch.setattr(backend, "_verify_ownership", lambda *a: None)
    try:
        desc = {"seq": 1, "type": "collective-exec", "kind": "count",
                "index": "ci", "queries": ["Row(f=1)"], "slots": [[0, 1], [2, 3]],
                "k": 2, "dLocal": 2, "meshDevices": None, "timeoutMs": 1000,
                "sig": None, "epoch": 0}
        assert len(backend.partitions()) == 1  # this rank's engine: one partition
        with pytest.raises(CollectiveUnavailable, match="partitions") as ei:
            backend._enter(desc)
        assert ei.value.reason == "placement"
        assert backend.counters["reduces"] == 0
    finally:
        backend.close()


def test_enter_discards_result_when_epoch_advances_mid_execution(holder):
    """A cutover committing while planes are being assembled discards the
    collective result; the leader re-runs through the fan-out."""
    _plant(holder)
    backend, server = _pod(holder)
    try:
        c = _call("Count(Row(f=1))")
        desc = backend._descriptor("count", "ci", queries=[str(c)],
                                   sig=backend._call_sig("ci", c))
        desc["seq"] = 1
        orig = backend._run_count

        def bump_then_run(*a, **kw):
            server.cluster.routing_epoch += 1
            return orig(*a, **kw)

        backend._run_count = bump_then_run
        with pytest.raises(CollectiveUnavailable, match="advanced") as ei:
            backend._enter(desc)
        assert ei.value.reason == "epoch"
        assert backend.counters["epoch_rechecks"] == 1
    finally:
        backend.close()


def test_placement_follows_committed_cutover():
    """Mid-rebalance, a committed cutover's shard routes to its NEW
    owner in the descriptor placement."""
    nodes = [Node(id="n0", process_idx=0), Node(id="n1", process_idx=1)]
    c = Cluster(node=nodes[0], nodes=nodes, replica_n=1, hasher=ModHasher())
    before = placement(c, "i", 4, 2)
    moved = before[0][0]
    c.begin_rebalance([nodes[1]])
    c.apply_cutover("i", moved)
    after = placement(c, "i", 4, 2)
    assert moved in after[1] and moved not in after[0]
    assert sorted(after[0] + after[1]) == list(range(4))


def test_barrier_failpoint_opens_breaker_then_recovers(holder):
    """Barrier failures open the plane breaker after
    `collective-breaker-failures`; once open, queries short-circuit
    INSTANTLY (no barrier wait, no seq burned); after the fault clears,
    the half-open probe query re-closes the plane."""
    from pilosa_tpu_torch import failpoints
    from pilosa_tpu_torch.cluster.health import ResilienceConfig
    from pilosa_tpu_torch.parallel.device_health import CollectivePlaneHealth

    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    clock = [1000.0]
    backend.health = CollectivePlaneHealth(
        ResilienceConfig(collective_breaker_failures=2,
                         collective_breaker_backoff=1.0).validate(),
        clock=lambda: clock[0])
    try:
        c = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        want = len(exp[1] & exp[2])
        assert backend.count("ci", c) == want
        failpoints.configure("collective-barrier", "error")
        for _ in range(2):
            with pytest.raises(CollectiveUnavailable) as ei:
                backend.count("ci", c)
            assert ei.value.reason == "barrier-timeout"
        assert backend.counters["barrier_timeouts"] == 2
        assert backend.health.plane_state() == "open"
        seq_before = backend._local_seq
        with pytest.raises(CollectiveUnavailable) as ei:
            backend.count("ci", c)
        assert ei.value.reason == "breaker-open"
        assert backend._local_seq == seq_before
        assert backend.counters["breaker_short_circuits"] == 1
        failpoints.reset()
        clock[0] += 10.0
        assert backend.count("ci", c) == want
        assert backend.health.plane_state() == "closed"
    finally:
        failpoints.reset()
        backend.close()


def test_allow_never_orphans_plane_probe_on_blocked_slice():
    """allow() must due-check EVERY breaker before claiming any probe."""
    from pilosa_tpu_torch.cluster.health import ResilienceConfig
    from pilosa_tpu_torch.parallel.device_health import CollectivePlaneHealth

    clock = [0.0]
    h = CollectivePlaneHealth(
        ResilienceConfig(collective_breaker_failures=1,
                         collective_breaker_backoff=2.0).validate(),
        clock=lambda: clock[0])
    h.record_failure("runtime")  # t=0: plane opens
    clock[0] = 1.0
    h.record_failure("broadcast", [1])  # t=1: slice 1 opens
    clock[0] = 2.5  # plane due (>= 2.0), slice NOT due (>= 3.0)
    assert not h.allow([0, 1])
    assert h.plane_state() == "open"  # no wedged half-open probe
    assert h.counters["plane_probes"] == 0
    assert h.counters["slice_short_circuits"] == 1
    clock[0] = 3.5  # both due: joint probe, one entry resolves both
    assert h.allow([0, 1])
    h.record_success([0, 1])
    assert h.plane_state() == "closed"
    assert h.slice_state(1) == "closed"


def test_broadcast_failure_quarantines_slice():
    from pilosa_tpu_torch.cluster.health import ResilienceConfig
    from pilosa_tpu_torch.parallel.device_health import CollectivePlaneHealth

    clock = [0.0]
    h = CollectivePlaneHealth(
        ResilienceConfig(collective_breaker_failures=1,
                         collective_breaker_backoff=2.0).validate(),
        clock=lambda: clock[0])
    assert h.allow([0, 1])
    h.record_failure("broadcast", [1])
    assert h.slice_state(1) == "open"
    assert not h.allow([0, 1])
    clock[0] += 2.5
    assert h.allow([0, 1])  # half-open probe claimed
    h.record_success([0, 1])
    assert h.slice_state(1) == "closed"
    assert h.plane_state() == "closed"


def _executor(holder, server, **kw):
    from pilosa_tpu_torch.executor import Executor

    ex = Executor(holder, cluster=server.cluster, workers=0, **kw)
    server.executor = ex
    return ex


def test_executor_falls_back_cleanly_and_counts_reason(holder):
    """A refusing collective plane is a performance event, not an
    availability event: the executor serves the query through the
    fan-out and the refusal reason lands in the collective counters."""
    _, exp = _plant(holder)
    backend, server = _pod(holder)
    ex = _executor(holder, server)
    ex.collective = backend
    try:
        def refuse(index, call):
            raise CollectiveUnavailable("mid-rebalance window",
                                        reason="epoch")

        backend.count = refuse
        got = ex.execute("ci", "Count(Intersect(Row(f=1), Row(f=2)))")
        assert got[0] == len(exp[1] & exp[2])
        assert backend.fallbacks == {"epoch": 1}
    finally:
        backend.close()
        ex.close()


def test_executor_serves_whole_index_queries_through_the_plane(holder):
    """Count, TopN's phase 2 and Sum/Min/Max take the collective rung
    when the plane is active and the query covers every shard; a shard
    subset takes the fan-out."""
    from pilosa_tpu_torch.core.field import FieldOptions

    idx, exp = _plant(holder)
    idx.create_field_if_not_exists("v", FieldOptions(type="int", min=0, max=255))
    vals = {3: 10, 9: 20, 700: 30}
    for col, val in vals.items():
        idx.field("v").set_value(col, val)
    backend, server = _pod(holder)
    ex = _executor(holder, server)
    ex.collective = backend
    try:
        assert ex.execute("ci", "Count(Intersect(Row(f=1), Row(f=2)))") == [
            len(exp[1] & exp[2])]
        assert backend.counters["served_count"] == 1
        pairs = ex.execute("ci", "TopN(f, n=2)")[0]
        want = sorted(((len(exp[r]), r) for r in exp), reverse=True)[:2]
        assert [(p.count, p.id) for p in pairs] == want
        assert backend.counters["served_topn"] == 1
        got = ex.execute("ci", "Sum(field=v) Max(field=v) Min(field=v)")
        assert [(g.val, g.count) for g in got] == [(60, 3), (30, 1), (10, 1)]
        assert backend.counters["served_bsi"] == 3
        entries = backend.counters["entries"]
        ex.execute("ci", "Count(Row(f=1))", shards=[0, 1])
        assert backend.counters["entries"] == entries
    finally:
        backend.close()
        ex.close()


@pytest.mark.parametrize("mesh_devices,minmax_copies", [(1, 1), (2, 2)])
def test_a_reduce_on_the_device_copies_the_reduced_result_once(holder, monkeypatch,
                                                              mesh_devices, minmax_copies):
    """With the reduce on the device (an NCCL group; its device stood in
    for by the CPU here), each entry's result stays where its partitions
    folded it, the payload is built there, and the reduced result is
    copied to the host once. Min/Max over several partitions folds them
    on the host first and sends its one row back: one copy more. The
    answers equal the host path's."""
    from pilosa_tpu_torch.core.field import FieldOptions

    idx, exp = _plant(holder)
    idx.create_field_if_not_exists("v", FieldOptions(type="int", min=0, max=255))
    for col, val in {3: 10, 9: 20, 700: 30}.items():
        idx.field("v").set_value(col, val)
    backend, _ = _pod(holder)
    backend.mesh_devices = mesh_devices
    monkeypatch.setattr(backend, "_reduce_device", lambda: torch.device("cpu"))
    try:
        def copies(fn):
            before = backend.counters["host_copies"]
            got = fn()
            return got, backend.counters["host_copies"] - before

        calls = [_call("Count(Intersect(Row(f=1), Row(f=2)))"),
                 _call("Count(Intersect(Row(f=2), Row(f=3)))")]
        got, n = copies(lambda: backend.count_batch("ci", calls))
        assert got == [len(exp[1] & exp[2]), len(exp[2] & exp[3])] and n == 1
        got, n = copies(lambda: backend.topn_counts("ci", "f", [1, 2, 3]))
        assert got.tolist() == [len(exp[r]) for r in (1, 2, 3)] and n == 1
        got, n = copies(lambda: backend.bsi_val_count("ci", "v", "sum", 8))
        assert int(got[-1]) == 3 and n == 1
        (bits, count), n = copies(lambda: backend.bsi_val_count("ci", "v", "max", 8))
        assert (sum(int(b) << i for i, b in enumerate(bits)), count) == (30, 1)
        assert n == minmax_copies
        assert backend.counters["reduces"] == backend.counters["entries"] == 4
    finally:
        backend.close()


def test_kernel_fault_in_an_entry_raises_out_of_execute(holder, monkeypatch):
    """A real kernel fault inside a collective entry is not a refusal: it
    raises out of Executor.execute, and the fan-out never answers it (no
    fallback, no peer asked), as on every other path of the port."""
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import collective
    from pilosa_tpu_torch.parallel.device_health import DeviceKernelFault

    _plant(holder)
    backend, server = _pod(holder)

    class Peer:
        asked = 0

        def query_node(self, *a, **kw):
            Peer.asked += 1
            return [0]

    ex = _executor(holder, server, client=Peer())
    ex.collective = backend

    def fault(*a, **kw):
        raise DeviceKernelFault("runtime", None, "planted fault")

    monkeypatch.setattr(collective.kernels, "gather_expr_count_blocks", fault)
    try:
        with pytest.raises(DeviceKernelFault, match="planted"):
            ex.execute("ci", "Count(Intersect(Row(f=1), Row(f=2)))")
        assert backend.fallbacks == {}
        assert Peer.asked == 0
        assert backend.counters["reduces"] == 1  # the rank still reduced
        # A build failure passes through the same way.
        monkeypatch.setattr(collective.kernels, "gather_expr_count_blocks",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                kernels.KernelBuildError("no nvcc")))
        with pytest.raises(kernels.KernelBuildError):
            ex.execute("ci", "Count(Intersect(Row(f=1), Row(f=3)))")
        assert backend.fallbacks == {}
    finally:
        backend.close()
        ex.close()


def test_a_peer_rank_failure_fails_every_rank_together(holder, monkeypatch):
    """After the barrier every rank takes part in the reduce; a rank whose
    part failed sets the status slot, so the healthy ranks raise too (a
    fault, for the breaker) instead of waiting out the group's timeout."""
    _plant(holder)
    backend, _ = _pod(holder)

    def peer_failed(values):
        values[0] += 1  # another rank's status slot
        return values

    monkeypatch.setattr(distributed, "all_reduce_sum", peer_failed)
    try:
        with pytest.raises(CollectiveUnavailable, match="1 rank") as ei:
            backend.count("ci", _call("Count(Row(f=1))"))
        assert ei.value.reason == "error"
        assert backend.counters["rank_failures"] == 1
        assert backend.health.counters["failures_runtime"] == 1
    finally:
        backend.close()


class _Group:
    """A stand-in for the job's reduce group: its generation, and why it
    failed (None while it serves)."""

    def __init__(self, generation=0):
        self.generation, self.failed = generation, None
        self.backend, self.device = "gloo", torch.device("cpu")


def _as_rank_0_of_2(monkeypatch, backend, server, generations):
    """`backend` as rank 0 of a two-rank job whose barriers read the
    reduce-group generations `generations` in turn; returns a descriptor
    maker (rank 0 holds shards 0 and 1) and the job's stand-in state."""
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    server.cluster.nodes.append(Node(id="n1", process_idx=1))
    server.cluster.node.process_idx = 0
    monkeypatch.setattr(backend, "_verify_ownership", lambda *a: None)
    gens = iter(generations)
    monkeypatch.setattr(backend, "_barrier", lambda *a: next(gens))
    job = SimpleNamespace(group=_Group(0), reforms=[])
    monkeypatch.setattr(distributed, "reduce_group", lambda: job.group)

    def desc(seq):
        return {"seq": seq, "type": "collective-exec", "kind": "count",
                "index": "ci", "queries": ["Row(f=1)"], "slots": [[0, 1], [2, 3]],
                "k": 2, "timeoutMs": 1000, "sig": None, "epoch": 0}

    return desc, job


def test_a_failed_reduce_re_forms_the_group(holder, monkeypatch):
    """A reduce that fails (the group's timeout ran out) answers the
    entry `error`, for the breaker, and leaves the plane on: the next
    entry's barrier reads the generation the failure advanced, the rank
    re-forms its group at it before the reduce, and the entry is
    served."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    _, exp = _plant(holder)
    backend, server = _pod(holder)
    desc, job = _as_rank_0_of_2(monkeypatch, backend, server, [0, 1])
    reduced = []

    def reduce(values):
        reduced.append(job.group.generation)
        if len(reduced) == 1:
            job.group.failed = "timed out"
            raise distributed.ReduceFailed("gloo reduce of generation 0 failed: timed out")
        return values

    def regroup(generation):
        job.group = _Group(generation)
        job.reforms.append(generation)
        return job.group

    monkeypatch.setattr(distributed, "all_reduce_sum", reduce)
    monkeypatch.setattr(distributed, "regroup", regroup)
    try:
        with pytest.raises(CollectiveUnavailable, match="reduce failed") as ei:
            backend._enter(desc(1))
        assert ei.value.reason == "error"
        snap = backend.snapshot()
        assert snap["group_failures"] == 1 and snap["broken"] is None
        assert backend.active()
        got = backend._enter(desc(2))
        assert list(got) == [sum(1 for c in exp[1] if c // SHARD_WIDTH in (0, 1))]
        assert job.reforms == [1] and reduced == [0, 1]
        snap = backend.snapshot()
        assert snap["group_reforms"] == 1 and snap["reduces"] == 1
        assert snap["host_copies"] == 2  # one per entry: the gloo payload
    finally:
        backend.close()


@pytest.mark.parametrize("case", ["re-formation", "first-group"])
def test_a_group_that_does_not_form_turns_the_plane_off(holder, monkeypatch, case):
    """The plane goes off only when a reduce group does not form: a
    re-formation whose rendezvous times out, or the job's first group
    (a job the rule sends to NCCL that cannot form its NCCL group is not
    served on gloo instead). `broken` holds the reason and the leader
    refuses `inactive`, which the executor answers through the fan-out."""
    _plant(holder)
    backend, server = _pod(holder)
    desc, job = _as_rank_0_of_2(monkeypatch, backend, server, [1])
    why = f"reduce group of generation {int(case != 'first-group')} did not form"
    try:
        assert backend.active()
        if case == "first-group":
            monkeypatch.setattr(distributed, "group_error",
                                lambda: f"nccl {why}: this torch build has no NCCL")
        else:
            job.group.failed = "timed out"

            def regroup(generation):
                raise distributed.ReduceFailed(
                    f"gloo {why}: not formed within 30000 ms")

            monkeypatch.setattr(distributed, "regroup", regroup)
            with pytest.raises(CollectiveUnavailable, match="did not re-form") as ei:
                backend._enter(desc(2))
            assert ei.value.reason == "error"
        assert not backend.active()
        assert why in backend.snapshot()["broken"]
        with pytest.raises(CollectiveUnavailable) as ei:
            backend.count("ci", _call("Count(Row(f=1))"))
        assert ei.value.reason == "inactive"
    finally:
        backend.close()


def test_collective_eviction_demotes_to_tier(holder):
    """Resident-block eviction is DEMOTION: past the leaf budget, the LRU
    plane's compressed image lands in the engine's tier manager, and the
    next cold assembly promotes from it instead of walking containers."""
    from pilosa_tpu_torch.tier import TierConfig

    _, exp = _plant(holder)
    # One (4, W) block is 512 KiB here (k = 4 shards, one device): the
    # budget fits 2 planes, so the third leaf evicts the first.
    backend, server = _pod(holder, leaf_budget_bytes=2 * (1 << 19) + (1 << 16))
    ex = _executor(holder, server, tier_config=TierConfig(host_bytes=1 << 24))
    assert ex.engine.tier is not None
    try:
        for row in (1, 2, 3):
            backend.count("ci", _call(f"Count(Row(f={row}))"))
        assert backend.counters["evictions"] >= 1
        ex.engine.tier.drain()
        assert backend.counters["demotions"] >= 1
        tp0 = backend.counters["tier_promotes"]
        assert backend.count("ci", _call("Count(Row(f=1))")) == len(exp[1])
        assert backend.counters["tier_promotes"] > tp0
    finally:
        backend.close()
        ex.close()


def test_batcher_coalesces_collective_counts(holder):
    """sched/batcher.py collective_count: concurrent same-signature
    Counts coalesce into ONE backend entry (count_batch), results split
    back bit-exact."""
    from pilosa_tpu_torch.sched import MicroBatcher

    _, exp = _plant(holder)
    backend, _ = _pod(holder)
    release = threading.Event()

    def wait_window(group, window):
        release.wait(timeout=10)

    b = MicroBatcher(lambda: None, window=0.001, window_max=0.05,
                     batch_max=8, depth_fn=lambda: 8,
                     wait_window=wait_window)
    try:
        c12 = _call("Count(Intersect(Row(f=1), Row(f=2)))")
        c21 = _call("Count(Intersect(Row(f=2), Row(f=1)))")
        sig = ("sig",)
        results = {}
        threads = []

        def run(i, call):
            results[i] = b.collective_count(backend, "ci", call, sig)

        for i, call in enumerate([c12, c21, c12, c21]):
            t = threading.Thread(target=run, args=(i, call))
            t.start()
            threads.append(t)
        deadline = time.time() + 5
        while b.snapshot()["enqueued"] < 4 and time.time() < deadline:
            time.sleep(0.005)
        release.set()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        want = len(exp[1] & exp[2])
        assert results == {0: want, 1: want, 2: want, 3: want}
        assert backend.counters["entries"] == 1  # ONE collective entry
        assert b.snapshot()["coalesced"] == 3
    finally:
        backend.close()


def test_malformed_descriptor_is_a_typed_error(holder):
    """A collective-exec message without an integer seq is refused at
    receipt (the reference's runner raises KeyError there, a 500)."""
    from pilosa_tpu_torch.errors import QueryError

    backend, _ = _pod(holder)
    try:
        with pytest.raises(QueryError, match="seq"):
            backend.receive({"type": "collective-exec"})
        assert backend._runner._thread is None
    finally:
        backend.close()


# ------------------------------------------- two-process cluster integration

WORKER = textwrap.dedent("""
    import json, os, sys, threading, time
    import urllib.request

    coord, pid, port0, port1, tmp = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5],
    )
    os.environ["PILOSA_JAX_COORDINATOR"] = coord
    os.environ["PILOSA_JAX_NUM_PROCESSES"] = "2"
    os.environ["PILOSA_JAX_PROCESS_ID"] = str(pid)
    os.environ["PILOSA_COLLECTIVE_TIMEOUT_MS"] = "3000"

    from pilosa_tpu_torch.server.client import InternalClient
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.parallel import collective as coll

    # Trace collective entries to stderr: on failure pytest shows which
    # seq/kind each process entered and whether it completed.
    _orig_enter = coll.CollectiveBackend._enter

    def _traced_enter(self, desc):
        print(f"[p{pid}] enter seq={desc['seq']} kind={desc['kind']}",
              file=sys.stderr, flush=True)
        try:
            r = _orig_enter(self, desc)
            print(f"[p{pid}] done seq={desc['seq']}", file=sys.stderr, flush=True)
            return r
        except BaseException as e:
            print(f"[p{pid}] FAILED seq={desc['seq']}: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            raise

    coll.CollectiveBackend._enter = _traced_enter

    SW = 1 << 20
    hosts = [f"localhost:{port0}", f"localhost:{port1}"]
    s = Server(
        data_dir=f"{tmp}/node{pid}",
        port=[port0, port1][pid],
        cluster_hosts=hosts,
        replica_n=1,
        cache_flush_interval=0,
        anti_entropy_interval=0,
        member_monitor_interval=0.2,
        executor_workers=0,
        device="cpu",
    )
    s.open()
    try:
        if pid == 1:
            # Serve until the leader finishes; receive descriptors late
            # while the `late` sentinel exists, and drop them once the
            # `drop` sentinel appears.
            real = s.collective.receive

            def late(desc):
                def later():
                    time.sleep(s.collective.timeout_ms / 1000.0 + 1.0)
                    real(desc)
                threading.Thread(target=later, daemon=True).start()

            mode = "real"
            while not os.path.exists(f"{tmp}/done"):
                want = ("drop" if os.path.exists(f"{tmp}/drop") else
                        "late" if os.path.exists(f"{tmp}/late") else "real")
                if want != mode:
                    s.collective.receive = {"drop": lambda desc: None,
                                            "late": late, "real": real}[want]
                    mode = want
                time.sleep(0.05)
            print("WORKER1_OK")
            sys.exit(0)

        client = InternalClient()
        h = hosts[0]

        deadline = time.time() + 30
        while time.time() < deadline and not s.collective.active():
            time.sleep(0.1)
        assert s.collective.active(), [
            (n.id, n.process_idx) for n in s.cluster.nodes
        ]

        client.create_index(h, "ci")
        client.create_field(h, "ci", "f")
        client.create_field(h, "ci", "v",
                            {"type": "int", "min": 0, "max": 255})

        # Data through the NORMAL cluster write path: jump-hash placement
        # decides which node stores each shard's fragment.
        row1 = [5, SW + 1, 3 * SW + 7, 11]
        row2 = [5, SW + 1, 9]
        for col in row1:
            client.query(h, "ci", f"Set({col}, f=1)")
        for col in row2:
            client.query(h, "ci", f"Set({col}, f=2)")
        vals = {5: 10, 9: 20, SW + 1: 30}
        for col, val in vals.items():
            client.query(h, "ci", f"SetValue(col={col}, v={val})")

        def dvars(host):
            raw = urllib.request.urlopen(f"http://{host}/debug/vars", timeout=5).read()
            return json.loads(raw)

        def counter(name):
            return dvars(h)["counters"].get(name, 0)

        count_q = "Count(Intersect(Row(f=1), Row(f=2)))"
        got = client.query(h, "ci", count_q)
        assert got["results"][0] == 2, got
        assert counter("CollectiveCount") >= 1, "collective path not taken"

        got = client.query(h, "ci", "TopN(f, n=5)")
        pairs = {p["id"]: p["count"] for p in got["results"][0]}
        assert pairs == {1: 4, 2: 3}, pairs
        assert counter("CollectiveTopN") >= 1

        got = client.query(h, "ci", "Sum(field=v)")
        assert got["results"][0] == {"value": 60, "count": 3}, got
        got = client.query(h, "ci", "Sum(Row(f=1), field=v)")
        assert got["results"][0] == {"value": 40, "count": 2}, got
        got = client.query(h, "ci", "Min(field=v)")
        assert got["results"][0] == {"value": 10, "count": 1}, got
        got = client.query(h, "ci", "Max(field=v)")
        assert got["results"][0] == {"value": 30, "count": 1}, got
        assert counter("CollectiveValCount") >= 4
        assert counter("CollectiveFallback") == 0

        # --- A late peer: it receives the descriptor only after the
        # leader's barrier timed out. The leader falls back (right
        # answer); the peer, arriving, reads `abort` and never enters
        # the reduce, so both ranks entered the same number of reduces.
        open(f"{tmp}/late", "w").close()
        time.sleep(0.3)
        got = client.query(h, "ci", count_q)
        assert got["results"][0] == 2, got
        assert counter("CollectiveFallback") == 1
        deadline = time.time() + 20
        while time.time() < deadline and dvars(hosts[1])["collective"]["barrier_aborts"] < 1:
            time.sleep(0.1)
        peer, mine = dvars(hosts[1])["collective"], dvars(h)["collective"]
        assert peer["barrier_aborts"] == 1, peer
        assert peer["reduces"] == mine["reduces"], (peer, mine)
        os.remove(f"{tmp}/late")
        time.sleep(0.3)
        before = counter("CollectiveCount")
        got = client.query(h, "ci", count_q)
        assert got["results"][0] == 2, got
        assert counter("CollectiveCount") == before + 1, "plane did not resume"

        # --- The peer drops descriptors: the leader's barrier times out
        # and the query falls back to the HTTP fan-out, no hang.
        open(f"{tmp}/drop", "w").close()
        time.sleep(0.3)
        t0 = time.time()
        got = client.query(h, "ci", count_q)
        elapsed = time.time() - t0
        assert got["results"][0] == 2, got
        assert counter("CollectiveFallback") >= 2, "no fallback recorded"
        assert elapsed < 25, f"leader stalled {elapsed}s"
        print(f"WORKER0_OK fallback_after={elapsed:.1f}s")
    finally:
        open(f"{tmp}/done", "w").close()
        s.close()
""")


def run_workers(tmp_path, script, argv, timeout):
    """Start one worker per argv list, wait for all (each with a time
    limit), kill any that is left in a `finally`; [(rc, out, err)]."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(path)] + [str(a) for a in args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(tmp_path))
             for args in argv]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


@pytest.mark.parametrize("n_proc", [2])
def test_two_process_cluster_collective_queries(tmp_path, n_proc):
    coord = f"localhost:{free_port()}"
    http_ports = [free_port(), free_port()]
    outs = run_workers(tmp_path, WORKER, [
        [coord, pid, http_ports[0], http_ports[1], tmp_path] for pid in range(n_proc)],
        timeout=150)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
    assert any("WORKER0_OK" in out for _, out, _ in outs)
    assert any("WORKER1_OK" in out for _, out, _ in outs)


# One rank of a two-rank job whose rank 1 stalls one reduce past the
# group's timeout (a sentinel file arms it): both ranks' reduces fail, the
# leader answers that Count through the fan-out, and the next entry's
# barrier re-forms the group on both ranks before its reduce.
WORKER_STALL = textwrap.dedent("""
    import json, os, sys, time
    import urllib.request

    coord, pid, port0, port1, tmp = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5],
    )
    os.environ["PILOSA_JAX_COORDINATOR"] = coord
    os.environ["PILOSA_JAX_NUM_PROCESSES"] = "2"
    os.environ["PILOSA_JAX_PROCESS_ID"] = str(pid)
    os.environ["PILOSA_COLLECTIVE_TIMEOUT_MS"] = "2000"

    from pilosa_tpu_torch.parallel import distributed
    from pilosa_tpu_torch.server.client import InternalClient
    from pilosa_tpu_torch.server.server import Server

    hosts = [f"localhost:{port0}", f"localhost:{port1}"]
    s = Server(data_dir=f"{tmp}/node{pid}", port=[port0, port1][pid],
               cluster_hosts=hosts, replica_n=1, cache_flush_interval=0,
               anti_entropy_interval=0, member_monitor_interval=0.2,
               executor_workers=0, device="cpu")
    s.open()

    def dvars(host):
        return json.loads(urllib.request.urlopen(f"http://{host}/debug/vars",
                                                 timeout=5).read())

    try:
        if pid == 1:
            real = distributed.all_reduce_sum

            def stalled(values):
                if os.path.exists(f"{tmp}/stall"):
                    os.remove(f"{tmp}/stall")
                    time.sleep(s.collective.timeout_ms / 1000.0 + 0.5)
                return real(values)

            distributed.all_reduce_sum = stalled
            while not os.path.exists(f"{tmp}/done"):
                time.sleep(0.05)
            print("WORKER1_OK")
            sys.exit(0)

        client = InternalClient()
        h = hosts[0]
        deadline = time.time() + 30
        while time.time() < deadline and not s.collective.active():
            time.sleep(0.1)
        assert s.collective.active()
        client.create_index(h, "ci")
        client.create_field(h, "ci", "f")
        cols = [5, (1 << 20) + 1, 3 * (1 << 20) + 7, 11]
        for col in cols:
            client.query(h, "ci", f"Set({col}, f=1)")
        q = "Count(Row(f=1))"

        def served():
            return dvars(h)["counters"].get("CollectiveCount", 0)

        assert client.query(h, "ci", q)["results"][0] == 4
        assert served() == 1, "collective path not taken"
        for host in hosts:
            c = dvars(host)["collective"]
            assert c["reduce_backend"] == "gloo" and c["group_generation"] == 0, c

        # --- rank 1 stalls its next reduce past the group's timeout
        open(f"{tmp}/stall", "w").close()
        assert client.query(h, "ci", q)["results"][0] == 4  # through the fan-out
        failed_at = time.time()
        assert served() == 1
        assert dvars(h)["collective"]["group_failures"] == 1
        recovered = None
        while time.time() - failed_at < 10:
            assert client.query(h, "ci", q)["results"][0] == 4
            if served() == 2:
                recovered = time.time() - failed_at
                break
            time.sleep(0.1)
        assert recovered is not None, dvars(h)["collective"]
        for host in hosts:
            c = dvars(host)["collective"]
            assert c["group_failures"] == 1 and c["group_reforms"] == 1, (host, c)
            assert c["group_generation"] == 1 and c["broken"] is None, (host, c)
        print(f"WORKER0_OK recovered={recovered:.2f}s")
    finally:
        open(f"{tmp}/done", "w").close()
        s.close()
""")


def test_a_stalled_reduce_re_forms_the_group_across_processes(tmp_path):
    """Two real ranks on gloo; rank 1 stalls one reduce past the group's
    timeout. Both ranks' reduces fail, the Count is answered through the
    fan-out, both re-form at generation 1, and the next Count goes
    through the plane again with the right answer within 10 s."""
    coord = f"localhost:{free_port()}"
    http_ports = [free_port(), free_port()]
    outs = run_workers(tmp_path, WORKER_STALL, [
        [coord, pid, http_ports[0], http_ports[1], tmp_path] for pid in range(2)],
        timeout=120)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
    assert any("WORKER0_OK" in out for _, out, _ in outs)
    assert any("WORKER1_OK" in out for _, out, _ in outs)


def test_server_open_builds_the_backend(tmp_path):
    """Every server builds the collective backend at open and wires it
    into the executor; one process on a one-node cluster stays off the
    plane unless `[collective] single-process` is set."""
    from pilosa_tpu_torch.parallel import CollectiveConfig
    from pilosa_tpu_torch.server.server import Server

    for single, want in ((0, False), (1, True)):
        s = Server(data_dir=str(tmp_path / f"d{single}"), device="cpu",
                   cache_flush_interval=0,
                   collective_config=CollectiveConfig(single_process=single))
        s.open()
        try:
            assert s.executor.collective is s.collective
            assert s.node.process_idx is None  # no job joined
            assert s.collective.active() is want
        finally:
            s.close()
