"""Multi-process collective query execution: the primary read path for
whole-index queries when a torch.distributed job spans the cluster.

The counterpart of pilosa_tpu/parallel/collective.py. The reference
fans every call out over HTTP and reduces in Python; its fast path runs
ONE SPMD program over a global device mesh instead. Here every server
process is one rank of a torch.distributed job (parallel/distributed.py):
each rank runs the port's hand kernels over the shard planes it owns,
and the ranks combine their results with one host reduce over gloo.

Design (the reference's, with its names):

- **Placement follows the cluster.** The leader derives each rank's
  shard list from the real jump-hash placement and ships it in the
  descriptor; each rank contributes exactly the fragments it owns, as a
  (k, W) block padded with zero planes, and verifies ownership of every
  assigned shard against its own cluster view, refusing on mismatch.
- **Any compiled call tree.** The descriptor carries the PQL of the
  (already key-translated) call and its canonical plan signature
  (plan/signature.py); every rank plans it itself and refuses on a
  different signature (schema divergence).
- **Each rank over its local partitions.** A rank holds its k shard
  slots as Blocks over its partitions (the devices of its engine's
  `[engine] mesh-devices`, or a one-process job's `mesh_devices`:
  distributed.global_mesh), d_local of them: k pads to a multiple of
  d_local and slot s lives in partition s // (k / d_local), as the
  reference shards over its processes' local devices. The descriptor
  carries the leader's d_local (and a one-process job's meshDevices); a
  rank holding another number refuses.
- **Three program kinds, each on its kernel, once per partition.**
  `_run_count`: each partition's blocks of the batch's distinct leaves
  stacked, K1 (`gather_expr_count_blocks`: k1_plan and the staging buffer
  once for the entry) gives Q int64 counts per partition, summed on
  partition 0's device, then one all_reduce(SUM). `_run_topn`: the
  filter's plane masks K2 (`masked_plane_counts`) over the candidate
  rows of each partition, summed to (R,), then one all_reduce(SUM).
  `_run_bsi`: Sum is K2 over each partition's (D+1, k / d_local, W)
  planes and one all_reduce; Min/Max is K3 (`bsi_minmax`) on each
  partition, folded as the engine folds its blocks, then one all_gather
  of every rank's (count, bits), combined as K3's own block reduce
  combines its blocks: ranks with count 0 drop out, the best value
  wins, and the counts of the ranks holding it add up — one collective
  where the reference's global bit scan makes D dependent ones. Counts
  are int64 throughout, so the reference's 15-bit split sums have no
  counterpart.
- **Resident blocks.** Each rank keeps its leaf Blocks and stack Blocks
  on its partitions' devices, keyed with the mesh width, invalidated by
  per-fragment (incarnation, generation) fingerprints, refreshed by a
  scatter of the dirty words into a clone of the written slot's block
  (as the engine's delta path does), assembled from the tier manager's
  compressed host image when cold, and demoted through the same tier
  when evicted; byte budgets count every block.
- **Batched entries.** `count_batch` evaluates N same-signature Counts in
  ONE descriptor: one sequence slot, one barrier, one K1 launch per
  partition, one reduce. The micro-batcher feeds it (sched/batcher.py collective_count).
- **Failure semantics.** Every rank passes a named barrier before the
  reduce. Its outcome is one atomic decision in the job's store
  (distributed.barrier): a rank that is late finds `abort` and never
  enters the reduce, so no rank waits inside it for a peer that will not
  come, and no reduce pairs with another sequence's. Each rank runs its
  kernels before the barrier, so a passed barrier leaves every rank a
  host copy away from the reduce; every rank then takes part in it, a
  failing one with a status slot set, so that all raise together. A
  barrier timeout or a lost broadcast feeds the plane's breakers
  (device_health.CollectivePlaneHealth) and the leader answers through
  the HTTP fan-out; topology refusals (epoch, ownership, schema,
  placement) fall back without advancing them. A real
  fault of a kernel on a CUDA rank (DeviceKernelFault) and a kernel that
  cannot be built (KernelBuildError) are not served by the fan-out: they
  raise out of the query, as on every other path of the port. A reduce
  that fails (the group's timeout ran out) leaves the group unusable:
  the plane stays off in this process until it restarts.
- **Epoch-aware membership** and **total order** as in the reference:
  descriptors carry the leader's routing epoch, and one runner thread
  per process enters descriptors in cluster-wide sequence order
  (sequence numbers from the store's atomic add).
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import failpoints
from ..constants import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD, WORDS_PER_ROW
from ..errors import PilosaError, QueryError
from ..obs import current as obs_current
from ..ops import kernels
from ..ops.bitplane import compose_bits
from ..plan.signature import Leaf, cached_plan
from . import CollectiveConfig, distributed
from .device_health import (
    BARRIER_TIMEOUT, BROADCAST, CollectivePlaneHealth, DeviceKernelFault,
    classify_device_error,
)
from .engine import Blocks, ShardedQueryEngine, _fold_minmax, _lowered

DEFAULT_TIMEOUT_MS = int(os.environ.get("PILOSA_COLLECTIVE_TIMEOUT_MS", "10000"))
SEQ_KEY = "pilosa-collective/seq"
# Rank 0 deletes a barrier's keys this many sequences after it: a rank
# that far behind decides `abort` alone, which is what it would read.
BARRIER_KEEP = 1024


class CollectiveUnavailable(PilosaError):
    """The collective plane cannot (or must not) serve this request;
    callers fall back to the HTTP fan-out path. `reason` is the
    fallback-counter key (/debug/vars `collective.fallbacks`): breaker
    evidence only for reasons that indicate a FAULT (barrier-timeout,
    error) — topology churn (epoch, ownership, schema, placement,
    inactive) falls back without opening anything."""

    def __init__(self, message: str = "", reason: str = "error"):
        super().__init__(message)
        self.reason = reason


class CollectiveBarrierTimeout(CollectiveUnavailable):
    """A barrier wait expired: some participant never entered. The one
    failure kind that MUST advance the plane breaker — paying a full
    barrier timeout per query on a known-sick plane is the tax the
    breaker exists to remove."""

    def __init__(self, message: str = ""):
        super().__init__(message, reason="barrier-timeout")


def placement(cluster, index: str, n_shards: int, n_processes: int) -> List[List[int]]:
    """Per-process shard lists from the REAL cluster placement.

    Each shard goes to the process of its first available owner per
    jump-hash (cluster.go:776-857) — including per-shard routing
    overrides for committed live-rebalance cutovers (cluster/node.py
    shard_nodes follows Cluster.migrated), so a descriptor built
    mid-rebalance reflects the refreshed placement, not the pre-job one.
    Raises CollectiveUnavailable when any owning node's process index
    is unknown (node not in the job, or membership status hasn't
    propagated yet)."""
    slots: List[List[int]] = [[] for _ in range(n_processes)]
    for s in range(n_shards):
        owners = cluster.shard_nodes(index, s)
        owner = next(
            (n for n in owners if n.id not in cluster.unavailable), None
        ) or (owners[0] if owners else None)
        if owner is None:
            raise CollectiveUnavailable(
                f"no owner for shard {s}", reason="placement")
        p = owner.process_idx
        if p is None or not (0 <= p < n_processes):
            raise CollectiveUnavailable(
                f"node {owner.id} has no known process index",
                reason="placement",
            )
        slots[p].append(s)
    return slots


class CollectiveBackend:
    """Leader + peer sides of collective execution for one server process."""

    def __init__(self, server, config: Optional[CollectiveConfig] = None):
        self.server = server
        self.holder = server.holder
        self.logger = server.logger
        cfg = config or getattr(server, "collective_config", None)
        if cfg is None:
            # No resolved config (library/test use): the env spellings.
            cfg = CollectiveConfig(
                single_process=int(os.environ.get(
                    "PILOSA_COLLECTIVE_SINGLE_PROCESS", "0")),
                timeout_ms=DEFAULT_TIMEOUT_MS,
                leaf_budget_bytes=int(
                    os.environ.get("PILOSA_COLLECTIVE_LEAF_BYTES", 1 << 28)),
                delta_max_fraction=float(os.environ.get(
                    "PILOSA_COLLECTIVE_DELTA_MAX_FRACTION", "0.25")),
            )
        self.config = cfg
        # The mesh width of a one-process job (the reference's attribute):
        # N partitions placed as engine_mesh places an engine's; None takes
        # the engine's own (`[engine] mesh-devices`).
        self.mesh_devices: Optional[int] = None
        self.enabled = bool(int(cfg.enabled))
        self.single_process = bool(int(cfg.single_process))
        self.timeout_ms = int(cfg.timeout_ms)
        # Collective-plane breakers: barrier timeouts / broadcast losses
        # open per-rank and plane-wide breakers so a sick plane costs an
        # instant fallback, never a barrier timeout per query. Shares the
        # [resilience] section with the peer/device breakers.
        rcfg = getattr(
            getattr(getattr(server, "cluster", None), "health", None),
            "config", None)
        self.health = CollectivePlaneHealth(rcfg)
        # Lowered-program cache (the reference caches jitted programs):
        # entry-bounded LRU, keyed by the canonical signature.
        self._fn_cache: Dict[Tuple, object] = {}
        self._fn_budget = int(os.environ.get("PILOSA_FN_CACHE_ENTRIES", 256))
        # Resident blocks: this rank's (k, W) leaf blocks and (U, k, W)
        # stacks, fingerprint-invalidated, delta-refreshed,
        # tier-demotable. One byte budget each.
        self._leaf_cache: Dict[Tuple, Tuple[Tuple, torch.Tensor]] = {}
        self._leaf_bytes = 0
        self._leaf_budget = int(cfg.leaf_budget_bytes)
        self._stack_cache: Dict[Tuple, Tuple[Tuple, torch.Tensor]] = {}
        self._stack_bytes = 0
        self._stack_budget = int(cfg.leaf_budget_bytes)
        self._delta_max_fraction = float(cfg.delta_max_fraction)
        self._lock = threading.Lock()
        self._local_seq = 0
        # Store clients (distributed.connect_store): the sequence counter's
        # is shared by request threads under its lock, the barrier's
        # belongs to the runner thread alone.
        self._seq_store = None
        self._seq_lock = threading.Lock()
        self._barrier_store = None
        # Why the group stopped serving, after a reduce failed.
        self._broken: Optional[str] = None
        self.counters: Dict[str, int] = {
            "entries": 0,
            "served_count": 0, "served_topn": 0, "served_bsi": 0,
            "batched_entries": 0, "batched_launches": 0,
            "barrier_timeouts": 0, "breaker_short_circuits": 0,
            "resident_hits": 0, "delta_hits": 0, "delta_bytes": 0,
            "full_refreshes": 0, "full_refresh_bytes": 0,
            "tier_promotes": 0, "evictions": 0, "demotions": 0,
            "stale_epoch_refusals": 0, "epoch_rechecks": 0,
            # The port's: reduces entered, barriers this rank found
            # decided `abort`, entries a rank failed after the barrier,
            # reduces the group failed.
            "reduces": 0, "barrier_aborts": 0, "rank_failures": 0,
            "group_failures": 0,
        }
        # Why the fast path refused, by CollectiveUnavailable.reason.
        self.fallbacks: Dict[str, int] = {}
        self._runner = _Runner(self)
        # Descriptor broadcasts ride a shared pool: a thread per peer per
        # query would churn on the hot path (every full-index query).
        self._senders = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="collective-send"
        )

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        self._runner.close()
        self._senders.shutdown(wait=False)

    def active(self) -> bool:
        """True when the collective plane may serve whole-index queries:
        a multi-process job spanning the whole cluster, or (opt-in,
        `[collective] single-process`) a one-process job whose one node
        holds the whole index."""
        if not self.enabled:
            return False
        n_proc = distributed.process_count()
        cluster = self.server.cluster
        if n_proc <= 1:
            # Every fragment is local and the barrier is a no-op. Only
            # safe when the cluster IS this one node — a multi-node
            # cluster without a spanning job would count remote shards as
            # silently empty.
            return self.single_process and len(cluster.nodes) <= 1
        if self._broken is not None:
            return False
        if cluster.unavailable:
            # A down node can't reach the barrier; entering would stall
            # every query the full barrier timeout before falling back.
            return False
        nodes = cluster.nodes
        if len(nodes) != n_proc:
            return False
        return all(n.process_idx is not None for n in nodes)

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def note_fallback(self, reason: str) -> None:
        """Record WHY the fast path refused (the executor calls this on
        every CollectiveUnavailable it catches)."""
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def snapshot(self) -> dict:
        """Counter export: the `collective` group in /debug/vars."""
        with self._lock:
            out = dict(self.counters)
            out["fallbacks"] = dict(self.fallbacks)
            out["leaf_cache_entries"] = len(self._leaf_cache)
            out["leaf_cache_bytes"] = self._leaf_bytes
            out["stack_cache_entries"] = len(self._stack_cache)
            out["stack_cache_bytes"] = self._stack_bytes
            out["broken"] = self._broken
        out["health"] = self.health.snapshot()
        return out

    def _tier(self):
        """The engine's TierManager, when one exists: the resident blocks
        demote into (and promote from) the SAME compressed host tier as
        the engine's caches — tier keys share the (index, leaf, shards)
        shape. Peeks the lazy engine slot only: cache maintenance must
        never be what first opens the device."""
        ex = getattr(self.server, "executor", None)
        eng = getattr(ex, "_engine", None)
        return getattr(eng, "tier", None)

    def partitions(self, mesh_devices: Optional[int] = None) -> List[torch.device]:
        """This rank's partition devices (distributed.global_mesh): N
        placed as engine_mesh places an engine's when `mesh_devices` is N
        (a one-process descriptor's meshDevices), else the engine's own
        mesh, from `[engine] mesh-devices` (built or not)."""
        if mesh_devices:
            return distributed.global_mesh(mesh_devices, self.holder.device)
        ex = getattr(self.server, "executor", None)
        eng = getattr(ex, "_engine", None)
        if eng is not None:
            return list(eng.mesh)
        cfg = getattr(ex, "engine_config", None)
        n = (cfg.mesh_devices if cfg is not None
             else int(os.environ.get("PILOSA_TPU_ENGINE_MESH_DEVICES", 0)))
        return distributed.global_mesh(n, self.holder.device)

    # ---------------------------------------------------------- leader side

    def count(self, index: str, call) -> int:
        out = self.count_batch(index, [call])
        return int(out[0])

    def count_batch(self, index: str, calls: Sequence) -> List[int]:
        """N same-canonical-signature Counts in ONE collective entry:
        one sequence slot, one barrier, one K1 launch per partition, one
        reduce. The calls need not be distinct; duplicates compute once
        and fan back out. Returns per-call counts in input order."""
        calls = list(calls)
        sig = self._call_sig(index, calls[0])
        desc = self._descriptor(
            "count", index, queries=[str(c) for c in calls], sig=sig,
        )
        counts = self._lead(desc)
        with self._lock:
            self.counters["served_count"] += len(calls)
            if len(calls) > 1:
                self.counters["batched_entries"] += len(calls)
                self.counters["batched_launches"] += 1
        return [int(c) for c in counts]

    def topn_counts(self, index: str, field: str, row_ids: Sequence[int],
                    src_call=None) -> np.ndarray:
        """Global per-row counts (optionally ∩ src bitmap): the
        distributed TopN phase-2 inner loop, one entry for the cluster."""
        desc = self._descriptor(
            "topn", index, field=field, rows=[int(r) for r in row_ids],
            query=str(src_call) if src_call is not None else None,
            sig=self._call_sig(index, src_call),
        )
        out = self._lead(desc)
        self._count("served_topn")
        return np.asarray(out, dtype=np.int64)

    def bsi_val_count(self, index: str, field: str, kind: str, depth: int,
                      filter_call=None):
        """Collective BSI Sum/Min/Max (fragment.go:565-837 bit-slice scans
        over every rank's planes). kind='sum' -> (depth+1,) per-plane
        global counts; 'min'/'max' -> (bits, count)."""
        desc = self._descriptor(
            "bsi", index, field=field, bsi_kind=kind, depth=depth,
            query=str(filter_call) if filter_call is not None else None,
            sig=self._call_sig(index, filter_call),
        )
        out = self._lead(desc)
        self._count("served_bsi")
        if kind == "sum":
            return np.asarray(out, dtype=np.int64)
        bits, count = out
        return np.asarray(bits), int(count)

    def _call_sig(self, index: str, call) -> Optional[str]:
        """CANONICAL structure signature of a planned call: respellings
        of one shape share one descriptor signature (and one batcher
        group). Shipped in the descriptor so ranks can detect schema
        divergence and refuse instead of computing."""
        if call is None:
            return None
        return repr(self._sig_tuple(self._compile(index, call)))

    @staticmethod
    def _sig_tuple(plan) -> Tuple:
        return plan.sig_tuple

    def _descriptor(self, kind: str, index: str, query: Optional[str] = None,
                    queries: Optional[List[str]] = None,
                    field: Optional[str] = None, rows: Optional[List[int]] = None,
                    bsi_kind: Optional[str] = None, depth: Optional[int] = None,
                    sig: Optional[str] = None) -> dict:
        idx = self.holder.index(index)
        if idx is None:
            from ..errors import IndexNotFoundError

            raise IndexNotFoundError(index)
        n_shards = idx.max_shard() + 1
        n_proc = distributed.process_count()
        if n_proc > 1:
            if not self.active():
                raise CollectiveUnavailable(
                    "torch.distributed job does not span the cluster "
                    f"({len(self.server.cluster.nodes)} nodes, {n_proc} processes)",
                    reason="inactive",
                )
            slots = placement(self.server.cluster, index, n_shards, n_proc)
            mesh_devices = None
            d_local = len(self.partitions())
        else:
            slots = [list(range(n_shards))]
            mesh_devices = self.mesh_devices
            d_local = mesh_devices or len(self.partitions())
        # k: the largest rank's shard count, padded to a multiple of the
        # partitions per rank. A rank's partitions come from its own
        # server's settings, so the leader's d_local travels with k and a
        # rank holding another number refuses (_verify_mesh_layout).
        k = max(max(len(s) for s in slots), 1)
        k = -(-k // d_local) * d_local
        return {
            "type": "collective-exec", "kind": kind,
            "index": index, "query": query, "queries": queries,
            "field": field, "rows": rows,
            "bsiKind": bsi_kind, "depth": depth, "nShards": n_shards,
            "slots": slots, "k": k, "dLocal": d_local,
            "meshDevices": mesh_devices,
            "timeoutMs": self.timeout_ms, "sig": sig,
            # The leader's routing view: peers whose epoch diverges
            # refuse (clean fan-out fallback) rather than contributing
            # planes placed under a different topology.
            "epoch": int(getattr(self.server.cluster, "routing_epoch", 0)),
        }

    def _next_seq(self) -> int:
        if distributed.process_count() > 1:
            try:
                with self._seq_lock:
                    if self._seq_store is None:
                        self._seq_store = distributed.connect_store()
                    return int(self._seq_store.add(SEQ_KEY, 1))
            except RuntimeError as e:  # the store is unreachable
                raise CollectiveUnavailable(f"seq allocation failed: {e}")
        with self._lock:
            self._local_seq += 1
            return self._local_seq

    def _lead(self, desc: dict):
        """Gate on the plane breakers, allocate the sequence slot,
        broadcast the descriptor, enter locally, return the result.

        The broadcast does not wait for peer responses, and any plane
        failure surfaces as CollectiveUnavailable so the executor falls
        back to the HTTP fan-out. Fault outcomes (barrier timeout,
        runtime error) feed the breakers; topology refusals do not. A
        kernel fault on this rank raises through, unserved."""
        n_proc = distributed.process_count()
        slices = list(range(n_proc))
        if not self.health.allow(slices):
            # Breaker open: instant fallback, no barrier wait.
            self._count("breaker_short_circuits")
            raise CollectiveUnavailable(
                "collective plane breaker open", reason="breaker-open")
        # Seq allocated AFTER the gate: a refused query must not burn a
        # cluster-wide sequence slot (and a batch burns exactly one).
        desc["seq"] = self._next_seq()
        if n_proc > 1:
            for node in self.server.cluster.nodes:
                if node.id == self.server.cluster.node.id:
                    continue
                self._senders.submit(self._send, node, desc)
        local = dict(desc)
        local["_trace"] = obs_current()
        fut = self._runner.submit(local)
        try:
            result = fut.result(timeout=desc["timeoutMs"] / 1000.0 + 30.0)
        except CollectiveBarrierTimeout:
            self._count("barrier_timeouts")
            self.health.record_failure(BARRIER_TIMEOUT, slices)
            raise
        except CollectiveUnavailable as e:
            if e.reason == "error":
                # A real fault (a failed rank, a lost group), not
                # topology churn — evidence for the plane breaker.
                self.health.record_failure("runtime")
            raise
        except (DeviceKernelFault, kernels.KernelBuildError):
            raise
        except Exception as e:
            self.health.record_failure("runtime")
            raise CollectiveUnavailable(f"collective execution failed: {e}")
        self.health.record_success(slices)
        return result

    def _send(self, node, desc: dict) -> None:
        try:
            self.server.client.send_message(node, desc)
        except PilosaError as e:
            # The peer misses the descriptor; the barrier times out and
            # every process aborts cleanly instead of hanging. The
            # breaker evidence points at the unreachable slice.
            if node.process_idx is not None:
                self.health.record_failure(BROADCAST, [node.process_idx])
            self.logger.error("collective broadcast to %s failed: %s", node.id, e)

    # ------------------------------------------------------------ peer side

    def receive(self, desc: dict) -> None:
        """Peer side of the broadcast: enqueue and return immediately (the
        HTTP handler thread must not block inside the collective). Peers
        do NOT consult the breakers — a probing leader's barrier must
        find every healthy peer waiting, or the plane could never
        re-close under a single-leader workload."""
        if not isinstance(desc.get("seq"), int):
            raise QueryError("collective-exec descriptor without an integer seq")
        self._runner.submit(desc)

    # ----------------------------------------------------------- execution

    def _enter(self, desc: dict):
        """Execute one descriptor. Called only from the runner thread, in
        cluster-wide seq order."""
        trace = desc.get("_trace")
        t_entry = time.monotonic()
        index = desc["index"]
        n_proc = distributed.process_count()
        pid = distributed.process_index()
        slots = desc["slots"]
        k = int(desc["k"])
        self._count("entries")
        cluster = self.server.cluster
        epoch0 = int(getattr(cluster, "routing_epoch", 0))
        want_epoch = desc.get("epoch")
        if want_epoch is not None and int(want_epoch) != epoch0:
            # The leader routed under a different topology than ours
            # (mid-rebalance cutover window). Refuse before computing.
            self._count("stale_epoch_refusals")
            raise CollectiveUnavailable(
                f"routing epoch divergence (descriptor {want_epoch}, "
                f"local {epoch0})", reason="epoch")
        self._verify_job(desc, n_proc)
        my_shards = [int(s) for s in slots[pid]]
        if len(my_shards) > k:
            raise CollectiveUnavailable("slot range overflow",
                                        reason="placement")
        if n_proc > 1:
            self._verify_ownership(index, my_shards)
        mesh = self._verify_mesh_layout(desc, n_proc, k)

        kind = desc["kind"]
        queries = desc.get("queries")
        if queries is None:
            queries = [desc["query"]] if desc.get("query") else []
        calls = []
        if queries:
            from ..pql.parser import parse

            calls = [parse(q).calls[0] for q in queries]

        if kind == "count":
            out = self._run_count(desc, index, calls, my_shards, k, mesh, trace)
        elif kind == "topn":
            out = self._run_topn(desc, index, calls[0] if calls else None,
                                 my_shards, k, mesh, trace)
        elif kind == "bsi":
            out = self._run_bsi(desc, index, calls[0] if calls else None,
                                my_shards, k, mesh, trace)
        else:
            raise CollectiveUnavailable(f"unknown collective kind: {kind}")
        if int(getattr(cluster, "routing_epoch", 0)) != epoch0:
            # A live-rebalance cutover committed while planes were being
            # assembled/computed: discard, the leader re-runs through the
            # fan-out on refreshed placement.
            self._count("epoch_rechecks")
            raise CollectiveUnavailable(
                f"routing epoch advanced during collective execution "
                f"({epoch0} -> {cluster.routing_epoch})", reason="epoch")
        if trace is not None:
            trace.record("collective.entry",
                         (time.monotonic() - t_entry) * 1000.0,
                         kind=kind, seq=desc.get("seq"))
        return out

    def _verify_ownership(self, index: str, my_shards: List[int]) -> None:
        """Refuse loudly when the leader's placement disagrees with this
        node's cluster view — silently contributing zero planes for
        unowned shards is a wrong count."""
        cluster = self.server.cluster
        me = cluster.node.id
        for s in my_shards:
            if not cluster.owns_shard(me, index, s):
                raise CollectiveUnavailable(
                    f"placement mismatch: process assigned shard {s} of "
                    f"{index!r} but node {me} does not own it",
                    reason="ownership",
                )

    @staticmethod
    def _verify_job(desc: dict, n_proc: int) -> None:
        """The descriptor was placed for this job's world size."""
        if len(desc["slots"]) != n_proc:
            raise CollectiveUnavailable(
                f"descriptor spans {len(desc['slots'])} processes, job has {n_proc}",
                reason="placement",
            )

    def _verify_mesh_layout(self, desc: dict, n_proc: int, k: int) -> List[torch.device]:
        """This rank's partitions for the entry, checked against the
        descriptor (the counterpart of the reference's mesh-layout check):
        the leader's d_local partitions, k a multiple of them, so that slot
        s lands in partition s // (k / d_local) on every rank. In the
        reference every process has the same local device count; here a
        rank's partitions come from its own `[engine] mesh-devices`, so a
        rank that holds another number refuses."""
        mesh = self.partitions(desc.get("meshDevices") if n_proc == 1 else None)
        d_local = int(desc.get("dLocal") or len(mesh))
        if len(mesh) != d_local or k % d_local:
            raise CollectiveUnavailable(
                f"rank {distributed.process_index()} holds {len(mesh)} partitions; "
                f"the descriptor places k = {k} slots over {d_local} per rank",
                reason="placement",
            )
        return mesh

    def _barrier_client(self):
        if self._barrier_store is None:
            self._barrier_store = distributed.connect_store()
        return self._barrier_store

    def _barrier(self, desc: dict, trace=None) -> None:
        t0 = time.monotonic()
        try:
            # Deterministic chaos hook: fires even at world size 1, where
            # the real barrier is a no-op, so the timeout -> breaker ->
            # fallback ladder is testable in one process.
            failpoints.fire("collective-barrier")
            n_proc = distributed.process_count()
            if n_proc > 1:
                store = self._barrier_client()
                if store is None:
                    raise CollectiveUnavailable(
                        "no distributed store")
                seq = int(desc["seq"])
                try:
                    distributed.barrier(store, str(seq), n_proc,
                                        int(desc["timeoutMs"]))
                except distributed.BarrierAborted:
                    self._count("barrier_aborts")
                    raise
                if distributed.process_index() == 0 and seq > BARRIER_KEEP:
                    distributed.forget_barrier(store, str(seq - BARRIER_KEEP))
        except CollectiveUnavailable:
            raise
        except Exception as e:
            raise CollectiveBarrierTimeout(
                f"collective barrier timed out (seq {desc['seq']}): {e}"
            )
        finally:
            if trace is not None:
                trace.record("collective.barrier",
                             (time.monotonic() - t0) * 1000.0,
                             seq=desc.get("seq"))

    def _launch(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Run this rank's kernels and bring the small result to the host
        (the copy waits for the device, so a fault surfaces here). On a
        CUDA rank a failure is a kernel fault: classified, then raised as
        DeviceKernelFault, which no rung serves; a build failure raises
        as it is."""
        try:
            return fn().cpu()
        except (DeviceKernelFault, kernels.KernelBuildError):
            raise
        except Exception as e:
            if self.holder.device.type != "cuda":
                raise
            raise DeviceKernelFault(classify_device_error(e), None,
                                    f"collective kernel fault: {e}") from e

    def _settle(self, desc: dict, trace, n: int,
                compute: Callable[[], torch.Tensor],
                gather: bool = False) -> torch.Tensor:
        """Compute this rank's (n,) int64 result, pass the barrier, and
        combine the result over every rank: summed, or gathered to
        (world, n) rank by rank.

        The kernels run BEFORE the barrier, so that once it passes, every
        rank is at most a host copy away from the reduce, well inside the
        group's timeout (the reference runs its program after the
        barrier: there the program holds the collective). A status slot
        rides in front of the values: a rank whose compute failed still
        arrives and reduces with the slot set, so every rank raises
        together instead of waiting out the group's timeout."""
        err = None
        try:
            local = compute().to(torch.int64).reshape(n)
            status = 0
        except BaseException as e:  # re-raised below, after the reduce
            err, local, status = e, torch.zeros(n, dtype=torch.int64), 1
        try:
            self._barrier(desc, trace)
        except BaseException:
            if err is not None:
                raise err
            raise
        payload = torch.cat([torch.tensor([status], dtype=torch.int64), local])
        try:
            out = (distributed.all_gather(payload) if gather
                   else distributed.all_reduce_sum(payload))
        except RuntimeError as e:
            # The group's timeout ran out inside the reduce: gloo's pairs
            # are not reusable after it, so the plane stays off here.
            with self._lock:
                self._broken = str(e)
                self.counters["group_failures"] += 1
            self.logger.error("collective reduce failed; plane off: %s", e)
            raise CollectiveUnavailable(f"collective reduce failed: {e}")
        self._count("reduces")
        if err is not None:
            raise err
        failed = int(out[:, 0].sum()) if gather else int(out[0])
        if failed:
            self._count("rank_failures")
            raise CollectiveUnavailable(
                f"{failed} rank(s) failed their part of the entry")
        return out[:, 1:] if gather else out[1:]

    # ------------------------------------------------- resident plane blocks

    def _local_block(self, index: str, leaf, my_shards: List[int], k: int,
                     frags: Optional[List] = None) -> np.ndarray:
        buf = np.zeros((k, WORDS_PER_ROW), dtype=np.uint32)
        if frags is None:
            frags = [self.holder.fragment(index, leaf.field, leaf.view, s)
                     for s in my_shards]
        for i, frag in enumerate(frags):
            if frag is not None:
                buf[i] = frag.plane_np(leaf.row)
        return buf

    def _leaf_fingerprint(self, index: str, leaf, my_shards: List[int],
                          frags: Optional[List] = None) -> Tuple:
        # (incarnation, generation) pairs, as in engine._fingerprint: a
        # deleted-and-recreated index resets generation counters while this
        # name-keyed cache survives, and a bare counter climbing back to a
        # cached value would alias the old index's stale plane.
        if frags is None:
            frags = (
                self.holder.fragment(index, leaf.field, leaf.view, s)
                for s in my_shards
            )
        return tuple(
            -1 if f is None else (f.incarnation, f.generation)
            for f in frags
        )

    def _collect_updates(self, members, size: int):
        """Dirty-word deltas for stale cache members, or None when only a
        full re-assembly is safe — same contract as the engine's
        _collect_updates (missing fragment, recreated incarnation,
        journal overflow, or budget exceeded all poison to None).

        `members`: iterable of (coords, frag, row, old_fp, new_fp);
        coords are LOCAL block coordinates ((slot,) for a leaf,
        (u, slot) for a stack). Returns a list of (coords, col32
        indices, uint32 values) — possibly empty (generation churn from
        rows outside this cache, zero bytes to move)."""
        out = []
        n32 = 0
        for coords, frag, row, old_fp, new_fp in members:
            if frag is None or old_fp == -1 or new_fp == -1:
                return None
            if old_fp[0] != new_fp[0] or frag.incarnation != new_fp[0]:
                return None
            w = frag.dirty_words_since(row, old_fp[1])
            if w is None:
                return None
            if not len(w):
                continue
            n32 += 2 * len(w)
            if n32 > self._delta_max_fraction * size:
                return None
            cols, vals = ShardedQueryEngine._updates32(
                w, frag.row_words64(row, w))
            out.append((coords, cols, vals))
        return out

    def _delta_scatter(self, arr: Blocks, updates) -> Blocks:
        """Apply (coords, cols, vals) updates to this rank's resident
        blocks, each in its own partition's block (slot s in block
        s // (k / d_local)), through a clone of the touched blocks only
        (readers holding the old ones keep them), as the engine's delta
        path does: a 1-bit write moves a few scattered words, not the
        plane."""
        per = arr[0].shape[-2]
        by_part: Dict[int, List] = {}
        for coords, cols, vals in updates:
            local = coords[:-1] + (coords[-1] % per,)
            by_part.setdefault(coords[-1] // per, []).append((local, cols, vals))
        out = list(arr)
        for p, part in by_part.items():
            out[p] = self._scatter(arr[p], part)
        return Blocks(out)

    @staticmethod
    def _scatter(arr: torch.Tensor, updates) -> torch.Tensor:
        ix = [np.concatenate([np.full(len(c), co[a], np.int64)
                              for co, c, _ in updates])
              for a in range(arr.dim() - 1)]
        ix.append(np.concatenate([c for _, c, _ in updates]))
        vals = np.concatenate([v for _, _, v in updates])
        dev = arr.device
        new = arr.clone()
        new[tuple(torch.from_numpy(a).to(dev) for a in ix)] = \
            torch.from_numpy(vals.view(np.int32)).to(dev)
        return new

    def _byte_put(self, cache: Dict, key, entry: Tuple, budget: int,
                  used: int, evicted: Optional[List] = None) -> int:
        """Insert at MRU, evict LRU past the byte budget; returns updated
        used-bytes. Caller holds self._lock. Evicted keys collect into
        `evicted` for off-lock tier demotion — eviction is demotion, not
        loss."""
        prev = cache.pop(key, None)
        if prev is not None:
            used -= prev[1].nbytes
        used += entry[1].nbytes
        cache[key] = entry
        while used > budget and len(cache) > 1:
            old_key = next(iter(cache))
            if old_key == key:
                break
            used -= cache.pop(old_key)[1].nbytes
            self.counters["evictions"] += 1
            if evicted is not None:
                evicted.append(old_key)
        return used

    def _demote_keys(self, keys) -> None:
        """Hand evicted resident planes to the tier manager (off-lock).
        Keys are cache keys; the tier key is their (index, leaf, shards)
        prefix — the key space the engine uses, so the two share one
        inclusive host tier."""
        if not keys:
            return
        tier = self._tier()
        if tier is None:
            return
        for key in keys:
            index, leaves, shards = key[0], key[1], key[2]
            # Leaf IS a NamedTuple: a leaf-cache key holds one Leaf, a
            # stack-cache key holds a tuple of them.
            if isinstance(leaves, Leaf):
                leaves = (leaves,)
            for leaf in leaves:
                if tier.demote((index, leaf, shards)):
                    self._count("demotions")

    def _global_leaf(self, index: str, leaf, my_shards: List[int],
                     k: int, mesh: Sequence[torch.device]) -> Blocks:
        """This rank's (k, W) block of one leaf, held as Blocks of
        k / d_local slots over its partitions `mesh` — RESIDENT: cached
        per process, invalidated by this process's own fragment
        generations, delta-refreshed from the dirty-word journals, and
        assembled from the compressed tier image when cold."""
        # The mesh width in the key, as the reference's: the same shards
        # and k over another number of partitions is another layout.
        key = (index, leaf, tuple(my_shards), k, len(mesh))
        frags = [self.holder.fragment(index, leaf.field, leaf.view, s)
                 for s in my_shards]
        fp = self._leaf_fingerprint(index, leaf, my_shards, frags)
        with self._lock:
            cached = self._leaf_cache.get(key)
            if cached is not None and cached[0] == fp:
                self._leaf_cache[key] = self._leaf_cache.pop(key)  # LRU touch
                self.counters["resident_hits"] += 1
                return cached[1]
            stale = cached
        evicted: List = []
        if stale is not None and self._delta_max_fraction > 0 \
                and len(stale[0]) == len(fp):
            updates = self._collect_updates(
                (((i,), frags[i], leaf.row, stale[0][i], fp[i])
                 for i in range(len(frags)) if stale[0][i] != fp[i]),
                stale[1].numel(),
            )
            if updates is not None:
                arr = (stale[1] if not updates
                       else self._delta_scatter(stale[1], updates))
                moved = sum(c.nbytes + v.nbytes for _, c, v in updates)
                with self._lock:
                    self.counters["delta_hits"] += 1
                    self.counters["delta_bytes"] += moved
                    self._leaf_bytes = self._byte_put(
                        self._leaf_cache, key, (fp, arr),
                        self._leaf_budget, self._leaf_bytes, evicted)
                self._demote_keys(evicted)
                return arr
        # Cold (or delta-ineligible): compressed tier image first, live
        # container walk second.
        block = None
        tier = self._tier()
        if tier is not None:
            block = tier.promote((index, leaf, tuple(my_shards)), frags, fp, k)
        tier_hit = block is not None
        if block is None:
            block = self._local_block(index, leaf, my_shards, k, frags)
        arr = distributed.make_global_planes(block, mesh)
        with self._lock:
            if tier_hit:
                self.counters["tier_promotes"] += 1
            self.counters["full_refreshes"] += 1
            self.counters["full_refresh_bytes"] += int(block.nbytes)
            self._leaf_bytes = self._byte_put(
                self._leaf_cache, key, (fp, arr),
                self._leaf_budget, self._leaf_bytes, evicted)
        self._demote_keys(evicted)
        return arr

    def _global_stack(self, index: str, leaves, my_shards: List[int],
                      k: int, mesh: Sequence[torch.device]) -> Blocks:
        """This rank's (L, k, W) stack of leaves (TopN rows, BSI planes),
        held as Blocks of (L, k / d_local, W) over its partitions —
        RESIDENT like the leaves: fingerprint-invalidated,
        delta-refreshed, LRU-bounded. BSI plane sets are stable per field;
        TopN candidate stacks cache per rows-tuple."""
        leaves = list(leaves)
        key = (index, tuple(leaves), tuple(my_shards), k, len(mesh))
        frags = [
            [self.holder.fragment(index, leaf.field, leaf.view, s)
             for s in my_shards]
            for leaf in leaves
        ]
        fp = tuple(
            self._leaf_fingerprint(index, leaf, my_shards, frags[u])
            for u, leaf in enumerate(leaves)
        )
        with self._lock:
            cached = self._stack_cache.get(key)
            if cached is not None and cached[0] == fp:
                self._stack_cache[key] = self._stack_cache.pop(key)
                self.counters["resident_hits"] += 1
                return cached[1]
            stale = cached
        evicted: List = []
        if stale is not None and self._delta_max_fraction > 0 \
                and len(stale[0]) == len(fp) \
                and all(len(o) == len(n) for o, n in zip(stale[0], fp)):

            def members():
                for u, leaf in enumerate(leaves):
                    if stale[0][u] == fp[u]:
                        continue
                    for i in range(len(my_shards)):
                        if stale[0][u][i] == fp[u][i]:
                            continue
                        yield ((u, i), frags[u][i], leaf.row,
                               stale[0][u][i], fp[u][i])

            updates = self._collect_updates(members(), stale[1].numel())
            if updates is not None:
                arr = (stale[1] if not updates
                       else self._delta_scatter(stale[1], updates))
                moved = sum(c.nbytes + v.nbytes for _, c, v in updates)
                with self._lock:
                    self.counters["delta_hits"] += 1
                    self.counters["delta_bytes"] += moved
                    self._stack_bytes = self._byte_put(
                        self._stack_cache, key, (fp, arr),
                        self._stack_budget, self._stack_bytes, evicted)
                self._demote_keys(evicted)
                return arr
        tier = self._tier()
        blocks = []
        for u, leaf in enumerate(leaves):
            block = None
            if tier is not None:
                block = tier.promote(
                    (index, leaf, tuple(my_shards)), frags[u], fp[u], k)
            if block is not None:
                self._count("tier_promotes")
            else:
                block = self._local_block(index, leaf, my_shards, k, frags[u])
            blocks.append(block)
        block = np.stack(blocks)
        arr = distributed.make_global_planes(block, mesh)
        with self._lock:
            self.counters["full_refreshes"] += 1
            self.counters["full_refresh_bytes"] += int(block.nbytes)
            self._stack_bytes = self._byte_put(
                self._stack_cache, key, (fp, arr),
                self._stack_budget, self._stack_bytes, evicted)
        self._demote_keys(evicted)
        return arr

    def _compile(self, index: str, call):
        """The call's canonical plan, lowered (a tree past K1's tape
        limits raises here, before any entry)."""
        plan = cached_plan(self.holder, index, call)
        _lowered(plan)
        return plan

    def _fn(self, key: Tuple, build):
        """Lowered programs (op tapes and elementwise closures) by
        canonical signature, in place of the reference's jitted ones."""
        with self._lock:
            fn = self._fn_cache.get(key)
            if fn is not None:
                self._fn_cache[key] = self._fn_cache.pop(key)  # LRU touch
        if fn is None:
            fn = build()
            with self._lock:
                self._fn_cache[key] = fn
                while len(self._fn_cache) > self._fn_budget:
                    self._fn_cache.pop(next(iter(self._fn_cache)))
        return fn

    # -------------------------------------------------------- program kinds

    def _check_sig(self, desc, plan) -> None:
        """Refuse when this process planned a different structure than
        the leader (schema divergence: a lagging bsig depth/offset
        lowers different predicates on each rank)."""
        want = desc.get("sig")
        if want is not None and repr(self._sig_tuple(plan)) != want:
            raise CollectiveUnavailable(
                "schema divergence: local call signature "
                f"{self._sig_tuple(plan)!r} != leader's {want}",
                reason="schema",
            )

    def _filter(self, desc, index: str, call, my_shards: List[int], k: int, mesh):
        """(lowered filter, its leaf blocks, signature) of a TopN source
        or BSI filter; (None, None, ()) without one."""
        if call is None:
            return None, None, ()
        plan = self._compile(index, call)
        self._check_sig(desc, plan)
        leaves = tuple(self._global_leaf(index, leaf, my_shards, k, mesh)
                       for leaf in plan.leaves)
        sig = self._sig_tuple(plan)
        return self._fn(("filter", sig), lambda: _lowered(plan)), leaves, sig

    @staticmethod
    def _masks(low, leaves, n: int) -> List[Optional[torch.Tensor]]:
        """The filter's plane on each of the n partitions (None: none)."""
        if low is None:
            return [None] * n
        return [low.bitmap(tuple(leaf[p] for leaf in leaves)).contiguous()
                for p in range(n)]

    def _run_count(self, desc, index, calls, my_shards, k, mesh, trace=None):
        # Duplicates (N clients asking the SAME hot query) compute once.
        queries = [str(c) for c in calls]
        uniq: Dict[str, int] = {}
        ucalls = []
        for q, c in zip(queries, calls):
            if q not in uniq:
                uniq[q] = len(ucalls)
                ucalls.append(c)
        plans = [self._compile(index, c) for c in ucalls]
        for plan in plans:
            self._check_sig(desc, plan)
        blocks = {leaf: self._global_leaf(index, leaf, my_shards, k, mesh)
                  for plan in plans for leaf in plan.leaves}
        slots, idxs, inverse, _ = ShardedQueryEngine._batch_slot_gather(
            plans, len(plans))
        tape = self._fn(("count", self._sig_tuple(plans[0]), k),
                        lambda: _lowered(plans[0]).tape)

        def compute():
            # Each partition's (U, k / d_local, W) stack of the batch's
            # leaves; K1 once per partition, staged once for the entry.
            stacks = [torch.stack([blocks[leaf][p] for leaf in slots])
                      for p in range(len(mesh))]
            counts = self._launch(lambda: _fold_sum(kernels.gather_expr_count_blocks(
                stacks, torch.from_numpy(np.stack(idxs)), tape)))
            return counts if inverse is None else counts[torch.from_numpy(inverse)]

        totals = self._settle(desc, trace, len(plans), compute).numpy()
        return totals[[uniq[q] for q in queries]]

    def _row_totals(self, stacked: Blocks, low, flt) -> torch.Tensor:
        """K2 once per partition over its (R, k / d_local, W) block, each
        masked by the filter's plane there; the (R,) int64 row totals
        summed on partition 0's device, then brought to the host."""
        return self._launch(lambda: _fold_sum([
            kernels.masked_plane_counts(b, m).sum(dim=1, dtype=torch.int64)
            for b, m in zip(stacked, self._masks(low, flt, len(stacked)))]))

    def _run_topn(self, desc, index, call, my_shards, k, mesh, trace=None):
        field = desc["field"]
        rows = [int(r) for r in desc["rows"]]
        leaves = [Leaf(field, VIEW_STANDARD, r) for r in rows]
        stacked = self._global_stack(index, leaves, my_shards, k, mesh)
        low, flt, _ = self._filter(desc, index, call, my_shards, k, mesh)
        return self._settle(desc, trace, len(rows),
                            lambda: self._row_totals(stacked, low, flt)).numpy()

    def _run_bsi(self, desc, index, call, my_shards, k, mesh, trace=None):
        field = desc["field"]
        depth = int(desc["depth"])
        kind = desc["bsiKind"]
        # The plane layout itself depends on the bsig depth: a rank whose
        # depth disagrees would read its bit-i planes as different
        # magnitudes than the leader. Verify, don't assume.
        fld = self.holder.field(index, field)
        bsig = fld.bsi_group(field) if fld is not None else None
        if bsig is None or bsig.bit_depth() != depth:
            local = "missing" if bsig is None else bsig.bit_depth()
            raise CollectiveUnavailable(
                f"schema divergence: bsig depth for {field!r} is {local}, "
                f"leader says {depth}", reason="schema",
            )
        view = VIEW_BSI_GROUP_PREFIX + field
        leaves = [Leaf(field, view, i) for i in range(depth + 1)]
        planes = self._global_stack(index, leaves, my_shards, k, mesh)
        low, flt, _ = self._filter(desc, index, call, my_shards, k, mesh)
        if kind == "sum":
            return self._settle(desc, trace, depth + 1,
                                lambda: self._row_totals(planes, low, flt)).numpy()
        maximize = kind == "max"

        def scan():
            # K3 once per partition; its (count, bits) rows joined on
            # partition 0's device, brought to the host once, and folded
            # as the engine folds its blocks (_fold_minmax).
            def run():
                rows = []
                for b, m in zip(planes, self._masks(low, flt, len(planes))):
                    bits, count = kernels.bsi_minmax(b, m, maximize=maximize)
                    rows.append(torch.cat([count.reshape(1), bits.to(torch.int64)]))
                return torch.stack([r.to(rows[0].device) for r in rows])

            parts = self._launch(run).numpy()
            bits, count = _fold_minmax([(r[1:], int(r[0])) for r in parts], maximize)
            return torch.from_numpy(np.concatenate([[count], bits]).astype(np.int64))

        ranks = self._settle(desc, trace, depth + 1, scan, gather=True).numpy()
        return combine_minmax(ranks, depth, maximize)


def _fold_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The partitions' partial results summed on partition 0's device
    (the reference's psum over the shard axis)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def combine_minmax(ranks: np.ndarray, depth: int, maximize: bool):
    """Every rank's K3 answer, (world, 1 + depth) rows of (count, bits),
    combined as K3's own block reduce combines its blocks
    (csrc/bitplane_kernels.cu): ranks with count 0 drop out, the best
    value wins, and the counts of the ranks that hold it add up. With no
    column anywhere the bits are all 0 for Max and all 1 for Min and the
    count is 0, as the reference's global bit scan gives them."""
    best, count = None, 0
    for row in ranks:
        if not row[0]:
            continue
        value = compose_bits(row[1:])
        if best is None or (value > best if maximize else value < best):
            best, count = value, int(row[0])
        elif value == best:
            count += int(row[0])
    if best is None:
        return np.full(depth, 0 if maximize else 1, dtype=np.int32), 0
    return np.array([(best >> i) & 1 for i in range(depth)], dtype=np.int32), count


class _Runner:
    """Single consumer thread executing descriptors in cluster-wide seq
    order. Seqs are dense except when a leader dies between allocating a
    seq and broadcasting it; a bounded gap wait keeps a dead leader from
    stalling the queue (its own peers' barrier times out regardless)."""

    GAP_TIMEOUT = 2.0

    def __init__(self, backend: CollectiveBackend):
        self.backend = backend
        self._heap: List[Tuple[int, int, dict, Future]] = []
        self._tiebreak = 0
        self._cond = threading.Condition()
        self._last_seq = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def submit(self, desc: dict) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._closed:
                fut.set_exception(CollectiveUnavailable(
                    "collective runner closed", reason="closed"))
                return fut
            self._tiebreak += 1
            heapq.heappush(
                self._heap, (int(desc["seq"]), self._tiebreak, desc, fut)
            )
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="collective-runner", daemon=True
                )
                self._thread.start()
            self._cond.notify_all()
        return fut

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._heap and not self._closed:
                    self._cond.wait()
                if self._closed:
                    for _, _, _, fut in self._heap:
                        if not fut.done():
                            fut.set_exception(CollectiveUnavailable(
                                "collective runner closed", reason="closed"))
                    self._heap.clear()
                    return
                # In-order delivery: wait (bounded) for a missing seq so all
                # processes execute collectives in the same order.
                deadline = time.monotonic() + self.GAP_TIMEOUT
                while (
                    self._heap
                    and self._heap[0][0] > self._last_seq + 1
                    and not self._closed
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                if not self._heap:
                    continue
                seq, _, desc, fut = heapq.heappop(self._heap)
                if seq <= self._last_seq:
                    # A gap-skipped descriptor arrived late: its other
                    # participants already timed out at its barrier, and
                    # entering it now would both stall this runner for the
                    # full barrier timeout and break the same-order
                    # invariant. Reject, never execute.
                    fut.set_exception(CollectiveUnavailable(
                        f"stale collective seq {seq} (already past "
                        f"{self._last_seq})", reason="stale-seq",
                    ))
                    continue
                self._last_seq = seq
            try:
                result = self.backend._enter(desc)
            except BaseException as e:
                if not fut.done():
                    fut.set_exception(e)
                continue
            if not fut.done():
                fut.set_result(result)
