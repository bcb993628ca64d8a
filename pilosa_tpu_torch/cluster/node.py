"""Node identity and cluster membership/placement.

Port of the data-placement core of reference cluster.go: Node, cluster
states, partition/shardNodes placement with replication. The full resize
state machine lives in cluster/resize.py; this module is dependency-light so
the executor can use placement without pulling in networking.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

from ..constants import DEFAULT_PARTITION_N
from .hash import JmpHasher, partition as partition_of
from .health import DownView, HealthRegistry

# Cluster states (reference cluster.go:43-45).
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_RESIZING = "RESIZING"


@dataclass
class Node:
    id: str
    uri: str = ""
    is_coordinator: bool = False
    # jax.distributed process index when this node is part of a multi-host
    # device-mesh job (None otherwise). The collective plane needs every
    # node's index to map jump-hash shard placement onto global-array slots
    # (parallel/collective.py placement); it propagates via node-join /
    # cluster-status messages and the member monitor's status probes.
    process_idx: Optional[int] = None

    def to_dict(self):
        d = {"id": self.id, "uri": self.uri, "isCoordinator": self.is_coordinator}
        if self.process_idx is not None:
            d["processIdx"] = self.process_idx
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(
            id=d["id"], uri=d.get("uri", ""),
            is_coordinator=d.get("isCoordinator", False),
            process_idx=d.get("processIdx"),
        )


class Cluster:
    """Membership + placement. Single-node by default; multi-node clusters
    append Nodes (sorted by id, as the reference maintains them)."""

    def __init__(
        self,
        node: Optional[Node] = None,
        nodes: Optional[List[Node]] = None,
        replica_n: int = 1,
        partition_n: int = DEFAULT_PARTITION_N,
        hasher=None,
    ):
        self.node = node or Node(id="node0")
        self.nodes: List[Node] = nodes or [self.node]
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.hasher = hasher or JmpHasher()
        self.state = STATE_NORMAL
        # Per-peer fault-tolerance state (cluster/health.py): circuit
        # breakers, retry budget, rolling latencies. The server installs
        # its [resilience] config via health.configure(); library users
        # get the defaults. Placement ignores this; the executor's owner
        # selection, retry, and hedging logic consult it.
        self.health = HealthRegistry()
        # Node ids currently down (failure detector; the reference's
        # memberlist suspicion state). A set-like view over the breaker
        # state: `in` means "breaker not closed", add/discard force it.
        self.unavailable = DownView(self.health)
        # Per-shard routing epochs (cluster/rebalance.py). During a live
        # rebalance `next_nodes` holds the target membership and
        # `migrated` the (index, shard) pairs whose cutover committed:
        # placement for a migrated shard follows the NEXT topology while
        # every other shard stays on the old owners — a half-migrated
        # cluster never serves a hole. `routing_epoch` is monotonic;
        # forwarded requests stamp it, and a receiver that has advanced
        # past the sender's epoch answers 409 (one re-route) instead of
        # serving from a moved/GC'd shard.
        self.routing_epoch = 0
        self.next_nodes: Optional[List[Node]] = None
        self.migrated: Set[Tuple[str, int]] = set()
        self._routing_mu = threading.Lock()

    # ------------------------------------------------------------ placement

    def partition(self, index: str, shard: int) -> int:
        return partition_of(index, shard, self.partition_n)

    def _placement(self, nodes: List[Node], partition_id: int) -> List[Node]:
        if not nodes:
            return []
        replica_n = min(self.replica_n, len(nodes)) or 1
        node_index = self.hasher.hash(partition_id, len(nodes))
        return [nodes[(node_index + i) % len(nodes)] for i in range(replica_n)]

    def partition_nodes(self, partition_id: int) -> List[Node]:
        return self._placement(self.nodes, partition_id)

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        # Snapshot the override state once: a concurrent commit/abort can
        # null next_nodes between a check and a re-read, and
        # _placement(None) would return zero owners for an owned shard.
        nxt = self.next_nodes
        nodes = self.nodes
        if nxt is not None and (index, shard) in self.migrated:
            nodes = nxt
        return self._placement(nodes, self.partition(index, shard))

    # ------------------------------------------------------ routing epochs

    def _advance_epoch(self, epoch: Optional[int]) -> None:
        # Must hold _routing_mu. An epoch carried by a coordinator
        # message is AUTHORITATIVE: merge with max() only. A local
        # routing change with no message epoch bumps by one. Doing both
        # (max(local+1, msg)) overshoots under message reordering — a
        # later commit's merge jumps the counter, then an earlier
        # commit's +1 pushes it past every number the coordinator will
        # ever send, and the node ends permanently ahead of the cluster.
        if epoch is not None:
            self.routing_epoch = max(self.routing_epoch, epoch)
        else:
            self.routing_epoch += 1

    def begin_rebalance(self, new_nodes: List[Node], committed=(),
                        epoch: Optional[int] = None) -> None:
        """Install the target membership of a live rebalance. Placement
        keeps following the OLD nodes until per-shard cutovers commit."""
        with self._routing_mu:
            self.next_nodes = sorted(new_nodes, key=lambda n: n.id)
            self.migrated = {(i, int(s)) for i, s in committed}
            self._advance_epoch(epoch)

    def apply_cutover(self, index: str, shard: int,
                      epoch: Optional[int] = None) -> None:
        """Commit one shard's routing flip to the next topology."""
        with self._routing_mu:
            if self.next_nodes is None:
                # No rebalance in flight (late/duplicate commit); still
                # merge an authoritative epoch so a node that already
                # collapsed the overrides doesn't fall behind.
                if epoch is not None:
                    self.routing_epoch = max(self.routing_epoch, epoch)
                return
            if (index, shard) in self.migrated:
                # Idempotent: the source flips at freeze time and again on
                # the broadcast commit; only the first advances the epoch.
                if epoch is not None:
                    self.routing_epoch = max(self.routing_epoch, epoch)
                return
            self.migrated.add((index, shard))
            self._advance_epoch(epoch)

    def revert_cutover(self, index: str, shard: int,
                       epoch: Optional[int] = None) -> None:
        """Reverse migration (autoscale abort, docs/rebalance.md): flip
        one committed shard's routing BACK to the prior topology after
        its data has been streamed back to the prior owners. The inverse
        of apply_cutover; idempotent the same way."""
        with self._routing_mu:
            if self.next_nodes is None:
                if epoch is not None:
                    self.routing_epoch = max(self.routing_epoch, epoch)
                return
            if (index, shard) not in self.migrated:
                # Late/duplicate revert; still merge an authoritative
                # epoch so this node doesn't fall behind.
                if epoch is not None:
                    self.routing_epoch = max(self.routing_epoch, epoch)
                return
            self.migrated.discard((index, shard))
            self._advance_epoch(epoch)

    def commit_topology(self, new_nodes: Optional[List[Node]] = None,
                        epoch: Optional[int] = None) -> None:
        """Job completion: the target membership becomes THE membership
        and the per-shard overrides collapse."""
        with self._routing_mu:
            nodes = new_nodes if new_nodes is not None else self.next_nodes
            if nodes is not None:
                self.nodes = sorted(nodes, key=lambda n: n.id)
            self.next_nodes = None
            self.migrated = set()
            self._advance_epoch(epoch)

    def adopt_topology_if_ahead(self, new_nodes: List[Node],
                                epoch: Optional[int]) -> bool:
        """Anti-entropy adoption (member monitor): atomically re-validate
        and commit a peer's post-job topology. The monitor's decision to
        adopt runs OUTSIDE the routing lock, so a rebalance-begin landing
        between the decision and the commit would otherwise have its
        next_nodes/migrated overrides wiped by the late commit — routing
        cut-over shards back to their old owners until the job's complete
        broadcast. Returns False when the adoption lost the race (a begin
        installed overrides, or the epoch caught up meanwhile)."""
        with self._routing_mu:
            if (self.next_nodes is not None
                    or epoch is None
                    or epoch <= self.routing_epoch):
                return False
            self.nodes = sorted(new_nodes, key=lambda n: n.id)
            self.migrated = set()
            self.routing_epoch = epoch
            return True

    def abort_rebalance(self, committed=None) -> bool:
        """Drop a live rebalance. Returns True when routing fully
        reverted to the old topology; False when cutovers had already
        committed — those shards keep the mixed routing (their data now
        lives on the new owners; reverting would lose post-cutover
        writes) until a resumed job finishes the move."""
        with self._routing_mu:
            kept = {(i, int(s)) for i, s in committed} if committed else set()
            kept &= self.migrated
            if not kept:
                self.next_nodes = None
                self.migrated = set()
                self.routing_epoch += 1
                return True
            self.migrated = kept
            self.routing_epoch += 1
            return False

    def mark_unavailable(self, node_id: str) -> None:
        self.unavailable.add(node_id)

    def mark_available(self, node_id: str) -> None:
        self.unavailable.discard(node_id)

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def contains_shards(self, index: str, max_shard: int, node: Node) -> List[int]:
        return [
            s
            for s in range(max_shard + 1)
            if any(n.id == node.id for n in self.partition_nodes(self.partition(index, s)))
        ]

    def node_by_id(self, node_id: str) -> Optional[Node]:
        for n in self.nodes:
            if n.id == node_id:
                return n
        # Mid-rebalance, a cut-over shard's owners come from the target
        # membership (e.g. the joining node) before it appears in `nodes`.
        if self.next_nodes is not None:
            for n in self.next_nodes:
                if n.id == node_id:
                    return n
        return None

    def coordinator_node(self) -> Optional[Node]:
        """The coordinator, preferring an AVAILABLE flagged node: after a
        failover a survivor can transiently hold both the dead
        coordinator's stale flag and the successor's fresh claim — joins
        must route to the live one, not the lowest-id corpse."""
        flagged = [n for n in self.nodes if n.is_coordinator]
        for n in flagged:
            if n.id not in self.unavailable:
                return n
        return flagged[0] if flagged else None

    def is_coordinator(self) -> bool:
        return self.node.is_coordinator

    def add_node(self, node: Node) -> None:
        if self.node_by_id(node.id) is None:
            self.nodes.append(node)
            self.nodes.sort(key=lambda n: n.id)

    def remove_node(self, node_id: str) -> bool:
        n = self.node_by_id(node_id)
        if n is None:
            return False
        self.nodes.remove(n)
        # Drop health/availability state with the membership entry: a
        # removed node's stale breaker must not shadow a later re-add
        # that reuses the same id.
        self.health.prune(node_id)
        return True
