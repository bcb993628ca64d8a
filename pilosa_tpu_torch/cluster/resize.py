"""Cluster resize: coordinator-driven shard redistribution.

Port of the reference's resizeJob flow (cluster.go:1080-1423): when a node
joins/leaves with data present, the coordinator diffs old-vs-new shard
placement, builds one ResizeInstruction per node listing fragment sources,
broadcasts RESIZING, each node streams the fragments it is gaining from
source peers, acks with resize-complete, and the coordinator flips the
cluster back to NORMAL and broadcasts the new status.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

from ..cluster.node import Cluster, Node, STATE_NORMAL, STATE_RESIZING
from ..errors import PilosaError


def fragment_sources(
    old_cluster: Cluster, new_cluster: Cluster, schema: List[dict],
    max_shards: Dict[str, int], source_ok=None,
) -> Dict[str, List[dict]]:
    """Per-node list of fragments each node must fetch, with a source node
    owning that fragment in the old placement (cluster.go:689 fragSources).

    `source_ok(node_id, index, field, view, shard) -> bool` lets the
    caller steer source selection away from unhealthy replicas: the
    first old owner it accepts wins, falling back to placement order if
    it rejects them all (a degraded source beats no source — the fetch
    itself still fails loudly if the source refuses). Shards with NO old
    owner (an empty prior cluster) are skipped outright: there is
    nothing to fetch, and blindly indexing old_owners[0] raised."""
    sources: Dict[str, List[dict]] = {n.id: [] for n in new_cluster.nodes}
    for idx_info in schema:
        index = idx_info["name"]
        max_shard = max_shards.get(index, 0)
        for shard in range(max_shard + 1):
            old_owners = [n.id for n in old_cluster.shard_nodes(index, shard)]
            if not old_owners:
                continue
            new_owners = [n.id for n in new_cluster.shard_nodes(index, shard)]
            gaining = [nid for nid in new_owners if nid not in old_owners]
            if not gaining:
                continue
            for f_info in idx_info.get("fields", []):
                for v_info in f_info.get("views", []):
                    src = old_owners[0]
                    if source_ok is not None:
                        for cand in old_owners:
                            if source_ok(cand, index, f_info["name"],
                                         v_info["name"], shard):
                                src = cand
                                break
                    for node_id in gaining:
                        sources[node_id].append(
                            {
                                "index": index,
                                "field": f_info["name"],
                                "view": v_info["name"],
                                "shard": shard,
                                "sourceNodeID": src,
                            }
                        )
    return sources


class ResizeJob:
    def __init__(self, job_id: str, instructions: Dict[str, List[dict]], new_nodes: List[Node]):
        self.id = job_id
        self.instructions = instructions
        self.new_nodes = new_nodes
        self.acks = {node_id: False for node_id in instructions}
        self.lock = threading.Lock()

    def ack(self, node_id: str) -> bool:
        with self.lock:
            self.acks[node_id] = True
            return all(self.acks.values())


class ResizeCoordinator:
    """Runs on the coordinator node; one job at a time (cluster.go:1095)."""

    def __init__(self, server):
        self.server = server
        self.job: Optional[ResizeJob] = None
        self._lock = threading.Lock()

    def begin(self, new_nodes: List[Node]) -> None:
        cluster = self.server.cluster
        with self._lock:
            if self.job is not None:
                raise PilosaError("a resize job is already running")
            old = Cluster(
                node=cluster.node,
                nodes=list(cluster.nodes),
                replica_n=cluster.replica_n,
                partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            new = Cluster(
                node=cluster.node,
                nodes=sorted(new_nodes, key=lambda n: n.id),
                replica_n=cluster.replica_n,
                partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            schema = self.server.holder.schema()
            max_shards = {
                name: idx.max_shard() for name, idx in self.server.holder.indexes.items()
            }
            sources = fragment_sources(old, new, schema, max_shards)
            job = ResizeJob(uuid.uuid4().hex[:8], sources, new.nodes)
            self.job = job

        cluster.state = STATE_RESIZING
        status = {
            "type": "cluster-status",
            "state": STATE_RESIZING,
            "nodes": [n.to_dict() for n in new.nodes],
        }
        self.server.broadcast_message(status)

        node_uris = {n.id: n.uri for n in old.nodes}
        node_uris.update({n.id: n.uri for n in new.nodes})
        for node_id, instr_sources in sources.items():
            msg = {
                "type": "resize-instruction",
                "jobID": job.id,
                "nodeID": node_id,
                "coordinatorID": cluster.node.id,
                "coordinatorURI": cluster.node.uri,
                "schema": schema,
                "sources": instr_sources,
                "nodeURIs": node_uris,
                "maxShards": max_shards,
            }
            if self.job is not job:
                return  # an earlier dispatch already aborted this job
            if node_id == cluster.node.id:
                follow_resize_instruction(self.server, msg)
            else:
                target = next((n for n in new.nodes if n.id == node_id), None)
                if target is not None:
                    try:
                        self.server.client.send_message(target, msg)
                    except PilosaError as e:
                        # An undeliverable instruction can never be acked:
                        # abort now instead of hanging in RESIZING forever.
                        self.abort(
                            f"cannot deliver resize instruction to "
                            f"{node_id}: {e}"
                        )
                        return

    def abort(self, reason: str) -> None:
        """Abandon the running job: the membership never flipped (nodes
        flip only on full completion), so the cluster returns to NORMAL on
        the OLD topology and no node garbage-collects anything
        (cluster.go:1247 job abort)."""
        with self._lock:
            job = self.job
            self.job = None
        if job is None:
            return
        self.server.logger.error("resize job %s aborted: %s", job.id, reason)
        cluster = self.server.cluster
        cluster.state = STATE_NORMAL
        self.server.broadcast_message(
            {
                "type": "cluster-status",
                "state": STATE_NORMAL,
                "nodes": [n.to_dict() for n in cluster.nodes],
            }
        )

    def complete(self, node_id: str, error: str = "",
                 job_id: str = "") -> None:
        with self._lock:
            job = self.job
        if job is None or (job_id and job_id != job.id):
            return  # stale ack from an earlier (aborted) job
        if error:
            self.abort(f"node {node_id} failed its resize instruction: {error}")
            return
        with self._lock:
            job = self.job
            if job is None:
                return
            done = job.ack(node_id)
            if done:
                self.job = None
        if done:
            cluster = self.server.cluster
            cluster.nodes = job.new_nodes
            cluster.state = STATE_NORMAL
            # Checkpoint membership so a restarting coordinator knows which
            # nodes to wait for (startup topology quorum).
            self.server.topology.save(job.new_nodes)
            self.server.broadcast_message(
                {
                    "type": "cluster-status",
                    "state": STATE_NORMAL,
                    "nodes": [n.to_dict() for n in job.new_nodes],
                }
            )
            # Post-resize GC on the COORDINATOR too: followers run the
            # holder cleaner on their RESIZING -> NORMAL status
            # transition, but the coordinator never receives its own
            # broadcast — without this it kept every fragment it stopped
            # owning, forever.
            from .topology import HolderCleaner

            removed = HolderCleaner(self.server).clean_holder()
            if removed:
                self.server.logger.info(
                    "resize %s: holder cleaner removed %d fragments",
                    job.id, len(removed))


def follow_resize_instruction(server, msg: dict) -> None:
    """Receiver side (cluster.go:1179 followResizeInstruction)."""
    import io

    server.holder.apply_schema(msg.get("schema", []))
    for index_name, max_shard in msg.get("maxShards", {}).items():
        idx = server.holder.index(index_name)
        if idx is not None:
            idx.set_remote_max_shard(max_shard)
    node_uris = msg.get("nodeURIs", {})
    errors = []
    for src in msg.get("sources", []):
        source_uri = node_uris.get(src["sourceNodeID"])
        if source_uri is None or src["sourceNodeID"] == server.cluster.node.id:
            continue
        try:
            data = server.client.retrieve_shard_from_uri(
                source_uri, src["index"], src["field"], src["view"], src["shard"]
            )
        except PilosaError as e:
            # A fetch failure must ABORT the resize, not complete with
            # holes: after completion every node garbage-collects shards
            # it no longer owns, so at replica_n=1 a silently-skipped
            # fragment would be lost when its old owner cleans up
            # (reference cluster.go followResizeInstruction propagates the
            # error and the coordinator aborts the job).
            errors.append(
                f"{src['index']}/{src['field']}/{src['view']}/{src['shard']} "
                f"from {src['sourceNodeID']}: {e}"
            )
            continue
        fld = server.holder.field(src["index"], src["field"])
        if fld is None:
            continue
        view = fld.create_view_if_not_exists(src["view"])
        frag = view.create_fragment_if_not_exists(src["shard"])
        frag.read_from(io.BytesIO(data))

    complete = {
        "type": "resize-complete",
        "jobID": msg.get("jobID"),
        "nodeID": server.cluster.node.id,
    }
    if errors:
        complete["error"] = "; ".join(errors[:4])
    if msg.get("coordinatorID") == server.cluster.node.id:
        mark_resize_instruction_complete(server, complete)
    else:
        server.client.send_message(
            Node(id=msg.get("coordinatorID", ""), uri=msg.get("coordinatorURI", "")),
            complete,
        )


def mark_resize_instruction_complete(server, msg: dict) -> None:
    coordinator = getattr(server, "resize_coordinator", None)
    if coordinator is not None:
        coordinator.complete(
            msg.get("nodeID", ""), error=msg.get("error", ""),
            job_id=msg.get("jobID", ""),
        )
