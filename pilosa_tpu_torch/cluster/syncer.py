"""Anti-entropy: merkle-block sync of replicated fragments.

Port of the reference's holderSyncer/fragmentSyncer (holder.go:566-774,
fragment.go:1716-1904): walk every locally-owned fragment, compare
HASH_BLOCK_SIZE-row block checksums across replicas, pull differing blocks,
majority-vote merge locally, and push Set/Clear diffs back to replicas as
PQL. Attribute stores sync first via block-checksum diff (attr.go:80-120).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..constants import SHARD_WIDTH, VIEW_STANDARD
from ..errors import PilosaError


class HolderSyncer:
    def __init__(self, server):
        self.server = server
        self.holder = server.holder
        self.cluster = server.cluster
        self.client = server.client
        # Hinted-handoff store (cluster/hints.py): shards with pending or
        # expired hints sync FIRST — they are the ones KNOWN to be
        # divergent — instead of waiting their turn in the full-holder
        # walk. None for library holders without a server-owned store.
        self.hints = getattr(server, "hints", None)
        # Per-sweep pacing ([anti-entropy] pace): seconds slept between
        # fragment syncs so one sweep can't saturate replicas with
        # back-to-back block RPCs.
        self.pace = getattr(server, "anti_entropy_pace", 0.0)

    def _remote_replicas(self, index: str, shard: int):
        nodes = self.cluster.shard_nodes(index, shard)
        me = self.cluster.node.id
        if not any(n.id == me for n in nodes):
            return None  # not owned here
        # Shared peer-health state (cluster/health.py): a replica whose
        # breaker is open gets skipped for this sweep instead of costing
        # one connect timeout per fragment; the next sweep retries after
        # the breaker readmits it.
        health = self.cluster.health
        return [n for n in nodes if n.id != me and not health.is_down(n.id)]

    def sync_holder(self) -> None:
        import time as _t

        # Collect the whole fragment worklist first so hint-flagged
        # shards (pending, expired, or overflowed hints — the shards
        # KNOWN to be divergent) can be ordered to the FRONT of the
        # sweep; everything else keeps its stable walk order behind them.
        work = []
        for index_name in self.holder.index_names():
            idx = self.holder.index(index_name)
            self._sync_attrs(index_name, None, idx.column_attr_store)
            for field_name in idx.field_names():
                fld = idx.field(field_name)
                self._sync_attrs(index_name, field_name, fld.row_attr_store)
                for view_name in fld.view_names():
                    view = fld.view(view_name)
                    for shard in view.available_shards():
                        work.append((index_name, field_name, view_name,
                                     shard))
        priority = (self.hints.priority_shards()
                    if self.hints is not None else set())
        if priority:
            work.sort(key=lambda w: (w[0], w[3]) not in priority)
        first = True
        unrepaired = set()
        for index_name, field_name, view_name, shard in work:
            if not first and self.pace > 0:
                # Per-sweep pacing: spread the block-RPC load out.
                _t.sleep(self.pace)
            first = False
            replicas = self._remote_replicas(index_name, shard)
            if not replicas:
                if replicas is not None:
                    # Owned here but every remote replica is DOWN:
                    # nothing was repaired. A hint-flagged shard must
                    # keep its flag, or the outage that created the
                    # divergence would also erase its priority ordering.
                    # (None = not owned here: the owners' sweeps are the
                    # repair path, so those flags still settle below.)
                    unrepaired.add((index_name, shard))
                continue
            try:
                self._sync_fragment(
                    index_name, field_name, view_name, shard, replicas
                )
            except (PilosaError, OSError) as e:
                # One fragment's failure (peer down mid-sync, an
                # oversized diff rejected, a local disk fault
                # while persisting a merge) must not abort the
                # rest of the sweep.
                self.server.logger.error(
                    "anti-entropy: %s/%s/%s/%s sync failed: %s",
                    index_name, field_name, view_name, shard, e,
                )
                unrepaired.add((index_name, shard))
        if self.hints is not None:
            # A completed sweep settles every hint-priority flag whose
            # shard was actually repaired (pending per-peer hint records
            # stay — replay is idempotent and cheaper than dropping them
            # mid-log); flags for shards that failed mid-sync or had no
            # reachable replica survive to keep their ordering. Flags for
            # shards this node doesn't even hold are settled: their
            # owners' sweeps are the repair path, and keeping dead flags
            # would pin the priority set forever.
            for key in priority:
                if key not in unrepaired:
                    self.hints.note_synced(*key)

    # ---------------------------------------------------------------- attrs

    def _sync_attrs(self, index: str, field, store) -> None:
        health = self.cluster.health
        replicas = [
            n for n in self.cluster.nodes
            if n.id != self.cluster.node.id and not health.is_down(n.id)
        ]
        if not replicas:
            return
        blocks = [{"id": bid, "checksum": chk.hex()} for bid, chk in store.blocks()]
        for node in replicas:
            try:
                remote_attrs = self.client.attr_diff(node, index, field, blocks)
            except PilosaError:
                continue
            if remote_attrs:
                store.set_bulk_attrs(remote_attrs)

    # ------------------------------------------------------------- fragment

    def _sync_fragment(self, index: str, field: str, view: str, shard: int, replicas) -> None:
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            return
        if frag.quarantined:
            # A quarantined fragment booted empty after its file failed
            # validation. Letting its emptiness vote in the block merge
            # below could CLEAR acknowledged bits on healthy replicas, so
            # restore a full copy from a replica first; the normal checksum
            # walk then runs on repaired data (and pushes nothing, since
            # local now matches the repair source).
            if not self._repair_fragment(index, field, view, shard, frag, replicas):
                return  # no replica could serve a copy; retry next sweep
        local_blocks = {b.id: b.checksum for b in frag.blocks()}

        # Gather remote block checksums; union of block ids drives the merge.
        remote_blocks: List[Tuple[object, Dict[int, bytes]]] = []
        for node in replicas:
            try:
                blocks = self.client.fragment_blocks(node, index, field, shard,
                                                     view=view)
                remote_blocks.append(
                    (node, {b["id"]: bytes.fromhex(b["checksum"]) for b in blocks})
                )
            except PilosaError:
                continue

        all_ids = set(local_blocks)
        for _, blocks in remote_blocks:
            all_ids.update(blocks)

        for block_id in sorted(all_ids):
            checksums = [blocks.get(block_id) for _, blocks in remote_blocks]
            if all(c == local_blocks.get(block_id) for c in checksums):
                continue
            self._merge_block(index, field, view, shard, block_id, frag, remote_blocks)

    def _repair_fragment(self, index, field, view, shard, frag, replicas) -> bool:
        """Restore a quarantined fragment from the first replica that can
        ship a full copy (the resize shard-retrieval RPC), folding back any
        writes acknowledged locally while the fragment served degraded.
        Returns True when the fragment is whole again."""
        import io

        for node in replicas:
            try:
                data = self.client.retrieve_shard_from_uri(
                    node, index, field, view, shard
                )
            except PilosaError as e:
                self.server.logger.error(
                    "anti-entropy: repair pull %s/%s/%s/%s from %s failed: %s",
                    index, field, view, shard, node.id, e,
                )
                continue
            # Under the fragment's (reentrant) write mutex for the whole
            # capture -> restore -> fold-back sequence: a write landing
            # between the local snapshot and read_from's storage swap would
            # otherwise be silently dropped from the repaired fragment.
            with frag._mu:
                # Bits acknowledged AFTER quarantine (the corrupt original
                # booted empty, so everything currently in storage is
                # post-quarantine): a full replica restore must not drop
                # them.
                local_pos = frag.storage.slice()
                try:
                    frag.read_from(io.BytesIO(data))  # clears the quarantine
                except PilosaError as e:
                    self.server.logger.error(
                        "anti-entropy: repair stream %s/%s/%s/%s from %s "
                        "bad: %s", index, field, view, shard, node.id, e,
                    )
                    continue
                except OSError as e:
                    if frag.quarantined:
                        # Failed before the in-memory restore landed.
                        self.server.logger.error(
                            "anti-entropy: repair of %s/%s/%s/%s from %s "
                            "errored: %s", index, field, view, shard,
                            node.id, e,
                        )
                        continue
                    # The restore DID land (read_from swapped storage and
                    # cleared the quarantine) — only its trailing snapshot
                    # failed to persist. Fall through to the fold-back: the
                    # in-memory state is whole, and bulk_import/next
                    # snapshot retries persistence.
                    self.server.logger.error(
                        "anti-entropy: repaired %s/%s/%s/%s from %s but "
                        "snapshot persist failed (will retry): %s",
                        index, field, view, shard, node.id, e,
                    )
                if len(local_pos):
                    rows = local_pos // np.uint64(SHARD_WIDTH)
                    cols = (local_pos % np.uint64(SHARD_WIDTH)) + np.uint64(
                        shard * SHARD_WIDTH
                    )
                    frag.bulk_import(rows, cols)
            self.server.logger.info(
                "anti-entropy: repaired quarantined fragment %s/%s/%s/%s "
                "from %s", index, field, view, shard, node.id,
            )
            return True
        return False

    def _merge_block(self, index, field, view, shard, block_id, frag, remote_blocks) -> None:
        """Pull remote pairs, consensus-merge, push diffs (fragment.go:1737-1809)."""
        datas = []
        nodes = []
        for node, _ in remote_blocks:
            try:
                d = self.client.block_data(node, index, field, view, shard, block_id)
            except PilosaError:
                continue
            datas.append((np.asarray(d["rowIDs"], dtype=np.uint64),
                          np.asarray(d["columnIDs"], dtype=np.uint64)))
            nodes.append(node)
        if not datas:
            return
        sets, clears = frag.merge_block(block_id, datas)
        base = shard * SHARD_WIDTH
        for node, add, rem in zip(nodes, sets, clears):
            if not add and not rem:
                continue
            if view == VIEW_STANDARD:
                # Push standard-view diffs as Set/Clear PQL
                # (fragment.go:1814-1903 — the reference only syncs this
                # view). Chunked: one giant request for a large divergence
                # would trip the peer's max_writes_per_request cap (5000)
                # and the whole diff would be rejected.
                calls = [f"Set({base + c}, {field}={r})" for r, c in add]
                calls += [f"Clear({base + c}, {field}={r})" for r, c in rem]
                # Chunk under the CONFIGURED write cap, not a hardcoded
                # guess — a cluster run with a smaller cap would reject
                # every chunk and never converge.
                cap = getattr(self.server.executor, "max_writes_per_request", 0)
                chunk = min(1000, cap) if cap and cap > 0 else 1000
                for i in range(0, len(calls), chunk):
                    self.client.query_node(
                        node, index, " ".join(calls[i : i + chunk]), remote=True
                    )
            else:
                # Time/bsig views are unreachable via PQL writes; apply the
                # diff through the view-addressed internal endpoint instead.
                self.client.send_block_diff(
                    node, index, field, view, shard, block_id,
                    [[int(r), int(base + c)] for r, c in add],
                    [[int(r), int(base + c)] for r, c in rem],
                )
