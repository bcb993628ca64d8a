"""API facade: one method per externally-reachable operation.

Port of reference api.go — the single surface shared by the HTTP
handler, the cluster-message dispatcher, and the CLI. Methods validate
against cluster state (api.go:870-939): while RESIZING only resize-abort
and common methods are allowed.
"""

from __future__ import annotations

import threading
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence


from ..cluster.node import STATE_NORMAL
from ..constants import SHARD_WIDTH
from ..core.field import FieldOptions
from ..core.index import IndexOptions
from ..core.row import Row
from ..errors import PilosaError, QueryError
from ..executor import ExecOptions, Executor, ValCount
from ..obs import current as obs_current
from ..core.cache import Pair


class ApiError(PilosaError):
    pass


def _by_shard(column_ids, *payloads):
    """Group an import batch by owning shard.

    Yields (shard, column_ids, payloads) where each payload list is sliced
    to that shard's positions; a None payload stays None.
    """
    groups: Dict[int, List[int]] = {}
    for i, col in enumerate(column_ids):
        groups.setdefault(col // SHARD_WIDTH, []).append(i)
    for sh, idxs in sorted(groups.items()):
        cols = [column_ids[i] for i in idxs]
        sliced = tuple(
            [p[i] for i in idxs] if p is not None else None for p in payloads
        )
        yield sh, cols, sliced


# Methods valid in any cluster state (api.go apiMethod "common" set).
_COMMON_METHODS = {
    "status", "info", "schema", "version", "cluster_message",
    "resize_abort", "set_coordinator", "state", "shards_max",
}


class API:
    def __init__(self, server):
        self.server = server
        # Ingest observability (/debug/vars `ingest` group): shard batches
        # applied or routed through this node's import surface.
        self.import_batches = 0
        self._import_mu = threading.Lock()

    def _note_import_batches(self, n: int = 1) -> None:
        with self._import_mu:
            self.import_batches += n

    @property
    def ingest_config(self):
        cfg = getattr(self.server, "ingest_config", None)
        if cfg is None:
            from ..ingest import IngestConfig

            cfg = IngestConfig()
        return cfg

    @property
    def holder(self):
        return self.server.holder

    @property
    def cluster(self):
        return self.server.cluster

    @property
    def executor(self) -> Executor:
        return self.server.executor

    def _validate(self, method: str) -> None:
        state = self.cluster.state
        if state == STATE_NORMAL or method in _COMMON_METHODS:
            return
        raise ApiError(f"api method {method} unavailable in state {state}")

    # ---------------------------------------------------------------- query

    def query(
        self,
        index: str,
        query: str,
        shards: Optional[Sequence[int]] = None,
        column_attrs: bool = False,
        exclude_row_attrs: bool = False,
        exclude_columns: bool = False,
        remote: bool = False,
        deadline=None,
        traffic_class: Optional[str] = None,
        epoch: Optional[int] = None,
        at_position: Optional[int] = None,
        max_staleness: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> List[Any]:
        """Execute PQL under the query scheduler's lifecycle: admit (429
        when the queue is full) -> wait (bounded by `deadline`) ->
        execute, with the deadline riding ExecOptions so the executor
        aborts expired work before the next device dispatch. `deadline`
        is a sched.Deadline (or None); `traffic_class` defaults to
        interactive. `tenant` (the X-Pilosa-Tenant header, defaulting to
        the index name) is the QoS budget identity — see sched/qos.py."""
        self._validate("query")
        # Tenant identity defaults to the index name: single-tenant
        # deployments get per-index budgets for free, multi-tenant ones
        # send X-Pilosa-Tenant. Tagged onto the trace so the QoS ledger
        # and trace consumers can attribute the measured cost.
        tenant = tenant or index
        opt = ExecOptions(
            remote=remote,
            column_attrs=column_attrs,
            exclude_row_attrs=exclude_row_attrs,
            exclude_columns=exclude_columns,
            deadline=deadline,
            epoch=epoch,
            at_position=at_position,
            max_staleness=max_staleness,
            tenant=tenant,
        )
        t = obs_current()
        if t is not None:
            t.tag(tenant=tenant)
        sched = getattr(self.server, "scheduler", None)
        if sched is None:
            return self.executor.execute(index, query, shards=shards, opt=opt)
        from ..sched import CLASS_INTERACTIVE, DeadlineExceededError

        # Per-index traffic signal for the tier manager's prefetch
        # (docs/tiered-storage.md): forwarded sub-queries count too —
        # on a data node they ARE this index's serving traffic.
        sched.note_index(index)
        try:
            if remote:
                # Remote (forwarded) sub-queries are fan-out fragments of
                # a request the COORDINATOR already admitted — re-admitting
                # them here would double-count the work and, when every
                # node's interactive slots hold coordinators blocked on
                # each other's peers, form a cross-node slot-wait cycle
                # that only breaks on HTTP timeouts. Deadlines still apply
                # via opt; backpressure belongs at the admission edge.
                # They DO register as pressure, so concurrent fragment
                # queries coalesce on data nodes too.
                with sched.track_remote():
                    return self.executor.execute(
                        index, query, shards=shards, opt=opt)
            with sched.admit(traffic_class or CLASS_INTERACTIVE, deadline,
                             tenant=tenant):
                return self.executor.execute(index, query, shards=shards, opt=opt)
        except DeadlineExceededError as e:
            # Expiries detected downstream (executor map/reduce, remote
            # fan-out, micro-batch wait) surface here — on forwarded
            # sub-queries too; count each once so every abort is
            # observable in scheduler stats.
            if not getattr(e, "counted", False):
                e.counted = True
                sched.note_deadline_exceeded()
            raise

    def query_response(self, index: str, query: str, **kw) -> Dict[str, Any]:
        """Query + serialize results to the JSON wire shape
        (reference http/handler.go response encoding)."""
        column_attrs = kw.get("column_attrs", False)
        results = self.query(index, query, **kw)
        out: Dict[str, Any] = {"results": [serialize_result(r) for r in results]}
        if column_attrs:
            cols = set()
            for r in results:
                if isinstance(r, Row):
                    cols.update(int(c) for c in r.columns())
            idx = self.holder.index(index)
            attrs = []
            for col in sorted(cols):
                a = idx.column_attr_store.attrs(col)
                if a:
                    attrs.append({"id": col, "attrs": a})
            out["columnAttrs"] = attrs
        return out

    # ------------------------------------------------------------------ cdc

    @property
    def cdc(self):
        return getattr(self.server, "cdc", None)

    def _require_cdc(self):
        mgr = self.cdc
        if mgr is None:
            raise ApiError(
                "change capture is disabled (set cdc.enabled = true)")
        return mgr

    def cdc_stream(self, index: str, from_pos: int,
                   incarnation: Optional[str] = None,
                   timeout: Optional[float] = None,
                   max_bytes: int = 4 << 20):
        """One chunk of the resumable change stream: raw framed op
        records for positions > from_pos (cdc/log.py framing), the next
        cursor, and the log incarnation. Raises CdcGoneError (410) when
        the cursor fell behind retention or the index was recreated."""
        return self._require_cdc().stream(
            index, from_pos, inc=incarnation, timeout=timeout,
            max_bytes=max_bytes)

    def cdc_bootstrap(self, index: str) -> dict:
        """Snapshot re-seed for a behind-retention consumer: compressed
        fragment images + the position each was cut at."""
        return self._require_cdc().bootstrap(index)

    def cdc_standing_register(self, index: str, pql: str) -> dict:
        mgr = self._require_cdc()
        sq, created = mgr.standing.register(index, pql)
        out = sq.to_dict()
        out["created"] = created
        return out

    def cdc_standing_list(self) -> dict:
        return {"queries": self._require_cdc().standing.list()}

    def cdc_standing_poll(self, sid: str, after_version: int,
                          timeout: Optional[float] = None) -> dict:
        mgr = self._require_cdc()
        if timeout is None:
            timeout = mgr.config.poll_timeout
        return mgr.standing.poll(sid, after_version, timeout)

    def cdc_standing_delete(self, sid: str) -> None:
        self._require_cdc().standing.delete(sid)

    # ------------------------------------------------------------------ geo

    @property
    def geo(self):
        return getattr(self.server, "geo", None)

    def _require_geo(self):
        mgr = self.geo
        if mgr is None:
            raise ApiError(
                "geo replication is disabled (set geo.role)")
        return mgr

    def geo_promote(self) -> dict:
        """Operator-initiated leader-loss promotion (POST /geo/promote,
        docs/geo-replication.md): this follower becomes the leader
        under a bumped fencing geo epoch and starts pushing the demote
        handshake at the old leader."""
        return self._require_geo().promote()

    def geo_demote(self, leader: str, epoch: int) -> dict:
        """Fencing handshake target (POST /geo/demote): re-tail
        `leader` under the authoritative `epoch`, or 409 when we are
        already fenced at or past it."""
        return self._require_geo().demote(leader, epoch)

    def geo_status(self) -> dict:
        return self._require_geo().status()

    def _geo_check_write(self) -> None:
        """Import-path write fence: a geo follower refuses external
        writes with a typed 409 pointing at the leader; a leader
        tallies the accepting epoch (the split-brain evidence). The
        tail applies replicated records through apply_hint_ops, which
        deliberately does NOT pass this gate."""
        mgr = self.geo
        if mgr is not None:
            mgr.check_write()

    # --------------------------------------------------------------- schema

    def schema(self) -> List[dict]:
        self._validate("schema")
        return self.holder.schema()

    def apply_schema(self, schema: List[dict]) -> None:
        self.holder.apply_schema(schema)

    def create_index(self, name: str, options: Optional[dict] = None) -> dict:
        self._validate("create_index")
        opts = IndexOptions.from_dict(options or {})
        index = self.holder.create_index(name, opts)
        self.server.broadcast_message({"type": "create-index", "index": name,
                                       "options": opts.to_dict()})
        return index.to_info()

    def delete_index(self, name: str) -> None:
        self._validate("delete_index")
        self.holder.delete_index(name)
        self.server.broadcast_message({"type": "delete-index", "index": name})

    def create_field(self, index: str, name: str, options: Optional[dict] = None) -> dict:
        self._validate("create_field")
        idx = self.holder.index(index)
        if idx is None:
            from ..errors import IndexNotFoundError

            raise IndexNotFoundError(index)
        opts = FieldOptions.from_dict(options or {})
        field = idx.create_field(name, opts)
        self.server.broadcast_message({"type": "create-field", "index": index,
                                       "field": name, "options": opts.to_dict()})
        return field.to_info()

    def delete_field(self, index: str, name: str) -> None:
        self._validate("delete_field")
        idx = self.holder.index(index)
        if idx is None:
            from ..errors import IndexNotFoundError

            raise IndexNotFoundError(index)
        idx.delete_field(name)
        self.server.broadcast_message({"type": "delete-field", "index": index, "field": name})

    # --------------------------------------------------------------- import

    def _fan_out_import(self, index: str, shard: int, apply_local, send_remote,
                        remote: bool) -> None:
        """Bulk imports ride the executor's shared tolerant owner fan-out
        (one source of truth for the cluster's write-tolerance policy:
        dead replicas hinted or skipped + marked, deterministic rejections
        surfaced after the loop, the [replication] consistency level
        gating the ack). The local apply runs under hint capture so a
        missed replica forward enqueues this batch's exact WAL op bytes."""
        from ..core.fragment import capture_hint_ops

        captured: list = []

        def local():
            captured.clear()  # cutover retries must not double the batch
            with capture_hint_ops(captured):
                apply_local()

        def hint(node):
            hints = self.executor.hints
            if hints is None:
                return False
            return hints.add(node.id, index, shard, captured)

        self.executor.tolerant_owner_fanout(
            index, shard, remote, local, send_remote, hint=hint
        )

    def import_bits(self, index: str, field: str, shard: int, row_ids, column_ids,
                    timestamps=None, remote: bool = False,
                    row_keys=None, column_keys=None) -> None:
        """Route or apply a shard's worth of bits (api.go:653-698).

        String keys (row_keys/column_keys) are translated to ids here and
        the bits re-grouped by shard before routing — the key-mode import
        path (reference api.go key translation + ctl/import.go -k).
        """
        self._validate("import")
        if not remote:
            self._geo_check_write()
        idx = self.holder.index(index)
        if idx is None:
            from ..errors import IndexNotFoundError

            raise IndexNotFoundError(index)
        fld = idx.field(field)
        if fld is None:
            from ..errors import FieldNotFoundError

            raise FieldNotFoundError(field)

        store = self.server.translate_store
        if row_keys or column_keys:
            n = len(column_keys) if column_keys else len(column_ids or [])
            n_rows = len(row_keys) if row_keys else len(row_ids or [])
            if n != n_rows:
                raise QueryError(
                    f"import row/column length mismatch: {n_rows} rows vs {n} columns"
                )
            if timestamps is not None and len(timestamps) != n:
                raise QueryError(
                    f"import timestamps length mismatch: {len(timestamps)} vs {n}"
                )
            if store.read_only:
                # Key allocation happens on the translation primary
                # (reference PrimaryTranslateStore); forward the whole
                # key-mode import there.
                self.server.client.import_keys_node(
                    self.server.primary_translate_store_url, index, field,
                    row_ids, column_ids, row_keys, column_keys, timestamps,
                )
                return
            if column_keys:
                if not idx.keys():
                    raise QueryError("column keys require index 'keys' option")
                column_ids = store.translate_columns_to_uint64(index, list(column_keys))
            if row_keys:
                if not fld.keys():
                    raise QueryError("row keys require field 'keys' option")
                row_ids = store.translate_rows_to_uint64(index, field, list(row_keys))
            # Re-group by shard now that column ids are known, then fan
            # the shard batches out across the executor worker pool (one
            # forward stream per peer) instead of the old serial loop.
            groups = {
                sh: (rows, cols, ts)
                for sh, cols, (rows, ts) in _by_shard(
                    column_ids, row_ids, timestamps)
            }

            def apply_local(shard):
                rows, cols, ts = groups[shard]
                tsl = None
                if ts is not None and any(t is not None for t in ts):
                    tsl = [_to_datetime(t) for t in ts]
                fld.import_bits(rows, cols, tsl)

            def send(node, shard):
                rows, cols, ts = groups[shard]
                self.server.client.import_node(
                    node, index, field, shard, rows, cols, ts)

            self.executor.tolerant_group_fanout(
                index, list(groups), remote, apply_local, send,
                workers=self.ingest_config.import_workers,
            )
            self._note_import_batches(len(groups))
            return

        n = len(column_ids or [])
        if len(row_ids or []) != n:
            raise QueryError(
                f"import row/column length mismatch: {len(row_ids or [])} rows vs {n} columns"
            )
        if timestamps is not None and len(timestamps) != n:
            raise QueryError(
                f"import timestamps length mismatch: {len(timestamps)} vs {n}"
            )
        def apply_local():
            ts = None
            # Presence = "any entry is not None": a truthiness check here
            # silently dropped an explicit epoch-0 timestamp.
            if timestamps is not None and any(t is not None for t in timestamps):
                ts = [_to_datetime(t) for t in timestamps]
            fld.import_bits(row_ids, column_ids, ts)

        self._note_import_batches()
        self._fan_out_import(
            index, shard, apply_local,
            lambda node: self.server.client.import_node(
                node, index, field, shard, row_ids, column_ids, timestamps
            ),
            remote,
        )

    def import_values(self, index: str, field: str, shard: int, column_ids, values,
                      remote: bool = False, column_keys=None) -> None:
        self._validate("import")
        if not remote:
            self._geo_check_write()
        idx = self.holder.index(index)
        fld = self.holder.field(index, field)
        if fld is None:
            from ..errors import FieldNotFoundError

            raise FieldNotFoundError(field)
        if column_keys:
            if len(column_keys) != len(values):
                raise QueryError(
                    f"import columns/values length mismatch: {len(column_keys)} vs {len(values)}"
                )
            if not idx.keys():
                raise QueryError("column keys require index 'keys' option")
            store = self.server.translate_store
            if store.read_only:
                # Same primary forwarding as key-mode bit imports: key
                # allocation only happens on the translation primary.
                self.server.client.import_value_keys_node(
                    self.server.primary_translate_store_url, index, field,
                    column_keys, values,
                )
                return
            column_ids = store.translate_columns_to_uint64(index, list(column_keys))
            groups = {
                sh: (cols, vals)
                for sh, cols, (vals,) in _by_shard(column_ids, values)
            }
            self.executor.tolerant_group_fanout(
                index, list(groups), remote,
                lambda shard: fld.import_value(*groups[shard]),
                lambda node, shard: self.server.client.import_value_node(
                    node, index, field, shard, *groups[shard]),
                workers=self.ingest_config.import_workers,
            )
            self._note_import_batches(len(groups))
            return
        if len(column_ids or []) != len(values or []):
            raise QueryError(
                f"import columns/values length mismatch: "
                f"{len(column_ids or [])} vs {len(values or [])}"
            )
        self._note_import_batches()
        self._fan_out_import(
            index, shard, lambda: fld.import_value(column_ids, values),
            lambda node: self.server.client.import_value_node(
                node, index, field, shard, column_ids, values
            ),
            remote,
        )

    # --------------------------------------------------------------- export

    def export_csv(self, index: str, field: str, shard: int) -> str:
        self._validate("export")
        frag = self.holder.fragment(index, field, "standard", shard)
        if frag is None:
            from ..errors import FragmentNotFoundError

            raise FragmentNotFoundError(f"{index}/{field}/standard/{shard}")
        lines = []
        for pos in frag.storage.slice():
            row_id = int(pos) // SHARD_WIDTH
            col_id = frag.shard * SHARD_WIDTH + int(pos) % SHARD_WIDTH
            lines.append(f"{row_id},{col_id}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -------------------------------------------------------------- cluster

    def status(self) -> dict:
        return {
            "state": self.cluster.state,
            "nodes": [n.to_dict() for n in self.cluster.nodes],
            "localID": self.cluster.node.id,
            # NodeStatus payload (reference gossip.go:240-273 push/pull sync):
            # schema + max shards ride the probe so peers converge without a
            # dedicated gossip plane.
            "maxShards": self.shards_max(),
            "schema": self.holder.schema(),
            # jax.distributed identity rides the status probe so static
            # clusters converge on every node's process index (the
            # collective plane's placement needs all of them).
            "processIdx": self.cluster.node.process_idx,
            # Routing epoch + whether a live rebalance is in flight: a
            # follower that lost the rebalance-complete broadcast (flaky
            # link, all retries dropped) converges by adopting a peer's
            # newer COMMITTED topology off the probe (_monitor_members).
            "routingEpoch": self.cluster.routing_epoch,
            "midRebalance": self.cluster.next_nodes is not None,
        }

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH}

    def shards_max(self) -> Dict[str, int]:
        return {name: idx.max_shard() for name, idx in self.holder.indexes.items()}

    def fragment_blocks(self, index: str, field: str, shard: int,
                        view: str = "standard") -> List[dict]:
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            from ..errors import FragmentNotFoundError

            raise FragmentNotFoundError(f"{index}/{field}/{view}/{shard}")
        return [b.to_dict() for b in frag.blocks()]

    def apply_block_diff(self, index: str, field: str, view: str, shard: int,
                         sets, clears) -> None:
        """View-exact anti-entropy write-back: apply consensus Set/Clear
        pairs to the addressed view (columns are global ids). Creates the
        view/fragment if the replica is missing them, like the reference
        syncer does locally (holder.go:751-762)."""
        fld = self.holder.field(index, field)
        if fld is None:
            from ..errors import FieldNotFoundError

            raise FieldNotFoundError(f"{index}/{field}")
        v = fld.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard, broadcast=False)
        for row, col in sets:
            frag.set_bit(int(row), int(col))
        for row, col in clears:
            frag.clear_bit(int(row), int(col))

    def apply_hint_ops(self, index: str, field: str, view: str, shard: int,
                       data: bytes) -> None:
        """Hinted-handoff delivery target (cluster/hints.py): replay a
        shipped run of WAL op records — the coordinator's byte-exact
        capture of a write this replica missed — into the addressed
        fragment. Creates the view/fragment if this replica never saw
        them (it was down when the write landed), like apply_block_diff.
        Replay is idempotent set/clear, so redelivery after a crashed
        checkpoint is harmless."""
        from ..storage.bitmap import decode_op_records

        fld = self.holder.field(index, field)
        if fld is None:
            from ..errors import FieldNotFoundError

            raise FieldNotFoundError(f"{index}/{field}")
        records = decode_op_records(data)  # raises typed on a torn stream
        v = fld.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(shard, broadcast=False)
        for adds, removes in records:
            frag.apply_hint_positions(adds, removes)

    def fragment_block_data(self, index: str, field: str, view: str, shard: int, block: int) -> dict:
        frag = self.holder.fragment(index, field, view, shard)
        if frag is None:
            from ..errors import FragmentNotFoundError

            raise FragmentNotFoundError(f"{index}/{field}/{view}/{shard}")
        rows, cols = frag.block_data(block)
        return {"rowIDs": rows.tolist(), "columnIDs": cols.tolist()}

    def collective_count(self, index: str, field: str, rows: List[int]) -> int:
        """Leader side of multi-process collective execution:
        Count(Intersect) over `rows` through the collective backend
        (parallel/collective.py) — placement follows jump-hash, entry is
        barrier-guarded and seq-ordered, failures surface instead of
        hanging. A one-process job counts over this node's shards."""
        self._validate("collective_count")
        if not rows:
            raise QueryError("collective_count requires at least one row")
        if len(self.cluster.nodes) > 1:
            from ..parallel import distributed

            if distributed.process_count() < len(self.cluster.nodes):
                # Without a shared job a count would silently miss the
                # peers' shards: refuse rather than answer wrong.
                raise ApiError(
                    "collective_count requires a torch.distributed job "
                    f"spanning the cluster ({len(self.cluster.nodes)} nodes, "
                    f"{distributed.process_count()} processes); set "
                    "PILOSA_JAX_COORDINATOR on every node")
        from ..pql.parser import parse

        terms = ", ".join(f"Row({field}={int(r)})" for r in rows)
        query = terms if len(rows) == 1 else f"Intersect({terms})"
        call = parse(query).calls[0]
        return self.server.collective.count(index, call)

    def cluster_message(self, msg: dict) -> None:
        self._validate("cluster_message")
        self.server.receive_message(msg)

    def recalculate_caches(self) -> None:
        for index in self.holder.indexes.values():
            for field in index.fields.values():
                for view in field.views.values():
                    for frag in view.fragments.values():
                        frag.cache.invalidate(force=True)
        self.server.broadcast_message({"type": "recalculate-caches"})

    def max_inverse_shards(self):  # parity stub: inverse views removed upstream
        return {}

    def set_coordinator(self, node_id: str) -> None:
        self._validate("set_coordinator")
        for n in self.cluster.nodes:
            n.is_coordinator = n.id == node_id
        self.server.broadcast_message({"type": "set-coordinator", "nodeID": node_id})

    def remove_node(self, node_id: str) -> None:
        self.server.handle_node_leave(node_id)

    def translate_data(self, offset: int) -> bytes:
        store = self.server.translate_store
        return store.read_from(offset) if store else b""

    def attr_diff(self, index: str, field: Optional[str], blocks: List[dict]) -> Dict[int, dict]:
        """Return attrs for blocks whose checksums differ (api.go attr diff)."""
        idx = self.holder.index(index)
        if idx is None:
            from ..errors import IndexNotFoundError

            raise IndexNotFoundError(index)
        if field:
            fld = idx.field(field)
            if fld is None:
                from ..errors import FieldNotFoundError

                raise FieldNotFoundError(field)
            store = fld.row_attr_store
        else:
            store = idx.column_attr_store
        remote = {b["id"]: bytes.fromhex(b["checksum"]) for b in blocks}
        out: Dict[int, dict] = {}
        for bid, chk in store.blocks():
            if remote.get(bid) != chk:
                out.update(store.block_data(bid))
        return out


def _to_datetime(t):
    """Timestamp from wire: RFC3339-minute string (JSON) or epoch
    nanoseconds (protobuf ImportRequest.Timestamps). Only None means
    "absent": an explicit epoch-0 is a real timestamp (the protobuf
    boundary, which cannot distinguish absent from 0, already maps its
    zeros to None at decode — proto/__init__.py)."""
    if t is None:
        return None
    if isinstance(t, str):
        return datetime.strptime(t, "%Y-%m-%dT%H:%M")
    if isinstance(t, (int, float)):
        return datetime.utcfromtimestamp(t / 1e9)
    return t


def serialize_result(r) -> Any:
    if isinstance(r, Row):
        d = {"attrs": r.attrs or {}, "columns": [int(c) for c in r.columns()]}
        if r.keys:
            d["keys"] = r.keys
        return d
    if isinstance(r, ValCount):
        return r.to_dict()
    if isinstance(r, list) and (not r or isinstance(r[0], Pair)):
        return [p.to_dict() for p in r]
    if isinstance(r, (bool, int, float)) or r is None:
        return r
    return str(r)
