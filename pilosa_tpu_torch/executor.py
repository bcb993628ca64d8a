"""PQL executor: single-node execution of the read and write paths.

Port of the local half of pilosa_tpu/executor.py (itself a port of
reference executor.go): Set / Clear / SetValue / SetRowAttrs /
SetColumnAttrs writes; Row / Intersect / Union / Difference / Xor and BSI
and time-quantum Range bitmaps; Count of such trees; Sum / Min / Max over
a BSI field with an optional filter; and two-phase TopN
(executor.go:524-560) with an optional filter, attribute filter and
tanimoto threshold.

Every tree the plan compiler lowers runs over all shards at once on the
device engine (parallel/engine.py): Counts on the gather-count kernel,
Sum on masked_plane_counts, Min/Max on bsi_minmax, TopN filters on
masked_plane_counts. A tree the engine's compile gate refuses (a time
Range over a field without a quantum or over no populated views, more
than 256 views, a missing field) is walked shard by shard, as the JAX
executor walks it.

The device-fault ladder (executor.py:1016-1121, 1160-1200 and 1277-1311
of the JAX package) sits here: the engine's breakers route a quarantined
signature to the per-shard walk and an open plane to host execution
before any device work, and a dispatch that fails mid-request
(DeviceDispatchError) falls one rung down for that query: Counts and
TopN counts to the host evaluators, bitmaps, BSI and TopNs whose source
has no host twin to the per-shard walk. Every fallback is logged and
counted (holder.stats: DeviceLadderFallback, DeviceHostRouted,
DeviceSigQuarantined). A kernel that cannot be built
(kernels.KernelBuildError) is not a device fault and is never served
one rung down: it raises out of execute. Nor is a real fault of a kernel
on the card: the engine raises it as DeviceKernelFault, which no rung
here catches; the rungs serve a CPU-device engine and injected faults.

Around it, the single-node request of the JAX executor: ExecOptions
(deadline, tenant, exclusions), the parse span and the deadline checks
before each shard, device dispatch and TopN chunk, `device.dispatch`
spans naming the rung, the micro-batcher (sched/batcher.py) for Counts
and bitmaps, string-key translation (executor.py:2059-2140 of the JAX
package), and the write routing through the shard owners with hint
capture and the [replication] consistency gate (executor.py:1588-1942,
2024-2057). On one node every owner is this node. Not ported yet, and
refused when asked: the read path's peer fan-out (a cluster of more than
one node), the collective plane, and point-in-time reads (at_position).
"""

from __future__ import annotations

import math
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from .constants import (
    MAX_WRITES_PER_REQUEST,
    SHARD_WIDTH,
    VIEW_BSI_GROUP_PREFIX,
    VIEW_STANDARD,
    WORDS_PER_ROW,
)
from .core.cache import Pair, add_pairs, sort_pairs
from .core.fragment import Fragment, TopOptions
from .core.holder import Holder
from .core.row import Row
from .errors import (
    BSIGroupNotFoundError,
    FieldNotFoundError,
    IndexNotFoundError,
    PilosaError,
    QueryError,
    TooManyWritesError,
)
from .obs import NOP_SPAN, current as obs_current, span as obs_span
from .ops.bitplane import compose_bits
from .parallel.device_health import DeviceDispatchError
from .pql import parser as pql_parser
from .pql.ast import BETWEEN, GT, GTE, LT, LTE, NEQ, Call, Condition
from .timeq import parse_timestamp, views_by_time_range

DEFAULT_FIELD = "general"
DEFAULT_MIN_THRESHOLD = 1

_WRITE_CALLS = {"Set", "Clear", "SetValue", "SetRowAttrs", "SetColumnAttrs"}
_NARY_SHARD_OPS = {"Difference": "difference", "Intersect": "intersect",
                   "Union": "union", "Xor": "xor"}


def _topn_chunk(n_shards: int) -> int:
    """Candidate rows per TopN kernel pass, bounded by BYTES not rows
    (each row costs n_shards * 128 KiB in the stacked tensor): the byte
    budget PILOSA_TOPN_CHUNK_BYTES (default 2 GiB), floored at one row."""
    budget = int(os.environ.get("PILOSA_TOPN_CHUNK_BYTES", 2 << 30))
    return max(1, min(512, budget // max(1, n_shards * WORDS_PER_ROW * 4)))


def not_ported(what: str) -> QueryError:
    """The typed refusal of a feature the port does not have yet."""
    return QueryError(f"{what} is not ported to the PyTorch/CUDA executor yet")


def _is_node_failure(e) -> bool:
    """True when a ClientError indicates the NODE failed (connect/transport
    error carries status 0, server fault is 5xx) rather than the REQUEST
    (4xx application errors are deterministic). A deadline-expiry or
    write-consistency 503 is a deterministic answer from a live node."""
    status = getattr(e, "status", 0)
    if status == 503 and ("deadline exceeded" in str(e)
                          or "write consistency" in str(e)):
        return False
    return status == 0 or status >= 500


@dataclass
class ExecOptions:
    """Per-request options (executor.py:79-116 of the JAX package)."""

    remote: bool = False
    exclude_row_attrs: bool = False
    exclude_columns: bool = False
    column_attrs: bool = False
    # Per-request time budget (sched/deadline.py), installed at admission
    # and checked before every shard, device dispatch and TopN chunk.
    deadline: Optional[Any] = None
    # Sender's routing epoch on forwarded requests (live rebalance).
    epoch: Optional[int] = None
    entry_epoch: Optional[int] = None
    # Point-in-time read (CDC): refused until the CDC slice.
    at_position: Optional[int] = None
    # Bounded-staleness read: a no-op without a geo manager, as in the
    # reference's single cluster.
    max_staleness: Optional[float] = None
    # QoS budget identity (X-Pilosa-Tenant, default: the index name).
    tenant: Optional[str] = None


@dataclass
class ValCount:
    """Sum/Min/Max result (reference executor.go:1762-1808)."""

    val: int = 0
    count: int = 0

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val < self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)

    def larger(self, other: "ValCount") -> "ValCount":
        if self.count == 0 or (other.val > self.val and other.count > 0):
            return other
        return ValCount(self.val, self.count)

    def to_dict(self):
        return {"value": self.val, "count": self.count}


class Executor:
    def __init__(self, holder: Holder, cluster=None, client=None,
                 translate_store=None,
                 max_writes_per_request: int = MAX_WRITES_PER_REQUEST,
                 workers: int = 1, engine_config=None, tier_config=None,
                 resilience_config=None):
        """`workers` sizes the pool for the per-shard walk and the import
        fan-out; the port's default is 1 (no pool, serial), as its
        container walks hold the GIL (the reference's is 8; the server
        passes its `executor_workers`). `resilience_config` installs the
        [resilience] knobs on the cluster's health registry, which the
        lazily built engine's device breakers read."""
        from .cluster.node import Cluster
        from .logger import NopLogger

        self.holder = holder
        self.engine_config = engine_config
        self.tier_config = tier_config
        # The scheduler's per-index traffic signal for the tier
        # prefetcher; the server wires it before any query builds the
        # engine.
        self.tier_traffic_fn = None
        self.cluster = cluster or Cluster()
        if resilience_config is not None:
            self.cluster.health.configure(resilience_config.validate())
        self.client = client
        self.translate_store = translate_store
        self.max_writes_per_request = max_writes_per_request
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None
        self._engine = None  # lazy ShardedQueryEngine
        # Cross-query micro-batcher (sched/batcher.py), wired by the
        # server's scheduler; None keeps the direct engine path.
        self.batcher = None
        # The collective plane comes with the multi-GPU slice.
        self.collective = None
        # Reads that touched a quarantined fragment (/debug/vars).
        self.quarantined_reads = 0
        # How long a write caught in a rebalance cutover keeps re-routing.
        self.cutover_wait = 2.0
        # Hinted handoff (cluster/hints.py) and the [replication] section,
        # wired by the server.
        self.hints = None
        self.replication_config = None
        # Geo replication: refused by the port's server, so always None
        # (X-Pilosa-Max-Staleness is the reference's documented no-op).
        self.geo = None
        self.logger = NopLogger()

    @property
    def engine(self):
        """The device engine, built on first device use so that building
        a server never opens the device."""
        if self._engine is None:
            from .parallel.engine import ShardedQueryEngine

            self._engine = ShardedQueryEngine(
                self.holder, config=self.engine_config,
                tier_config=self.tier_config,
                traffic_fn=self.tier_traffic_fn,
                resilience_config=self.cluster.health.config)
        return self._engine

    def close(self) -> None:
        """Release serving resources (the pool, the engine, client
        sockets)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._engine is not None:
            self._engine.close()
        if self.client is not None and hasattr(self.client, "close"):
            self.client.close()

    @property
    def health(self):
        """Per-peer breaker/budget state (cluster/health.py)."""
        return self.cluster.health

    @property
    def node(self):
        return self.cluster.node

    # ------------------------------------------------------------- execute

    def execute(self, index: str, query,
                shards: Optional[Sequence[int]] = None,
                opt: Optional[ExecOptions] = None) -> List[Any]:
        if not index:
            raise PilosaError("index required")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        if isinstance(query, str):
            with obs_span("parse"):
                query = pql_parser.parse(query)
        if self.max_writes_per_request > 0 and len(query.write_calls()) > self.max_writes_per_request:
            raise TooManyWritesError(
                f"too many writes: {len(query.write_calls())} > {self.max_writes_per_request}"
            )
        opt = opt or ExecOptions()
        if opt.at_position is not None:
            raise not_ported("point-in-time reads (at_position, CDC)")
        if opt.max_staleness is not None and self.geo is not None:
            self.geo.check_staleness(opt.max_staleness)
        if self.geo is not None and not opt.remote and query.write_calls():
            self.geo.check_write()
        for call in query.calls:
            self._translate_call(index, idx, call)
        needs_shards = any(c.name not in _WRITE_CALLS for c in query.calls)
        if not shards and needs_shards:
            shards = list(range(idx.max_shard() + 1))
        shards = list(shards or [])
        results = [self._execute_call(index, call, shards, opt)
                   for call in query.calls]
        return [self._translate_result(index, idx, call, r)
                for call, r in zip(query.calls, results)]

    def _execute_call(self, index: str, c: Call, shards: List[int],
                      opt: ExecOptions):
        if c.name in ("Sum", "Min", "Max"):
            return self._execute_val_count(index, c, shards, opt, c.name.lower())
        if c.name == "Count":
            return self._execute_count(index, c, shards, opt)
        if c.name == "Set":
            return self._execute_set_bit(index, c, opt)
        if c.name == "Clear":
            return self._execute_clear_bit(index, c, opt)
        if c.name == "SetValue":
            self._execute_set_value(index, c, opt)
            return None
        if c.name == "SetRowAttrs":
            self._execute_set_row_attrs(index, c, opt)
            return None
        if c.name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c, opt)
            return None
        if c.name == "TopN":
            return self._execute_topn(index, c, shards, opt)
        return self._execute_bitmap_call(index, c, shards, opt)

    def _supports(self, index: str, c: Call, shards: List[int]):
        """The engine's compile gate; nothing to run over no shards."""
        return bool(shards) and self.engine.supports(c, index)

    # ----------------------------------------------------------- mapReduce

    def _fan_out(self, shards: List[int], opt: ExecOptions,
                 local_runner: Callable):
        """The single node's fan-out: every shard is local, so the runner
        takes them all in one call (the reference's _fan_out with no
        remote owner). A cluster of more than one node needs the peer
        fan-out, which is not ported yet."""
        if len(self.cluster.nodes) > 1 and not opt.remote:
            raise not_ported("the read path's peer fan-out")
        if not shards:
            return None
        trace = obs_current()
        t0 = _time.monotonic()
        if opt.deadline is not None:
            opt.deadline.check("local dispatch")
        result = local_runner(list(shards))
        if trace is not None:
            trace.record("executor.fanout",
                         (_time.monotonic() - t0) * 1000.0, shards=len(shards))
        return result

    def _map_reduce(self, shards: List[int], opt: ExecOptions,
                    map_fn: Callable, reduce_fn: Callable):
        """The per-shard walk for trees the engine does not compile, and
        the ladder's rung for device work with no host twin: one shard at
        a time (on the pool when there is one), the deadline checked
        before each, reduced in shard order (None over no shards)."""
        deadline = opt.deadline

        def checked_map(shard):
            if deadline is not None:
                deadline.check("shard map")
            return map_fn(shard)

        def local_runner(local_shards):
            if self._pool is not None and len(local_shards) > 1:
                values = list(self._pool.map(checked_map, local_shards))
            else:
                values = [checked_map(s) for s in local_shards]
            result = None
            for v in values:
                result = v if result is None else reduce_fn(result, v)
            return result

        return self._fan_out(shards, opt, local_runner)

    def _count_stat(self, name: str) -> None:
        """holder.stats.count guarded for library use (a holder opened
        without stats counts nothing)."""
        if self.holder.stats is not None:
            self.holder.stats.count(name, 1)

    def _fallback(self, what: str, e: DeviceDispatchError, rung: str) -> None:
        self._count_stat("DeviceLadderFallback")
        self.logger.error("device %s dispatch failed (%s), serving it from "
                          "the %s rung: %s", what, e.kind, rung, e)

    def _shard_rung(self, shards: List[int], opt: ExecOptions,
                    map_fn: Callable, reduce_fn: Callable):
        """The per-shard walk as a ladder rung, in a `device.dispatch`
        span naming it."""
        with obs_span("device.dispatch", rung="shard", shards=len(shards)):
            return self._map_reduce(shards, opt, map_fn, reduce_fn)

    def _batched_or_map_reduce(self, index: str, c: Call, shards: List[int],
                               opt: ExecOptions, kind: str, map_fn: Callable,
                               reduce_fn: Callable, child: Optional[Call] = None):
        """One device program over all shards when the tree compiles
        (kind "count" or "bitmap"), through the micro-batcher when the
        server wired one, under the device-fault ladder: the breakers
        route a quarantined signature to the per-shard walk and an open
        plane to host execution before any device work, and a dispatch
        that fails mid-request falls one rung down for this query — the
        breakers make the routing sticky for the next. Each rung runs in
        a `device.dispatch` span naming it."""
        target = child if child is not None else c
        plan = self._supports(index, target, shards)
        if not plan:
            return self._map_reduce(shards, opt, map_fn, reduce_fn)
        eng = self.engine
        host_ok = kind == "count" and eng.host_supports(target)

        def host_runner(local_shards):
            if opt.deadline is not None:
                opt.deadline.check("host execution")
            with obs_span("device.dispatch", rung="host", shards=len(local_shards)):
                return eng.host_count(index, target, local_shards, plan=plan)

        route = eng.route(plan.sig_tuple)
        if route == "shard":
            self._count_stat("DeviceSigQuarantined")
            return self._shard_rung(shards, opt, map_fn, reduce_fn)
        if route == "host":
            self._count_stat("DeviceHostRouted")
            if host_ok:
                return self._fan_out(shards, opt, host_runner)
            return self._shard_rung(shards, opt, map_fn, reduce_fn)

        def local_runner(local_shards):
            if opt.deadline is not None:
                opt.deadline.check("device dispatch")
            with obs_span("device.dispatch", rung="device",
                          shards=len(local_shards)) as sp:
                if sp is not NOP_SPAN:
                    sp.tag(sig=str(plan.sig_tuple))
                if kind == "count":
                    if self.batcher is not None:
                        return self.batcher.count(index, target, local_shards,
                                                  plan=plan, deadline=opt.deadline)
                    return eng.count(index, target, local_shards, plan=plan)
                if self.batcher is not None:
                    return self.batcher.bitmap(index, target, local_shards,
                                               plan=plan, deadline=opt.deadline)
                return eng.bitmap(index, target, local_shards, plan=plan)

        try:
            return self._fan_out(shards, opt, local_runner)
        except DeviceDispatchError as e:
            self._fallback(kind, e, "host" if host_ok else "shard")
            if host_ok:
                return self._fan_out(shards, opt, host_runner)
            return self._shard_rung(shards, opt, map_fn, reduce_fn)

    # ------------------------------------------------------------- bitmaps

    def _execute_bitmap_call(self, index: str, c: Call, shards: List[int],
                             opt: ExecOptions) -> Row:
        def merge(prev: Row, v: Row) -> Row:
            prev.merge(v)
            return prev

        row = self._batched_or_map_reduce(
            index, c, shards, opt, "bitmap",
            lambda s: self._execute_bitmap_call_shard(index, c, s), merge) or Row()
        if c.name == "Row" and not opt.exclude_row_attrs:
            fld = self.holder.field(index, c.field_arg())
            if fld is not None:
                row_id, ok = c.uint_arg(c.field_arg())
                if ok:
                    row.attrs = fld.row_attr_store.attrs(row_id)
        if opt.exclude_columns:
            row.segments = {}
        return row

    def _fragment(self, index: str, field: str, view: str, shard: int):
        """Read-path fragment lookup. A quarantined fragment (corrupt file
        moved aside at open, repair pending) reads as empty; the touch is
        counted (quarantined_reads, /debug/vars)."""
        frag = self.holder.fragment(index, field, view, shard)
        if frag is not None and frag.quarantined:
            self.quarantined_reads += 1
        return frag

    def _execute_bitmap_call_shard(self, index: str, c: Call, shard: int) -> Row:
        if c.name == "Row":
            return self._execute_row_shard(index, c, shard)
        if c.name in _NARY_SHARD_OPS:
            return self._execute_nary_shard(index, c, shard, _NARY_SHARD_OPS[c.name])
        if c.name == "Range":
            return self._execute_range_shard(index, c, shard)
        raise QueryError(f"unknown call: {c.name}")

    def _execute_row_shard(self, index: str, c: Call, shard: int) -> Row:
        field_name = c.field_arg()
        if self.holder.field(index, field_name) is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError("Row() must specify row")
        frag = self._fragment(index, field_name, VIEW_STANDARD, shard)
        return Row() if frag is None else frag.row(row_id)

    def _execute_nary_shard(self, index: str, c: Call, shard: int, op: str) -> Row:
        if not c.children and op in ("difference", "intersect"):
            raise QueryError(f"empty {c.name} query is currently not supported")
        rows = [self._execute_bitmap_call_shard(index, ch, shard) for ch in c.children]
        if not rows:
            return Row()
        out = rows[0]
        for r in rows[1:]:
            out = getattr(out, op)(r)
        return out

    def _execute_range_shard(self, index: str, c: Call, shard: int) -> Row:
        if c.has_condition_arg():
            return self._execute_bsi_range_shard(index, c, shard)
        field_name = c.field_arg()
        fld = self.holder.field(index, field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError("Range() must specify row")
        start, end = c.args.get("_start"), c.args.get("_end")
        if not isinstance(start, str) or not isinstance(end, str):
            raise QueryError("Range() start/end time required")
        start_t, end_t = parse_timestamp(start), parse_timestamp(end)
        q = fld.time_quantum()
        if not q:
            return Row()
        row = Row()
        for view_name in views_by_time_range(VIEW_STANDARD, start_t, end_t, q):
            frag = self._fragment(index, field_name, view_name, shard)
            if frag is not None:
                row.merge(frag.row(row_id))
        return row

    def _execute_bsi_range_shard(self, index: str, c: Call, shard: int) -> Row:
        if len(c.args) == 0:
            raise QueryError("Range(): condition required")
        if len(c.args) > 1:
            raise QueryError("Range(): too many arguments")
        (field_name, cond), = c.args.items()
        if not isinstance(cond, Condition):
            raise QueryError(f"Range(): expected condition argument, got {cond!r}")
        fld = self.holder.field(index, field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        bsig = fld.bsi_group(field_name)
        if bsig is None:
            raise BSIGroupNotFoundError(field_name)
        depth = bsig.bit_depth()
        frag = self._fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, shard)

        if cond.op == NEQ and cond.value is None:  # != null
            return frag.not_null(depth) if frag else Row()

        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise QueryError("Range(): BETWEEN condition requires exactly two integer values")
            lo, hi, out_of_range = bsig.base_value_between(*predicates)
            if out_of_range or frag is None:
                return Row()
            if predicates[0] <= bsig.min and predicates[1] >= bsig.max:
                return frag.not_null(depth)
            return frag.range_between(depth, lo, hi)

        if not isinstance(cond.value, int) or isinstance(cond.value, bool):
            raise QueryError("Range(): conditions only support integer values")
        value = cond.value
        base, out_of_range = bsig.base_value(cond.op, value)
        if (out_of_range and cond.op != NEQ) or frag is None:
            return Row()
        # Full-range LT/GT collapse to not-null (executor.go:938-948).
        if (
            (cond.op == LT and value > bsig.max)
            or (cond.op == LTE and value >= bsig.max)
            or (cond.op == GT and value < bsig.min)
            or (cond.op == GTE and value <= bsig.min)
            or out_of_range  # != a value outside the range
        ):
            return frag.not_null(depth)
        return frag.range_op(cond.op, depth, base)

    # --------------------------------------------------------------- count

    def _execute_count(self, index: str, c: Call, shards: List[int],
                       opt: ExecOptions) -> int:
        if len(c.children) == 0:
            raise QueryError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise QueryError("Count() only accepts a single bitmap input")
        child = c.children[0]
        result = self._batched_or_map_reduce(
            index, c, shards, opt, "count",
            lambda s: self._execute_bitmap_call_shard(index, child, s).count(),
            lambda a, b: a + b, child=child)
        return int(result or 0)

    # --------------------------------------------------------- sum/min/max

    def _execute_val_count(self, index: str, c: Call, shards: List[int],
                           opt: ExecOptions, kind: str) -> ValCount:
        field_name = c.args.get("field")
        if not field_name:
            raise QueryError(f"{c.name}(): field required")
        if len(c.children) > 1:
            raise QueryError(f"{c.name}() only accepts a single bitmap input")
        fld = self.holder.field(index, field_name)
        bsig = fld.bsi_group(field_name) if fld else None
        filter_call = c.children[0] if c.children else None
        reduce_fn = {"sum": ValCount.add, "min": ValCount.smaller,
                     "max": ValCount.larger}[kind]

        def walk() -> ValCount:
            return self._map_reduce(
                shards, opt, lambda s: self._execute_val_count_shard(index, c, s, kind),
                reduce_fn) or ValCount()

        def device(local_shards):
            with obs_span("device.dispatch", rung="device", shards=len(local_shards)):
                return self.engine.bsi_val_count(
                    index, field_name, kind, bsig.bit_depth(), local_shards,
                    filter_call)

        # The BSI scans are device programs with no host twin, so the
        # per-shard walk is their whole degraded ladder: an open plane
        # breaker takes it BEFORE any dispatch, and a dispatch failing
        # mid-request takes it for this query.
        if (bsig is not None
                and (self._supports(index, filter_call, shards)
                     if filter_call is not None else shards)
                and self.engine.route() == "device"):
            try:
                result = self._compose_bsi_result(
                    bsig, kind, self._fan_out(shards, opt, device))
            except DeviceDispatchError as e:
                self._fallback("BSI", e, "shard")
                with obs_span("device.dispatch", rung="shard", shards=len(shards)):
                    result = walk()
        else:
            result = walk()
        if result.count == 0:
            return ValCount()
        return result

    @staticmethod
    def _compose_bsi_result(bsig, kind: str, out) -> ValCount:
        """ValCount from an engine.bsi_val_count result: the offset and
        weight math (executor.py:1219-1237 of the JAX package)."""
        depth = bsig.bit_depth()
        if kind == "sum":
            vcount = int(out[depth])
            if vcount == 0:
                return ValCount()
            vsum = sum((1 << i) * int(out[i]) for i in range(depth))
            return ValCount(vsum + vcount * bsig.min, vcount)
        bits, count = out
        if count == 0:
            return ValCount()
        return ValCount(compose_bits(bits) + bsig.min, count)

    def _execute_val_count_shard(self, index: str, c: Call, shard: int,
                                 kind: str) -> ValCount:
        filter_row = None
        if len(c.children) == 1:
            filter_row = self._execute_bitmap_call_shard(index, c.children[0], shard)
        field_name = c.args.get("field")
        fld = self.holder.field(index, field_name)
        bsig = fld.bsi_group(field_name) if fld else None
        if bsig is None:
            return ValCount()
        frag = self._fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, shard)
        if frag is None:
            return ValCount()
        if kind == "sum":
            vsum, vcount = frag.sum(filter_row, bsig.bit_depth())
            return ValCount(val=vsum + vcount * bsig.min, count=vcount)
        v, cnt = getattr(frag, kind)(filter_row, bsig.bit_depth())
        return ValCount(val=v + bsig.min if cnt else 0, count=cnt)

    # ----------------------------------------------------------------- TopN

    def _check_chunk_deadline(self, deadline, where: str) -> None:
        """Deadline re-check between device chunks and TopN phases: a
        budget that expired mid-query stops here (503) instead of
        finishing dead device work; DeadlineMidQuery counts it."""
        if deadline is None:
            return
        if deadline.expired():
            self._count_stat("DeadlineMidQuery")
        deadline.check(where)

    def _execute_topn(self, index: str, c: Call, shards: List[int],
                      opt: ExecOptions) -> List[Pair]:
        ids_arg = self._uint_slice_arg(c, "ids")
        n, _ = c.uint_arg("n")
        pairs = self._execute_topn_shards(index, c, shards, opt)
        if not pairs or ids_arg or opt.remote:
            return pairs
        # Phase 2: refetch full counts for the merged candidate ids
        # (executor.go:524-560), after re-checking the budget.
        self._check_chunk_deadline(opt.deadline, "between TopN phases")
        other = Call(c.name, dict(c.args), list(c.children))
        other.args["ids"] = sorted({p.id for p in pairs})
        trimmed = self._execute_topn_shards(index, other, shards, opt)
        if n and len(trimmed) > n:
            trimmed = trimmed[:n]
        return trimmed

    def _execute_topn_shards(self, index: str, c: Call, shards: List[int],
                             opt: ExecOptions) -> List[Pair]:
        ids = self._uint_slice_arg(c, "ids")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise QueryError("Tanimoto Threshold is from 1 to 100 only")
        if len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")
        src_call = c.children[0] if c.children else None

        def walk() -> List[Pair]:
            return sort_pairs(self._map_reduce(
                shards, opt, lambda s: self._execute_topn_shard(index, c, s),
                add_pairs) or [])

        # Without a filter the host rank caches hold exact counts: the
        # per-shard walk needs no device work, as in the JAX package.
        if src_call is None or not self._supports(index, src_call, shards):
            return walk()
        field_name = c.args.get("_field") or DEFAULT_FIELD
        thr = max(c.uint_arg("threshold")[0], DEFAULT_MIN_THRESHOLD)
        attr_name = c.args.get("attrName", "")
        attr_values = c.args.get("attrValues") or []
        def batched(local_shards):
            if ids:
                return self._topn_candidates(
                    index, field_name, ids, local_shards, src_call, thr,
                    tanimoto, attr_name, attr_values)
            return self._topn_ranked(
                index, field_name, local_shards, src_call, TopOptions(
                    n=c.uint_arg("n")[0], min_threshold=thr,
                    filter_name=attr_name, filter_values=attr_values,
                    tanimoto_threshold=tanimoto), opt.deadline)

        try:
            return self._fan_out(shards, opt, batched) or []
        except DeviceDispatchError as e:
            # Last rung: neither the device nor the host evaluator could
            # serve the counts (a degraded plane and a source with no host
            # twin, such as a BSI Range): the per-shard TopN walk.
            self._fallback("TopN", e, "shard")
            with obs_span("device.dispatch", rung="shard", shards=len(shards)):
                return walk()

    def _topn_counts_laddered(self, index: str, field: str, ids, shards,
                              src_call: Optional[Call], need_rc: bool):
        """engine.topn_shard_counts under the device-fault ladder: an open
        plane breaker (or a dispatch failure mid-request) answers the same
        contract from host planes and numpy popcounts. When the source
        has no host twin (BSI Range) the DeviceDispatchError propagates to
        _execute_topn_shards, which takes the per-shard walk."""
        eng = self.engine
        host_ok = src_call is None or eng.host_supports(src_call)
        if eng.route() == "device":
            try:
                with obs_span("device.dispatch", rung="device", shards=len(shards)):
                    return eng.topn_shard_counts(
                        index, field, ids, shards, src_call,
                        need_row_counts=need_rc)
            except DeviceDispatchError as e:
                if not host_ok:
                    raise
                self._fallback("TopN", e, "host")
        elif not host_ok:
            raise DeviceDispatchError(
                "runtime", None,
                "device plane degraded and TopN src is not host-executable")
        else:
            self._count_stat("DeviceHostRouted")
        with obs_span("device.dispatch", rung="host", shards=len(shards)):
            return eng.host_topn_shard_counts(
                index, field, ids, shards, src_call, need_row_counts=need_rc)

    def _topn_candidates(self, index, field_name, ids, shards, src_call, thr,
                         tanimoto, attr_name, attr_values) -> List[Pair]:
        """Phase 2: every candidate's per-shard count against the filter,
        one K2 pass over the stacked candidate rows, keeping per-shard
        MinThreshold, tanimoto (fragment.go:899-990, 1008-1027: the
        coefficient is a function of the row, intersection and src counts)
        and the attr filter (a host check against the field's row attr
        store, fragment.go:922-934)."""
        if attr_name and attr_values:
            fld = self.holder.field(index, field_name)
            store = fld.row_attr_store if fld else None
            values = set(attr_values)
            ids = [r for r in ids if Fragment.row_attrs_match(store, r, attr_name, values)]
            if not ids:
                return []
        # Row counts only gate tanimoto and thresholds > 1; at thr <= 1
        # the count > 0 check below subsumes them.
        need_rc = bool(tanimoto) or thr > 1
        row_counts, inter, src_counts = self._topn_counts_laddered(
            index, field_name, ids, shards, src_call, need_rc)
        pairs: Dict[int, int] = {}
        for ri, row_id in enumerate(ids):
            for si in range(len(shards)):
                count = int(inter[ri, si])
                cnt = int(row_counts[ri, si]) if need_rc else count
                if cnt <= 0 or count == 0:
                    continue
                if tanimoto:
                    tan = math.ceil(count * 100.0 / (cnt + int(src_counts[si]) - count))
                    if tan <= tanimoto:
                        continue
                elif cnt < thr or count < thr:
                    continue
                pairs[row_id] = pairs.get(row_id, 0) + count
        return sort_pairs([Pair(id=r, count=n) for r, n in pairs.items()])

    def _topn_ranked(self, index, field_name, shards, src_call,
                     topn_opt: TopOptions, deadline=None) -> List[Pair]:
        """Phase 1: each shard's candidates come from its rank cache; the
        filter intersections for the union of candidates run as K2 passes
        over all shards at once, and each fragment replays the reference
        heap selection (tanimoto and attr filter included) from the
        precomputed counts (fragment.go:899-990)."""
        frags = []
        union: List[int] = []
        seen = set()
        for s in shards:
            frag = self._fragment(index, field_name, VIEW_STANDARD, s)
            if frag is None:
                continue
            cands = frag.top_candidates(topn_opt)
            frags.append((frag, cands))
            for r, _ in cands:
                if r not in seen:
                    seen.add(r)
                    union.append(r)
        if not frags or not union:
            return []
        shard_list = [f.shard for f, _ in frags]
        inter_by_shard: Dict[int, Dict[int, int]] = {s: {} for s in shard_list}
        src_count_by_shard: Dict[int, int] = {}
        chunk_rows = _topn_chunk(len(shard_list))
        for i in range(0, len(union), chunk_rows):
            if i:
                self._check_chunk_deadline(deadline, "between TopN chunks")
            chunk = union[i:i + chunk_rows]
            _, inter, src_counts = self._topn_counts_laddered(
                index, field_name, chunk, shard_list, src_call, False)
            for si, s in enumerate(shard_list):
                src_count_by_shard[s] = int(src_counts[si])
            for ri, r in enumerate(chunk):
                for si, s in enumerate(shard_list):
                    inter_by_shard[s][r] = int(inter[ri, si])
        out = []
        for frag, cands in frags:
            counts = {r: inter_by_shard[frag.shard].get(r, 0) for r, _ in cands}
            out.extend(frag.top(topn_opt, inter_counts=counts,
                                src_count=src_count_by_shard[frag.shard]))
        return sort_pairs(add_pairs([], out))

    def _execute_topn_shard(self, index: str, c: Call, shard: int) -> List[Pair]:
        field_name = c.args.get("_field") or DEFAULT_FIELD
        src = None
        if c.children:
            src = self._execute_bitmap_call_shard(index, c.children[0], shard)
        frag = self._fragment(index, field_name, VIEW_STANDARD, shard)
        if frag is None:
            return []
        return frag.top(TopOptions(
            n=c.uint_arg("n")[0],
            src=src,
            row_ids=self._uint_slice_arg(c, "ids"),
            min_threshold=c.uint_arg("threshold")[0] or DEFAULT_MIN_THRESHOLD,
            filter_name=c.args.get("attrName", ""),
            filter_values=c.args.get("attrValues") or [],
            tanimoto_threshold=c.uint_arg("tanimotoThreshold")[0],
        ))

    @staticmethod
    def _uint_slice_arg(c: Call, key: str) -> List[int]:
        v = c.args.get(key)
        if v is None:
            return []
        if not isinstance(v, list):
            raise QueryError(f"invalid call.Args[{key}]: {v!r}")
        return [int(x) for x in v]

    # --------------------------------------------------------------- writes

    def _forward_tolerant(self, node, send, errors, note_app_error,
                          what: str = "", hint=None):
        """THE per-target write-tolerance step (one implementation for
        the single-shard and the group fan-outs): breaker short-circuit
        (don't pay a connect timeout per write; an elapsed backoff makes
        this forward the half-open probe), transport-vs-4xx
        classification — a 4xx means the replica is alive and rejected
        the write, which is transport-level SUCCESS for the breaker (a
        half-open probe must re-close, not wedge) but is handed to
        `note_app_error` so the caller surfaces the divergence only
        after every other owner got its forward — and health recording.
        Returns the forward's result on success, None otherwise (errors
        are appended, never raised).

        `hint` (hinted handoff, cluster/hints.py) is a callable(node) ->
        bool that appends this write's captured op batch to the peer's
        durable hint log; it runs when the forward is skipped at the
        breaker or fails at the transport, so a dead replica costs an
        O(batch) disk append — never a connect timeout — and the missed
        write replays when the peer returns. While a peer has UNDELIVERED
        hints, later writes append behind them even though the breaker
        would admit a send: per-peer FIFO keeps replay order identical to
        coordinator apply order, so a drain can never resurrect a bit
        that a post-recovery write already cleared. A hinted forward
        still counts as NOT applied for write-consistency accounting."""
        from .server.client import ClientError

        if hint is not None and self.hints is not None \
                and self.hints.pending(node.id):
            if hint(node):
                self._count_stat("WriteForwardHinted")
                errors.append(
                    f"{node.id}{what}: hinted (queued behind pending "
                    "handoff)")
                return None
            # Hint append refused (byte budget / disk fault): fall through
            # to the direct forward — applying out of order beats dropping
            # the write, and anti-entropy owns the reconciliation either
            # way (the refused append flagged the shard for priority sync).
        if not self.health.allow_request(node.id):
            self._count_stat("WriteForwardSkipped")
            if hint is not None and hint(node):
                self._count_stat("WriteForwardHinted")
                errors.append(
                    f"{node.id}{what}: unavailable (breaker open; hinted)")
            else:
                errors.append(f"{node.id}{what}: unavailable (breaker open)")
            return None
        try:
            res = send(node)
        except ClientError as e:
            if not _is_node_failure(e):
                self.health.record_success(node.id)
                note_app_error(e)
                errors.append(f"{node.id}: {e}")
                return None
            self.health.record_failure(node.id)
            self._count_stat("WriteForwardFailed")
            if hint is not None and hint(node):
                self._count_stat("WriteForwardHinted")
            errors.append(f"{node.id}: {e}")
            return None
        self.health.record_success(node.id)
        return res if res is not None else True

    def _write_required(self, n_owners: int) -> int:
        """Owners that must APPLY before a write acks ([replication]
        write-consistency): 1 without config (the reference behavior)."""
        cfg = self.replication_config
        return 1 if cfg is None else cfg.required_owners(n_owners)

    def _write_level(self) -> str:
        cfg = self.replication_config
        return "one" if cfg is None else cfg.write_consistency

    def tolerant_owner_fanout(self, index: str, shard: int, remote: bool,
                              local_fn, forward_fn, on_forward_ok=None,
                              hint=None):
        """THE write-tolerance policy, shared by PQL writes and bulk
        imports (executor.go:1109): apply locally FIRST (arming the
        caller's hint capture with this write's op bytes), forward to
        every other owner, hint-or-skip dead owners (hinted handoff
        replays the miss when the peer returns; anti-entropy remains the
        backstop), finish the whole loop before surfacing a deterministic
        4xx rejection (so one lagging replica cannot cause extra
        divergence on the others), then gate the ack on the configured
        write-consistency level: a write that applied on fewer owners
        than `one|quorum|all` requires surfaces as a typed retryable 503
        (errors.WriteConsistencyError) AFTER hints were enqueued for the
        missed owners — the applied copies stand, there is no rollback
        (docs/durability.md "Write-path consistency").

        Live-rebalance cutovers surface here as ShardMovedError (the
        local fragment froze) or a 409 from a frozen remote owner: the
        write re-routes on refreshed placement — re-applying to an owner
        that already took it is an idempotent set/clear — and keeps
        retrying up to `cutover_wait` while the commit broadcast lands,
        so a write racing the cutover follows the shard to its new owner
        instead of failing. Past the cap it surfaces clean (retryable)."""
        from .errors import ShardMovedError, WriteConsistencyError

        deadline = _time.monotonic() + (0.0 if remote else
                                        max(self.cutover_wait, 0.0))
        while True:
            try:
                applied, total, errors = self._owner_fanout_once(
                    index, shard, remote, local_fn, forward_fn,
                    on_forward_ok, hint)
            except PilosaError as e:
                mid_cutover = isinstance(e, ShardMovedError) or (
                    getattr(e, "status", 0) == 409)
                if not mid_cutover or _time.monotonic() >= deadline:
                    raise
                if self.holder.stats is not None:
                    self.holder.stats.count("CutoverWriteWait", 1)
                _time.sleep(0.02)
                continue
            if remote:
                # Forwarded leg: the COORDINATOR owns level accounting
                # (our `applied` counts the forwarder's owners as
                # fictitious applies).
                return
            required = self._write_required(total)
            if applied < required:
                self._count_stat("WriteConsistencyUnmet")
                raise WriteConsistencyError(
                    f"applied on {applied}/{total} owners of {index}/"
                    f"shard {shard}, level {self._write_level()!r} "
                    f"requires {required}: " + "; ".join(errors),
                    level=self._write_level(), required=required,
                    applied=applied,
                )
            return

    def _owner_fanout_once(self, index, shard, remote, local_fn, forward_fn,
                           on_forward_ok, hint=None):
        """One fan-out pass; returns (applied, n_owners, errors)."""
        applied = 0
        errors = []
        app_error = [None]

        def note(e):
            app_error[0] = app_error[0] or e

        owners = self.cluster.shard_nodes(index, shard)
        if remote and not any(n.id == self.node.id for n in owners):
            # A forwarded write for a shard this node no longer serves
            # (the sender routed under a pre-cutover placement). The old
            # behavior — count every non-self owner as applied-by-
            # forwarder and ack — SILENTLY DROPPED the write: zero
            # fragments were touched. Raise instead (HTTP 409) so the
            # sender re-routes to the shard's current owner.
            from .errors import ShardMovedError

            raise ShardMovedError(
                f"{index}/shard {shard} is not served by this node")
        # Local apply first (stable otherwise): the caller's hint capture
        # is filled by the local apply, and a forward can miss — and need
        # those bytes — at ANY position in the owner walk. Replicas have
        # no ordering contract among themselves, so the reorder is free.
        for node in sorted(owners, key=lambda n: n.id != self.node.id):
            if node.id == self.node.id:
                local_fn()
                applied += 1
                continue
            if remote:
                applied += 1  # forwarding node already counted the write
                continue
            res = self._forward_tolerant(node, forward_fn, errors, note,
                                         hint=hint)
            if res is None:
                continue
            applied += 1
            if on_forward_ok is not None:
                on_forward_ok(res if res is not True else None)
        if app_error[0] is not None:
            raise app_error[0]
        return applied, len(owners), errors

    def tolerant_group_fanout(self, index: str, shards, remote: bool,
                              apply_local, send_remote,
                              workers: int = 1) -> None:
        """Bulk-import fan-out for MANY shard batches at once: the same
        write-tolerance policy as tolerant_owner_fanout (dead replicas
        skipped + marked, deterministic rejections surfaced only after
        every batch got its chance, failure only when a shard reached NO
        owner), but parallel — local applies run across the worker pool
        and remote forwards are batched PER PEER: one task per node
        streams that node's shard batches sequentially over its
        keep-alive connection while different nodes (and local applies)
        proceed concurrently. `workers` caps how much of the shared pool
        one import may occupy, so a huge load can't starve query fan-out
        of threads. apply_local(shard) / send_remote(node, shard).

        Hinted handoff + consistency: local applies run under hint
        capture (core/fragment.py), and the local wave completes BEFORE
        any remote forward is attempted — a forward that then misses
        enqueues the shard's captured op batch for the dead peer (a shard
        with no local replica degrades to a sync-priority marker). After
        the loop, the same [replication] write-consistency gate as the
        single-shard fan-out applies PER SHARD: any shard under its level
        raises a typed retryable 503 (hints already enqueued, no
        rollback)."""
        import threading

        from .core.fragment import capture_hint_ops

        # Placement resolved up front: one routing decision per import.
        plan = {int(s): self.cluster.shard_nodes(index, int(s)) for s in shards}
        if remote:
            from .errors import ShardMovedError

            for shard, owners in plan.items():
                if not any(n.id == self.node.id for n in owners):
                    # Same silent-drop hazard as the single-shard fanout:
                    # a forwarded batch for a migrated-away shard must
                    # 409 so the sender re-routes, not ack into the void.
                    raise ShardMovedError(
                        f"{index}/shard {shard} is not served by this node")
        applied = {s: 0 for s in plan}
        errors: List[str] = []
        app_error: List[Optional[Exception]] = [None]
        captured: Dict[int, list] = {}  # shard -> [(frag, op_bytes)]
        mu = threading.Lock()

        local_shards: List[int] = []
        node_work: Dict[str, tuple] = {}  # node.id -> (node, [shards])
        for shard, owners in plan.items():
            for node in owners:
                if node.id == self.node.id:
                    local_shards.append(shard)
                elif remote:
                    applied[shard] += 1  # forwarding node counted the write
                else:
                    node_work.setdefault(node.id, (node, []))[1].append(shard)

        def run_local(shard):
            rec: list = []
            try:
                with capture_hint_ops(rec):
                    apply_local(shard)
            except Exception as e:
                # Local failures are deterministic (validation, storage
                # fault): surface after the loop like a replica's 4xx, so
                # one bad batch can't abort the others mid-flight.
                with mu:
                    app_error[0] = app_error[0] or e
                    errors.append(f"local/shard {shard}: {e}")
                return
            with mu:
                captured[shard] = rec
                applied[shard] += 1

        def note_app_error(e):
            with mu:
                app_error[0] = app_error[0] or e

        def hint_for(shard):
            def hint(node):
                if self.hints is None:
                    return False
                with mu:
                    rec = captured.get(shard)
                return self.hints.add(node.id, index, shard, rec)
            return hint

        def run_node(node, shard_list):
            # The per-target tolerance step is _forward_tolerant — the
            # SAME implementation tolerant_owner_fanout uses, so the two
            # fan-outs cannot drift apart on breaker/4xx/hint semantics.
            for shard in shard_list:
                local_errs: List[str] = []
                res = self._forward_tolerant(
                    node, lambda n, s=shard: send_remote(n, s),
                    local_errs, note_app_error, what=f"/shard {shard}",
                    hint=hint_for(shard))
                with mu:
                    errors.extend(local_errs)
                    if res is not None:
                        applied[shard] += 1

        # Two waves — all local applies, THEN remote forwards: a forward
        # can only hint op bytes its shard's local apply has already
        # captured. Locals still parallelize among themselves and per-peer
        # streams still overlap each other; only the local->remote overlap
        # is given up, and that was already bounded by `workers` waves.
        for tasks in ([(run_local, (s,)) for s in local_shards],
                      [(run_node, nw) for nw in node_work.values()]):
            if self._pool is None or workers <= 1 or len(tasks) <= 1:
                for fn, args in tasks:
                    fn(*args)
            else:
                # Bounded waves rather than one submit-all: `workers` caps
                # this import's occupancy of the shared pool.
                cap = max(1, workers)
                for i in range(0, len(tasks), cap):
                    futs = [self._pool.submit(fn, *args)
                            for fn, args in tasks[i:i + cap]]
                    for f in futs:
                        f.result()  # worker exceptions captured inside

        if app_error[0] is not None:
            raise app_error[0]
        if remote:
            # Forwarded leg: the coordinator owns level accounting.
            return
        from .errors import WriteConsistencyError

        under = sorted(
            s for s, n in applied.items()
            if n < self._write_required(len(plan[s])))
        if under:
            self._count_stat("WriteConsistencyUnmet")
            raise WriteConsistencyError(
                f"import applied under level {self._write_level()!r} on "
                f"{index}/shards {under}: " + "; ".join(errors),
                level=self._write_level(),
            )

    def _for_shard_owners(self, index: str, c: Call, shard: int, opt: ExecOptions, local_fn):
        """Apply a PQL write locally and forward to other owners — the
        shared tolerant fan-out with query_node as the transport. The
        local apply runs under a hint capture (core/fragment.py), so a
        missed forward hands the peer's hint log the exact WAL op bytes
        this write produced — every view the write touched (standard plus
        time-quantum views) rides along with no re-derivation."""
        from .core.fragment import capture_hint_ops

        out = {"ret": False}
        captured: list = []

        def local():
            captured.clear()  # cutover retries must not double the batch
            with capture_hint_ops(captured):
                if local_fn():
                    out["ret"] = True

        def forward(node):
            return self.client.query_node(node, index, str(c), remote=True)

        def note(res):
            if res and isinstance(res[0], bool):
                out["ret"] = out["ret"] or res[0]

        def hint(node):
            if self.hints is None:
                return False
            return self.hints.add(node.id, index, shard, captured)

        self.tolerant_owner_fanout(
            index, shard, opt.remote, local, forward, on_forward_ok=note,
            hint=hint,
        )
        return out["ret"]

    def _execute_set_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        field_name = c.field_arg()
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        fld = idx.field(field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError("Set() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError("Set() column argument required")
        timestamp = None
        ts = c.args.get("_timestamp")
        if isinstance(ts, str):
            timestamp = parse_timestamp(ts)
        shard = col_id // SHARD_WIDTH
        return self._for_shard_owners(
            index, c, shard, opt, lambda: fld.set_bit(row_id, col_id, timestamp)
        )

    def _execute_clear_bit(self, index: str, c: Call, opt: ExecOptions) -> bool:
        field_name = c.field_arg()
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        fld = idx.field(field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError("Clear() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError("Clear() column argument required")
        shard = col_id // SHARD_WIDTH
        return self._for_shard_owners(
            index, c, shard, opt, lambda: fld.clear_bit(row_id, col_id)
        )

    def _execute_set_value(self, index: str, c: Call, opt: ExecOptions) -> None:
        col_id, ok = c.uint_arg("col")
        if not ok:
            # Message parity: executor_test.go:451-458.
            raise QueryError("SetValue() column field 'col' required")
        args = {k: v for k, v in c.args.items() if k != "col"}
        for name, value in args.items():
            fld = self.holder.field(index, name)
            if fld is None:
                raise FieldNotFoundError(name)
            if not isinstance(value, int) or isinstance(value, bool):
                # pilosa.go:42 ErrInvalidBSIGroupValueType.
                raise QueryError("invalid bsigroup value type")
            fld.set_value(col_id, value)
        self._forward_to_all(index, c, opt)

    def _execute_set_row_attrs(self, index: str, c: Call, opt: ExecOptions) -> None:
        field_name = c.args.get("_field")
        fld = self.holder.field(index, field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg("_row")
        if not ok:
            raise QueryError("SetRowAttrs() row argument required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_field", "_row")}
        fld.row_attr_store.set_attrs(row_id, attrs)
        self._forward_to_all(index, c, opt)

    def _execute_set_column_attrs(self, index: str, c: Call, opt: ExecOptions) -> None:
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        col, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError("SetColumnAttrs() col argument required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_col", "field")}
        idx.column_attr_store.set_attrs(col, attrs)
        self._forward_to_all(index, c, opt)

    def _forward_to_all(self, index: str, c: Call, opt: ExecOptions) -> None:
        """Fan a write out to every node. The local apply already succeeded,
        so dead peers are marked unavailable and skipped rather than failing
        the request (anti-entropy converges them later); previously one dead
        peer made every attr/value write block on a client timeout and raise."""
        from .server.client import ClientError

        if opt.remote:
            return
        app_error = None
        for node in self.cluster.nodes:
            if node.id == self.node.id:
                continue
            if not self.health.allow_request(node.id):
                self._count_stat("WriteForwardSkipped")
                continue
            try:
                self.client.query_node(node, index, str(c), remote=True)
            except ClientError as e:
                if not _is_node_failure(e):
                    # Deterministic rejection by a live peer: transport
                    # success for the breaker; finish the fan-out (don't
                    # widen divergence), then surface it.
                    self.health.record_success(node.id)
                    app_error = app_error or e
                    continue
                self.health.record_failure(node.id)
                self._count_stat("WriteForwardFailed")
            else:
                self.health.record_success(node.id)
        if app_error is not None:
            raise app_error

    # ---------------------------------------------------------- translation

    def _translate_call(self, index: str, idx, c: Call) -> None:
        """Translate string keys to ids in-place (executor.go:1595-1659).

        Mirrors the reference's key selection exactly: Set/Clear/Row use the
        positional column arg and the field-named row arg; every other call
        uses literal 'col'/'row' args with the field taken from a 'field'
        arg — so e.g. SetValue(col=10, f="x") is NOT key-translated and
        falls through to the BSI type check (executor_test.go:461-466)."""
        store = self.translate_store
        if store is not None:
            if c.name in ("Set", "Clear", "Row"):
                col_key = "_col"
                # Reference ignores FieldArg errors here (fieldName, _ =
                # c.FieldArg()); a missing field is rejected at execution
                # time, not during translation.
                try:
                    field_name = c.field_arg()
                except QueryError:
                    field_name = None
                row_key = field_name
            else:
                col_key = "col"
                # callArgString semantics: a non-string `field` arg reads as
                # "" in the reference, so row translation is skipped and the
                # call is rejected later — not a FieldNotFoundError here.
                fv = c.args.get("field")
                field_name = fv if isinstance(fv, str) else None
                row_key = "row"

            col = c.args.get(col_key)
            if idx.keys():
                if col is not None and not isinstance(col, str):
                    raise QueryError(
                        "column value must be a string when index 'keys' option enabled"
                    )
                if isinstance(col, str) and col != "":
                    # Empty keys are not translated (callArgString != ""
                    # guard); the later uint-arg check rejects the call.
                    c.args[col_key] = store.translate_columns_to_uint64(index, [col])[0]
            elif isinstance(col, str):
                raise QueryError(
                    "string 'col' value not allowed unless index 'keys' option enabled"
                )

            if field_name:
                fld = idx.field(field_name)
                if fld is None:
                    raise FieldNotFoundError(field_name)
                row = c.args.get(row_key)
                if fld.keys():
                    if row is not None and not isinstance(row, str):
                        raise QueryError(
                            "row value must be a string when field 'keys' option enabled"
                        )
                    if isinstance(row, str) and row != "":
                        c.args[row_key] = store.translate_rows_to_uint64(
                            index, field_name, [row]
                        )[0]
                elif isinstance(row, str):
                    raise QueryError(
                        "string 'row' value not allowed unless field 'keys' option enabled"
                    )
        for child in c.children:
            self._translate_call(index, idx, child)

    def _translate_result(self, index: str, idx, c: Call, result):
        store = self.translate_store
        if store is None:
            return result
        if isinstance(result, Row) and idx.keys():
            result.keys = store.translate_columns_to_string(
                index, [int(x) for x in result.columns()]
            )
        if isinstance(result, list) and result and isinstance(result[0], Pair):
            field_name = c.args.get("_field")
            fld = idx.field(field_name) if field_name else None
            if fld is not None and fld.keys():
                result = [
                    Pair(id=p.id, count=p.count,
                         key=store.translate_row_to_string(index, field_name, p.id))
                    for p in result
                ]
        return result
