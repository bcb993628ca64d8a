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

Not ported yet: key translation, cluster fan-out and write forwarding,
the collective plane and the micro-batcher; keys raise a QueryError
saying so.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from .constants import (
    MAX_WRITES_PER_REQUEST,
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
from .ops.bitplane import compose_bits
from .parallel.device_health import DeviceDispatchError
from .parallel.engine import ShardedQueryEngine
from .pql import parser as pql_parser
from .pql.ast import BETWEEN, GT, GTE, LT, LTE, NEQ, Call, Condition
from .timeq import parse_timestamp, views_by_time_range

log = logging.getLogger(__name__)

DEFAULT_FIELD = "general"
DEFAULT_MIN_THRESHOLD = 1

_WRITE_CALLS = {"Set", "Clear", "SetValue", "SetRowAttrs", "SetColumnAttrs"}
# String arguments that are times, not keys.
_TIME_ARGS = ("_timestamp", "_start", "_end")
_NARY_SHARD_OPS = {"Difference": "difference", "Intersect": "intersect",
                   "Union": "union", "Xor": "xor"}


def _topn_chunk(n_shards: int) -> int:
    """Candidate rows per TopN kernel pass, bounded by BYTES not rows
    (each row costs n_shards * 128 KiB in the stacked tensor): the byte
    budget PILOSA_TOPN_CHUNK_BYTES (default 2 GiB), floored at one row."""
    budget = int(os.environ.get("PILOSA_TOPN_CHUNK_BYTES", 2 << 30))
    return max(1, min(512, budget // max(1, n_shards * WORDS_PER_ROW * 4)))


def _not_ported(what: str) -> QueryError:
    return QueryError(f"{what} is not ported to the PyTorch/CUDA executor yet")


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


class Executor:
    def __init__(self, holder: Holder,
                 max_writes_per_request: int = MAX_WRITES_PER_REQUEST,
                 engine_config=None, tier_config=None, resilience_config=None):
        self.holder = holder
        self.max_writes_per_request = max_writes_per_request
        self.engine = ShardedQueryEngine(
            holder, config=engine_config, tier_config=tier_config,
            resilience_config=resilience_config)

    def close(self) -> None:
        self.engine.close()

    # ------------------------------------------------------------- execute

    def execute(self, index: str, query,
                shards: Optional[Sequence[int]] = None) -> List[Any]:
        if not index:
            raise PilosaError("index required")
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        if isinstance(query, str):
            query = pql_parser.parse(query)
        if self.max_writes_per_request > 0 and len(query.write_calls()) > self.max_writes_per_request:
            raise TooManyWritesError(
                f"too many writes: {len(query.write_calls())} > {self.max_writes_per_request}"
            )
        for call in query.calls:
            self._check_untranslated(idx, call)
        needs_shards = any(c.name not in _WRITE_CALLS for c in query.calls)
        if not shards and needs_shards:
            shards = list(range(idx.max_shard() + 1))
        shards = list(shards or [])
        return [self._execute_call(index, call, shards)
                for call in query.calls]

    def _check_untranslated(self, idx, c: Call) -> None:
        """Key translation is not ported: string keys raise instead of
        being silently treated as ids."""
        if idx.keys():
            raise _not_ported("key translation (index 'keys' option)")
        if c.name in ("Set", "Clear", "Row") and any(
                isinstance(v, str) for k, v in c.args.items() if k not in _TIME_ARGS):
            raise _not_ported("key translation (string row/column)")
        for child in c.children:
            self._check_untranslated(idx, child)

    def _execute_call(self, index: str, c: Call, shards: List[int]):
        if c.name in ("Sum", "Min", "Max"):
            return self._execute_val_count(index, c, shards, c.name.lower())
        if c.name == "Count":
            return self._execute_count(index, c, shards)
        if c.name == "Set":
            return self._execute_set_bit(index, c)
        if c.name == "Clear":
            return self._execute_clear_bit(index, c)
        if c.name == "SetValue":
            self._execute_set_value(index, c)
            return None
        if c.name == "SetRowAttrs":
            self._execute_set_row_attrs(index, c)
            return None
        if c.name == "SetColumnAttrs":
            self._execute_set_column_attrs(index, c)
            return None
        if c.name == "TopN":
            return self._execute_topn(index, c, shards)
        return self._execute_bitmap_call(index, c, shards)

    def _supports(self, index: str, c: Call, shards: List[int]):
        """The engine's compile gate; nothing to run over no shards."""
        return bool(shards) and self.engine.supports(c, index)

    @staticmethod
    def _map_reduce(shards: List[int], map_fn: Callable, reduce_fn: Callable):
        """The per-shard walk for trees the engine does not compile, and
        the ladder's rung for device work with no host twin: one shard at
        a time, reduced in shard order (None over no shards)."""
        result = None
        for shard in shards:
            v = map_fn(shard)
            result = v if result is None else reduce_fn(result, v)
        return result

    def _count_stat(self, name: str) -> None:
        """holder.stats.count guarded for library use (a holder opened
        without stats counts nothing)."""
        if self.holder.stats is not None:
            self.holder.stats.count(name, 1)

    def _fallback(self, what: str, e: DeviceDispatchError, rung: str) -> None:
        self._count_stat("DeviceLadderFallback")
        log.error("device %s dispatch failed (%s), serving it from the %s "
                  "rung: %s", what, e.kind, rung, e)

    def _batched_or_map_reduce(self, index: str, c: Call, shards: List[int],
                               kind: str, map_fn: Callable, reduce_fn: Callable,
                               child: Optional[Call] = None):
        """One device program over all shards when the tree compiles
        (kind "count" or "bitmap"), under the device-fault ladder: the
        breakers route a quarantined signature to the per-shard walk and
        an open plane to host execution before any device work, and a
        dispatch that fails mid-request falls one rung down for this
        query — the breakers make the routing sticky for the next."""
        target = child if child is not None else c
        plan = self._supports(index, target, shards)
        if not plan:
            return self._map_reduce(shards, map_fn, reduce_fn)
        eng = self.engine
        host_ok = kind == "count" and eng.host_supports(target)
        route = eng.route(plan.sig_tuple)
        if route == "shard":
            self._count_stat("DeviceSigQuarantined")
            return self._map_reduce(shards, map_fn, reduce_fn)
        if route == "host":
            self._count_stat("DeviceHostRouted")
            if host_ok:
                return eng.host_count(index, target, shards, plan=plan)
            return self._map_reduce(shards, map_fn, reduce_fn)
        try:
            if kind == "count":
                return eng.count(index, target, shards, plan=plan)
            return eng.bitmap(index, target, shards, plan=plan)
        except DeviceDispatchError as e:
            self._fallback(kind, e, "host" if host_ok else "shard")
            if host_ok:
                return eng.host_count(index, target, shards, plan=plan)
            return self._map_reduce(shards, map_fn, reduce_fn)

    # ------------------------------------------------------------- bitmaps

    def _execute_bitmap_call(self, index: str, c: Call, shards: List[int]) -> Row:
        def merge(prev: Row, v: Row) -> Row:
            prev.merge(v)
            return prev

        row = self._batched_or_map_reduce(
            index, c, shards, "bitmap",
            lambda s: self._execute_bitmap_call_shard(index, c, s), merge) or Row()
        if c.name == "Row":
            fld = self.holder.field(index, c.field_arg())
            if fld is not None:
                row_id, ok = c.uint_arg(c.field_arg())
                if ok:
                    row.attrs = fld.row_attr_store.attrs(row_id)
        return row

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
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
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
            frag = self.holder.fragment(index, field_name, view_name, shard)
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
        frag = self.holder.fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, shard)

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

    def _execute_count(self, index: str, c: Call, shards: List[int]) -> int:
        if len(c.children) == 0:
            raise QueryError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise QueryError("Count() only accepts a single bitmap input")
        child = c.children[0]
        result = self._batched_or_map_reduce(
            index, c, shards, "count",
            lambda s: self._execute_bitmap_call_shard(index, child, s).count(),
            lambda a, b: a + b, child=child)
        return int(result or 0)

    # --------------------------------------------------------- sum/min/max

    def _execute_val_count(self, index: str, c: Call, shards: List[int],
                           kind: str) -> ValCount:
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
                shards, lambda s: self._execute_val_count_shard(index, c, s, kind),
                reduce_fn) or ValCount()

        # The BSI scans are device programs with no host twin, so the
        # per-shard walk is their whole degraded ladder: an open plane
        # breaker takes it BEFORE any dispatch, and a dispatch failing
        # mid-request takes it for this query.
        if (bsig is not None
                and (self._supports(index, filter_call, shards)
                     if filter_call is not None else shards)
                and self.engine.route() == "device"):
            try:
                out = self.engine.bsi_val_count(
                    index, field_name, kind, bsig.bit_depth(), shards, filter_call)
                result = self._compose_bsi_result(bsig, kind, out)
            except DeviceDispatchError as e:
                self._fallback("BSI", e, "shard")
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
        frag = self.holder.fragment(index, field_name, VIEW_BSI_GROUP_PREFIX + field_name, shard)
        if frag is None:
            return ValCount()
        if kind == "sum":
            vsum, vcount = frag.sum(filter_row, bsig.bit_depth())
            return ValCount(val=vsum + vcount * bsig.min, count=vcount)
        v, cnt = getattr(frag, kind)(filter_row, bsig.bit_depth())
        return ValCount(val=v + bsig.min if cnt else 0, count=cnt)

    # ----------------------------------------------------------------- TopN

    def _execute_topn(self, index: str, c: Call, shards: List[int]) -> List[Pair]:
        ids_arg = self._uint_slice_arg(c, "ids")
        n, _ = c.uint_arg("n")
        pairs = self._execute_topn_shards(index, c, shards)
        if not pairs or ids_arg:
            return pairs
        # Phase 2: refetch full counts for the merged candidate ids
        # (executor.go:524-560).
        other = Call(c.name, dict(c.args), list(c.children))
        other.args["ids"] = sorted({p.id for p in pairs})
        trimmed = self._execute_topn_shards(index, other, shards)
        if n and len(trimmed) > n:
            trimmed = trimmed[:n]
        return trimmed

    def _execute_topn_shards(self, index: str, c: Call, shards: List[int]) -> List[Pair]:
        ids = self._uint_slice_arg(c, "ids")
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            raise QueryError("Tanimoto Threshold is from 1 to 100 only")
        if len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")
        src_call = c.children[0] if c.children else None

        def walk() -> List[Pair]:
            return sort_pairs(self._map_reduce(
                shards, lambda s: self._execute_topn_shard(index, c, s),
                add_pairs) or [])

        # Without a filter the host rank caches hold exact counts: the
        # per-shard walk needs no device work, as in the JAX package.
        if src_call is None or not self._supports(index, src_call, shards):
            return walk()
        field_name = c.args.get("_field") or DEFAULT_FIELD
        thr = max(c.uint_arg("threshold")[0], DEFAULT_MIN_THRESHOLD)
        attr_name = c.args.get("attrName", "")
        attr_values = c.args.get("attrValues") or []
        try:
            if ids:
                return self._topn_candidates(
                    index, field_name, ids, shards, src_call, thr, tanimoto,
                    attr_name, attr_values)
            return self._topn_ranked(index, field_name, shards, src_call, TopOptions(
                n=c.uint_arg("n")[0], min_threshold=thr, filter_name=attr_name,
                filter_values=attr_values, tanimoto_threshold=tanimoto))
        except DeviceDispatchError as e:
            # Last rung: neither the device nor the host evaluator could
            # serve the counts (a degraded plane and a source with no host
            # twin, such as a BSI Range): the per-shard TopN walk.
            self._fallback("TopN", e, "shard")
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
                return eng.topn_shard_counts(
                    index, field, ids, shards, src_call, need_row_counts=need_rc)
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
                     topn_opt: TopOptions) -> List[Pair]:
        """Phase 1: each shard's candidates come from its rank cache; the
        filter intersections for the union of candidates run as K2 passes
        over all shards at once, and each fragment replays the reference
        heap selection (tanimoto and attr filter included) from the
        precomputed counts (fragment.go:899-990)."""
        frags = []
        union: List[int] = []
        seen = set()
        for s in shards:
            frag = self.holder.fragment(index, field_name, VIEW_STANDARD, s)
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
        frag = self.holder.fragment(index, field_name, VIEW_STANDARD, shard)
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

    def _write_target(self, index: str, c: Call, what: str):
        field_name = c.field_arg()
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError(index)
        fld = idx.field(field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg(field_name)
        if not ok:
            raise QueryError(f"{what}() row argument required")
        col_id, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError(f"{what}() column argument required")
        return fld, row_id, col_id

    def _execute_set_bit(self, index: str, c: Call) -> bool:
        fld, row_id, col_id = self._write_target(index, c, "Set")
        timestamp = None
        ts = c.args.get("_timestamp")
        if isinstance(ts, str):
            timestamp = parse_timestamp(ts)
        return bool(fld.set_bit(row_id, col_id, timestamp))

    def _execute_clear_bit(self, index: str, c: Call) -> bool:
        fld, row_id, col_id = self._write_target(index, c, "Clear")
        return bool(fld.clear_bit(row_id, col_id))

    def _execute_set_value(self, index: str, c: Call) -> None:
        col_id, ok = c.uint_arg("col")
        if not ok:
            # Message parity: executor_test.go:451-458.
            raise QueryError("SetValue() column field 'col' required")
        for name, value in c.args.items():
            if name == "col":
                continue
            fld = self.holder.field(index, name)
            if fld is None:
                raise FieldNotFoundError(name)
            if not isinstance(value, int) or isinstance(value, bool):
                # pilosa.go:42 ErrInvalidBSIGroupValueType.
                raise QueryError("invalid bsigroup value type")
            fld.set_value(col_id, value)

    def _execute_set_row_attrs(self, index: str, c: Call) -> None:
        field_name = c.args.get("_field")
        fld = self.holder.field(index, field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        row_id, ok = c.uint_arg("_row")
        if not ok:
            raise QueryError("SetRowAttrs() row argument required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_field", "_row")}
        fld.row_attr_store.set_attrs(row_id, attrs)

    def _execute_set_column_attrs(self, index: str, c: Call) -> None:
        idx = self.holder.index(index)
        col, ok = c.uint_arg("_col")
        if not ok:
            raise QueryError("SetColumnAttrs() col argument required")
        attrs = {k: v for k, v in c.args.items() if k not in ("_col", "field")}
        idx.column_attr_store.set_attrs(col, attrs)
