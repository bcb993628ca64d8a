"""PQL executor: single-node execution of the read hot path.

Port of the local half of pilosa_tpu/executor.py (itself a port of
reference executor.go): Set / Clear writes, Row / Intersect / Union
/ Difference / Xor bitmaps, Count of such trees, and two-phase TopN
(executor.go:524-560) with an optional filter. Bitmap and Count calls run
over all shards at once on the device engine (parallel/engine.py); TopN
without a filter ranks from the fragments' host rank caches, as the JAX
package does, and TopN with a filter counts the candidate rows against
the filter with the masked_plane_counts kernel.

Everything else the JAX executor serves — Sum/Min/Max, BSI and time
Ranges, attribute writes, key translation, cluster fan-out, the
collective plane, the device-fault ladder — raises a QueryError saying it
is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from .constants import MAX_WRITES_PER_REQUEST, VIEW_STANDARD, WORDS_PER_ROW
from .core.cache import Pair, add_pairs, sort_pairs
from .core.fragment import TopOptions
from .core.holder import Holder
from .core.row import Row
from .errors import (
    FieldNotFoundError,
    IndexNotFoundError,
    PilosaError,
    QueryError,
    TooManyWritesError,
)
from .parallel.engine import ShardedQueryEngine
from .pql import parser as pql_parser
from .pql.ast import Call
from .timeq import parse_timestamp

DEFAULT_FIELD = "general"
DEFAULT_MIN_THRESHOLD = 1

_WRITE_CALLS = {"Set", "Clear", "SetValue", "SetRowAttrs", "SetColumnAttrs"}
_BITMAP_CALLS = {"Row", "Intersect", "Union", "Difference", "Xor"}


def _topn_chunk(n_shards: int) -> int:
    """Candidate rows per TopN kernel pass, bounded by BYTES not rows
    (each row costs n_shards * 128 KiB in the stacked tensor): the byte
    budget PILOSA_TOPN_CHUNK_BYTES (default 2 GiB), floored at one row."""
    budget = int(os.environ.get("PILOSA_TOPN_CHUNK_BYTES", 2 << 30))
    return max(1, min(512, budget // max(1, n_shards * WORDS_PER_ROW * 4)))


def _not_ported(what: str) -> QueryError:
    return QueryError(f"{what} is not ported to the PyTorch/CUDA executor yet")


class Executor:
    def __init__(self, holder: Holder,
                 max_writes_per_request: int = MAX_WRITES_PER_REQUEST,
                 engine_config=None):
        self.holder = holder
        self.max_writes_per_request = max_writes_per_request
        self.engine = ShardedQueryEngine(holder, config=engine_config)

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
        for v in c.args.values():
            if isinstance(v, str) and c.name in ("Set", "Clear", "Row"):
                raise _not_ported("key translation (string row/column)")
        for child in c.children:
            self._check_untranslated(idx, child)

    def _execute_call(self, index: str, c: Call, shards: List[int]):
        if c.name == "Count":
            return self._execute_count(index, c, shards)
        if c.name == "Set":
            return self._execute_set_bit(index, c)
        if c.name == "Clear":
            return self._execute_clear_bit(index, c)
        if c.name == "TopN":
            return self._execute_topn(index, c, shards)
        if c.name in _BITMAP_CALLS:
            return self._execute_bitmap_call(index, c, shards)
        raise _not_ported(f"{c.name}()")

    # ------------------------------------------------------------- bitmaps

    def _execute_bitmap_call(self, index: str, c: Call, shards: List[int]) -> Row:
        row = self.engine.bitmap(index, c, shards) if shards else Row()
        if c.name == "Row":
            fld = self.holder.field(index, c.field_arg())
            if fld is not None:
                row_id, ok = c.uint_arg(c.field_arg())
                if ok:
                    row.attrs = fld.row_attr_store.attrs(row_id)
        return row

    # --------------------------------------------------------------- count

    def _execute_count(self, index: str, c: Call, shards: List[int]) -> int:
        if len(c.children) == 0:
            raise QueryError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise QueryError("Count() only accepts a single bitmap input")
        child = c.children[0]
        if child.name not in _BITMAP_CALLS:
            raise _not_ported(f"Count({child.name}())")
        if not shards:
            return 0
        return self.engine.count(index, child, shards)

    # ----------------------------------------------------------------- TopN

    def _execute_topn(self, index: str, c: Call, shards: List[int]) -> List[Pair]:
        ids_arg = self._uint_slice_arg(c, "ids")
        n, _ = c.uint_arg("n")
        if c.args.get("attrName") or c.args.get("tanimotoThreshold"):
            raise _not_ported("TopN attribute and tanimoto filters")
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
        field_name = c.args.get("_field") or DEFAULT_FIELD
        ids = self._uint_slice_arg(c, "ids")
        if len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")
        src_call = c.children[0] if c.children else None
        if src_call is not None and src_call.name not in _BITMAP_CALLS:
            raise _not_ported(f"TopN over {src_call.name}()")
        thr = max(c.uint_arg("threshold")[0], DEFAULT_MIN_THRESHOLD)
        n_arg, _ = c.uint_arg("n")

        if src_call is None:
            # No filter: ranks come from each fragment's host rank cache
            # (exact counts) — no device work, as in the JAX package.
            out: List[Pair] = []
            for s in shards:
                frag = self.holder.fragment(index, field_name, VIEW_STANDARD, s)
                if frag is None:
                    continue
                out = add_pairs(out, frag.top(TopOptions(
                    n=n_arg, row_ids=ids, min_threshold=thr)))
            return sort_pairs(out)

        if ids:
            # Phase 2: every candidate's per-shard count against the
            # filter, one K2 pass over the stacked candidate rows.
            _, inter, _ = self.engine.topn_shard_counts(
                index, field_name, ids, shards, src_call,
                need_row_counts=False)
            pairs: Dict[int, int] = {}
            for ri, row_id in enumerate(ids):
                for si in range(len(shards)):
                    count = int(inter[ri, si])
                    if count == 0 or count < thr:
                        continue
                    pairs[row_id] = pairs.get(row_id, 0) + count
            return sort_pairs([Pair(id=r, count=n) for r, n in pairs.items()])

        # Phase 1: each shard's candidates come from its rank cache; the
        # filter intersections for the union of candidates run as K2
        # passes over all shards at once, and each fragment replays the
        # reference heap selection from the precomputed counts
        # (fragment.go:899-990).
        topn_opt = TopOptions(n=n_arg, min_threshold=thr)
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
            _, inter, src_counts = self.engine.topn_shard_counts(
                index, field_name, chunk, shard_list, src_call,
                need_row_counts=False)
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
