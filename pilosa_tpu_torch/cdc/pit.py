"""Point-in-time reads: materialize historical fragments from the CDC
log's base images + op replay.

A query carrying at-position P sees each fragment as

    base image (exact at its cut position)  +  replay of every retained
    record of that fragment with position <= P

which is bit-exact with a fragment that simply stopped writing at P:
the base holds exactly this fragment's ops with position <= cut_pos,
replaying records below the cut re-applies idempotent set/clear to the
same state, and records in (cut_pos, P] land in position order — the
apply order, because appends happen under the fragment mutex.

Materialized fragments are pathless, immutable after seal, and cached
in a small LRU (cdc.pit-cache entries) keyed by (index, incarnation,
field, view, shard, position) — immutability means the cache never
needs invalidation, and the incarnation key retires entries of a
deleted+recreated index for free.

Jax-free (pilint R2). In the port a materialized fragment lives on the
live holder's device, so a point-in-time Count on the card counts its
planes there (K2 through Row.count), never quietly on the CPU.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..errors import CdcGoneError


class PitCache:
    def __init__(self, manager, capacity: int):
        self.manager = manager
        self.capacity = max(1, int(capacity))
        self._mu = threading.Lock()
        self._cache: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def materialize(self, index: str, field: str, view: str, shard: int,
                    position: int):
        from ..core.fragment import Fragment

        log = self.manager.require_log(index)
        key = (index, log.incarnation, field, view, shard, position)
        with self._mu:
            got = self._cache.get(key)
            if got is not None:
                self._cache.move_to_end(key)
                self.hits += 1
                return got
            self.misses += 1
        # Base image and replay tail in ONE log-lock critical section
        # (410s when P itself fell behind the fold line): a compaction
        # between separate base()/records_for() calls could fold
        # records into a newer base and drop them from the log, leaving
        # the folded span in neither the stale base read first nor the
        # tail read second.
        base, ops = log.base_and_records_for(field, view, shard, position)
        if base is not None and base[0] > position:
            # The base was cut AFTER the requested position (data that
            # predates change capture, or a fold past it): the state at
            # P is not reconstructible from what we kept.
            raise CdcGoneError(
                f"position {position} of {index}/{field}/{view}/{shard} "
                f"predates the retained history (base image cut at "
                f"{base[0]})",
                first=base[0], last=log.last_pos,
                incarnation=log.incarnation)
        holder = self.manager.holder
        if holder is None:
            # The server wires the holder before any query can arrive; a
            # manager without one has no device to build planes on, and
            # a default would put them on the CPU whatever the holder's.
            raise RuntimeError("point-in-time read before the CDC manager has a holder")
        frag = Fragment(None, index, field, view, shard, device=holder.device)
        frag.open()
        if base is not None:
            frag.migrate_install(base[1])
        if ops:
            frag.migrate_apply_ops(ops)
        frag.migrate_seal()
        with self._mu:
            self._cache[key] = frag
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
                self.evictions += 1
        return frag

    def __len__(self) -> int:
        with self._mu:
            return len(self._cache)

    def snapshot(self) -> dict:
        with self._mu:
            return {"entries": len(self._cache), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


class HistoricalHolder:
    """Holder facade for at-position execution: schema lookups (index,
    field — metadata) delegate to the live holder, fragment lookups
    materialize through the PIT cache. Live shards with no retained
    history at P materialize from their base image or empty — exactly
    the fragment's state at that position."""

    def __init__(self, holder, manager, index: str, position: int):
        self._holder = holder
        self._manager = manager
        self._index = index
        self._position = position
        self.stats = holder.stats
        self.device = holder.device

    def index(self, name: str):
        return self._holder.index(name)

    def field(self, index: str, name: str):
        return self._holder.field(index, name)

    def fragment(self, index: str, field: str, view: str, shard: int):
        f = self._holder.field(index, field)
        if f is None:
            return None
        v = f.view(view)
        if v is None:
            return None
        if v.fragment(shard) is None:
            # Never existed live either: nothing to time-travel.
            return None
        return self._manager.historical_fragment(
            index, field, view, shard, self._position)
