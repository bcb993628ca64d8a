"""Per-fragment TopN row-count caches.

Behavioral port of the reference's cache.go: rankCache (sorted, trimmed,
throttled invalidation), lruCache, nopCache, plus the Pair/Pairs merge math
used by the cross-shard TopN reduce (cache.go:315-427).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..constants import DEFAULT_CACHE_SIZE

# Throttle for rank-cache re-sorting (reference cache.go:44 invalidate at most
# every 10 seconds).
RANK_CACHE_INVALIDATE_SECONDS = 10.0


@dataclass(frozen=True)
class Pair:
    id: int
    count: int
    key: str = ""

    def to_dict(self):
        d = {"id": self.id, "count": self.count}
        if self.key:
            d["key"] = self.key
        return d


def add_pairs(a: List[Pair], b: List[Pair]) -> List[Pair]:
    """Merge pair lists summing counts per id (reference cache.go:370 Pairs.Add)."""
    counts: Dict[int, int] = {}
    for p in a:
        counts[p.id] = counts.get(p.id, 0) + p.count
    for p in b:
        counts[p.id] = counts.get(p.id, 0) + p.count
    return [Pair(id=i, count=c) for i, c in counts.items()]


def sort_pairs(pairs: List[Pair]) -> List[Pair]:
    """Descending by count; ties broken by ascending id for determinism."""
    return sorted(pairs, key=lambda p: (-p.count, p.id))


class RankCache:
    """Keeps the top `max_entries` (row, count) pairs, sorted lazily."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE):
        self.max_entries = max_entries
        self.entries: Dict[int, int] = {}
        self._sorted: Optional[List[Pair]] = None
        self._last_invalidate = 0.0

    def add(self, row_id: int, n: int) -> None:
        if n == 0:
            self.entries.pop(row_id, None)
        else:
            self.entries[row_id] = n
        self._sorted = None

    bulk_add = add

    def get(self, row_id: int) -> int:
        return self.entries.get(row_id, 0)

    def ids(self) -> List[int]:
        return sorted(list(self.entries))

    def __len__(self) -> int:
        return len(self.entries)

    def invalidate(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and self._sorted is not None and (
            now - self._last_invalidate < RANK_CACHE_INVALIDATE_SECONDS
        ):
            return
        # list() snapshots entries in one C-level call: TopN reads are
        # lock-free and must not raise if a fragment writer (who holds the
        # fragment mutex, not ours) inserts mid-iteration.
        ranked = sort_pairs(
            [Pair(id=i, count=c) for i, c in list(self.entries.items())]
        )
        if len(ranked) > self.max_entries:
            ranked = ranked[: self.max_entries]
            self.entries = {p.id: p.count for p in ranked}
        self._sorted = ranked
        self._last_invalidate = now

    def top(self) -> List[Pair]:
        if self._sorted is None:
            self.invalidate(force=True)
        return list(self._sorted or [])

    def clear(self) -> None:
        self.entries.clear()
        self._sorted = None


class LRUCache:
    """LRU row-count cache (reference cache.go:58-130, lru/lru.go)."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE):
        self.max_entries = max_entries
        self.entries: OrderedDict[int, int] = OrderedDict()

    def add(self, row_id: int, n: int) -> None:
        if row_id in self.entries:
            self.entries.move_to_end(row_id)
        self.entries[row_id] = n
        if len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)

    bulk_add = add

    def get(self, row_id: int) -> int:
        n = self.entries.get(row_id, 0)
        if row_id in self.entries:
            self.entries.move_to_end(row_id)
        return n

    def ids(self) -> List[int]:
        return sorted(list(self.entries))

    def __len__(self) -> int:
        return len(self.entries)

    def invalidate(self, force: bool = False) -> None:
        pass

    def top(self) -> List[Pair]:
        return sort_pairs(
            [Pair(id=i, count=c) for i, c in list(self.entries.items())]
        )

    def clear(self) -> None:
        self.entries.clear()


class NopCache:
    def add(self, row_id: int, n: int) -> None:
        pass

    bulk_add = add

    def get(self, row_id: int) -> int:
        return 0

    def ids(self) -> List[int]:
        return []

    def __len__(self) -> int:
        return 0

    def invalidate(self, force: bool = False) -> None:
        pass

    def top(self) -> List[Pair]:
        return []

    def clear(self) -> None:
        pass


def new_cache(cache_type: str, size: int):
    from ..constants import CACHE_TYPE_LRU, CACHE_TYPE_NONE, CACHE_TYPE_RANKED
    from ..errors import InvalidCacheTypeError

    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type == CACHE_TYPE_NONE:
        return NopCache()
    raise InvalidCacheTypeError(cache_type)
