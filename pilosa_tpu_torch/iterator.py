"""(row, column) iterators (port of reference iterator.go).

Iterate set bits of a fragment in (rowID, columnID) order, with seek
support — used by export, block-data extraction and tests.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from .constants import SHARD_WIDTH


class BufIterator:
    """Peek/unread wrapper (reference bufIterator)."""

    def __init__(self, it: Iterator[Tuple[int, int]]):
        self._it = iter(it)
        self._buf: Optional[Tuple[int, int]] = None
        self._eof = False

    def next(self) -> Optional[Tuple[int, int]]:
        if self._buf is not None:
            v, self._buf = self._buf, None
            return v
        try:
            return next(self._it)
        except StopIteration:
            self._eof = True
            return None

    def peek(self) -> Optional[Tuple[int, int]]:
        if self._buf is None:
            self._buf = self.next()
        return self._buf

    def unread(self, value: Tuple[int, int]) -> None:
        assert self._buf is None
        self._buf = value


def fragment_iterator(fragment, seek_row: int = 0) -> Iterator[Tuple[int, int]]:
    """Yield (rowID, absolute columnID) pairs in ascending order."""
    base = fragment.shard * SHARD_WIDTH
    vals = fragment.storage.slice()
    start = np.searchsorted(vals, np.uint64(seek_row * SHARD_WIDTH))
    for pos in vals[start:]:
        pos = int(pos)
        yield pos // SHARD_WIDTH, base + pos % SHARD_WIDTH


def slice_iterator(row_ids, column_ids) -> Iterator[Tuple[int, int]]:
    """Iterator over parallel (rowIDs, columnIDs) arrays (reference
    sliceIterator), sorted by (row, col)."""
    pairs = sorted(zip((int(r) for r in row_ids), (int(c) for c in column_ids)))
    return iter(pairs)


def limit_iterator(it, max_row: int, max_col: int) -> Iterator[Tuple[int, int]]:
    """Stop before (max_row, *) or columns >= max_col (reference limitIterator)."""
    for row, col in it:
        if row >= max_row:
            return
        if col % SHARD_WIDTH >= max_col:
            continue
        yield row, col
