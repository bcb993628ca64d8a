"""Query-result rows spanning shards.

A Row is the framework's equivalent of the reference's Row/RowSegment
(reference row.go:27,312): per-shard bitplanes (int32 torch tensors
of WORDS_PER_ROW words, on the holder's device) keyed by shard number.
Set algebra merges segment maps shard-by-shard with elementwise torch ops;
column ids only materialize on host at the API edge (columns()), mirroring
how the reference never concatenates segments. Counting a row on the card
goes through the masked_plane_counts kernel (ops/kernels.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..constants import SHARD_WIDTH
from ..ops import bitplane as bp


class Row:
    __slots__ = ("segments", "attrs", "keys")

    def __init__(self, segments: Optional[Dict[int, torch.Tensor]] = None,
                 columns=None, device="cpu"):
        self.segments: Dict[int, torch.Tensor] = dict(segments or {})
        self.attrs: dict = {}
        self.keys: List[str] = []
        if columns is not None:
            self._add_columns(columns, device)

    def _add_columns(self, columns: Iterable[int], device) -> None:
        cols = np.asarray(sorted(columns), dtype=np.uint64)
        if len(cols) == 0:
            return
        shards = (cols // SHARD_WIDTH).astype(np.int64)
        for shard in np.unique(shards):
            local = (cols[shards == shard] % SHARD_WIDTH).astype(np.uint32)
            existing = self.segments.get(int(shard))
            plane = bp.to_tensor(bp.pack_bits(local),
                                 device if existing is None else existing.device)
            if existing is not None:
                plane = torch.bitwise_or(existing, plane)
            self.segments[int(shard)] = plane

    # -------------------------------------------------------------- algebra

    def union(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                cur = out.get(shard)
                out[shard] = seg if cur is None else bp.p_or(cur, seg)
        return Row(out)

    def intersect(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            nxt = {}
            for shard, seg in out.items():
                o = other.segments.get(shard)
                if o is not None:
                    nxt[shard] = bp.p_and(seg, o)
            out = nxt
        return Row(out)

    def difference(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                cur = out.get(shard)
                if cur is not None:
                    out[shard] = bp.p_andnot(cur, seg)
        return Row(out)

    def xor(self, *others: "Row") -> "Row":
        out = dict(self.segments)
        for other in others:
            for shard, seg in other.segments.items():
                cur = out.get(shard)
                out[shard] = seg if cur is None else bp.p_xor(cur, seg)
        return Row(out)

    def intersection_count(self, other: "Row") -> int:
        common = [s for s in self.segments if s in other.segments]
        if not common:
            return 0
        return self.intersect(other).count()

    def merge(self, other: "Row") -> None:
        """In-place union (the reference's Row.Merge reduce step, row.go:47)."""
        for shard, seg in other.segments.items():
            cur = self.segments.get(shard)
            self.segments[shard] = seg if cur is None else bp.p_or(cur, seg)

    # ------------------------------------------------------------- material

    def count(self) -> int:
        """Total bits: ONE popcount over the (S, W) stack of segments (on
        the card, one masked_plane_counts launch)."""
        if not self.segments:
            return 0
        return int(bp.popcount(torch.stack(list(self.segments.values()))).sum())

    def any(self) -> bool:
        return self.count() > 0

    def columns(self) -> np.ndarray:
        """Ascending absolute column ids (uint64) — host materialization."""
        parts = []
        for shard in sorted(self.segments):
            cols = bp.unpack_bits(bp.to_numpy(self.segments[shard]))
            if len(cols):
                parts.append(cols + np.uint64(shard * SHARD_WIDTH))
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    def segment_plane(self, shard: int):
        return self.segments.get(shard)

    def shard_row(self, shard: int) -> "Row":
        seg = self.segments.get(shard)
        return Row({shard: seg} if seg is not None else {})

    def __eq__(self, other):
        if not isinstance(other, Row):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self):
        cols = self.columns()
        preview = cols[:10].tolist()
        return f"Row(n={len(cols)}, cols={preview}{'...' if len(cols) > 10 else ''})"
