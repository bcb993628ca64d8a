"""Hands the port's holder the containers that roaring would choose for
the generated columns: a sorted array of low bits where a 2^16-column
container holds at most 4096 bits, a bitmap of 1024 words where it holds
more. The masks, counts and bit packing run on the device; the host only
wraps the results in the holder's containers."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .datagen import CONTAINER_BITS, SHARD_WIDTH, Columns, bit_depth

ARRAY_MAX = 4096
CONTAINERS_PER_SHARD = SHARD_WIDTH // CONTAINER_BITS
_BYTE_WEIGHTS: Dict[torch.device, torch.Tensor] = {}


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(N,) bool, N a multiple of 64 -> (N / 64,) int64 words, bit i of word
    j = column 64 j + i (the holder's little-endian plane layout)."""
    w = _BYTE_WEIGHTS.get(mask.device)
    if w is None:
        w = _BYTE_WEIGHTS[mask.device] = (
            1 << torch.arange(8, dtype=torch.int32, device=mask.device))
    packed = (mask.view(-1, 8).to(torch.int32) * w).sum(dim=1, dtype=torch.int32)
    return packed.to(torch.uint8).view(torch.int64)


class Loader:
    """Builds one index of the port's holder from a configuration's columns:
    every field it declares, with the history of its loaded fields.
    `counts` keeps the containers made by form, for the set-up report."""

    def __init__(self, holder, columns: Columns):
        from pilosa_tpu_torch.core.field import FieldOptions

        self.holder = holder
        self.columns = columns
        self.index = holder.create_index_if_not_exists(columns.cfg["index"])
        self.views = {}
        self.set_rows = {}
        self.counts = {"array": 0, "bitmap": 0}
        for c in columns.fields:
            name, f = c["name"], c["field"]
            if f["type"] == "set":
                fld = self.index.create_field_if_not_exists(name, FieldOptions(type="set"))
                self.views[name] = fld.create_view_if_not_exists("standard")
                self.set_rows[name] = columns.rows(name)
            else:
                fld = self.index.create_field_if_not_exists(
                    name, FieldOptions(type="int", min=f["min"], max=f["max"]))
                self.views[name] = fld.create_view_if_not_exists(fld.bsi_view_name())

    def _fragments(self, view, shard0: int, nb: int) -> list:
        return [view.create_fragment_if_not_exists(shard0 + i, broadcast=False)
                for i in range(nb)]

    def _inject(self, frags, row: int, mask: torch.Tensor, ranked: bool) -> None:
        """One row of every fragment of the block from its column mask."""
        from pilosa_tpu_torch.storage.bitmap import Container

        per = mask.view(-1, CONTAINER_BITS)
        counts = per.sum(dim=1, dtype=torch.int32)
        dense = counts > ARRAY_MAX
        sparse = (counts > 0) & ~dense
        counts_np = counts.cpu().numpy()
        dense_np = dense.cpu().numpy()
        sparse_np = sparse.cpu().numpy()
        words = arrays = None
        if dense_np.any():
            idx = torch.nonzero(dense).squeeze(1)
            words = pack_bits(per[idx].reshape(-1)).view(-1, 1024).cpu().numpy().view(np.uint64)
            dense_at = np.cumsum(dense_np) - 1
        if sparse_np.any():
            idx = torch.nonzero(sparse).squeeze(1)
            pos = torch.nonzero(per[idx].reshape(-1)).squeeze(1)
            low = torch.remainder(pos, CONTAINER_BITS).to(torch.int32).cpu().numpy()
            arrays = np.split(low.astype(np.uint16), np.cumsum(counts_np[sparse_np])[:-1])
            sparse_at = np.cumsum(sparse_np) - 1
        base = row * CONTAINERS_PER_SHARD
        for s, frag in enumerate(frags):
            total = 0
            conts = frag.storage.containers
            for ci in range(CONTAINERS_PER_SHARD):
                k = s * CONTAINERS_PER_SHARD + ci
                n = int(counts_np[k])
                if not n:
                    continue
                total += n
                if dense_np[k]:
                    conts[base + ci] = Container(bits=words[dense_at[k]], n=n)
                else:
                    conts[base + ci] = Container(arr=arrays[sparse_at[k]], n=n)
                    self.counts["array"] += 1
                    continue
                self.counts["bitmap"] += 1
            if ranked and total:
                frag.cache.bulk_add(row, total)

    def load_block(self, shard0: int, nb: int, n: int, cols: Dict[str, torch.Tensor]) -> None:
        padded = nb * SHARD_WIDTH
        for name in self.columns.loaded:
            view = self.views[name]
            c = self.columns.field(name)
            v = cols[name]
            if n < padded:
                v = torch.cat([v, torch.full((padded - n,), -1, dtype=v.dtype, device=v.device)])
            frags = self._fragments(view, shard0, nb)
            if name in self.set_rows:
                for row in self.set_rows[name]:
                    self._inject(frags, row, v == row, ranked=True)
                for frag in frags:
                    frag.cache.invalidate(force=True)
                continue
            lo, hi = c["field"]["min"], c["field"]["max"]
            depth = bit_depth(lo, hi)
            valid = v >= lo  # the padding (-1) lies under every field's min
            base = torch.where(valid, v - lo, torch.zeros_like(v))
            for i in range(depth):
                self._inject(frags, i, (torch.bitwise_right_shift(base, i) & 1).bool() & valid,
                             ranked=False)
            self._inject(frags, depth, valid, ranked=False)

    def load(self) -> None:
        for shard0, nb, n, cols in self.columns.iter_blocks():
            self.load_block(shard0, nb, n, cols)
            del cols
