"""Column values from a configuration and a seed, made on the device in
blocks of shards. The same (configuration, seed, device type) gives the
same values, block by block, so the reference can make them again after
the window instead of holding them."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import spec as spec_mod

SHARD_WIDTH = 1 << 20
CONTAINER_BITS = 1 << 16


class Columns:
    """The columns a configuration declares. `fields` are those the index
    holds (a `field` entry in the file), in file order; the others are
    hidden inputs of derived columns. `loaded` are the fields whose
    history is made and loaded (`loaded_fields`, all where absent); the
    blocks hold those and the hidden inputs."""

    def __init__(self, cfg: dict, seed: int, device, shards_per_block: int = 8):
        self.cfg = cfg
        self.seed = int(seed) % (1 << 64)
        self.device = torch.device(device)
        self.n_columns = int(cfg["columns_total"])
        self.n_shards = -(-self.n_columns // SHARD_WIDTH)
        self.shards_per_block = shards_per_block
        self.specs = cfg["columns"]
        self.kinds = {c["kind"]: spec_mod.column_kind(c["kind"]) for c in self.specs}
        self.fields = [c for c in self.specs if c.get("field")]
        self.loaded = list(cfg.get("loaded_fields") or [c["name"] for c in self.fields])
        self.built = [c for c in self.specs if not c.get("field") or c["name"] in self.loaded]

    def field(self, name: str) -> dict:
        for c in self.fields:
            if c["name"] == name:
                return c
        raise KeyError(f"no field {name!r} in configuration {self.cfg['name']!r}")

    def rows(self, name: str) -> List[int]:
        """A set field's rows (every value its column can take)."""
        c = self.field(name)
        return self.kinds[c["kind"]].rows(c)

    def blocks(self) -> List[Tuple[int, int]]:
        """(first shard, shard count) of each block."""
        step = self.shards_per_block
        return [(s, min(step, self.n_shards - s)) for s in range(0, self.n_shards, step)]

    def _generator(self, block: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, block]).generate_state(2, np.uint32)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(state[0]) << 32 | int(state[1]))
        return g

    def block(self, shard0: int, n_shards: int) -> Tuple[int, Dict[str, torch.Tensor]]:
        """(valid column count, {built column's name: (valid,) int32 values})
        of the block that starts at shard0; the valid columns are its first
        ones."""
        first = shard0 * SHARD_WIDTH
        n = min(self.n_columns, first + n_shards * SHARD_WIDTH) - first
        g = self._generator(shard0 // self.shards_per_block)
        cols: Dict[str, torch.Tensor] = {}
        for c in self.built:
            cols[c["name"]] = self.kinds[c["kind"]].generate(c, n, g, self.device, cols)
        return n, cols

    def iter_blocks(self) -> Iterator[Tuple[int, int, int, Dict[str, torch.Tensor]]]:
        for shard0, nb in self.blocks():
            n, cols = self.block(shard0, nb)
            yield shard0, nb, n, cols


def bit_depth(lo: int, hi: int) -> int:
    """Planes of a range-encoded integer field of values lo..hi, the not-null
    plane aside (the port's and Pilosa's bsiGroup.BitDepth)."""
    for i in range(63):
        if hi - lo < (1 << i):
            return i
    return 63
