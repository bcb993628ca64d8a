"""View: container of fragments for one time-view of a field.

Port of reference view.go: "standard" plus time-quantum subviews
("standard_2018", ...) and BSI group views ("bsig_<field>"). Creates
fragments on demand and notifies the holder when a new shard appears so a
CreateShardMessage can be broadcast (view.go:210-257).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from ..constants import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE, SHARD_WIDTH
from .fragment import Fragment


class View:
    def __init__(
        self,
        path: Optional[str],
        index: str,
        field: str,
        name: str,
        cache_type: str = CACHE_TYPE_RANKED,
        cache_size: int = DEFAULT_CACHE_SIZE,
        row_attr_store=None,
        stats=None,
        broadcast_shard: Optional[Callable[[str, str, int], None]] = None,
        epoch=None,
        storage_config=None,
        snapshotter=None,
        delta_journal_ops=None,
        cdc=None,
        device=None,
    ):
        self.path = path
        self.index = index
        self.field = field
        self.name = name
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.stats = stats
        self.broadcast_shard = broadcast_shard
        self.epoch = epoch
        self.storage_config = storage_config
        self.snapshotter = snapshotter
        self.delta_journal_ops = delta_journal_ops
        self.cdc = cdc
        self.device = device
        self.fragments: Dict[int, Fragment] = {}
        self._lock = threading.RLock()

    def open(self) -> "View":
        if self.path:
            frag_dir = os.path.join(self.path, "fragments")
            if os.path.isdir(frag_dir):
                for fname in sorted(os.listdir(frag_dir)):
                    if not fname.isdigit():
                        continue
                    shard = int(fname)
                    frag = self._new_fragment(shard)
                    frag.open()
                    self.fragments[shard] = frag
        return self

    def close(self) -> None:
        with self._lock:
            for frag in list(self.fragments.values()):
                frag.close()

    def _fragment_path(self, shard: int) -> Optional[str]:
        if not self.path:
            return None
        return os.path.join(self.path, "fragments", str(shard))

    def _new_fragment(self, shard: int) -> Fragment:
        return Fragment(
            self._fragment_path(shard),
            self.index,
            self.field,
            self.name,
            shard,
            cache_type=self.cache_type,
            cache_size=self.cache_size,
            row_attr_store=self.row_attr_store,
            stats=self.stats,
            epoch=self.epoch,
            storage_config=self.storage_config,
            snapshotter=self.snapshotter,
            delta_journal_ops=self.delta_journal_ops,
            cdc=self.cdc,
            device=self.device,
        )

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int, broadcast: bool = True) -> Fragment:
        created = False
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None:
                frag = self._new_fragment(shard)
                frag.open()
                self.fragments[shard] = frag
                created = True
        # Broadcast outside the lock: the peer handling CreateShardMessage
        # takes its own view lock and may call back here (deadlock otherwise).
        if created and broadcast and self.broadcast_shard:
            self.broadcast_shard(self.index, self.field, shard)
        return frag

    def available_shards(self) -> List[int]:
        return sorted(list(self.fragments))

    def max_shard(self) -> int:
        return max(self.fragments, default=0)

    # ----------------------------------------------------------- forwards

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return False
        return frag.clear_bit(row_id, column_id)

    def row(self, row_id: int, shard: int):
        from .row import Row

        frag = self.fragment(shard)
        if frag is None:
            return Row()
        return frag.row(row_id)

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SHARD_WIDTH)
        return frag.set_value(column_id, bit_depth, value)

    def value(self, column_id: int, bit_depth: int):
        frag = self.fragment(column_id // SHARD_WIDTH)
        if frag is None:
            return 0, False
        return frag.value(column_id, bit_depth)
