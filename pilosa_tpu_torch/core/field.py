"""Field: a set of views plus options (port of reference field.go).

Types: "set" (standard rows, TopN cache), "int" (BSI group with min/max
offset encoding), "time" (time-quantum subviews). Metadata persists as JSON
(the reference uses protobuf .meta; JSON is the idiomatic host-side choice).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, List, Optional, Tuple

from ..constants import (
    CACHE_TYPE_NONE,
    CACHE_TYPE_RANKED,
    DEFAULT_CACHE_SIZE,
    FIELD_TYPE_INT,
    FIELD_TYPE_SET,
    FIELD_TYPE_TIME,
    SHARD_WIDTH,
    VIEW_BSI_GROUP_PREFIX,
    VIEW_STANDARD,
)
from ..errors import (
    BSIGroupNotFoundError,
    InvalidBSIGroupRangeError,
    InvalidCacheTypeError,
    InvalidFieldTypeError,
    PilosaError,
    validate_name,
)
from ..pql.ast import EQ, GT, GTE, LT, LTE, NEQ
from ..timeq import parse_time_quantum, views_by_time
from .attrs import AttrStore, MemAttrStore
from .row import Row
from .view import View


@dataclass
class FieldOptions:
    type: str = FIELD_TYPE_SET
    cache_type: str = CACHE_TYPE_RANKED
    cache_size: int = DEFAULT_CACHE_SIZE
    min: int = 0
    max: int = 0
    time_quantum: str = ""
    keys: bool = False

    def to_dict(self):
        return {
            "type": self.type,
            "cacheType": self.cache_type,
            "cacheSize": self.cache_size,
            "min": self.min,
            "max": self.max,
            "timeQuantum": self.time_quantum,
            "keys": self.keys,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FieldOptions":
        return cls(
            type=d.get("type", FIELD_TYPE_SET),
            cache_type=d.get("cacheType", CACHE_TYPE_RANKED),
            cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
            min=d.get("min", 0),
            max=d.get("max", 0),
            time_quantum=d.get("timeQuantum", ""),
            keys=d.get("keys", False),
        )


@dataclass
class BSIGroup:
    """Range-encoded row group (reference field.go:1237 bsiGroup)."""

    name: str
    type: str = "int"
    min: int = 0
    max: int = 0

    def bit_depth(self) -> int:
        for i in range(63):
            if self.max - self.min < (1 << i):
                return i
        return 63

    def base_value(self, op: str, value: int) -> Tuple[int, bool]:
        """Offset-encode a predicate; True means out of range (field.go:1256)."""
        base = 0
        if op in (GT, GTE):
            if value > self.max:
                return 0, True
            if value > self.min:
                base = value - self.min
        elif op in (LT, LTE):
            if value < self.min:
                return 0, True
            if value > self.max:
                base = self.max - self.min
            else:
                base = value - self.min
        elif op in (EQ, NEQ):
            if value < self.min or value > self.max:
                return 0, True
            base = value - self.min
        return base, False

    def base_value_between(self, lo: int, hi: int) -> Tuple[int, int, bool]:
        if hi < self.min or lo > self.max:
            return 0, 0, True
        base_lo = lo - self.min if lo > self.min else 0
        if hi > self.max:
            base_hi = self.max - self.min
        elif hi > self.min:
            base_hi = hi - self.min
        else:
            base_hi = 0
        return base_lo, base_hi, False


class Field:
    def __init__(
        self,
        path: Optional[str],
        index: str,
        name: str,
        options: Optional[FieldOptions] = None,
        stats=None,
        broadcast_shard=None,
        use_sqlite_attrs: bool = True,
        epoch=None,
        storage_config=None,
        snapshotter=None,
        delta_journal_ops=None,
        cdc=None,
        device=None,
    ):
        validate_name(name)
        self.path = path
        self.index = index
        self.name = name
        self.options = options or FieldOptions()
        self.stats = stats
        self.broadcast_shard = broadcast_shard
        self.epoch = epoch
        self.storage_config = storage_config
        self.snapshotter = snapshotter
        self.delta_journal_ops = delta_journal_ops
        self.cdc = cdc
        self.device = device
        self.views: Dict[str, View] = {}
        self.bsi_groups: List[BSIGroup] = []
        self._lock = threading.RLock()
        if path and use_sqlite_attrs:
            self.row_attr_store = AttrStore(os.path.join(path, ".data"))
        else:
            self.row_attr_store = MemAttrStore()

    # ------------------------------------------------------------ lifecycle

    def open(self) -> "Field":
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            meta = os.path.join(self.path, ".meta")
            if os.path.exists(meta):
                with open(meta) as f:
                    self.options = FieldOptions.from_dict(json.load(f))
        self._apply_options()
        self.row_attr_store.open()
        if self.path:
            views_dir = os.path.join(self.path, "views")
            if os.path.isdir(views_dir):
                for vname in sorted(os.listdir(views_dir)):
                    view = self._new_view(vname)
                    view.open()
                    self.views[vname] = view
        return self

    def _apply_options(self) -> None:
        o = self.options
        if o.type not in (FIELD_TYPE_SET, FIELD_TYPE_INT, FIELD_TYPE_TIME):
            raise InvalidFieldTypeError(o.type)
        if o.type == FIELD_TYPE_INT:
            if o.min > o.max:
                raise InvalidBSIGroupRangeError(f"{o.min} > {o.max}")
            if not any(b.name == self.name for b in self.bsi_groups):
                self.bsi_groups.append(
                    BSIGroup(name=self.name, type="int", min=o.min, max=o.max)
                )
        if o.type == FIELD_TYPE_TIME:
            o.time_quantum = parse_time_quantum(o.time_quantum)
        if o.cache_type not in ("lru", "ranked", "none"):
            raise InvalidCacheTypeError(o.cache_type)

    def save_meta(self) -> None:
        if not self.path:
            return
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, ".meta"), "w") as f:
            json.dump(self.options.to_dict(), f)

    def close(self) -> None:
        for view in list(self.views.values()):
            view.close()
        self.row_attr_store.close()

    # ---------------------------------------------------------------- views

    def _new_view(self, name: str) -> View:
        cache_type = self.options.cache_type
        cache_size = self.options.cache_size
        if name.startswith(VIEW_BSI_GROUP_PREFIX):
            cache_type, cache_size = CACHE_TYPE_NONE, 0
        return View(
            os.path.join(self.path, "views", name) if self.path else None,
            self.index,
            self.name,
            name,
            cache_type=cache_type,
            cache_size=cache_size,
            row_attr_store=self.row_attr_store,
            stats=self.stats,
            broadcast_shard=self.broadcast_shard,
            epoch=self.epoch,
            storage_config=self.storage_config,
            snapshotter=self.snapshotter,
            delta_journal_ops=self.delta_journal_ops,
            cdc=self.cdc,
            device=self.device,
        )

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            view = self.views.get(name)
            if view is None:
                view = self._new_view(name)
                view.open()
                self.views[name] = view
            return view

    def view_names(self) -> List[str]:
        return sorted(list(self.views))

    def max_shard(self) -> int:
        return max((v.max_shard() for v in list(self.views.values())), default=0)

    def available_shards(self) -> List[int]:
        shards = set()
        for v in list(self.views.values()):
            shards.update(v.available_shards())
        return sorted(shards)

    # ----------------------------------------------------------------- BSI

    def bsi_group(self, name: str) -> Optional[BSIGroup]:
        for b in self.bsi_groups:
            if b.name == name:
                return b
        return None

    def bsi_view_name(self) -> str:
        return VIEW_BSI_GROUP_PREFIX + self.name

    # --------------------------------------------------------------- reads

    def type(self) -> str:
        return self.options.type

    def time_quantum(self) -> str:
        return self.options.time_quantum

    def keys(self) -> bool:
        return self.options.keys

    def row(self, row_id: int) -> Row:
        if self.type() == FIELD_TYPE_INT:
            raise PilosaError(f"row method unsupported for field type: {self.type()}")
        view = self.view(VIEW_STANDARD)
        if view is None:
            return Row()
        row = Row()
        for shard in view.available_shards():
            row.merge(view.row(row_id, shard))
        return row

    def value(self, column_id: int) -> Tuple[int, bool]:
        bsig = self.bsi_group(self.name)
        if bsig is None:
            raise BSIGroupNotFoundError(self.name)
        view = self.view(self.bsi_view_name())
        if view is None:
            return 0, False
        v, exists = view.value(column_id, bsig.bit_depth())
        if not exists:
            return 0, False
        return v + bsig.min, True

    # -------------------------------------------------------------- writes

    def set_bit(self, row_id: int, col_id: int, timestamp: Optional[datetime] = None) -> bool:
        changed = False
        view = self.create_view_if_not_exists(VIEW_STANDARD)
        changed |= view.set_bit(row_id, col_id)
        if timestamp is not None:
            for name in views_by_time(VIEW_STANDARD, timestamp, self.time_quantum()):
                changed |= self.create_view_if_not_exists(name).set_bit(row_id, col_id)
        return changed

    def clear_bit(self, row_id: int, col_id: int) -> bool:
        changed = False
        for name, view in list(self.views.items()):
            if name == VIEW_STANDARD or (
                name.startswith(VIEW_STANDARD + "_")
            ):
                changed |= view.clear_bit(row_id, col_id)
        return changed

    def set_value(self, column_id: int, value: int) -> bool:
        from ..errors import PilosaError

        bsig = self.bsi_group(self.name)
        if bsig is None:
            raise BSIGroupNotFoundError(self.name)
        if value < bsig.min:
            raise PilosaError(f"value {value} below minimum {bsig.min}")
        if value > bsig.max:
            raise PilosaError(f"value {value} above maximum {bsig.max}")
        base = value - bsig.min
        view = self.create_view_if_not_exists(self.bsi_view_name())
        return view.set_value(column_id, bsig.bit_depth(), base)

    # -------------------------------------------------------------- import

    def import_bits(self, row_ids, column_ids, timestamps=None) -> None:
        """Bulk import (reference field.go:963 Import): groups bits by
        (view, shard) honoring time quantum views, then bulkImports.

        The common no-timestamp case groups by shard with numpy (the
        per-bit Python loop dominated ingest cost on big batches — an
        O(n) interpreter walk in front of an O(batch) storage path);
        timestamped bits keep the per-bit walk, since each bit's time
        views depend on its own timestamp."""
        import numpy as np

        q = self.time_quantum()
        has_time = timestamps is not None and any(t is not None for t in timestamps)
        if has_time and not q:
            raise PilosaError("time quantum not set in field")
        if not has_time:
            row_arr = np.asarray(row_ids, dtype=np.uint64)
            col_arr = np.asarray(column_ids, dtype=np.uint64)
            shards = col_arr // np.uint64(SHARD_WIDTH)
            view = self.create_view_if_not_exists(VIEW_STANDARD)
            for shard in np.unique(shards):
                mask = shards == shard
                frag = view.create_fragment_if_not_exists(int(shard))
                frag.bulk_import(row_arr[mask], col_arr[mask])
            return
        by_frag: Dict[Tuple[str, int], Tuple[list, list]] = {}
        for i, (row_id, col_id) in enumerate(zip(row_ids, column_ids)):
            ts = timestamps[i] if timestamps is not None else None
            names = [VIEW_STANDARD]
            if ts is not None:
                names = views_by_time(VIEW_STANDARD, ts, q) + [VIEW_STANDARD]
            for name in names:
                key = (name, int(col_id) // SHARD_WIDTH)
                rows, cols = by_frag.setdefault(key, ([], []))
                rows.append(int(row_id))
                cols.append(int(col_id))
        for (name, shard), (rows, cols) in by_frag.items():
            view = self.create_view_if_not_exists(name)
            frag = view.create_fragment_if_not_exists(shard)
            frag.bulk_import(np.asarray(rows, dtype=np.uint64), np.asarray(cols, dtype=np.uint64))

    def import_value(self, column_ids, values) -> None:
        """Bulk BSI import (reference field.go:1020 ImportValue)."""
        import numpy as np

        bsig = self.bsi_group(self.name)
        if bsig is None:
            raise BSIGroupNotFoundError(self.name)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if values.size and int(values.max()) > bsig.max:
            raise PilosaError(f"value {int(values.max())} above maximum {bsig.max}")
        if values.size and int(values.min()) < bsig.min:
            raise PilosaError(f"value {int(values.min())} below minimum {bsig.min}")
        shards = column_ids // np.uint64(SHARD_WIDTH)
        view = self.create_view_if_not_exists(self.bsi_view_name())
        for shard in np.unique(shards):
            mask = shards == shard
            frag = view.create_fragment_if_not_exists(int(shard))
            frag.import_value(
                column_ids[mask], (values[mask] - bsig.min).astype(np.uint64), bsig.bit_depth()
            )

    # ----------------------------------------------------------------- misc

    def to_info(self) -> dict:
        return {
            "name": self.name,
            "options": self.options.to_dict(),
            "views": [{"name": n} for n in self.view_names()],
        }
