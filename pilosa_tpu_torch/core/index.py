"""Index: a namespace of fields plus column attributes (port of
reference index.go)."""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..errors import (
    FieldExistsError,
    FieldNotFoundError,
    validate_name,
)
from .attrs import AttrStore, MemAttrStore
from .field import Field, FieldOptions


@dataclass
class IndexOptions:
    keys: bool = False

    def to_dict(self):
        return {"keys": self.keys}

    @classmethod
    def from_dict(cls, d: dict):
        return cls(keys=d.get("keys", False))


class Index:
    def __init__(
        self,
        path: Optional[str],
        name: str,
        options: Optional[IndexOptions] = None,
        stats=None,
        broadcast_shard=None,
        storage_config=None,
        snapshotter=None,
        delta_journal_ops=None,
        cdc=None,
        device=None,
    ):
        validate_name(name)
        self.path = path
        self.name = name
        self.options = options or IndexOptions()
        self.stats = stats
        self.broadcast_shard = broadcast_shard
        self.storage_config = storage_config
        self.snapshotter = snapshotter
        self.delta_journal_ops = delta_journal_ops
        self.cdc = cdc
        self.device = device
        # Index-wide write epoch: every fragment mutation in this index
        # bumps it (core/fragment.py WriteEpoch). The query micro-batcher
        # keys coalescing groups on it so a batch never mixes queries
        # spanning a visible write boundary.
        from .fragment import WriteEpoch

        self.write_epoch = WriteEpoch()
        self.fields: Dict[str, Field] = {}
        # Highest shard known to exist cluster-wide, even if not held
        # locally (reference index.go:231-255 remoteMaxShard, synced via
        # gossip NodeStatus; here via create-shard broadcasts, resize
        # instructions and heartbeat probes).
        self.remote_max_shard = 0
        self._lock = threading.RLock()
        if path:
            self.column_attr_store = AttrStore(os.path.join(path, ".data"))
        else:
            self.column_attr_store = MemAttrStore()

    def open(self) -> "Index":
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            meta = os.path.join(self.path, ".meta")
            if os.path.exists(meta):
                with open(meta) as f:
                    self.options = IndexOptions.from_dict(json.load(f))
        self.column_attr_store.open()
        if self.path:
            for fname in sorted(os.listdir(self.path)):
                fpath = os.path.join(self.path, fname)
                if not os.path.isdir(fpath) or fname.startswith("."):
                    continue
                field = Field(
                    fpath, self.name, fname, stats=self.stats,
                    broadcast_shard=self.broadcast_shard,
                    epoch=self.write_epoch,
                    storage_config=self.storage_config,
                    snapshotter=self.snapshotter,
                    delta_journal_ops=self.delta_journal_ops,
                    cdc=self.cdc,
                    device=self.device,
                )
                field.open()
                self.fields[fname] = field
        return self

    def save_meta(self) -> None:
        if not self.path:
            return
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, ".meta"), "w") as f:
            json.dump(self.options.to_dict(), f)

    def close(self) -> None:
        for field in list(self.fields.values()):
            field.close()
        self.column_attr_store.close()

    def keys(self) -> bool:
        return self.options.keys

    # --------------------------------------------------------------- fields

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def create_field(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._lock:
            if name in self.fields:
                raise FieldExistsError(name)
            return self._create_field(name, options or FieldOptions())

    def create_field_if_not_exists(self, name: str, options: Optional[FieldOptions] = None) -> Field:
        with self._lock:
            if name in self.fields:
                return self.fields[name]
            return self._create_field(name, options or FieldOptions())

    def _create_field(self, name: str, options: FieldOptions) -> Field:
        field = Field(
            os.path.join(self.path, name) if self.path else None,
            self.name,
            name,
            options=options,
            stats=self.stats,
            broadcast_shard=self.broadcast_shard,
            epoch=self.write_epoch,
            storage_config=self.storage_config,
            snapshotter=self.snapshotter,
            delta_journal_ops=self.delta_journal_ops,
            cdc=self.cdc,
            device=self.device,
        )
        field.open()
        field.save_meta()
        self.fields[name] = field
        return field

    def delete_field(self, name: str) -> None:
        with self._lock:
            field = self.fields.pop(name, None)
            if field is None:
                raise FieldNotFoundError(name)
            field.close()
            # Dropping a field changes what every query over this index can
            # see — without the bump, the memo's O(1) epoch fast path would
            # keep serving counts memoized against the deleted field's
            # fragments (a recreated same-name field shares this epoch).
            self.write_epoch.bump()
            if field.path and os.path.isdir(field.path):
                shutil.rmtree(field.path)

    def field_names(self) -> List[str]:
        return sorted(list(self.fields))

    def max_shard(self) -> int:
        local = max((f.max_shard() for f in list(self.fields.values())), default=0)
        return max(local, self.remote_max_shard)

    def set_remote_max_shard(self, shard: int) -> None:
        if shard > self.remote_max_shard:
            self.remote_max_shard = shard

    def available_shards(self) -> List[int]:
        shards = set()
        for f in list(self.fields.values()):
            shards.update(f.available_shards())
        return sorted(shards) or [0]

    def to_info(self) -> dict:
        return {
            "name": self.name,
            "options": self.options.to_dict(),
            "fields": [f.to_info() for _, f in sorted(list(self.fields.items()))],
        }
