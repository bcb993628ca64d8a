"""Holder: root container of all indexes (port of reference holder.go).

Opens by scanning the data directory tree (index -> field -> view ->
fragment), exposes schema encode/apply for cluster sync, and provides the
fragment lookup used throughout the executor.

The holder owns the torch device its planes live on (`device`, the card
unless the caller asks for the CPU) and threads it down Index -> Field ->
View -> Fragment, so every plane a fragment materializes lands there.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional

import torch

from ..errors import IndexExistsError, IndexNotFoundError
from .field import Field, FieldOptions
from .fragment import Fragment
from .index import Index, IndexOptions


def resolve_device(device=None) -> torch.device:
    """The device every plane of a holder lives on. No device means the
    card: with no CUDA device the caller must ask for the CPU explicitly
    (`device="cpu"`) — the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class Holder:
    def __init__(self, path: Optional[str] = None, stats=None, broadcast_shard=None,
                 storage_config=None, delta_journal_ops=None, cdc=None,
                 device=None):
        device = resolve_device(device)
        self.path = path
        self.stats = stats
        self.broadcast_shard = broadcast_shard
        self.storage_config = storage_config
        self.delta_journal_ops = delta_journal_ops
        # CDC change-stream manager (cdc/manager.py), threaded down
        # Holder -> Index -> Field -> View -> Fragment like the
        # snapshotter. None = change capture off (the default).
        self.cdc = cdc
        self.device = device
        self.indexes: Dict[str, Index] = {}
        self._lock = threading.RLock()
        self.opened = False
        # Background snapshotter (storage/snapshotter.py): fragments whose
        # snapshot policy fires enqueue here so the write path never blocks
        # on snapshot I/O. Only persistent holders get one — pathless
        # (in-memory) holders snapshot inline, keeping tests and benches
        # synchronous.
        self.snapshotter = None
        if path:
            from ..storage import StorageConfig
            from ..storage.snapshotter import Snapshotter

            cfg = storage_config or StorageConfig()
            self.snapshotter = Snapshotter(
                stats=stats, interval=cfg.snapshot_interval,
                fragments_fn=self._all_fragments,
            )

    def open(self) -> "Holder":
        # Per-fragment corruption is handled BELOW this walk: a fragment
        # whose file fails validation quarantines itself (bad bytes moved
        # to .corrupt, boots empty — Fragment._quarantine) instead of
        # raising, so one bad disk sector can't stop the node from booting.
        # quarantined_fragments() reports what came up degraded.
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            for name in sorted(os.listdir(self.path)):
                ipath = os.path.join(self.path, name)
                if not os.path.isdir(ipath) or name.startswith("."):
                    continue
                index = Index(
                    ipath, name, stats=self.stats,
                    broadcast_shard=self.broadcast_shard,
                    storage_config=self.storage_config,
                    snapshotter=self.snapshotter,
                    delta_journal_ops=self.delta_journal_ops,
                    cdc=self.cdc,
                    device=self.device,
                )
                index.open()
                self.indexes[name] = index
                if self.cdc is not None:
                    # Cut/refresh point-in-time base images for data that
                    # predates change capture (cdc/log.py base model).
                    self.cdc.register_index(index)
        if self.snapshotter is not None:
            self.snapshotter.start()
        self.opened = True
        return self

    def close(self) -> None:
        # Stop + drain the snapshotter FIRST: its thread must not race the
        # fragment closes below (queued rewrites either finish against
        # still-open fragments or abort on the _opened flag).
        if self.snapshotter is not None:
            self.snapshotter.close()
        for index in list(self.indexes.values()):
            index.close()
        self.opened = False

    def reopen(self) -> "Holder":
        """Close and reopen from disk (test helper, reference test/holder.go:62)."""
        self.close()
        self.indexes = {}
        return self.open()

    # -------------------------------------------------------------- indexes

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, options: Optional[IndexOptions] = None) -> Index:
        with self._lock:
            if name in self.indexes:
                raise IndexExistsError(name)
            return self._create_index(name, options or IndexOptions())

    def create_index_if_not_exists(self, name: str, options: Optional[IndexOptions] = None) -> Index:
        with self._lock:
            if name in self.indexes:
                return self.indexes[name]
            return self._create_index(name, options or IndexOptions())

    def _create_index(self, name: str, options: IndexOptions) -> Index:
        index = Index(
            os.path.join(self.path, name) if self.path else None,
            name,
            options=options,
            stats=self.stats,
            broadcast_shard=self.broadcast_shard,
            storage_config=self.storage_config,
            snapshotter=self.snapshotter,
            delta_journal_ops=self.delta_journal_ops,
            cdc=self.cdc,
            device=self.device,
        )
        index.open()
        index.save_meta()
        self.indexes[name] = index
        if self.cdc is not None:
            self.cdc.register_index(index)
        return index

    def delete_index(self, name: str) -> None:
        with self._lock:
            index = self.indexes.pop(name, None)
            if index is None:
                raise IndexNotFoundError(name)
            index.close()
            if index.path and os.path.isdir(index.path):
                shutil.rmtree(index.path)
            if self.cdc is not None:
                # Drop the change log WITH the index: a recreated index
                # gets a fresh incarnation, so a consumer's stale cursor
                # can never alias the new position sequence (410 instead).
                self.cdc.drop_index(name)

    def index_names(self) -> List[str]:
        return sorted(self.indexes)

    # ------------------------------------------------------------ fragments

    def field(self, index: str, name: str) -> Optional[Field]:
        idx = self.index(index)
        return idx.field(name) if idx else None

    def fragment(self, index: str, field: str, view: str, shard: int) -> Optional[Fragment]:
        f = self.field(index, field)
        if f is None:
            return None
        v = f.view(view)
        if v is None:
            return None
        return v.fragment(shard)

    # --------------------------------------------------------------- schema

    def schema(self) -> List[dict]:
        """Encode schema for cluster sync (reference holder.go:213-273)."""
        return [idx.to_info() for _, idx in sorted(self.indexes.items())]

    def apply_schema(self, schema: List[dict]) -> None:
        for idx_info in schema:
            index = self.create_index_if_not_exists(
                idx_info["name"], IndexOptions.from_dict(idx_info.get("options", {}))
            )
            for f_info in idx_info.get("fields", []):
                field = index.create_field_if_not_exists(
                    f_info["name"], FieldOptions.from_dict(f_info.get("options", {}))
                )
                for v_info in f_info.get("views", []):
                    field.create_view_if_not_exists(v_info["name"])

    def quarantined_fragments(self) -> List[Fragment]:
        """Fragments currently serving degraded (corrupt file moved aside,
        awaiting anti-entropy repair). Diagnostics and the syncer read this."""
        out = []
        for index in list(self.indexes.values()):
            for field in list(index.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        if frag.quarantined:
                            out.append(frag)
        return out

    def _all_fragments(self) -> List[Fragment]:
        """Every live fragment (list() snapshots at each level: callers
        include the snapshotter's periodic sweep thread)."""
        out = []
        for index in list(self.indexes.values()):
            for field in list(index.fields.values()):
                for view in list(field.views.values()):
                    out.extend(list(view.fragments.values()))
        return out

    def ingest_stats(self) -> dict:
        """Aggregate ingest/snapshot health for /debug/vars' `ingest`
        group and diagnostics: un-snapshotted WAL bytes across all
        fragments plus the background snapshotter's counters."""
        out = {"wal_bytes": sum(f.wal_bytes for f in self._all_fragments())}
        if self.snapshotter is not None:
            out.update(self.snapshotter.snapshot())
        else:
            out.update({"snapshots_deferred": 0, "snapshots_taken": 0,
                        "snapshots_requeued": 0, "snapshot_errors": 0,
                        "snapshot_queue_depth": 0})
        return out

    def flush_caches(self) -> None:
        """Persist all TopN caches (reference holder.go:425-461)."""
        # list() snapshots at every level: this runs on the periodic
        # flusher thread while HTTP threads create indexes/fields/views.
        for index in list(self.indexes.values()):
            for field in list(index.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        frag.flush_cache()
