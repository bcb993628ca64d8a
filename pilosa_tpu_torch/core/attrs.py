"""Row/column attribute stores.

Equivalent of the reference's AttrStore (attr.go:34-48) with the BoltDB
implementation (boltdb/attrstore.go) replaced by sqlite3 (stdlib, embedded,
transactional — the idiomatic Python stand-in for an embedded B-tree KV).
Attribute blocks of 100 ids with checksums support anti-entropy diffing
(attr.go:80-120).
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

ATTR_BLOCK_SIZE = 100


def _validate_attrs(attrs: dict) -> None:
    for k, v in attrs.items():
        if v is not None and not isinstance(v, (str, int, float, bool)):
            raise ValueError(f"invalid attr type for {k!r}: {type(v)}")


class MemAttrStore:
    """In-memory store (reference attr.go:207-233 memAttrStore)."""

    def __init__(self, path: Optional[str] = None):
        self._m: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def open(self):
        return self

    def close(self):
        pass

    def attrs(self, id: int) -> dict:
        with self._lock:
            return dict(self._m.get(id, {}))

    def set_attrs(self, id: int, attrs: dict) -> None:
        _validate_attrs(attrs)
        with self._lock:
            cur = self._m.setdefault(id, {})
            for k, v in attrs.items():
                if v is None:
                    cur.pop(k, None)
                else:
                    cur[k] = v

    def set_bulk_attrs(self, m: Dict[int, dict]) -> None:
        for id, attrs in m.items():
            self.set_attrs(id, attrs)

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(i for i, a in self._m.items() if a)

    def blocks(self) -> List[Tuple[int, bytes]]:
        """(block_id, checksum) for anti-entropy diff (attr.go:80-120)."""
        with self._lock:
            items = sorted((i, a) for i, a in self._m.items() if a)
        out: Dict[int, hashlib._Hash] = {}
        for id, attrs in items:
            bid = id // ATTR_BLOCK_SIZE
            h = out.get(bid)
            if h is None:
                h = out[bid] = hashlib.blake2b(digest_size=8)
            h.update(json.dumps([id, attrs], sort_keys=True).encode())
        return [(bid, h.digest()) for bid, h in sorted(out.items())]

    def block_data(self, block_id: int) -> Dict[int, dict]:
        lo, hi = block_id * ATTR_BLOCK_SIZE, (block_id + 1) * ATTR_BLOCK_SIZE
        with self._lock:
            return {i: dict(a) for i, a in self._m.items() if lo <= i < hi and a}


class AttrStore(MemAttrStore):
    """sqlite3-backed store with the MemAttrStore interface."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._db: Optional[sqlite3.Connection] = None

    def open(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS attrs (id INTEGER PRIMARY KEY, data TEXT)"
        )
        self._db.commit()
        for id, data in self._db.execute("SELECT id, data FROM attrs"):
            self._m[id] = json.loads(data)
        return self

    def close(self):
        if self._db is not None:
            self._db.close()
            self._db = None

    def set_attrs(self, id: int, attrs: dict) -> None:
        super().set_attrs(id, attrs)
        self._persist(id)

    def set_bulk_attrs(self, m: Dict[int, dict]) -> None:
        for id, attrs in m.items():
            _validate_attrs(attrs)
        with self._lock:
            for id, attrs in m.items():
                cur = self._m.setdefault(id, {})
                for k, v in attrs.items():
                    if v is None:
                        cur.pop(k, None)
                    else:
                        cur[k] = v
        if self._db is not None:
            with self._lock:
                rows = [(i, json.dumps(self._m.get(i, {}))) for i in m]
            self._db.executemany(
                "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)", rows
            )
            self._db.commit()

    def _persist(self, id: int) -> None:
        if self._db is None:
            return
        with self._lock:
            data = json.dumps(self._m.get(id, {}))
        self._db.execute(
            "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)", (id, data)
        )
        self._db.commit()


class NopAttrStore(MemAttrStore):
    def set_attrs(self, id: int, attrs: dict) -> None:
        pass

    def set_bulk_attrs(self, m) -> None:
        pass

    def attrs(self, id: int) -> dict:
        return {}
