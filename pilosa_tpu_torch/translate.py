"""String key <-> uint64 id translation.

Equivalent of the reference's TranslateFile (translate.go): an append-only
binary log of (namespace, key, id) entries with an in-memory *offset* index
(translate.go:733-900 keeps a robin-hood table of log offsets over a 10GB
mmap — key bytes live on disk, memory holds fixed-size offsets). Here the
same shape: an open-addressing int64 offset table for key->id and a per-
namespace offset array for id->key; every lookup reads the entry lazily
from the log (pread / in-memory tail). Memory cost is ~16 bytes per key
regardless of key length, so billion-key stores fit.

Namespaces are per-index column keys ("i:<index>") and per-field row keys
("f:<index>:<field>"). Ids are 1-based dense sequences per namespace (the
reference's allocator semantics).

Read-only replicas follow a primary by streaming the log (reference
PrimaryTranslateStore, translate.go:259-310) — see server/client.py.

Log entry layout (little-endian):
    <I payload_len> <Q id> <H ns_len> <ns bytes> <key bytes>
Legacy JSON-framed logs (round 1) are detected and migrated on open.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from array import array
from hashlib import blake2b as _blake2b
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HDR = struct.Struct("<I")
_ENT = struct.Struct("<QH")


class _OffsetTable:
    """Linear-probe open-addressing map: key bytes -> log offset. Stores
    only int64 offsets; key comparison reads the log through `read_key`."""

    __slots__ = ("slots", "n")

    def __init__(self, capacity: int = 1024):
        self.slots = np.full(capacity, -1, dtype=np.int64)
        self.n = 0

    @staticmethod
    def _hash(full_key: bytes) -> int:
        # Deterministic across processes (unlike PYTHONHASHSEED-randomized
        # hash(bytes)) so probe distribution and rebuild cost are
        # reproducible; blake2b is C-speed for the short keys involved.
        return int.from_bytes(_blake2b(full_key, digest_size=8).digest(), "little")

    def _idx(self, h: int) -> int:
        return h % len(self.slots)

    def get(self, full_key: bytes, read_key) -> int:
        """Offset for full_key, or -1."""
        slots = self.slots
        i = self._idx(self._hash(full_key))
        for _ in range(len(slots)):
            off = slots[i]
            if off < 0:
                return -1
            if read_key(int(off)) == full_key:
                return int(off)
            i = (i + 1) % len(slots)
        return -1

    def put(self, full_key: bytes, offset: int, read_key) -> None:
        if (self.n + 1) * 10 > len(self.slots) * 7:  # load factor 0.7
            self._grow(read_key)
        slots = self.slots
        i = self._idx(self._hash(full_key))
        while slots[i] >= 0:
            i = (i + 1) % len(slots)
        slots[i] = offset
        self.n += 1

    def _grow(self, read_key) -> None:
        old = self.slots[self.slots >= 0]
        self.slots = np.full(len(self.slots) * 2, -1, dtype=np.int64)
        slots = self.slots
        for off in old:
            i = self._idx(self._hash(read_key(int(off))))
            while slots[i] >= 0:
                i = (i + 1) % len(slots)
            slots[i] = off

class TranslateStore:
    def __init__(self, path: Optional[str] = None, read_only: bool = False):
        self.path = path
        self.read_only = read_only
        self._lock = threading.Lock()
        self._table = _OffsetTable()
        # ns -> array('q') of entry offsets indexed by id-1 (dense 1-based)
        self._ids: Dict[str, array] = {}
        self._log = None          # append handle (writable stores with a path)
        self._fd: Optional[int] = None  # pread handle over the on-disk log
        self._tail = bytearray()  # entries not yet on disk (read-only stores)
        self._disk_size = 0       # bytes of log on disk (pread range)
        self._size = 0            # total log bytes (disk + tail)

    # ------------------------------------------------------------ lifecycle

    def open(self) -> "TranslateStore":
        if self.path and os.path.exists(self.path):
            if self._is_legacy_log():
                if self.read_only:
                    # A read-only replica must not rewrite shared on-disk
                    # state: decode the legacy log into the in-memory tail
                    # and leave the file untouched (only the store that owns
                    # the append handle migrates).
                    for ns, key, id in self._parse_legacy():
                        off = self._append_raw(self._encode(ns, key, id))
                        self._index_entry(off)
                    return self
                self._migrate_legacy()
            self._fd = os.open(self.path, os.O_RDONLY)
            self._disk_size = os.fstat(self._fd).st_size
            self._build_index()
            if self._size < os.fstat(self._fd).st_size and not self.read_only:
                # Drop a truncated trailing entry (crash mid-write) so the
                # append handle continues at the clean prefix — otherwise
                # every new entry's recorded offset points into garbage.
                os.truncate(self.path, self._size)
        if self.path and not self.read_only:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._log = open(self.path, "ab")
            if self._fd is None:
                self._fd = os.open(self.path, os.O_RDONLY)
        return self

    def _is_legacy_log(self) -> bool:
        """Round-1 logs framed JSON arrays after the length prefix; probe
        the first entry — a binary payload is valid JSON only by freak
        coincidence, and a JSON payload never parses as a sane binary
        entry, so parsing disambiguates."""
        with open(self.path, "rb") as f:
            head = f.read(4)
            if len(head) < 4:
                return False
            (n,) = _HDR.unpack(head)
            payload = f.read(n)
        if len(payload) < n or not payload.startswith(b"["):
            return False
        try:
            entry = json.loads(payload)
        except ValueError:
            return False
        return isinstance(entry, list) and len(entry) == 3

    def _parse_legacy(self) -> List[Tuple[str, str, int]]:
        """Decode a round-1 JSON-framed log into (ns, key, id) entries."""
        entries: List[Tuple[str, str, int]] = []
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (n,) = _HDR.unpack_from(data, pos)
            if pos + 4 + n > len(data):
                break
            try:
                ns, key, id = json.loads(data[pos + 4 : pos + 4 + n])
            except ValueError:
                break
            entries.append((ns, key, id))
            pos += 4 + n
        return entries

    def _migrate_legacy(self) -> None:
        """Rewrite a round-1 JSON-framed log in the binary layout."""
        tmp = self.path + ".migrate"
        with open(tmp, "wb") as f:
            for ns, key, id in self._parse_legacy():
                f.write(self._encode(ns, key, id))
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._log:
            self._log.close()
            self._log = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    # ------------------------------------------------------------- log I/O

    @staticmethod
    def _encode(ns: str, key: str, id: int) -> bytes:
        nsb, keyb = ns.encode(), key.encode()
        payload = _ENT.pack(id, len(nsb)) + nsb + keyb
        return _HDR.pack(len(payload)) + payload

    def _entry_at(self, offset: int) -> Tuple[int, str, str]:
        """(id, ns, key) parsed lazily from the log."""
        raw = self._read(offset, 4)
        (n,) = _HDR.unpack(raw)
        payload = self._read(offset + 4, n)
        id, ns_len = _ENT.unpack_from(payload, 0)
        ns = payload[10 : 10 + ns_len].decode()
        key = payload[10 + ns_len :].decode()
        return id, ns, key

    def _full_key_at(self, offset: int) -> bytes:
        raw = self._read(offset, 4)
        (n,) = _HDR.unpack(raw)
        payload = self._read(offset + 4, n)
        (_, ns_len) = _ENT.unpack_from(payload, 0)
        return payload[2 + 8 : 2 + 8 + ns_len] + b"\x00" + payload[10 + ns_len :]

    def _read(self, offset: int, n: int) -> bytes:
        if offset < self._disk_size:
            return os.pread(self._fd, n, offset)
        t = offset - self._disk_size
        return bytes(self._tail[t : t + n])

    def _build_index(self) -> None:
        """One sequential scan of the log; memory gets offsets only."""
        pos = 0
        size = self._disk_size
        while pos + 4 <= size:
            raw = os.pread(self._fd, 4, pos)
            (n,) = _HDR.unpack(raw)
            if pos + 4 + n > size:
                break  # truncated trailing entry
            self._index_entry(pos)
            pos += 4 + n
        self._size = pos
        self._disk_size = pos  # ignore a truncated tail

    def _index_entry(self, offset: int) -> None:
        id, ns, key = self._entry_at(offset)
        self._table.put(f"{ns}\x00{key}".encode(), offset, self._full_key_at)
        ids = self._ids.setdefault(ns, array("q"))
        while len(ids) < id:
            ids.append(-1)
        ids[id - 1] = offset

    def _append_raw(self, entry: bytes) -> int:
        """Write entry bytes to the log (disk or tail); returns its offset."""
        offset = self._size
        if self._log:
            self._log.write(entry)
            self._log.flush()
            self._disk_size += len(entry)
        else:
            self._tail.extend(entry)
        self._size += len(entry)
        return offset

    def _append(self, ns: str, key: str, id: int) -> None:
        offset = self._append_raw(self._encode(ns, key, id))
        self._table.put(f"{ns}\x00{key}".encode(), offset, self._full_key_at)
        ids = self._ids.setdefault(ns, array("q"))
        while len(ids) < id:
            ids.append(-1)
        ids[id - 1] = offset

    # ----------------------------------------------------------- translate

    def _lookup(self, ns: str, key: str) -> int:
        off = self._table.get(f"{ns}\x00{key}".encode(), self._full_key_at)
        if off < 0:
            return 0
        return self._entry_at(off)[0]

    def _key_for(self, ns: str, id: int) -> str:
        ids = self._ids.get(ns)
        if ids is None or not (1 <= id <= len(ids)) or ids[id - 1] < 0:
            return ""
        return self._entry_at(ids[id - 1])[2]

    def _create(self, ns: str, keys: Sequence[str]) -> List[int]:
        from .errors import TranslateStoreReadOnlyError

        out = []
        with self._lock:
            for key in keys:
                id = self._lookup(ns, key)
                if id == 0:
                    if self.read_only:
                        raise TranslateStoreReadOnlyError(ns)
                    id = len(self._ids.get(ns, ())) + 1
                    self._append(ns, key, id)
                out.append(id)
        return out

    def translate_columns_to_uint64(self, index: str, keys: Sequence[str]) -> List[int]:
        return self._create(f"i:{index}", keys)

    def translate_column_to_string(self, index: str, id: int) -> str:
        return self._key_for(f"i:{index}", id)

    def translate_columns_to_string(self, index: str, ids: Sequence[int]) -> List[str]:
        return [self._key_for(f"i:{index}", i) for i in ids]

    def translate_rows_to_uint64(self, index: str, field: str, keys: Sequence[str]) -> List[int]:
        return self._create(f"f:{index}:{field}", keys)

    def translate_row_to_string(self, index: str, field: str, id: int) -> str:
        return self._key_for(f"f:{index}:{field}", id)

    def translate_rows_to_string(self, index: str, field: str, ids: Sequence[int]) -> List[str]:
        return [self._key_for(f"f:{index}:{field}", i) for i in ids]

    # ---------------------------------------------------------- replication

    def size(self) -> int:
        return self._size

    def read_from(self, offset: int):
        """Raw log bytes from offset (for replica streaming): the binary
        disk prefix followed by the in-memory tail, so size() and the bytes
        served agree even on read-only replicas whose applied entries only
        live in the tail (a chained downstream replica must see them)."""
        out = b""
        if self._fd is not None and offset < self._disk_size:
            out = os.pread(self._fd, self._disk_size - offset, offset)
            offset = self._disk_size
        t = offset - self._disk_size
        if t < len(self._tail):
            out += bytes(self._tail[t:])
        return out

    def apply_log(self, data: bytes) -> int:
        """Apply streamed log bytes on a replica; returns bytes consumed."""
        pos = 0
        with self._lock:
            while pos + 4 <= len(data):
                (n,) = _HDR.unpack_from(data, pos)
                if pos + 4 + n > len(data):
                    break
                offset = self._append_raw(data[pos : pos + 4 + n])
                self._index_entry(offset)
                pos += 4 + n
        return pos
