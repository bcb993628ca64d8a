"""The per-index CDC change log: positions, retention, base images.

One append-only file per index under `<data-dir>/cdc/<index>/log`
(pathless holders keep it in memory), carrying the hint-record framing
adapted to CDC:

  <I body_len> <I crc32(body)> body
  body := <Q position> <Q shard> <d stamp> <H len(index)> <H len(field)>
          <H len(view)> index field view ops

`stamp` is the LEADER's wall clock (time.time()) at append. Geo
followers (pilosa_tpu/geo/) derive replication lag from it by comparing
leader stamps against the leader-reported head time — never against a
follower clock, so cross-cluster clock skew cancels out of the lag.

`ops` is a run of storage/bitmap.py WAL records (point + OP_BULK) —
byte-identical to what the fragment's own WAL appended for the same
write and replayed through the SAME decode_op_records framing, so the
CDC codec can never drift from the WAL/rebalance/hint codec.

Position model: a single monotonically increasing counter per index,
starting at 1, assigned under the log lock at append time (the caller
holds the fragment mutex, so per-fragment stream order is apply order;
lock order is always fragment._mu -> log lock). Positions survive the
background-snapshot WAL splice by construction — this log is a separate
file that the splice never touches — and survive restart because the
open scan (storage/logscan.py, shared with the hint store) recovers
last_pos from the retained records and `meta` persists the fold
baseline.

Retention: when the log exceeds retention-bytes/retention-ops, the
oldest records are FOLDED into per-fragment base images (roaring bytes
+ the position each is current at, under `base/`) and dropped from the
log file (tmp + os.replace). base_pos is the highest folded position: a
cursor/at-position below it answers a typed 410 (errors.CdcGoneError).

Incarnation: a random token persisted in `meta` and deleted with the
index. A deleted+recreated index restarts positions at 1 under a fresh
incarnation, so a consumer's stale cursor can never silently alias the
new sequence (mirrors the fragment/write-epoch incarnation rule).

Jax-free (pilint R2): numpy + stdlib only, via storage/bitmap.py.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from .. import failpoints
from ..errors import CdcGoneError

_HEAD = struct.Struct("<II")
_BODY = struct.Struct("<QQdHHH")

# Torn-tail scanning needs an upper bound to reject absurd lengths from
# bit rot without reading the whole remainder as one "record".
_MAX_RECORD = 256 << 20


class CdcRecord:
    __slots__ = ("position", "index", "field", "view", "shard", "ops",
                 "size", "stamp")

    def __init__(self, position, index, field, view, shard, ops, size=0,
                 stamp=0.0):
        self.position = position
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.ops = ops   # WAL op records (storage/bitmap decode_op_records)
        self.size = size  # on-disk footprint incl. framing
        self.stamp = stamp  # leader wall clock at append (lag derivation)


def encode_cdc_record(rec: CdcRecord) -> bytes:
    i = rec.index.encode()
    f = rec.field.encode()
    v = rec.view.encode()
    body = _BODY.pack(rec.position, rec.shard, rec.stamp,
                      len(i), len(f), len(v)) \
        + i + f + v + rec.ops
    return _HEAD.pack(len(body), zlib.crc32(body)) + body


def decode_cdc_records(data: bytes, offset: int = 0):
    """Yield (record, next_offset) from `offset`; stops at the first
    incomplete or checksum-failing record (the torn tail) — the exact
    contract storage/logscan.scan_log expects, shared with the hint
    store's decode_records."""
    n = len(data)
    while offset + _HEAD.size <= n:
        body_len, crc = _HEAD.unpack_from(data, offset)
        end = offset + _HEAD.size + body_len
        if body_len > _MAX_RECORD or end > n:
            return
        body = data[offset + _HEAD.size:end]
        if zlib.crc32(body) != crc:
            return
        position, shard, stamp, li, lf, lv = _BODY.unpack_from(body, 0)
        p = _BODY.size
        index = body[p:p + li].decode()
        field = body[p + li:p + li + lf].decode()
        view = body[p + li + lf:p + li + lf + lv].decode()
        ops = bytes(body[p + li + lf + lv:])
        yield CdcRecord(position, index, field, view, shard, ops,
                        size=end - offset, stamp=stamp), end
        offset = end


def _frag_key(field: str, view: str, shard: int) -> str:
    # Field/view names are validate_name()-constrained ([a-z0-9_-] plus
    # view prefixes), so '@' can never appear in them.
    return f"{field}@{view}@{shard}"


class CdcLog:
    """One index's change log + point-in-time base images.

    Thread model: appends come from write threads holding the owning
    fragment's mutex; stream reads, bootstrap, PIT materialization and
    compaction share the single log lock. Long-poll waiters ride the
    condition variable and are woken by every append (and by close, so
    a dropped index never strands a consumer)."""

    def __init__(self, index: str, path: Optional[str], config,
                 storage_config, counters: Optional[Dict[str, int]] = None):
        self.index = index
        self.path = path  # directory; None = memory-only
        self.config = config
        self.storage_config = storage_config
        self.counters = counters if counters is not None else {}
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.closed = False
        # Server shutdown signal: parked long-poll readers wake and return
        # an EMPTY chunk (a routine re-poll answer) instead of holding
        # their handler threads until the poll timeout — and instead of
        # the closed->410 path, which means "this index is GONE" and would
        # make a live consumer discard a perfectly good cursor.
        self.interrupted = False
        self.last_pos = 0   # newest assigned position (0 = none yet)
        self.base_pos = 0   # highest position folded into base images
        self.size = 0       # retained log bytes
        self.ops = 0        # retained record count
        self.appends = 0    # lifetime appends (counter surface)
        self.compactions = 0
        self._unsynced = 0
        self._fh = None
        self._mem = bytearray()  # pathless log body
        # (position, byte_offset) per retained record, in order — the
        # stream cursor bisects this to find its resume offset.
        self._offsets: List[Tuple[int, int]] = []
        # Keys (field@view@shard) with at least one retained record:
        # register-time base cuts skip these (their history is already
        # fully in the log, so an empty implicit base is exact).
        self._keys = set()
        # Pathless base images: key -> (cut_pos, roaring bytes).
        self._mem_bases: Dict[str, Tuple[int, bytes]] = {}
        # Whether any base image exists: a consumer at cursor 0 then
        # needs a bootstrap, since positions 1.. do not carry that data.
        self.has_bases = False
        self.incarnation = os.urandom(8).hex()
        if self.path:
            self._open()

    # ------------------------------------------------------------ lifecycle

    @property
    def _log_path(self) -> str:
        return os.path.join(self.path, "log")

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.path, "meta")

    def _base_dir(self) -> str:
        return os.path.join(self.path, "base")

    def _open(self) -> None:
        from ..storage.logscan import scan_log

        os.makedirs(self.path, exist_ok=True)
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    meta = json.load(f)
                self.incarnation = meta.get("incarnation", self.incarnation)
                self.base_pos = int(meta.get("base_pos", 0))
            except (OSError, ValueError):
                pass  # fresh meta below; a fresh incarnation 410s cursors
        else:
            self._persist_meta()
        self.last_pos = self.base_pos
        base_dir = self._base_dir()
        self.has_bases = os.path.isdir(base_dir) and any(
            not n.endswith(".tmp") for n in os.listdir(base_dir))

        def note(rec):
            self._offsets.append((rec.position, self.size))
            self.size += rec.size
            self.ops += 1
            self.last_pos = max(self.last_pos, rec.position)
            self._keys.add(_frag_key(rec.field, rec.view, rec.shard))

        res = scan_log(self._log_path, decode_cdc_records, on_record=note)
        if res.truncated:
            self.counters["cdc_truncated"] = \
                self.counters.get("cdc_truncated", 0) + 1
        self._fh = open(self._log_path, "ab")

    def _persist_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"incarnation": self.incarnation,
                       "base_pos": self.base_pos}, f)
            f.flush()
            if self.storage_config.fsync != "never":
                # pilint: allow-blocking(meta durability boundary: base_pos must hit disk under the log lock or a crash mid-compaction re-serves folded positions as live)
                os.fsync(f.fileno())
        # pilint: allow-blocking(atomic meta install under the log lock; tiny file, same tmp+replace contract as the fragment snapshot rename)
        os.replace(tmp, self._meta_path)

    def interrupt(self) -> None:
        """Unpark long-poll waiters without killing the log (server
        shutdown, NOT index drop — drop keeps closed->410 semantics)."""
        with self.cond:
            self.interrupted = True
            self.cond.notify_all()

    def close(self) -> None:
        with self.cond:
            self.closed = True
            if self._fh is not None:
                try:
                    if self._unsynced and self.storage_config.fsync != "never":
                        # pilint: allow-blocking(close-boundary flush: batch-mode appends owe one fsync before the handle drops, same contract as the hint log close)
                        os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()
                self._fh = None
            self.cond.notify_all()

    # -------------------------------------------------------------- append

    def append(self, field: str, view: str, shard: int, ops: bytes) -> int:
        """Append one captured WAL op record, assigning the next
        position. The caller holds the owning fragment's mutex — the
        only sanctioned order (fragment._mu -> log lock)."""
        with self.cond:
            if self.closed:
                return 0
            pos = self.last_pos + 1
            frame = encode_cdc_record(
                CdcRecord(pos, self.index, field, view, shard, ops,
                          stamp=time.time()))
            try:
                failpoints.fire("cdc-append")
                if self._fh is not None:
                    self._fh.write(frame)
                    self._fh.flush()
                    self._fsync_locked()
                else:
                    self._mem += frame
            except OSError:
                self.counters["cdc_append_errors"] = \
                    self.counters.get("cdc_append_errors", 0) + 1
                if self._fh is not None:
                    self._truncate_torn_locked()
                raise
            self._offsets.append((pos, self.size))
            self.size += len(frame)
            self.ops += 1
            self.appends += 1
            self.last_pos = pos
            self._keys.add(_frag_key(field, view, shard))
            self._maybe_compact_locked()
            self.cond.notify_all()
            return pos

    def _truncate_torn_locked(self) -> None:
        """A failed append may have left a partial frame at the tail; a
        later successful append would bury it mid-log, where the open
        scan rightly truncates everything after it. Cut back to the last
        whole-record boundary now (self.size) — same move as the
        fragment WAL's _truncate_torn_append."""
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        try:
            os.truncate(self._log_path, self.size)
        except OSError:
            pass  # the open-time scan still recovers
        self._fh = open(self._log_path, "ab")

    def _fsync_locked(self) -> None:
        mode = self.storage_config.fsync
        if mode == "always":
            # pilint: allow-blocking(stream durability is ordered with the write ack, same contract as the WAL fsync beside it)
            os.fsync(self._fh.fileno())
            self._unsynced = 0
        elif mode != "never":
            self._unsynced += 1
            if self._unsynced >= self.storage_config.fsync_batch_ops:
                # pilint: allow-blocking(batch-mode sync point, one fsync per N acked change records)
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    # ---------------------------------------------------------- base images

    def base(self, field: str, view: str, shard: int) \
            -> Optional[Tuple[int, bytes]]:
        """(cut_pos, roaring bytes) of the fragment's base image, or
        None (= empty bitmap current at position 0)."""
        key = _frag_key(field, view, shard)
        with self.lock:
            return self._base_locked(key)

    def _base_locked(self, key: str) -> Optional[Tuple[int, bytes]]:
        if self.path is None:
            return self._mem_bases.get(key)
        p = os.path.join(self._base_dir(), key)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            head = f.read(8)
            data = f.read()
        (cut_pos,) = struct.unpack("<Q", head)
        return cut_pos, data

    def _set_base_locked(self, key: str, cut_pos: int, data: bytes) -> None:
        self.has_bases = True
        if self.path is None:
            self._mem_bases[key] = (cut_pos, data)
            return
        os.makedirs(self._base_dir(), exist_ok=True)
        p = os.path.join(self._base_dir(), key)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", cut_pos))
            f.write(data)
            f.flush()
            if self.storage_config.fsync != "never":
                # pilint: allow-blocking(base-image durability boundary: the image must be on disk before compaction drops the records it folds, or a crash loses that history)
                os.fsync(f.fileno())
        # pilint: allow-blocking(atomic base-image install under the log lock, same tmp+replace contract as the fragment snapshot rename)
        os.replace(tmp, p)

    def cut_base(self, frag) -> None:
        """Cut a point-in-time base image for a fragment whose data
        predates change capture. Caller must NOT hold the log lock; this
        takes frag._mu then the log lock (the sanctioned order). Skipped
        when the fragment already has a base or its whole history is in
        the log (then the implicit empty base at position 0 is exact)."""
        key = _frag_key(frag.field, frag.view, frag.shard)
        with self.lock:
            if self._base_locked(key) is not None or key in self._keys:
                return
        with frag._mu:
            # Position read under the fragment mutex: every op of THIS
            # fragment already applied has a position <= this value, and
            # every later one will be > it — so the clone is exactly the
            # fragment's state at cut_pos.
            with self.lock:
                cut_pos = self.last_pos
            clone = frag.storage.cow_clone()
        try:
            if not clone.count():
                return  # empty base == no base
            data = clone.to_bytes()
        finally:
            clone.cow_release()
        with self.lock:
            if self._base_locked(key) is None and key not in self._keys:
                self._set_base_locked(key, cut_pos, data)

    # ----------------------------------------------------------- retention

    def _maybe_compact_locked(self) -> None:
        over_bytes = self.config.retention_bytes and \
            self.size > self.config.retention_bytes
        over_ops = self.config.retention_ops and \
            self.ops > self.config.retention_ops
        if not (over_bytes or over_ops):
            return
        # Fold down to half the budget (hysteresis: one compaction per
        # half-window of ingest, not one per append at the cap).
        tb = self.config.retention_bytes // 2 if self.config.retention_bytes \
            else self.size
        to = self.config.retention_ops // 2 if self.config.retention_ops \
            else self.ops
        drop = 0
        dropped_bytes = 0
        while drop < len(self._offsets) and (
                self.size - dropped_bytes > tb or self.ops - drop > to):
            nxt = self._offsets[drop + 1][1] if drop + 1 < len(self._offsets) \
                else self.size
            dropped_bytes = nxt
            drop += 1
        if not drop:
            return
        self._compact_locked(drop, dropped_bytes)

    def _read_locked(self, start: int, length: int) -> bytes:
        if self.path is None:
            return bytes(self._mem[start:start + length])
        with open(self._log_path, "rb") as f:
            f.seek(start)
            return f.read(length)

    def _compact_locked(self, drop: int, dropped_bytes: int) -> None:
        from ..storage.bitmap import Bitmap, replay_ops

        prefix = self._read_locked(0, dropped_bytes)
        # Fold the dropped prefix into the base images, batched per
        # fragment (records replay in position order within the prefix).
        folds: Dict[str, Tuple[int, Bitmap]] = {}
        new_base = self.base_pos
        for rec, _end in decode_cdc_records(prefix):
            key = _frag_key(rec.field, rec.view, rec.shard)
            got = folds.get(key)
            if got is None:
                base = self._base_locked(key)
                bm = Bitmap.from_bytes(base[1]) if base else Bitmap()
            else:
                bm = got[1]
            replay_ops(bm, rec.ops)
            folds[key] = (rec.position, bm)
            new_base = rec.position
        if not folds:
            # Zero records decoded from a prefix _offsets says holds
            # `drop` of them: the in-memory index and the log bytes
            # disagree. Dropping the offsets anyway would corrupt the
            # stream; skip this compaction and surface the anomaly.
            self.counters["cdc_compact_skipped"] = \
                self.counters.get("cdc_compact_skipped", 0) + 1
            return
        for key, (cut_pos, bm) in folds.items():
            self._set_base_locked(key, cut_pos, bm.to_bytes())
        # Drop the prefix from the log and rebase the offsets.
        tail = self._read_locked(dropped_bytes, self.size - dropped_bytes)
        if self.path is None:
            self._mem = bytearray(tail)
        else:
            tmp = self._log_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(tail)
                f.flush()
                if self.storage_config.fsync != "never":
                    # pilint: allow-blocking(tail rewrite durability: the truncated log must be on disk before the offsets rebase, or a crash replays dropped positions)
                    os.fsync(f.fileno())
            if self._fh is not None:
                self._fh.close()
            # pilint: allow-blocking(atomic log-tail install; writers are parked on this lock by design — compaction is the one stop-the-world moment per retention half-window)
            os.replace(tmp, self._log_path)
            self._fh = open(self._log_path, "ab")
            self._unsynced = 0
        self._offsets = [(p, o - dropped_bytes)
                         for p, o in self._offsets[drop:]]
        self._keys = set()
        # Rebuilding retained keys needs the records; the offsets list
        # alone doesn't carry them. Decode the (already in memory) tail.
        for rec, _end in decode_cdc_records(tail):
            self._keys.add(_frag_key(rec.field, rec.view, rec.shard))
        self.size -= dropped_bytes
        self.ops -= drop
        self.base_pos = new_base
        self.compactions += 1
        if self.path is not None:
            self._persist_meta()

    # -------------------------------------------------------------- stream

    def first_pos(self) -> int:
        """Oldest retained position (base_pos + 1 when anything is
        retained)."""
        with self.lock:
            return self._offsets[0][0] if self._offsets else self.last_pos + 1

    def check_cursor_locked(self, from_pos: int,
                            inc: Optional[str]) -> None:
        if inc and inc != self.incarnation:
            raise CdcGoneError(
                f"stale incarnation for index {self.index!r}: the index "
                "was deleted and recreated; re-bootstrap",
                first=self.base_pos + 1, last=self.last_pos,
                incarnation=self.incarnation)
        if from_pos < self.base_pos:
            raise CdcGoneError(
                f"cursor {from_pos} of index {self.index!r} fell behind "
                f"retention (oldest retained position is "
                f"{self.base_pos + 1}); re-bootstrap",
                first=self.base_pos + 1, last=self.last_pos,
                incarnation=self.incarnation)

    def read(self, from_pos: int, inc: Optional[str] = None,
             max_bytes: int = 4 << 20, timeout: float = 0.0) \
            -> Tuple[bytes, int]:
        """Raw retained frames for positions > from_pos, cut at a record
        boundary near max_bytes (always at least one record). Returns
        (frames, next_cursor). Blocks up to `timeout` seconds at the log
        head (long-poll); a cursor behind retention or under a stale
        incarnation raises CdcGoneError. The bytes are byte-identical to
        the on-disk log slice — the stream cannot drift from the codec
        that wrote it."""
        import bisect

        deadline = time.monotonic() + max(0.0, timeout)
        with self.cond:
            self.check_cursor_locked(from_pos, inc)
            while self.last_pos <= from_pos and not self.closed \
                    and not self.interrupted:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return b"", from_pos
                # pilint: allow-blocking(long-poll wait point: releases the log lock while parked; appends wake it)
                self.cond.wait(remaining)
            if self.interrupted and self.last_pos <= from_pos:
                # Server shutdown unparked us with nothing new: answer an
                # empty poll (the consumer re-polls and then sees the
                # socket die), NOT the closed->410 below — 410 means "the
                # INDEX is gone, re-bootstrap", which a restart isn't.
                return b"", from_pos
            if self.closed:
                raise CdcGoneError(
                    f"index {self.index!r} dropped mid-stream",
                    incarnation=self.incarnation)
            # Re-validate under the SAME lock hold before bisecting:
            # while this reader was parked, an append may have triggered
            # compaction that folded positions past from_pos (base_pos
            # advanced). The entry-time check above predates that fold;
            # reading on regardless would silently skip the folded span
            # — a replication gap with no 410/bootstrap signal.
            self.check_cursor_locked(from_pos, inc)
            # First retained record with position > from_pos.
            i = bisect.bisect_right([p for p, _ in self._offsets], from_pos)
            if i >= len(self._offsets):
                if self.last_pos > from_pos:
                    # Positions past the cursor exist but none are
                    # retained: everything after from_pos was folded.
                    # Jumping the cursor to last_pos here would silently
                    # drop those records — route to bootstrap instead.
                    raise CdcGoneError(
                        f"cursor {from_pos} of index {self.index!r} fell "
                        f"behind retention (positions through "
                        f"{self.last_pos} were folded into base images); "
                        "re-bootstrap",
                        first=self.base_pos + 1, last=self.last_pos,
                        incarnation=self.incarnation)
                return b"", from_pos
            start = self._offsets[i][1]
            j = i
            while j + 1 < len(self._offsets) and \
                    self._offsets[j + 1][1] - start <= max_bytes:
                j += 1
            end = self._offsets[j + 1][1] if j + 1 < len(self._offsets) \
                else self.size
            data = self._read_locked(start, end - start)
            return data, self._offsets[j][0]

    def records_for(self, field: str, view: str, shard: int,
                    upto: int) -> bytes:
        """Concatenated WAL op bytes of one fragment's retained records
        with position <= upto, in position order — the PIT replay tail."""
        return self.base_and_records_for(field, view, shard, upto)[1]

    def base_and_records_for(self, field: str, view: str, shard: int,
                             upto: int):
        """Atomic (base image, replay tail) snapshot for PIT
        materialization: the base and the retained log bytes are read
        under ONE lock hold, so a compaction cannot fold records between
        the two reads. Read separately, the folded span (old_cut,
        new_cut] would land in neither the stale base nor the tail — a
        silently wrong historical fragment. Returns (base, ops) where
        base is (cut_pos, roaring bytes) or None and ops is the
        concatenated WAL op bytes with position <= upto."""
        key = _frag_key(field, view, shard)
        with self.lock:
            if upto < self.base_pos:
                raise CdcGoneError(
                    f"position {upto} of index {self.index!r} fell behind "
                    f"retention (oldest retained position is "
                    f"{self.base_pos + 1})",
                    first=self.base_pos + 1, last=self.last_pos,
                    incarnation=self.incarnation)
            base = self._base_locked(key)
            data = self._read_locked(0, self.size)
        out = []
        for rec, _end in decode_cdc_records(data):
            if rec.position > upto:
                break
            if rec.field == field and rec.view == view \
                    and rec.shard == shard:
                out.append(rec.ops)
        return base, b"".join(out)

    # ------------------------------------------------------------ counters

    def snapshot(self) -> Dict[str, int]:
        with self.lock:
            return {
                "first_pos": self._offsets[0][0] if self._offsets
                else self.last_pos + 1,
                "last_pos": self.last_pos,
                "base_pos": self.base_pos,
                "bytes": self.size,
                "ops": self.ops,
                "appends": self.appends,
                "compactions": self.compactions,
            }
