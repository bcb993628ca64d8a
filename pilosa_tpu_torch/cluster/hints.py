"""Hinted handoff: durable per-peer hint logs for missed write forwards.

The write path's last durability hole (docs/durability.md "Write-path
consistency"): a write forwarded to a breaker-open or failing replica used
to be skipped outright, leaving the acked bit on a single node until the
next full anti-entropy sweep. This module closes it the Dynamo/Cassandra
way, adapted to the bitmap op-stream:

  capture      the coordinator's LOCAL apply already encodes every
               mutation as WAL op records (storage/bitmap.py point +
               OP_BULK codec — the same bytes the rebalance catch-up
               stream ships). core/fragment.py's capture hook hands those
               bytes to the executor's fan-out, so a hint is byte-
               identical to what the missed replica's own WAL would have
               recorded.

  append       when a forward is skipped (breaker open) or fails at the
               transport, the op batch is appended to a durable per-peer
               log under <data-dir>/hints/ — O(batch) disk write, never a
               connect timeout. While a peer has undelivered hints, LATER
               writes for it append behind them too (per-peer FIFO), so
               replay order matches coordinator apply order and a drain
               can never resurrect a bit a newer write cleared.

  deliver      a background daemon replays each peer's log in order with
               a checkpointed cursor, gated by the peer's circuit breaker
               (cluster/health.py): an OPEN breaker skips the peer for
               free, an elapsed backoff makes the delivery attempt the
               half-open probe, and a delivery success re-closes it.
               Replay is idempotent set/clear — a redelivered record after
               a crash between send and checkpoint is harmless.

  expire       records carry a wall-clock birth time; past `hint-ttl`
               they are dropped at delivery and the shard is flagged for
               the anti-entropy syncer, which orders flagged shards first
               (cluster/syncer.py). The syncer is always the backstop —
               hints only shrink the repair window from sweep-interval to
               seconds.

Hints that cannot carry op bytes (the coordinating node holds no local
replica of the shard, so nothing was captured) degrade to a MARKER: no
payload, but the (index, shard) is flagged for priority anti-entropy the
same way an expired hint is.

Jax-free and numpy/stdlib-only: config.py imports ReplicationConfig at
CLI startup.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .. import failpoints

WRITE_ONE = "one"
WRITE_QUORUM = "quorum"
WRITE_ALL = "all"
_LEVELS = (WRITE_ONE, WRITE_QUORUM, WRITE_ALL)


@dataclass
class ReplicationConfig:
    """The `[replication]` config section (TOML + env + CLI, config.py).
    See docs/durability.md "Write-path consistency"."""

    # Ack gate for the owner write fan-out (executor.tolerant_owner_fanout):
    # `one` acks when any owner applied (the reference's behavior),
    # `quorum` requires a majority of replicaN, `all` requires every
    # owner. An unmet level surfaces as a typed retryable 503 AFTER hints
    # were enqueued for the missed owners — there is no rollback; the
    # applied copies stand and repair flows toward the missed ones.
    write_consistency: str = WRITE_ONE
    # Hints older than this are dropped at delivery (their shard falls
    # back to priority anti-entropy). Bounds how stale a replayed op can
    # be, and how long a dead peer's log is worth keeping.
    hint_ttl: float = 3600.0
    # Per-peer hint log byte budget. At the cap, appends are refused (the
    # shard is flagged for priority anti-entropy instead) so one dead
    # peer under heavy ingest cannot eat the disk.
    hint_max_bytes: int = 64 << 20
    # Delivery daemon cadence (seconds between drain sweeps); 0 disables
    # background delivery (tests drive deliver_once() by hand).
    deliver_interval: float = 1.0
    # Max hint-log bytes replayed toward one peer per sweep: bounds how
    # long a drain monopolizes the daemon thread and how big a burst a
    # freshly-recovered peer absorbs at once.
    deliver_batch_bytes: int = 4 << 20

    def validate(self) -> "ReplicationConfig":
        if self.write_consistency not in _LEVELS:
            raise ValueError(
                "replication.write-consistency must be one of "
                f"{'/'.join(_LEVELS)}, got {self.write_consistency!r}")
        if self.hint_ttl <= 0:
            raise ValueError("replication.hint-ttl must be > 0")
        if self.hint_max_bytes < 0:
            raise ValueError("replication.hint-max-bytes must be >= 0")
        if self.deliver_interval < 0:
            raise ValueError("replication.deliver-interval must be >= 0")
        if self.deliver_batch_bytes <= 0:
            raise ValueError("replication.deliver-batch-bytes must be > 0")
        return self

    def required_owners(self, n_owners: int) -> int:
        """How many owners must APPLY (not hint) before the ack."""
        if self.write_consistency == WRITE_ALL:
            return n_owners
        if self.write_consistency == WRITE_QUORUM:
            return n_owners // 2 + 1
        return 1


# Hint record framing. One record per captured fragment op batch:
#
#   <I body_len> <I crc32(body)> body
#   body := <d created> <Q shard> <H len(index)> <H len(field)>
#           <H len(view)> index field view ops
#
# `ops` is a run of storage/bitmap.py WAL records (point + OP_BULK) —
# byte-identical to what the coordinator's local WAL appended for the
# same write, replayed on the peer via the SAME _apply_op_stream framing
# (storage/bitmap.decode_op_records) so the two codecs cannot drift.
# Empty ops = a marker hint (sync-priority only, no payload to replay).
_HEAD = struct.Struct("<II")
_BODY = struct.Struct("<dQHHH")

# Torn-tail scanning needs an upper bound to reject absurd lengths from
# bit rot without reading the whole remainder as one "record".
_MAX_RECORD = 256 << 20


class HintRecord:
    __slots__ = ("created", "index", "field", "view", "shard", "ops", "size")

    def __init__(self, created, index, field, view, shard, ops, size=0):
        self.created = created
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.ops = ops  # b"" for a marker hint
        self.size = size  # on-disk footprint incl. framing

    @property
    def marker(self) -> bool:
        return not self.ops


def encode_record(rec: HintRecord) -> bytes:
    i = rec.index.encode()
    f = rec.field.encode()
    v = rec.view.encode()
    body = _BODY.pack(rec.created, rec.shard, len(i), len(f), len(v)) \
        + i + f + v + rec.ops
    import zlib

    return _HEAD.pack(len(body), zlib.crc32(body)) + body


def decode_records(data: bytes, offset: int = 0):
    """Yield (record, next_offset) from `offset`; stops at the first
    incomplete or checksum-failing record (the torn tail). The caller
    decides whether trailing garbage is a crash artifact (truncate) —
    unlike the fragment WAL there is no quarantine tier: hints are a
    redundancy layer and anti-entropy backstops anything lost here."""
    import zlib

    n = len(data)
    while offset + _HEAD.size <= n:
        body_len, crc = _HEAD.unpack_from(data, offset)
        end = offset + _HEAD.size + body_len
        if body_len > _MAX_RECORD or end > n:
            return  # incomplete / implausible trailing record
        body = data[offset + _HEAD.size:end]
        if zlib.crc32(body) != crc:
            return
        created, shard, li, lf, lv = _BODY.unpack_from(body, 0)
        p = _BODY.size
        index = body[p:p + li].decode()
        field = body[p + li:p + li + lf].decode()
        view = body[p + li + lf:p + li + lf + lv].decode()
        ops = bytes(body[p + li + lf + lv:])
        yield HintRecord(created, index, field, view, shard, ops,
                         size=end - offset), end
        offset = end


def _peer_dirname(peer_id: str) -> str:
    # Peer ids are URIs in static clusters ("localhost:10101") — percent-
    # encode so ':' and '/' cannot escape the hints directory.
    return urllib.parse.quote(peer_id, safe="")


class _PeerLog:
    __slots__ = ("lock", "fh", "path", "cursor_path", "cursor", "size",
                 "pending", "shards", "unsynced")

    def __init__(self):
        self.lock = threading.Lock()
        self.fh = None
        self.path = ""
        self.cursor_path = ""
        self.cursor = 0  # delivered byte offset
        self.size = 0
        self.pending = 0  # undelivered record count
        self.shards: Dict[Tuple[str, int], int] = {}  # pending per shard
        self.unsynced = 0  # appends since last fsync (batch mode)


class HintStore:
    """Durable per-peer hint logs + the delivery state machine.

    Thread model: appends come from write fan-out threads, delivery from
    the server's monitor thread, snapshots from the handler. Per-peer
    state rides a per-peer lock; the store-level lock only guards the
    peer map and shared counters. Network sends never run under any lock
    (delivery reads records under the peer lock, sends outside it)."""

    def __init__(self, path: Optional[str],
                 config: Optional[ReplicationConfig] = None,
                 storage_config=None,
                 clock: Optional[Callable[[], float]] = None):
        from ..storage import StorageConfig

        self.path = path  # None = memory-only (library/test holders)
        self.config = (config or ReplicationConfig()).validate()
        self.storage_config = storage_config or StorageConfig()
        self.clock = clock or time.time
        self._mu = threading.Lock()
        # Delivery is single-flighted: cursors assume one replayer. The
        # server's daemon is normally the only caller, but tests drive
        # deliver_once by hand — a concurrent attempt returns 0 instead
        # of racing the cursor.
        self._deliver_mu = threading.Lock()
        self._peers: Dict[str, _PeerLog] = {}
        # Shards owed a priority anti-entropy pass: expired hints, marker
        # hints, overflow-refused appends. Cleared by note_synced when the
        # syncer repairs the shard.
        self._needs_sync: Set[Tuple[str, int]] = set()
        self.counters: Dict[str, int] = {
            "hints_appended": 0,
            "hints_delivered": 0,
            "hints_expired": 0,
            "hints_rejected": 0,   # peer answered 4xx: hint unreplayable
            "hints_markers": 0,
            "hints_overflow": 0,   # appends refused at hint-max-bytes
            "hints_truncated": 0,  # torn/corrupt log tails cut at open
            "append_errors": 0,
            "bytes_appended": 0,
            "bytes_delivered": 0,
            "drains": 0,           # peer logs drained to empty
            "deliver_errors": 0,
        }
        if self.path:
            os.makedirs(self.path, exist_ok=True)
            self._reload()

    # ----------------------------------------------------------- lifecycle

    def _reload(self) -> None:
        """Rebuild in-memory pending state from the on-disk logs (crash /
        restart recovery). A torn tail — the SIGKILL-mid-append artifact —
        truncates to the last whole-record boundary; garbage is never
        replayed toward a peer."""
        for name in sorted(os.listdir(self.path)):
            d = os.path.join(self.path, name)
            if not os.path.isdir(d):
                continue
            peer_id = urllib.parse.unquote(name)
            log = self._log(peer_id)
            with log.lock:
                self._open_locked(peer_id, log, scan=True)

    def close(self) -> None:
        with self._mu:
            peers = list(self._peers.values())
        for log in peers:
            with log.lock:
                if log.fh is not None:
                    try:
                        if log.unsynced and \
                                self.storage_config.fsync != "never":
                            # pilint: allow-blocking(close-boundary flush: batch-mode appends owe one fsync before the handle drops, same contract as the fragment WAL close)
                            os.fsync(log.fh.fileno())
                    except OSError:
                        pass
                    log.fh.close()
                    log.fh = None

    def _log(self, peer_id: str) -> _PeerLog:
        with self._mu:
            log = self._peers.get(peer_id)
            if log is None:
                log = self._peers[peer_id] = _PeerLog()
            return log

    def _open_locked(self, peer_id: str, log: _PeerLog, scan: bool) -> None:
        """Open (creating) the peer's log + cursor. Must hold log.lock."""
        if self.path is None or log.fh is not None:
            return
        d = os.path.join(self.path, _peer_dirname(peer_id))
        os.makedirs(d, exist_ok=True)
        log.path = os.path.join(d, "log")
        log.cursor_path = os.path.join(d, "cursor")
        cursor = 0
        if os.path.exists(log.cursor_path):
            try:
                with open(log.cursor_path) as f:
                    cursor = int(f.read().strip() or 0)
            except (OSError, ValueError):
                cursor = 0  # re-deliver from 0: replay is idempotent
        size = os.path.getsize(log.path) if os.path.exists(log.path) else 0
        cursor = min(cursor, size)
        valid = cursor
        if scan and size > cursor:
            # Bounded chunked scan shared with the CDC change log
            # (storage/logscan.py): one reader, one set of torn-tail
            # semantics — a record spanning a chunk boundary is extended
            # by the next read, and whatever tail remains at EOF is torn
            # and truncated to the last whole-record boundary.
            from ..storage.logscan import scan_log

            now = self.clock()

            def note(rec):
                log.pending += 1
                key = (rec.index, rec.shard)
                log.shards[key] = log.shards.get(key, 0) + 1
                if rec.marker or now - rec.created > self.config.hint_ttl:
                    self._needs_sync.add(key)

            res = scan_log(log.path, decode_records, start=cursor,
                           on_record=note)
            if res.truncated:
                with self._mu:
                    self.counters["hints_truncated"] += 1
            size = res.valid
        log.size = size
        log.cursor = min(cursor, log.size)
        log.fh = open(log.path, "ab")

    # -------------------------------------------------------------- append

    def add(self, peer_id: str, index: str, shard: int,
            records: Optional[List[Tuple[object, bytes]]]) -> bool:
        """Append the captured op batch for one write as hints toward
        `peer_id`. `records` is [(fragment, ops_bytes), ...] from the
        coordinator's local apply (core/fragment.capture_hint_ops); empty
        or None degrades to a marker hint: no replayable payload, but the
        (index, shard) is flagged for priority anti-entropy.

        Returns True when the hint is DURABLE per the [storage] fsync
        policy (the caller counts the owner as hinted-not-applied either
        way; False means the miss is covered only by the sweep)."""
        now = self.clock()
        recs = []
        if records and self.path is not None:
            recs = [HintRecord(now, f.index, f.field, f.view, f.shard, ops)
                    for f, ops in records if ops]
        if not recs:
            # No replayable payload (coordinator holds no local replica of
            # the shard, or a pathless store has nowhere durable to put
            # one): flag the shard for priority anti-entropy instead.
            with self._mu:
                self.counters["hints_markers"] += 1
                self._needs_sync.add((index, shard))
            if self.path is None:
                return False
            recs = [HintRecord(now, index, "", "", shard, b"")]
        log = self._log(peer_id)
        encoded = []
        for r in recs:
            b = encode_record(r)
            if len(b) - _HEAD.size > _MAX_RECORD:
                # decode_records treats an implausible body length as a
                # torn tail, so appending this record would WEDGE the
                # peer's drain forever (cursor can never pass it, and
                # the FIFO pre-check would queue every later write
                # behind it). Refuse the whole write's batch up front;
                # the sweep repairs every shard it touched.
                with self._mu:
                    self.counters["hints_overflow"] += 1
                    for rr in recs:
                        self._needs_sync.add((rr.index, rr.shard))
                return False
            encoded.append(b)
        payload = b"".join(encoded)
        with log.lock:
            self._open_locked(peer_id, log, scan=False)
            budget = self.config.hint_max_bytes
            if budget and log.size - log.cursor + len(payload) > budget:
                with self._mu:
                    self.counters["hints_overflow"] += 1
                    for r in recs:
                        self._needs_sync.add((r.index, r.shard))
                return False
            try:
                failpoints.fire("hint-append")
                log.fh.write(payload)
                log.fh.flush()
                self._fsync_locked(log)
            except OSError:
                with self._mu:
                    self.counters["append_errors"] += 1
                    for r in recs:
                        self._needs_sync.add((r.index, r.shard))
                return False
            log.size += len(payload)
            for r in recs:
                log.pending += 1
                key = (r.index, r.shard)
                log.shards[key] = log.shards.get(key, 0) + 1
        with self._mu:
            self.counters["hints_appended"] += len(recs)
            self.counters["bytes_appended"] += len(payload)
        return True

    def _fsync_locked(self, log: _PeerLog) -> None:
        """[storage] fsync policy applied to the hint log: `always` syncs
        per append, `batch` every fsync-batch-ops appends (the ack may
        ride up to N-1 page-cache hints across a power loss — same
        contract as the WAL), `never` leaves it to the page cache."""
        if log.fh is None:
            return
        mode = self.storage_config.fsync
        if mode == "always":
            # pilint: allow-blocking(hint durability is ordered with the write ack, exactly like the WAL fsync the hint stands in for)
            os.fsync(log.fh.fileno())
            log.unsynced = 0
        elif mode != "never":
            log.unsynced += 1
            if log.unsynced >= self.storage_config.fsync_batch_ops:
                # pilint: allow-blocking(batch-mode sync point, one fsync per N acked hints)
                os.fsync(log.fh.fileno())
                log.unsynced = 0

    # ------------------------------------------------------------ queries

    def pending(self, peer_id: str) -> int:
        with self._mu:
            log = self._peers.get(peer_id)
        if log is None:
            return 0
        with log.lock:
            return log.pending

    def peers_with_pending(self) -> List[str]:
        with self._mu:
            peers = list(self._peers.items())
        out = []
        for pid, log in peers:
            with log.lock:
                if log.pending:
                    out.append(pid)
        return out

    def priority_shards(self) -> Set[Tuple[str, int]]:
        """(index, shard) pairs the anti-entropy syncer should visit
        FIRST: shards with undelivered hints toward any peer, plus shards
        whose hints expired / overflowed / degraded to markers."""
        with self._mu:
            out = set(self._needs_sync)
            peers = list(self._peers.values())
        for log in peers:
            with log.lock:
                out.update(k for k, n in log.shards.items() if n > 0)
        return out

    def note_synced(self, index: str, shard: int) -> None:
        """The anti-entropy syncer repaired this shard wholesale: the
        sweep-priority flag is settled. Pending per-peer hint records
        stay — replaying them is idempotent and cheaper than surgically
        dropping mid-log records."""
        with self._mu:
            self._needs_sync.discard((index, shard))

    def prune(self, peer_id: str) -> None:
        """Drop all hint state for a node removed from the cluster."""
        with self._mu:
            log = self._peers.pop(peer_id, None)
        if log is None:
            return
        with log.lock:
            if log.fh is not None:
                log.fh.close()
                log.fh = None
            for p in (log.path, log.cursor_path):
                if p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

    # ------------------------------------------------------------ delivery

    def deliver_once(self, cluster, client, logger=None) -> int:
        """One delivery sweep: for every peer with pending hints whose
        breaker admits a request (cluster/health.py — an elapsed backoff
        makes this attempt the half-open probe), replay up to
        deliver-batch-bytes of records in order, checkpoint the cursor,
        and compact a fully-drained log. Returns records delivered."""
        if not self._deliver_mu.acquire(blocking=False):
            return 0  # another sweep is mid-flight; it owns the cursors
        try:
            delivered = 0
            for peer_id in self.peers_with_pending():
                node = cluster.node_by_id(peer_id)
                if node is None:
                    # Departed the membership: its hints are undeliverable.
                    self.prune(peer_id)
                    continue
                if not cluster.health.allow_request(peer_id):
                    continue
                # pilint: allow-blocking(_deliver_mu is a try-acquire single-flight busy flag, not a data lock: contenders return 0 immediately, so nothing can queue behind the replay's network sends)
                delivered += self._deliver_peer(peer_id, node, cluster.health,
                                                client, logger)
            return delivered
        finally:
            self._deliver_mu.release()

    def _deliver_peer(self, peer_id: str, node, health, client,
                      logger) -> int:
        from ..server.client import ClientError

        log = self._log(peer_id)
        with log.lock:
            self._open_locked(peer_id, log, scan=False)
            start = log.cursor
            remaining = max(0, log.size - start)
            data = b""
            if log.path and remaining and os.path.exists(log.path):
                with open(log.path, "rb") as f:
                    f.seek(start)
                    data = f.read(self.config.deliver_batch_bytes)
                    if not next(iter(decode_records(data)), None) and \
                            len(data) < remaining:
                        # One record bigger than the batch budget: read it
                        # whole rather than stalling the drain forever.
                        f.seek(start)
                        data = f.read(remaining)
        # Parse + send OUTSIDE the lock: appends land behind `start` and
        # are untouched; this store's single delivery thread owns the
        # cursor, so nothing else advances it concurrently.
        now = self.clock()
        cursor = start
        done: List[HintRecord] = []
        sent = 0
        for rec, end in decode_records(data):
            if rec.marker or now - rec.created > self.config.hint_ttl:
                if not rec.marker:
                    with self._mu:
                        self.counters["hints_expired"] += 1
                        self._needs_sync.add((rec.index, rec.shard))
                cursor = start + end
                done.append(rec)
                continue
            try:
                failpoints.fire("hint-deliver",
                                target=getattr(node, "uri", None))
                client.send_hint_ops(node, rec.index, rec.field, rec.view,
                                     rec.shard, rec.ops)
            except (ClientError, OSError) as e:
                status = getattr(e, "status", 0)
                if 400 <= status < 500:
                    # Deterministic rejection (field/index deleted since
                    # the hint was written): unreplayable, skip past it;
                    # transport success for the breaker.
                    health.record_success(peer_id)
                    with self._mu:
                        self.counters["hints_rejected"] += 1
                        self._needs_sync.add((rec.index, rec.shard))
                    cursor = start + end
                    done.append(rec)
                    continue
                health.record_failure(peer_id)
                with self._mu:
                    self.counters["deliver_errors"] += 1
                if logger is not None:
                    logger.error("hint delivery to %s failed at %s/%s: %s",
                                 peer_id, rec.index, rec.shard, e)
                break  # keep order: retry from this record next sweep
            health.record_success(peer_id)
            sent += 1
            with self._mu:
                self.counters["hints_delivered"] += 1
                self.counters["bytes_delivered"] += rec.size
                # A drained shard still gets ONE priority sweep: the
                # per-peer FIFO covers writes that SAW the pending
                # backlog, but a write racing the very first in-flight
                # failing forward can slip a newer op to the peer before
                # the hint lands behind it — replaying that hint would
                # then resurrect stale state. The verifying sweep (block
                # checksums; a no-op when nothing diverged) closes that
                # window at priority order instead of the full walk.
                self._needs_sync.add((rec.index, rec.shard))
            cursor = start + end
            done.append(rec)
        if not done:
            return 0
        with log.lock:
            log.cursor = cursor
            for rec in done:
                log.pending = max(0, log.pending - 1)
                key = (rec.index, rec.shard)
                n = log.shards.get(key, 0) - 1
                if n <= 0:
                    log.shards.pop(key, None)
                else:
                    log.shards[key] = n
            self._checkpoint_locked(log)
            if log.pending == 0 and log.cursor >= log.size and log.size:
                self._compact_locked(log)
                with self._mu:
                    self.counters["drains"] += 1
                if logger is not None:
                    logger.info("hint log for %s drained", peer_id)
        return sent

    def _checkpoint_locked(self, log: _PeerLog) -> None:
        if not log.cursor_path:
            return
        tmp = log.cursor_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(str(log.cursor))
            # pilint: allow-blocking(cursor checkpoint is ordered with the delivery it acknowledges; a stale cursor only re-delivers idempotent records)
            os.replace(tmp, log.cursor_path)
        except OSError:
            # A lost checkpoint re-delivers from the old cursor: replay
            # is idempotent, so this is latency, not corruption.
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _compact_locked(self, log: _PeerLog) -> None:
        """Fully-drained log: reset to empty instead of growing forever.
        Appends hold the same lock, so no record can land mid-reset."""
        if log.fh is not None:
            log.fh.close()
        try:
            if log.path:
                with open(log.path, "wb"):
                    pass
        except OSError:
            pass
        log.fh = open(log.path, "ab") if log.path else None
        log.size = 0
        log.cursor = 0
        log.unsynced = 0
        self._checkpoint_locked(log)

    # ----------------------------------------------------------- testing

    def records(self, peer_id: str) -> List[HintRecord]:
        """Undelivered records for one peer (tests + diagnostics)."""
        with self._mu:
            log = self._peers.get(peer_id)
        if log is None:
            return []
        with log.lock:
            if not log.path or not os.path.exists(log.path):
                return []
            with open(log.path, "rb") as f:
                f.seek(log.cursor)
                data = f.read()
        return [rec for rec, _ in decode_records(data)]

    # -------------------------------------------------------- inspection

    def snapshot(self) -> dict:
        """Counters + per-peer pending state for /debug/vars
        (`replication` group) and diagnostics."""
        with self._mu:
            counters = dict(self.counters)
            needs = len(self._needs_sync)
            peers = list(self._peers.items())
        per_peer = {}
        for pid, log in peers:
            with log.lock:
                if log.pending or log.size > log.cursor:
                    per_peer[pid] = {
                        "pending": log.pending,
                        "bytes": max(0, log.size - log.cursor),
                    }
        return {
            "writeConsistency": self.config.write_consistency,
            "peers": per_peer,
            "needsSyncShards": needs,
            **counters,
        }
