"""Fragment: the compute+storage unit = (index, field, view, shard).

Behavioral port of reference fragment.go re-architected around
device-resident bitplanes (int32 torch tensors on the holder's device):

- Authoritative cold storage is a host roaring bitmap (storage/bitmap.py) with
  bit position = rowID*SHARD_WIDTH + columnID%SHARD_WIDTH (fragment.go:1935),
  persisted in the reference's roaring file format with an appended op-log WAL
  and snapshot-at-2000-ops semantics (fragment.go:63,167-224,1399-1469).
- Hot compute state is dense uint32 bitplanes materialized per row on device
  (HBM) and cached; all set algebra / counts / BSI / TopN math runs there
  (ops/bitplane.py). Writes invalidate the affected row's plane.
- TopN keeps the reference's rank/LRU cache design (fragment.go:870-1058) but
  replaces the per-row IntersectionCount walk with one batched device popcount
  over a stacked candidate plane tensor — identical results (candidates are
  count-descending, so the early-exit conditions commute with batching).
"""

from __future__ import annotations

import heapq
import itertools
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import (
    CACHE_TYPE_NONE,
    CACHE_TYPE_RANKED,
    DEFAULT_CACHE_SIZE,
    HASH_BLOCK_SIZE,
    MAX_OP_N,
    SHARD_WIDTH,
)
from .. import failpoints
from ..errors import ColumnRowOutOfRangeError, CorruptFragmentError, PilosaError
from ..ops import bitplane as bp
from ..storage import FSYNC_ALWAYS, FSYNC_NEVER, StorageConfig
from ..storage.bitmap import (
    OP_ADD,
    OP_REMOVE,
    OP_SIZE,
    Bitmap,
    _as_container,
    encode_bulk_op,
    encode_op,
)
from .cache import NopCache, Pair, new_cache, sort_pairs
from .row import Row

import hashlib

# TopN batched intersection-count chunk (rows per device call).
TOPN_BATCH = 256

# Dirty-word journal bound (total recorded words per fragment). The journal
# is what makes device-cache refresh cost proportional to the WRITE, not the
# plane (parallel/engine.py delta path); past this many un-consumed entries
# it resets and the next refresh of each cached row falls back to a full
# regather. Env default (same name as the [engine] config section's env
# override — ONE spelling per knob); per-Fragment override rides the
# Holder -> Index -> Field -> View chain like StorageConfig.
DELTA_JOURNAL_OPS = int(
    os.environ.get("PILOSA_TPU_ENGINE_DELTA_JOURNAL_OPS", "4096"))

# Process-wide incarnation ids for Fragment and WriteEpoch instances.
# Generations and epochs RESET when an index/fragment is deleted and
# recreated under the same name, while the engine's caches (keyed by name)
# survive — a recreated counter that climbs back to a cached value would
# alias a stale entry as fresh (or, worse, let a partial delta patch the
# OLD object's plane). Pairing every counter with an instance-unique
# incarnation makes cross-incarnation values never compare equal.
# itertools.count.__next__ is atomic under CPython's GIL.
_INCARNATION = itertools.count(1)

# Hinted-handoff op capture (cluster/hints.py): while a capture is armed
# on the CURRENT THREAD, every WAL op record a fragment encodes is also
# handed to the collector as (fragment, record_bytes) — the coordinator's
# local apply thereby yields the exact byte payload a missed replica
# forward must eventually replay, with zero re-encoding and no chance of
# the hint format drifting from the WAL format. Thread-local so a write
# fan-out capturing its own apply never sees concurrent writers' ops, and
# inert (one attribute miss) when no capture is armed.
_hint_capture = threading.local()


class capture_hint_ops:
    """Context manager arming hint capture on this thread; appended
    entries land in `into` as (fragment, op_record_bytes)."""

    def __init__(self, into: list):
        self.into = into
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_hint_capture, "into", None)
        _hint_capture.into = self.into
        return self.into

    def __exit__(self, *exc):
        _hint_capture.into = self._prev
        return False


def _capture_op(frag, record: bytes) -> None:
    into = getattr(_hint_capture, "into", None)
    if into is not None:
        into.append((frag, record))


def _block_hasher():
    """THE merkle block digest (one definition for the streaming blocks()
    path and the _block_hash oracle, so they cannot silently diverge).

    The reference uses xxhash over (row, col) pairs (fragment.go:1078-1174);
    we use blake2b-8 — checksums only ever compare against this framework's
    own, so cross-implementation byte parity is not required."""
    return hashlib.blake2b(digest_size=8)


def _block_hash(positions: np.ndarray) -> bytes:
    """Checksum of sorted bit positions within a merkle block."""
    h = _block_hasher()
    h.update(positions.astype("<u8").tobytes())
    return h.digest()


class WriteEpoch:
    """Monotonic per-index write counter, bumped by every fragment
    mutation in the index. O(1) to read, so serving-path layers (the
    query micro-batcher's group key, /debug/vars) can ask "has ANYTHING
    in this index changed?" without walking per-fragment generations.
    Locked: an unlocked += can regress under a read-stall-write race
    (load 5, preempt through 95 bumps, store 6), and a regressed epoch
    could collide a batch key with one seen before a write burst. Reads
    are a bare attribute load — a torn read is impossible for an int."""

    __slots__ = ("value", "incarnation", "_mu")

    def __init__(self):
        self.value = 0
        # See _INCARNATION: lets epoch-keyed memo entries distinguish a
        # recreated index whose fresh counter climbed back to an old value.
        self.incarnation = next(_INCARNATION)
        self._mu = threading.Lock()

    def bump(self) -> None:
        with self._mu:
            self.value += 1


@dataclass
class FragmentBlock:
    id: int
    checksum: bytes

    def to_dict(self):
        return {"id": self.id, "checksum": self.checksum.hex()}


@dataclass
class TopOptions:
    """Options for Fragment.top (reference fragment.go topOptions)."""

    n: int = 0
    src: Optional[Row] = None
    row_ids: Sequence[int] = ()
    min_threshold: int = 0
    filter_name: str = ""
    filter_values: Sequence = ()
    tanimoto_threshold: int = 0


class Fragment:
    def __init__(
        self,
        path: Optional[str],
        index: str,
        field: str,
        view: str,
        shard: int,
        cache_type: str = CACHE_TYPE_RANKED,
        cache_size: int = DEFAULT_CACHE_SIZE,
        row_attr_store=None,
        stats=None,
        max_op_n: int = MAX_OP_N,
        epoch: Optional[WriteEpoch] = None,
        storage_config: Optional[StorageConfig] = None,
        delta_journal_ops: Optional[int] = None,
        snapshotter=None,
        cdc=None,
        device=None,
    ):
        self.path = path
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.cache_type = cache_type
        self.cache = new_cache(cache_type, cache_size)
        self.row_attr_store = row_attr_store
        self.stats = stats
        self.max_op_n = max_op_n

        self.storage = Bitmap()
        self.op_n = 0
        self.storage_config = storage_config or StorageConfig()
        # WAL appends since the last fsync (drives the `batch` fsync mode).
        self._unsynced_ops = 0
        # Snapshot-trigger accounting (docs/ingest.md): op-log bytes
        # appended since the last snapshot vs. the container-section bytes
        # that snapshot wrote. The policy (snapshot_due) fires when the
        # log exceeds storage.snapshot-ratio x the base — write cost stays
        # O(batch) with total snapshot I/O amortized geometrically.
        self.wal_bytes = 0
        self.storage_bytes = 0
        # monotonic time of the FIRST append since the last snapshot:
        # the snapshotter's periodic sweep ages fragments on it.
        self.wal_since: Optional[float] = None
        # Background snapshotter (storage/snapshotter.py), threaded down
        # Holder -> Index -> Field -> View like storage_config. None =
        # snapshot inline (standalone fragments keep today's synchronous
        # semantics; tests rely on them).
        self._snapshotter = snapshotter
        # CDC change-stream manager (cdc/manager.py), threaded down
        # Holder -> Index -> Field -> View like the snapshotter. Every
        # WAL-codec op record appended here is also handed to the CDC
        # log, stamped with the per-index position, under this same
        # mutex (lock order is always fragment._mu -> cdc log lock).
        self.cdc = cdc
        self.device = device
        # Bumped by every COMPLETED storage-file rewrite. A background
        # snapshot records it at handoff and aborts its rename if an
        # inline snapshot / replica restore rewrote the file meanwhile —
        # renaming a stale rewrite over a newer file would resurrect
        # folded-away ops.
        self._snapshot_seq = 0
        # Crash-safety state: quarantined means the on-disk file failed
        # validation at open — the bad bytes were moved aside to
        # `<path>.corrupt` (corrupt_path) and this fragment serves/accepts
        # data from a fresh empty file until anti-entropy repairs it from a
        # replica. recovered_tail_bytes counts torn WAL bytes discarded by
        # the last open (0 = the file parsed clean).
        self.quarantined = False
        self.corrupt_path: Optional[str] = None
        self.quarantine_reason: Optional[str] = None
        self.recovered_tail_bytes = 0
        # Write mutex (reference fragment.go f.mu): the HTTP server applies
        # writes from many threads, and container mutations are multi-step
        # numpy read-modify-write sequences that would otherwise interleave
        # and lose updates. Reads stay lock-free — form transitions assign
        # the new form before clearing the old so a concurrent reader
        # always sees a value-complete container, and the engine's
        # generation counters handle staleness.
        self._mu = threading.RLock()
        self._wal = None  # append handle to the storage file
        self._plane_cache: Dict[int, torch.Tensor] = {}
        self._checksums: Dict[int, bytes] = {}
        self._opened = False
        # Bumped on every mutation; lets the sharded query engine know when
        # its device-resident leaf tensors are stale (parallel/engine.py).
        # Paired with `incarnation` in engine fingerprints so a recreated
        # fragment's fresh counter can never alias a stale cache entry.
        self.generation = 0
        self.incarnation = next(_INCARNATION)
        # Index-level write epoch (see WriteEpoch), bumped alongside
        # generation so O(1) index staleness reads need no fragment walk.
        self.epoch = epoch
        # Dirty-word journal. The engine's delta-refresh path asks
        # dirty_words_since(row, cached_gen) to upload only the changed
        # words of a stale resident plane instead of re-walking and
        # re-shipping the whole (S, W) tensor. Bounded by delta_journal_ops
        # unique dirty words; overflow or a bulk mutation without word info
        # poisons the affected rows (floor dicts) so stale readers fall
        # back to a full regather — never to a partial delta.
        self.delta_journal_ops = (
            DELTA_JOURNAL_OPS if delta_journal_ops is None else delta_journal_ops
        )
        # row -> {w64: generation of its LAST mutation}. A dict, not an
        # append log: re-writing a hot word updates its generation in
        # place, so the journal is bounded by UNIQUE dirty words.
        self._dirty: Dict[int, Dict[int, int]] = {}
        self._dirty_n = 0
        # Per-row completeness floor: deltas are answerable only for cached
        # generations >= max(row floor, fragment floor).
        self._dirty_floor: Dict[int, int] = {}
        self._dirty_floor_all = 0
        # Live-migration state (cluster/rebalance.py). _migrating counts
        # open source-side sessions: while nonzero the snapshot policy
        # defers so the WAL positions those sessions hold stay meaningful.
        # _moved flips at shard cutover: the shard now lives on a new
        # owner, and any write here must fail with ShardMovedError so the
        # caller re-routes instead of acking into a doomed copy.
        self._migrating = 0
        self._moved = False

    # ---------------------------------------------------------------- open

    def open(self) -> None:
        failpoints.fire("fragment-open")
        if self.path:
            # A leftover .snapshotting temp means a crash mid-snapshot:
            # the original file (with its op log) is still the durable
            # truth; the partial rewrite is garbage. Remove it BEFORE
            # parsing so a later snapshot can't rename torn bytes into
            # place.
            for tmp in (self.path + ".snapshotting",
                        self.path + ".snapshotting.bg"):
                if os.path.exists(tmp):
                    os.remove(tmp)
        if self.path and os.path.exists(self.path):
            size = os.path.getsize(self.path)
            if size:
                # mmap + zero-copy parse (the reference mmaps too,
                # fragment.go:167-224): open cost is O(container headers),
                # payloads are paged in on first touch, and host RAM is not
                # double-buffered. Mutations copy-on-write; snapshot()
                # replaces the inode so live views stay valid.
                import mmap

                with open(self.path, "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                try:
                    self.storage = Bitmap.from_buffer(mm, copy=False)
                except (ValueError, struct.error) as e:
                    # Includes CorruptFragmentError (a ValueError subclass)
                    # plus raw numpy/struct failures from mangled payloads.
                    # One bad fragment must not take the node down: move the
                    # bytes aside and boot empty; anti-entropy repairs from
                    # a replica (cluster/syncer.py), and until then queries
                    # read this fragment as empty.
                    self._quarantine(e)
                else:
                    self.op_n = self.storage.op_n
                    self.wal_bytes = self.storage.ops_bytes
                    if self.wal_bytes:
                        self.wal_since = time.monotonic()
                    self.storage_bytes = (
                        self.storage.valid_len - self.storage.ops_bytes)
                    if self.storage.truncated_bytes:
                        # Torn WAL tail (crash mid-append): every complete
                        # op was replayed; cut the file back to the last
                        # valid record boundary so the garbage can never
                        # sit between old and future ops.
                        self.recovered_tail_bytes = self.storage.truncated_bytes
                        os.truncate(self.path, self.storage.valid_len)
                        if self.stats:
                            self.stats.count(
                                "walTailTruncatedBytes", self.recovered_tail_bytes
                            )
        if self.path:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if not os.path.exists(self.path):
                with open(self.path, "wb") as f:
                    # Captured so storage_bytes + wal_bytes is ALWAYS the
                    # valid file length (the torn-append truncation and
                    # the snapshot ratio trigger both rely on it).
                    self.storage_bytes = self.storage.write_to(f)
            self._wal = open(self.path, "ab")
            if not self.quarantined and os.path.exists(self.path + ".corrupt"):
                # A .corrupt sibling left by a previous run whose quarantine
                # was never repaired: the current file holds only the
                # degraded-period writes, so stay quarantined until
                # anti-entropy restores the rest from a replica.
                self.quarantined = True
                self.corrupt_path = self.path + ".corrupt"
                self.quarantine_reason = (
                    f"carried over from previous run ({self.corrupt_path} present)"
                )
        self._load_cache()
        self._opened = True

    def _quarantine(self, err: Exception) -> None:
        """Move a corrupt fragment file aside and come up empty (repairable)."""
        corrupt = self.path + ".corrupt"
        os.replace(self.path, corrupt)
        self.quarantined = True
        self.corrupt_path = corrupt
        self.storage = Bitmap()
        self.op_n = 0
        if self.stats:
            self.stats.count("fragmentQuarantined", 1)
        detail = err if isinstance(err, CorruptFragmentError) else repr(err)
        self.quarantine_reason = str(detail)

    def clear_quarantine(self) -> None:
        """Called once a repair (replica restore) made local data whole.
        Removes the .corrupt forensic copy — it doubles as the persistent
        quarantine marker, so leaving it would re-quarantine on restart."""
        if self.corrupt_path:
            try:
                os.remove(self.corrupt_path)
            except OSError:
                pass
        self.quarantined = False
        self.corrupt_path = None
        self.quarantine_reason = None

    def close(self) -> None:
        # Under the mutex: closing the WAL out from under a writer inside
        # _append_op would drop the op from disk after the in-memory
        # mutation already landed.
        with self._mu:
            self._flush_cache()
            if self._wal:
                if (self._unsynced_ops
                        and self.storage_config.fsync != FSYNC_NEVER):
                    # `batch` mode promises a sync at every close boundary.
                    self._wal.flush()
                    # pilint: allow-blocking(close boundary: the mutex must pin the WAL open until its final sync lands)
                    os.fsync(self._wal.fileno())
                    self._unsynced_ops = 0
                self._wal.close()
                self._wal = None
            self._opened = False

    # ------------------------------------------------------------ positions

    def pos(self, row_id: int, column_id: int) -> int:
        min_col = self.shard * SHARD_WIDTH
        if not (min_col <= column_id < min_col + SHARD_WIDTH):
            raise ColumnRowOutOfRangeError(
                f"column {column_id} out of bounds for shard {self.shard}"
            )
        return row_id * SHARD_WIDTH + (column_id % SHARD_WIDTH)

    # ----------------------------------------------------------- row planes

    def plane(self, row_id: int) -> torch.Tensor:
        """Bitplane for one row (local column space): an int32 tensor on
        the holder's device, cached until the row is written."""
        cached = self._plane_cache.get(row_id)
        if cached is not None:
            return cached
        p = bp.to_tensor(self.plane_np(row_id), self._device())
        self._plane_cache[row_id] = p
        return p

    def plane_np(self, row_id: int) -> np.ndarray:
        """Host numpy bitplane for one row (for batched sharded assembly).

        Dense storage containers are copied word-for-word (no value-list
        round trip); only the container walk is per-row work."""
        start = row_id * SHARD_WIDTH
        return self.storage.range_words(start, start + SHARD_WIDTH).view(np.uint32)

    def plane_stack(self, row_ids: Sequence[int]) -> torch.Tensor:
        return torch.stack([self.plane(r) for r in row_ids])

    def _device(self) -> torch.device:
        # A fragment built outside a holder (tests) keeps its planes on
        # the CPU; every holder-owned fragment has the holder's device.
        return torch.device("cpu") if self.device is None else self.device

    def row(self, row_id: int) -> Row:
        return Row({self.shard: self.plane(row_id)})

    def row_count(self, row_id: int) -> int:
        start = row_id * SHARD_WIDTH
        return self.storage.count_range(start, start + SHARD_WIDTH)

    def row_counts(self, row_ids) -> np.ndarray:
        """Cardinalities of many rows with ONE batched key search —
        batching the per-row `row_count` calls a bulk import makes. Only
        the TOUCHED rows' containers are visited (never the whole
        fragment: a lazily-opened multi-GB file must not be paged in and
        popcounted because 10 bits landed in one row). Rows are
        container-aligned at the default shard width; the non-aligned
        fallback keeps exotic PILOSA_TPU_SHARD_WIDTH_EXP settings
        correct."""
        row_ids = np.asarray(row_ids, dtype=np.int64)
        if len(row_ids) == 0:
            return np.zeros(0, dtype=np.int64)
        if SHARD_WIDTH % (1 << 16):
            return np.array(
                [self.row_count(int(r)) for r in row_ids], dtype=np.int64)
        cpr = SHARD_WIDTH >> 16  # containers per row
        keys = self.storage._sorted_keys()
        out = np.zeros(len(row_ids), dtype=np.int64)
        if not len(keys):
            return out
        lo = np.searchsorted(keys, row_ids * cpr)
        hi = np.searchsorted(keys, (row_ids + 1) * cpr)
        for i in range(len(row_ids)):
            total = 0
            for k in keys[lo[i]:hi[i]]:
                c = self.storage.containers.get(int(k))
                if c is None:  # dropped by a concurrent writer
                    continue
                c = _as_container(c)
                c.verify_n()
                total += c.n
            out[i] = total
        return out

    def rows(self) -> List[int]:
        """Row ids with at least one bit set."""
        # list() snapshots the key set in one C-level call; a python-level
        # iteration would raise if a locked writer inserts a container.
        keys = list(self.storage.containers)
        seen = sorted({(int(key) << 16) // SHARD_WIDTH for key in keys})
        return [int(r) for r in seen]

    def bit(self, row_id: int, column_id: int) -> bool:
        return self.storage.contains(self.pos(row_id, column_id))

    # --------------------------------------------------------------- writes

    def _invalidate_row(self, row_id: int, dirty_w64=None) -> None:
        """Invalidate caches for one mutated row. EVERY mutation path must
        come through here (or read_from's whole-fragment equivalent): the
        generation bump is what stale-proofs the engine's device caches and
        the epoch bump is what stale-proofs the memo's O(1) probe — a path
        that skips either serves stale results silently
        (tests/test_torch_delta.py parametrizes the audit).

        `dirty_w64` is the iterable of changed 64-bit word indices within
        the row plane; None means the caller can't enumerate them (bulk
        storage ops), which poisons this row's journal so the next delta
        probe falls back to a full regather."""
        self._plane_cache.pop(row_id, None)
        self._checksums.pop(row_id // HASH_BLOCK_SIZE, None)
        self.generation += 1
        if dirty_w64 is None or SHARD_WIDTH % 64:
            dropped = self._dirty.pop(row_id, None)
            if dropped:
                self._dirty_n -= len(dropped)
            self._dirty_floor[row_id] = self.generation
            if len(self._dirty_floor) > max(self.delta_journal_ops, 1):
                self._journal_reset()
        else:
            g = self.generation
            d = self._dirty.setdefault(row_id, {})
            for w in dirty_w64:
                w = int(w)
                if w not in d:
                    self._dirty_n += 1
                d[w] = g
            if self._dirty_n > self.delta_journal_ops:
                self._journal_reset()
        if self.epoch is not None:
            self.epoch.bump()

    def _journal_reset(self) -> None:
        """Drop all delta history: any cached generation older than NOW can
        no longer be delta-refreshed (returns None => full regather)."""
        self._dirty.clear()
        self._dirty_n = 0
        self._dirty_floor.clear()
        self._dirty_floor_all = self.generation

    def dirty_words_since(self, row_id: int, gen: int):
        """64-bit word indices (within the row plane) mutated after
        generation `gen`, or None when the journal can't answer (overflow,
        bulk mutation, or `gen` from a previous fragment incarnation) and
        the caller must fall back to a full plane regather. An EMPTY array
        means the generation churn came from OTHER rows of this fragment —
        the cached plane for this row is still byte-exact."""
        with self._mu:
            if gen > self.generation:
                # A generation from a prior incarnation of this fragment
                # (reopen resets the counter): history is unknowable.
                return None
            floor = max(self._dirty_floor.get(row_id, 0), self._dirty_floor_all)
            if gen < floor:
                return None
            d = self._dirty.get(row_id)
            if not d:
                return np.empty(0, dtype=np.int64)
            words = [w for w, g in d.items() if g > gen]
            return np.array(words, dtype=np.int64)

    def row_words64(self, row_id: int, w64: np.ndarray) -> np.ndarray:
        """Current uint64 word values of the row plane at the given 64-bit
        word indices — O(touched containers), not O(plane): the host-side
        read half of a delta refresh."""
        base = (row_id * SHARD_WIDTH) >> 6
        return self.storage.words64(np.asarray(w64, dtype=np.int64) + base)

    def row_compressed(self, row_id: int) -> Tuple[bytes, Tuple[int, int]]:
        """Container-compressed snapshot of one row plane (roaring bytes,
        containers rebased to key 0) plus the (incarnation, generation)
        fingerprint it is exact at — the tier manager's demotion read. The
        container copies happen under the fragment mutex so a racing
        writer cannot tear a form transition mid-copy; the O(row bytes)
        serialization itself runs off-lock."""
        start = row_id * SHARD_WIDTH
        end = start + SHARD_WIDTH
        with self._mu:
            if SHARD_WIDTH % (1 << 16):
                # Exotic shard widths aren't container-aligned; rebuild
                # from values (correct, slower — tests only).
                vals = self.storage.slice_range(start, end)
                sub = Bitmap(vals - np.uint64(start) if len(vals) else None)
            else:
                sub = self.storage.offset_range(0, start, end)
            fp = (self.incarnation, self.generation)
        return sub.to_bytes(), fp

    def _check_moved(self) -> None:
        """Write gate for migrated-away fragments: raise BEFORE any
        mutation so a re-routed retry applies the write exactly once, on
        the new owner."""
        if self._moved:
            from ..errors import ShardMovedError

            raise ShardMovedError(
                f"{self.index}/{self.field}/{self.view}/{self.shard}")

    def set_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            self._check_moved()
            pos = self.pos(row_id, column_id)
            changed = self.storage.add(pos)
            if not changed:
                return False
            self._append_op(OP_ADD, pos)
            self._invalidate_row(row_id, ((pos % SHARD_WIDTH) >> 6,))
            self.cache.add(row_id, self.row_count(row_id))
        if self.stats:
            self.stats.count("setBit", 1)
        return True

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            self._check_moved()
            pos = self.pos(row_id, column_id)
            changed = self.storage.remove(pos)
            if not changed:
                return False
            self._append_op(OP_REMOVE, pos)
            self._invalidate_row(row_id, ((pos % SHARD_WIDTH) >> 6,))
            self.cache.add(row_id, self.row_count(row_id))
        if self.stats:
            self.stats.count("clearBit", 1)
        return True

    def _append_op(self, typ: int, pos: int) -> None:
        rec = None
        if self._wal or self.cdc is not None \
                or getattr(_hint_capture, "into", None) is not None:
            rec = encode_op(typ, pos)
            _capture_op(self, rec)
        if self._wal:
            failpoints.fire("wal-append")
            try:
                self._wal.write(rec)
                self._wal.flush()
            except OSError:
                self._truncate_torn_append()
                raise
            if self.wal_bytes == 0:
                self.wal_since = time.monotonic()
            self.wal_bytes += OP_SIZE
            self._fsync_policy()
        if self.cdc is not None:
            # After the WAL write: the stream only ever carries ops the
            # local WAL accepted. Still under _mu, so per-fragment CDC
            # order matches apply order.
            self.cdc.append(self, rec)
        self.op_n += 1
        self._maybe_snapshot()

    def _truncate_torn_append(self) -> None:
        """A failed append (ENOSPC, I/O error) may have left a PARTIAL
        record at the WAL tail. The fragment stays open for writes, so a
        later successful append would bury that garbage MID-log — which
        reopen rightly classifies as bit rot and quarantines, losing the
        whole fragment to what was a transient write failure. Cut the
        file back to the last whole-record boundary now; the invariant
        storage_bytes + wal_bytes == valid file length makes the
        boundary known without a parse."""
        valid = self.storage_bytes + self.wal_bytes
        try:
            self._wal.close()
        except OSError:
            pass
        self._wal = None
        try:
            os.truncate(self.path, valid)
        except OSError:
            pass  # reopen-time recovery still sees a torn FINAL record
        # Restore the append handle — a None _wal would silently skip WAL
        # logging for every later acknowledged write.
        self._wal = open(self.path, "ab")

    def _append_bulk_op(self, adds, removes) -> None:
        """Append ONE WAL record covering a whole import batch — the
        amortized replacement for the snapshot that used to end every
        bulk mutation. The in-memory mutation is already applied; crash
        safety comes from record replay at reopen (torn tails truncate,
        exactly like point ops)."""
        rec = None
        if self._wal or self.cdc is not None \
                or getattr(_hint_capture, "into", None) is not None:
            rec = encode_bulk_op(adds, removes)
            _capture_op(self, rec)
        if self._wal:
            failpoints.fire("bulk-wal-append")
            try:
                self._wal.write(rec)
                self._wal.flush()
            except OSError:
                # A multi-MB record makes a partial flush realistic:
                # truncate it away or the next append buries it mid-log.
                self._truncate_torn_append()
                raise
            if self.wal_bytes == 0:
                self.wal_since = time.monotonic()
            self.wal_bytes += len(rec)
            if self.storage_config.fsync != FSYNC_NEVER:
                # One fsync per bulk record, O(batch): the old
                # snapshot-per-batch path fsynced every acked import, so
                # riding the `batch` op counter here would silently leave
                # up to fsync-batch-ops-1 whole acked BATCHES in the page
                # cache across a power loss. The amortization win was the
                # removed O(fragment) file rewrite, not this fsync.
                # pilint: allow-blocking(WAL durability is ordered with the mutation: the record must be on disk before the mutex releases the ack)
                os.fsync(self._wal.fileno())
                self._unsynced_ops = 0
        if self.cdc is not None:
            self.cdc.append(self, rec)
        self.op_n += 1

    def _fsync_policy(self) -> None:
        mode = self.storage_config.fsync
        if mode == FSYNC_ALWAYS:
            # pilint: allow-blocking(fsync=always SELLS per-op durability under the mutex; that cost is the mode's contract, docs/durability.md)
            os.fsync(self._wal.fileno())
        elif mode != FSYNC_NEVER:
            self._unsynced_ops += 1
            if self._unsynced_ops >= self.storage_config.fsync_batch_ops:
                # pilint: allow-blocking(batch-mode sync point: one fsync per N acked ops, ordered with the op it makes durable)
                os.fsync(self._wal.fileno())
                self._unsynced_ops = 0

    def wal_sync(self) -> None:
        """Force any batch-deferred WAL appends to disk NOW. For callers
        that durably checkpoint external progress against this
        fragment's state (the geo tail cursor): the checkpoint may only
        claim positions whose WAL records are actually synced, or a
        crash loses the WAL tail while the checkpoint says those
        positions were applied — a gap that is never re-fetched."""
        with self._mu:
            if self._wal is not None and self._unsynced_ops \
                    and self.storage_config.fsync != FSYNC_NEVER:
                self._wal.flush()
                # pilint: allow-blocking(checkpoint ordering boundary: the geo cursor must not durably claim positions whose WAL records are still page-cache-only)
                os.fsync(self._wal.fileno())
                self._unsynced_ops = 0

    # ---------------------------------------------------- snapshot triggers

    def snapshot_due(self) -> bool:
        """Snapshot-trigger policy: op count (the reference's 2000-op
        threshold) OR op-log bytes exceeding snapshot-ratio x the last
        snapshot's container bytes (floored so a fresh fragment's first
        batches don't each trigger)."""
        if self._migrating:
            # Open migration sessions hold WAL positions into the current
            # file layout; a snapshot would fold the tail away and force
            # every stream back to a fresh base. Defer until they close.
            return False
        if self.op_n >= self.max_op_n:
            return True
        ratio = self.storage_config.snapshot_ratio
        if ratio and self.wal_bytes > ratio * max(
                self.storage_bytes, StorageConfig.SNAPSHOT_MIN_BASE):
            return True
        return False

    def _maybe_snapshot(self) -> None:
        if self.snapshot_due():
            self._request_snapshot()

    def _request_snapshot(self) -> None:
        """Snapshot now (inline) or hand the fragment to the holder's
        background snapshotter so the write path never blocks on
        snapshot I/O."""
        if self._snapshotter is not None and self.path:
            self._snapshotter.enqueue(self)
        else:
            self.snapshot()

    # ------------------------------------------------------------------ BSI

    def value(self, column_id: int, bit_depth: int) -> Tuple[int, bool]:
        """Read a BSI value at a column (reference fragment.go:468-490)."""
        if not self.bit(bit_depth, column_id):
            return 0, False
        value = 0
        for i in range(bit_depth):
            if self.bit(i, column_id):
                value |= 1 << i
        return value, True

    def set_value(self, column_id: int, bit_depth: int, value: int) -> bool:
        """Write a BSI value bit-by-bit (reference fragment.go:492-520).

        The whole composite holds the write mutex: per-bit locking alone
        would let two concurrent set_values interleave and store a torn
        value neither thread wrote."""
        with self._mu:
            changed = False
            for i in range(bit_depth):
                if (value >> i) & 1:
                    changed |= self.set_bit(i, column_id)
                else:
                    changed |= self.clear_bit(i, column_id)
            changed |= self.set_bit(bit_depth, column_id)
            return changed

    def _bsi_planes(self, bit_depth: int) -> torch.Tensor:
        return self.plane_stack(list(range(bit_depth + 1)))

    def _filter_plane(self, filter_row: Optional[Row]):
        if filter_row is None:
            return None
        seg = filter_row.segment_plane(self.shard)
        if seg is None:
            return torch.zeros_like(self.plane(0))
        return seg

    def sum(self, filter_row: Optional[Row], bit_depth: int) -> Tuple[int, int]:
        """(sum, count) over a BSI group (reference fragment.go:565-600)."""
        planes = self._bsi_planes(bit_depth)
        counts = bp.bsi_plane_counts(planes, self._filter_plane(filter_row)).cpu().numpy()
        total = sum((1 << i) * int(counts[i]) for i in range(bit_depth))
        return total, int(counts[bit_depth])

    def min(self, filter_row: Optional[Row], bit_depth: int) -> Tuple[int, int]:
        planes = self._bsi_planes(bit_depth)
        bits, count = bp.bsi_min(planes, bit_depth, self._filter_plane(filter_row))
        count = int(count)
        if count == 0 and not self._bsi_any(filter_row, bit_depth):
            return 0, 0
        return bp.compose_bits(bits), count

    def max(self, filter_row: Optional[Row], bit_depth: int) -> Tuple[int, int]:
        planes = self._bsi_planes(bit_depth)
        bits, count = bp.bsi_max(planes, bit_depth, self._filter_plane(filter_row))
        count = int(count)
        if count == 0 and not self._bsi_any(filter_row, bit_depth):
            return 0, 0
        return bp.compose_bits(bits), count

    def _bsi_any(self, filter_row: Optional[Row], bit_depth: int) -> bool:
        consider = self.plane(bit_depth)
        fp = self._filter_plane(filter_row)
        if fp is not None:
            consider = bp.p_and(consider, fp)
        return int(bp.count(consider)) > 0

    def range_op(self, op: str, bit_depth: int, predicate: int) -> Row:
        """op in {eq,neq,lt,lte,gt,gte} (reference fragment.go:660-681)."""
        planes = self._bsi_planes(bit_depth)
        if op == "eq":
            plane = bp.bsi_range_eq(planes, bit_depth, predicate)
        elif op == "neq":
            plane = bp.bsi_range_neq(planes, bit_depth, predicate)
        elif op in ("lt", "lte"):
            plane = bp.bsi_range_lt(planes, bit_depth, predicate, op == "lte")
        elif op in ("gt", "gte"):
            plane = bp.bsi_range_gt(planes, bit_depth, predicate, op == "gte")
        else:
            raise ValueError(f"invalid range operation: {op}")
        return Row({self.shard: plane})

    def range_between(self, bit_depth: int, pmin: int, pmax: int) -> Row:
        planes = self._bsi_planes(bit_depth)
        return Row({self.shard: bp.bsi_range_between(planes, bit_depth, pmin, pmax)})

    def not_null(self, bit_depth: int) -> Row:
        return self.row(bit_depth)

    # ----------------------------------------------------------------- TopN

    def top(self, opt: TopOptions, inter_counts: Optional[Dict[int, int]] = None,
            src_count: Optional[int] = None) -> List[Pair]:
        """TopN over this fragment. `inter_counts` (row -> |row ∩ src| for
        THIS shard) lets the executor batch the device popcounts for many
        shards into one program and replay the heap here without any
        per-fragment device work (heap semantics: fragment.go:899-990).
        `src_count` (|src| for THIS shard) comes from the same batched
        program so tanimoto TopN (fragment.go:1008-1027) rides the batched
        path too — without it tanimoto needs opt.src materialized."""
        pairs = self._top_pairs(list(opt.row_ids))
        n = 0 if opt.row_ids else opt.n
        has_src = opt.src is not None or inter_counts is not None

        filters = set(opt.filter_values) if opt.filter_name and opt.filter_values else None

        tanimoto = 0
        min_tan = max_tan = 0.0
        if opt.tanimoto_threshold > 0 and opt.src is not None:
            src_count = opt.src.count()
        if opt.tanimoto_threshold > 0 and src_count is not None:
            tanimoto = opt.tanimoto_threshold
            min_tan = src_count * tanimoto / 100.0
            max_tan = src_count * 100.0 / tanimoto
        if src_count is None:
            src_count = 0

        # Pre-filter candidates (cheap host checks), then batch-count the
        # survivors' intersections with src on device.
        candidates = self._filter_candidates(pairs, opt, min_tan, max_tan, filters)

        inter: Dict[int, int] = {}
        if inter_counts is not None:
            inter = {int(r): int(c) for r, c in inter_counts.items()}
        elif opt.src is not None and candidates:
            src_plane = self._filter_plane(opt.src)
            for i in range(0, len(candidates), TOPN_BATCH):
                chunk = candidates[i : i + TOPN_BATCH]
                planes = self.plane_stack([r for r, _ in chunk])
                counts = bp.topn_counts(planes, src_plane).cpu().numpy()
                for (row_id, _), c in zip(chunk, counts):
                    inter[row_id] = int(c)

        # Replay the reference's heap selection on host ints
        # (fragment.go:899-990) — exact semantics incl. threshold early-exit.
        results: List[Tuple[int, int]] = []  # min-heap of (count, row_id)
        out: List[Pair] = []
        for row_id, cnt in candidates:
            if n == 0 or len(results) < n:
                count = inter.get(row_id, 0) if has_src else cnt
                if count == 0:
                    continue
                if tanimoto > 0:
                    import math

                    tan = math.ceil(count * 100.0 / (cnt + src_count - count))
                    if tan <= tanimoto:
                        continue
                elif count < opt.min_threshold:
                    continue
                heapq.heappush(results, (count, row_id))
                if n > 0 and len(results) == n and not has_src:
                    break
                continue

            threshold = results[0][0]
            if threshold < opt.min_threshold or cnt < threshold:
                break
            count = inter.get(row_id, 0) if has_src else cnt
            if count < threshold:
                continue
            heapq.heappush(results, (count, row_id))

        out = sort_pairs([Pair(id=r, count=c) for c, r in results])
        return out

    @staticmethod
    def row_attrs_match(store, row_id: int, name: str, values) -> bool:
        """THE attr-filter predicate (reference fragment.go:922-934) —
        one implementation shared by the per-fragment candidate filter and
        the executor's batched TopN paths so they cannot silently
        diverge: rows with no attrs, or whose `name` attr is not in
        `values`, are filtered out."""
        attrs = store.attrs(row_id) if store else None
        if not attrs:
            return False
        return attrs.get(name) in values

    def _filter_candidates(self, pairs, opt: TopOptions, min_tan: float,
                           max_tan: float, filters) -> List[Tuple[int, int]]:
        candidates: List[Tuple[int, int]] = []  # (row_id, cnt)
        for p in pairs:
            row_id, cnt = p.id, p.count
            if cnt <= 0:
                continue
            if opt.tanimoto_threshold > 0:
                # Candidate filtering branches on tanimoto BEFORE
                # min_threshold (reference fragment.go:909-920), so
                # min_threshold is not applied here in tanimoto mode —
                # though the heap-full early-exit in top() still consults
                # it, exactly as fragment.go:976-981 does. Bounds pruning:
                # cnt outside [min_tan, max_tan] cannot reach the
                # coefficient threshold. The bounds need src_count, so
                # top_candidates (bounds 0/0, src not yet counted) prunes
                # nothing here and top() re-filters with real bounds.
                if (min_tan > 0 or max_tan > 0) and (
                    cnt <= min_tan or cnt >= max_tan
                ):
                    continue
            elif cnt < opt.min_threshold:
                continue
            if filters is not None:
                if not self.row_attrs_match(
                    self.row_attr_store, row_id, opt.filter_name, filters
                ):
                    continue
            candidates.append((row_id, cnt))
        return candidates

    def top_candidates(self, opt: TopOptions) -> List[Tuple[int, int]]:
        """Pre-filtered (row_id, cache_count) candidates for a TopN pass —
        the host-side half of top(), exposed so the executor can batch the
        device half (src intersections) across many fragments."""
        pairs = self._top_pairs(list(opt.row_ids))
        filters = set(opt.filter_values) if opt.filter_name and opt.filter_values else None
        return self._filter_candidates(pairs, opt, 0.0, 0.0, filters)

    def _top_pairs(self, row_ids: List[int]) -> List[Pair]:
        if self.cache_type == CACHE_TYPE_NONE and not row_ids:
            return []
        if not row_ids:
            self.cache.invalidate()
            return self.cache.top()
        pairs = []
        for row_id in row_ids:
            cnt = self.cache.get(row_id)
            if cnt <= 0:
                cnt = self.row_count(row_id)
            if cnt > 0:
                pairs.append(Pair(id=row_id, count=cnt))
        return sort_pairs(pairs)

    # --------------------------------------------------------------- blocks

    def blocks(self) -> List[FragmentBlock]:
        """Merkle block checksums of HASH_BLOCK_SIZE-row groups.

        Streams one container at a time instead of materializing every set
        position at once (storage.slice() costs 8 bytes PER BIT — on an
        RLE-heavy fragment that would undo the run form's memory bound on
        every anti-entropy sweep). Containers never straddle blocks:
        HASH_BLOCK_SIZE*SHARD_WIDTH is an exact multiple of 2^16, so each
        block's digest is the ascending concatenation of its containers'
        global positions — byte-identical to the all-at-once hash."""
        block_width = HASH_BLOCK_SIZE * SHARD_WIDTH
        if block_width % (1 << 16):
            # Non-default PILOSA_TPU_SHARD_WIDTH_EXP can make containers
            # straddle block boundaries; fall back to the all-at-once hash
            # (correct for any width, at slice() memory cost).
            return self._blocks_via_slice(block_width)
        containers_per_block = block_width >> 16
        out = []
        by_block: Dict[int, List[int]] = {}
        for key in sorted(list(self.storage.containers)):
            by_block.setdefault(int(key) // containers_per_block, []).append(int(key))
        for bid in sorted(by_block):
            cached = self._checksums.get(bid)
            if cached is None:
                h = _block_hasher()
                any_bits = False
                for key in by_block[bid]:
                    raw = self.storage.containers.get(key)
                    if raw is None:  # dropped by a concurrent writer
                        continue
                    c = _as_container(raw)
                    vals = c.to_array()
                    if not len(vals):
                        continue
                    any_bits = True
                    positions = (np.uint64(key) << np.uint64(16)) | vals.astype(
                        np.uint64
                    )
                    h.update(positions.astype("<u8").tobytes())
                if not any_bits:
                    continue  # all-empty containers: no block (as before)
                cached = h.digest()
                self._checksums[bid] = cached
            out.append(FragmentBlock(id=bid, checksum=cached))
        return out

    def _blocks_via_slice(self, block_width: int) -> List[FragmentBlock]:
        vals = self.storage.slice()
        if len(vals) == 0:
            return []
        block_ids = (vals // np.uint64(block_width)).astype(np.int64)
        out = []
        for bid in np.unique(block_ids):
            bid = int(bid)
            cached = self._checksums.get(bid)
            if cached is None:
                cached = _block_hash(vals[block_ids == bid])
                self._checksums[bid] = cached
            out.append(FragmentBlock(id=bid, checksum=cached))
        return out

    def checksum(self) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for block in self.blocks():
            h.update(block.checksum)
        return h.digest()

    def invalidate_checksums(self) -> None:
        self._checksums.clear()

    def block_data(self, block_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rowIDs, columnIDs) of bits in a block (reference fragment.go:1160)."""
        block_width = HASH_BLOCK_SIZE * SHARD_WIDTH
        vals = self.storage.slice_range(
            block_id * block_width, (block_id + 1) * block_width
        )
        return vals // np.uint64(SHARD_WIDTH), vals % np.uint64(SHARD_WIDTH)

    def merge_block(
        self, block_id: int, data: List[Tuple[np.ndarray, np.ndarray]]
    ) -> Tuple[List[List[Tuple[int, int]]], List[List[Tuple[int, int]]]]:
        """Consensus-merge a block across replicas (fragment.go:1176-1293).

        data: per-replica (rowIDs, columnIDs) pair sets, local block NOT
        included. Returns (sets, clears) diffs per input replica, majority
        vote over {local} ∪ replicas, and applies the local diff.
        """
        with self._mu:
            self._check_moved()
            # Vote on flat bit positions with numpy set ops — a dense 100-row
            # block holds up to 100 * 2^20 bits, so per-pair Python objects
            # (sets of tuples) are out of the question at scale.
            block_width = HASH_BLOCK_SIZE * SHARD_WIDTH
            base_pos = np.uint64(block_id * block_width)
            local_pos = self.storage.slice_range(
                block_id * block_width, (block_id + 1) * block_width
            ) - base_pos
            positions = [local_pos]
            for rows, cols in data:
                pos = np.asarray(rows, dtype=np.uint64) * np.uint64(SHARD_WIDTH) + np.asarray(
                    cols, dtype=np.uint64
                ) - base_pos
                # Drop replica pairs outside this block: below-block positions
                # wrap uint64 to huge values and above-block ones exceed the
                # width, so a single bound check rejects both. Without it,
                # wrapped garbage can reach consensus and persist phantom rows
                # at arbitrary local bit positions.
                pos = pos[pos < np.uint64(block_width)]
                positions.append(np.unique(pos))
            # Even splits keep the bit (reference fragment.go:1218 majorityN =
            # (n+1)/2 with setN >= majorityN).
            majority = (len(positions) + 1) // 2
            uniq, counts = np.unique(np.concatenate(positions), return_counts=True)
            consensus = uniq[counts >= majority]

            def pairs(pos: np.ndarray) -> List[Tuple[int, int]]:
                p = pos + base_pos
                rows = (p // np.uint64(SHARD_WIDTH)).tolist()
                cols = (p % np.uint64(SHARD_WIDTH)).tolist()
                return list(zip(map(int, rows), map(int, cols)))

            sets_out, clears_out = [], []
            for i, pos in enumerate(positions):
                add = np.setdiff1d(consensus, pos, assume_unique=True)
                rem = np.setdiff1d(pos, consensus, assume_unique=True)
                if i == 0:
                    self._apply_merge_diff(add + base_pos, rem + base_pos)
                else:
                    sets_out.append(pairs(add))
                    clears_out.append(pairs(rem))
            return sets_out, clears_out

    # Above this many local diff bits, anti-entropy applies the merge in
    # bulk (storage-level scatter + one snapshot) instead of per-bit
    # set/clear with per-op WAL appends.
    MERGE_BULK_THRESHOLD = 256

    def _apply_merge_diff(self, add_pos: np.ndarray, rem_pos: np.ndarray) -> None:
        if len(add_pos) + len(rem_pos) <= self.MERGE_BULK_THRESHOLD:
            sw = np.uint64(SHARD_WIDTH)
            base = self.shard * SHARD_WIDTH
            for p in add_pos:
                self.set_bit(int(p // sw), base + int(p % sw))
            for p in rem_pos:
                self.clear_bit(int(p // sw), base + int(p % sw))
            return
        self.storage.add_many(add_pos)
        self.storage.remove_many(rem_pos)
        self._append_bulk_op(add_pos, rem_pos)
        allpos = np.concatenate([add_pos, rem_pos])
        # Anti-entropy fold-back stays delta-refreshable: the diff positions
        # ARE the dirty words (journaled unless the diff alone would blow
        # the journal bound).
        self._invalidate_bulk(allpos // np.uint64(SHARD_WIDTH), allpos)
        self._maybe_snapshot()

    def apply_hint_positions(self, add_pos, rem_pos) -> None:
        """Replay one delivered hint record (cluster/hints.py): positions-
        based idempotent set/clear through the same WAL-backed path the
        anti-entropy block merge uses, so a redelivered record is
        harmless and the replay is as durable as a direct write."""
        add_pos = np.asarray(add_pos, dtype=np.uint64)
        rem_pos = np.asarray(rem_pos, dtype=np.uint64)
        if not len(add_pos) and not len(rem_pos):
            return
        with self._mu:
            self._check_moved()
            self._apply_merge_diff(add_pos, rem_pos)

    # --------------------------------------------------------------- import

    def _invalidate_bulk(self, row_ids: np.ndarray, positions: np.ndarray) -> None:
        """Cache/journal maintenance for a bulk mutation, grouped by row
        with one argsort + searchsorted pass. Imports small enough to
        journal keep resident planes delta-refreshable (positions
        overapproximate: an already-set bit journals a word that didn't
        change — extra words are re-read, never wrong); big imports poison
        the touched rows."""
        journal = len(positions) <= self.delta_journal_ops
        order = np.argsort(row_ids, kind="stable")
        rows_sorted = row_ids[order]
        uniq_rows, starts = np.unique(rows_sorted, return_index=True)
        bounds = np.append(starts, len(rows_sorted))
        w64_sorted = ((positions % np.uint64(SHARD_WIDTH)) >> np.uint64(6))[order]
        counts = self.row_counts(uniq_rows)
        for i, row_id in enumerate(uniq_rows):
            words = (np.unique(w64_sorted[bounds[i]:bounds[i + 1]])
                     if journal else None)
            self._invalidate_row(int(row_id), words)
            self.cache.bulk_add(int(row_id), int(counts[i]))
        self.cache.invalidate(force=True)

    def bulk_import(self, row_ids: np.ndarray, column_ids: np.ndarray) -> None:
        """Set many bits at once (reference fragment.go:1298), amortized:
        ONE bulk-set WAL record instead of the full-file snapshot that
        used to end every batch — ingest cost is O(batch); the snapshot
        policy (snapshot_due) decides when the file is rewritten, off the
        hot path when a background snapshotter is attached."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        positions = row_ids * np.uint64(SHARD_WIDTH) + (
            column_ids % np.uint64(SHARD_WIDTH)
        )
        with self._mu:
            self._check_moved()
            self.storage.add_many(positions)
            self._append_bulk_op(positions, None)
            self._invalidate_bulk(row_ids, positions)
            self._maybe_snapshot()

    def remove_bulk(self, row_ids: np.ndarray, column_ids: np.ndarray) -> None:
        """Clear many bits at once — bulk_import's write-path twin (one
        bulk-clear WAL record, snapshot deferred to policy)."""
        row_ids = np.asarray(row_ids, dtype=np.uint64)
        column_ids = np.asarray(column_ids, dtype=np.uint64)
        positions = row_ids * np.uint64(SHARD_WIDTH) + (
            column_ids % np.uint64(SHARD_WIDTH)
        )
        with self._mu:
            self._check_moved()
            self.storage.remove_many(positions)
            self._append_bulk_op(None, positions)
            self._invalidate_bulk(row_ids, positions)
            self._maybe_snapshot()

    def import_value(
        self, column_ids: np.ndarray, values: np.ndarray, bit_depth: int
    ) -> None:
        """Bulk BSI import (reference fragment.go:1361-1397), amortized:
        the per-plane on/off scatters land in ONE bsi-import WAL record
        (adds and removes are disjoint positions, so replay order within
        the record is immaterial) instead of a snapshot."""
        with self._mu:
            self._check_moved()
            column_ids = np.asarray(column_ids, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
            values = np.asarray(values, dtype=np.uint64)
            # Every bit plane's changed words are a subset of the imported
            # columns' words — one overapproximation journals all planes.
            w_all = np.unique(column_ids >> np.uint64(6))
            journal = len(w_all) * (bit_depth + 1) <= self.delta_journal_ops
            words = w_all if journal else None
            adds, removes = [], []
            for i in range(bit_depth):
                mask = (values >> np.uint64(i)) & np.uint64(1)
                on = column_ids[mask == 1]
                off = column_ids[mask == 0]
                base = np.uint64(i * SHARD_WIDTH)
                self.storage.add_many(on + base)
                self.storage.remove_many(off + base)
                adds.append(on + base)
                removes.append(off + base)
                self._invalidate_row(i, words)
            exists = column_ids + np.uint64(bit_depth * SHARD_WIDTH)
            self.storage.add_many(exists)
            adds.append(exists)
            self._invalidate_row(bit_depth, words)
            self._append_bulk_op(
                np.concatenate(adds) if adds else None,
                np.concatenate(removes) if removes else None,
            )
            self._maybe_snapshot()

    # ---------------------------------------------------------- persistence

    def snapshot(self) -> None:
        """Rewrite the storage file without the op log (fragment.go:1399-1469).

        Also re-compresses RLE-heavy containers to the run form (reference
        Optimize) so point-mutation churn between snapshots doesn't leave
        8 KiB bitsets where 4-byte interval lists suffice."""
        with self._mu:
            self.storage.optimize()
            if not self.path:
                self.op_n = 0
                self.wal_bytes = 0
                self._snapshot_seq += 1
                return
            if self._wal:
                self._wal.close()
                self._wal = None
            durable = self.storage_config.fsync != FSYNC_NEVER
            tmp = self.path + ".snapshotting"
            try:
                with open(tmp, "wb") as f:
                    written = self.storage.write_to(f)
                    if durable:
                        # fsync BEFORE rename: os.replace is atomic in the
                        # namespace but says nothing about data blocks — a
                        # crash after an un-synced rename can leave the new
                        # inode empty/torn, losing every op the snapshot
                        # folded in.
                        f.flush()
                        # pilint: allow-blocking(inline snapshot is the synchronous escape hatch — the off-lock path is snapshot_background)
                        os.fsync(f.fileno())
                failpoints.fire("snapshot-rename")
                # pilint: allow-blocking(inline snapshot: writers must not land ops between the serialized image and the rename)
                os.replace(tmp, self.path)
                if durable:
                    # Directory fsync: the rename itself must survive power
                    # loss, or recovery reopens the PRE-snapshot inode
                    # without the op log that was just folded in and
                    # truncated away.
                    dfd = os.open(os.path.dirname(self.path), os.O_RDONLY)
                    try:
                        # pilint: allow-blocking(inline snapshot: rename durability before the mutex releases)
                        os.fsync(dfd)
                    finally:
                        os.close(dfd)
            except OSError:
                # Snapshot failed mid-flight (disk fault, injected error).
                # Whichever inode now sits at self.path — the old file if
                # the rename didn't happen (its op log intact), the new one
                # if only the directory fsync failed — is parseable truth:
                # drop any leftover temp and, critically, restore the
                # append handle BEFORE re-raising (a None _wal would make
                # _append_op silently skip WAL logging for every later
                # acknowledged write).
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                self._wal = open(self.path, "ab")
                raise
            self.op_n = 0
            self._unsynced_ops = 0
            self.wal_bytes = 0
            self.wal_since = None
            self.storage_bytes = written
            self._snapshot_seq += 1
            self._wal = open(self.path, "ab")
            if self.stats:
                self.stats.count("snapshot", 1)

    def snapshot_background(self) -> bool:
        """Storage-file rewrite with readers AND writers live — the
        background snapshotter's entry point. Handoff under a brief mutex
        hold (optimize + copy-on-write container clone + WAL boundary),
        then serialize/write/fsync entirely OFF-lock; the mutex is
        retaken only at the rename boundary, long enough to splice the
        ops appended mid-snapshot onto the new file (so the rename can
        never lose an acked write) and swap the WAL handle. The mmap
        double-buffer design (see open()) keeps live views valid across
        the inode replacement. Returns True when mid-snapshot writes
        alone re-trigger the snapshot policy (caller re-queues)."""
        with self._mu:
            if not self._opened or not self.path or self._wal is None:
                return False
            self.storage.optimize()
            snap = self.storage.cow_clone()
            self._wal.flush()
            base_len = os.fstat(self._wal.fileno()).st_size
            seq = self._snapshot_seq
            op_base = self.op_n
        durable = self.storage_config.fsync != FSYNC_NEVER
        # Distinct temp name from the inline path: an inline snapshot
        # racing this one (replica restore, explicit flush) must never
        # share a half-written temp file. open() cleans both leftovers.
        tmp = self.path + ".snapshotting.bg"
        try:
            # The write/fsync phase: entirely off-lock. Tests stall HERE
            # via failpoint and prove readers/writers still complete.
            failpoints.fire("snapshot-write")
            with open(tmp, "wb") as f:
                snap_bytes = snap.to_bytes()
                f.write(snap_bytes)
                if durable:
                    f.flush()
                    os.fsync(f.fileno())
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            # Disarm copy-on-write too: leaving it set would make every
            # later first-touch mutation (and the next handoff's
            # optimize) pay needless container copies. Refcounted: a
            # concurrent migration base stream's clone keeps its
            # protection.
            with self._mu:
                self.storage.cow_release()
            raise
        with self._mu:
            # The clone is fully serialized: drop this clone's
            # copy-on-write protection (in-place mutation resumes once
            # the last outstanding clone releases).
            self.storage.cow_release()
            if (not self._opened or self._wal is None
                    or self._snapshot_seq != seq):
                # Fragment closed, or an inline snapshot / replica restore
                # already rewrote the file: this rewrite is stale.
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return False
            try:
                self._wal.flush()
                cur = os.fstat(self._wal.fileno()).st_size
                tail = b""
                if cur > base_len:
                    # Ops appended mid-snapshot: their in-memory effect is
                    # NOT in the clone, so carry their WAL records over.
                    with open(self.path, "rb") as src:
                        src.seek(base_len)
                        tail = src.read(cur - base_len)
                    with open(tmp, "ab") as f:
                        f.write(tail)
                        if durable:
                            f.flush()
                            # pilint: allow-blocking(splice boundary: the WAL tail copied under the mutex is exactly what makes acked mid-snapshot writes durable)
                            os.fsync(f.fileno())
                failpoints.fire("snapshot-rename")
                # pilint: allow-blocking(rename must be atomic vs writers: an op landing between splice and rename would vanish from the new inode)
                os.replace(tmp, self.path)
            except OSError:
                # The original file (containers + full op log) is still the
                # durable truth and the WAL handle still points at it.
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
            # Swap the append handle to the new inode BEFORE the directory
            # fsync: if that fsync fails, later appends must still land on
            # the file now visible at self.path.
            self._wal.close()
            self._wal = open(self.path, "ab")
            self._unsynced_ops = 0
            self.op_n -= op_base  # ops since handoff stay pending
            self.wal_bytes = len(tail)
            self.wal_since = time.monotonic() if tail else None
            self.storage_bytes = len(snap_bytes)
            self._snapshot_seq += 1
            if durable:
                dfd = os.open(os.path.dirname(self.path), os.O_RDONLY)
                try:
                    # pilint: allow-blocking(the handle swap above re-pointed appends at the new inode; its rename durability must land before the mutex releases them)
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            if self.stats:
                self.stats.count("snapshot", 1)
            return self.snapshot_due()

    def cache_path(self) -> Optional[str]:
        return self.path + ".cache" if self.path else None

    def _flush_cache(self) -> None:
        """Persist TopN cache row ids (reference fragment.go:1478-1509).

        tmp + os.replace: a crash mid-write must leave either the old cache
        file or the new one, never a truncated hybrid."""
        path = self.cache_path()
        if not path or isinstance(self.cache, NopCache):
            return
        ids = self.cache.ids()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<I", len(ids)))
            f.write(np.asarray(ids, dtype="<u8").tobytes())
        # pilint: allow-blocking(close/snapshot boundary: the tiny TopN cache file must match the storage the mutex is pinning)
        os.replace(tmp, path)

    def _load_cache(self) -> None:
        path = self.cache_path()
        if not path or not os.path.exists(path) or isinstance(self.cache, NopCache):
            return
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 4:
            return
        (n,) = struct.unpack_from("<I", data, 0)
        if 4 + 8 * n > len(data):
            # Truncated cache file (pre-atomic-flush crash): the cache is a
            # derived structure, so rebuild from storage instead of raising
            # and failing the whole fragment open.
            ids = np.asarray(self.rows(), dtype=np.uint64)
        else:
            ids = np.frombuffer(data, dtype="<u8", count=n, offset=4)
        for row_id in ids:
            self.cache.bulk_add(int(row_id), self.row_count(int(row_id)))
        self.cache.invalidate(force=True)

    def flush_cache(self) -> None:
        with self._mu:  # cache.ids() must not race writers' cache.add
            self._flush_cache()

    # ----------------------------------------------------------- shard ship

    def write_to(self, f) -> None:
        """Serialize fragment data for shard shipping (fragment.go:1511-1683)."""
        data = self.storage.to_bytes()
        f.write(struct.pack("<Q", len(data)))
        f.write(data)

    def read_from(self, f) -> None:
        with self._mu:
            where = self.path or f"{self.index}/{self.field}/{self.view}/{self.shard}"
            header = f.read(8)
            if len(header) < 8:
                raise PilosaError(
                    f"truncated fragment stream for {where}: expected 8 "
                    f"header bytes, got {len(header)}"
                )
            (n,) = struct.unpack("<Q", header)
            data = f.read(n)
            if len(data) < n:
                raise PilosaError(
                    f"truncated fragment stream for {where}: expected {n} "
                    f"payload bytes, got {len(data)}"
                )
            bm = Bitmap.from_bytes(data)
            if bm.truncated_bytes:
                # A torn op tail is recoverable on a local reopen, but a
                # SHIPPED stream promising n bytes that don't parse whole is
                # a transport/sender fault — reject so resize/replication
                # callers retry rather than silently install partial data.
                raise PilosaError(
                    f"torn op log in fragment stream for {where}: "
                    f"{bm.truncated_bytes} trailing bytes unparseable"
                )
            self.storage = bm
            # A full replica restore makes the local data whole again.
            self.clear_quarantine()
            self.op_n = 0
            self._plane_cache.clear()
            self._checksums.clear()
            self.cache.clear()
            self.generation += 1
            # Wholesale replacement: no per-word history exists, so every
            # cached generation older than NOW must full-regather.
            self._journal_reset()
            if self.epoch is not None:
                self.epoch.bump()
            for row_id in self.rows():
                self.cache.bulk_add(row_id, self.row_count(row_id))
            self.cache.invalidate(force=True)
            if self.path:
                self.snapshot()

    # ------------------------------------------------------- live migration

    def _migrate_invalidate(self) -> None:
        # Must hold _mu. Wholesale storage change with no per-word
        # history: poison every cached generation (full regather) and
        # stale-proof the memo via the epoch.
        self._plane_cache.clear()
        self._checksums.clear()
        self.generation += 1
        self._journal_reset()
        if self.epoch is not None:
            self.epoch.bump()

    def migrate_install(self, data: bytes) -> None:
        """Install a migration base snapshot (a serialized container
        section shipped by a source's /internal/migrate/begin). Unlike
        read_from there is no length frame and no snapshot here — the
        catch-up tail is still coming; migrate_seal persists."""
        bm = Bitmap.from_bytes(data)
        if bm.truncated_bytes:
            raise PilosaError(
                f"torn migration base for {self.index}/{self.field}/"
                f"{self.view}/{self.shard}: {bm.truncated_bytes} trailing "
                "bytes unparseable"
            )
        with self._mu:
            self.storage = bm
            self.op_n = 0
            self.cache.clear()
            self._migrate_invalidate()

    def migrate_apply_ops(self, data: bytes) -> None:
        """Replay a shipped WAL catch-up tail (point + bulk records, the
        exact on-disk codec) over the installed base. Replay over a base
        serialized concurrently with these ops is safe: set/clear of a
        bit position is idempotent, so a record that also made the base
        re-applies to the same state."""
        from ..storage.bitmap import replay_ops

        with self._mu:
            replay_ops(self.storage, data)
            self._migrate_invalidate()

    def migrate_seal(self) -> None:
        """Migration complete for this fragment: rebuild the rank cache
        and persist (containers + replayed tail folded into one file)."""
        with self._mu:
            self.cache.clear()
            for row_id in self.rows():
                self.cache.bulk_add(row_id, self.row_count(row_id))
            self.cache.invalidate(force=True)
        if self.path:
            self.snapshot()
