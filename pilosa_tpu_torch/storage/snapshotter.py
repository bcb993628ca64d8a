"""Background snapshotter: fragment storage rewrites off the hot path.

One thread per Holder. Fragments whose snapshot-trigger policy fires
(op-log bytes > snapshot-ratio x storage bytes, op count, or the periodic
snapshot-interval sweep) are ENQUEUED here instead of rewriting their
file inline under the write mutex — the write path's cost stays O(batch).
The thread then runs Fragment.snapshot_background(), which takes a
copy-on-write container handoff under a brief mutex hold and performs
serialize/write/fsync/rename entirely off-lock, so concurrent readers
and writers proceed during snapshot I/O. Writes that land mid-snapshot
survive in the WAL tail (re-appended to the new file at the rename
boundary) and, when they alone re-trigger the policy, re-queue the
fragment.

Counters feed /debug/vars' `ingest` group (docs/ingest.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class Snapshotter:
    def __init__(self, stats=None, interval: float = 0.0,
                 fragments_fn=None):
        self.stats = stats
        # Periodic sweep cadence (storage.snapshot-interval); 0 disables.
        self.interval = interval
        # Callback returning fragments to consider for the periodic sweep
        # (the holder's live fragment walk).
        self.fragments_fn = fragments_fn
        self._mu = threading.Lock()
        self._cond = threading.Condition(self._mu)
        self._queue: deque = deque()
        self._pending = set()  # id(frag) of enqueued fragments (dedup)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_sweep = time.monotonic()
        self.counters: Dict[str, int] = {
            # hot-path snapshots turned into queue entries instead of
            # inline file rewrites
            "snapshots_deferred": 0,
            "snapshots_taken": 0,
            # fragments re-queued because writes landed mid-snapshot and
            # re-triggered the policy
            "snapshots_requeued": 0,
            "snapshot_errors": 0,
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Snapshotter":
        if self._thread is None:
            self._stop.clear()
            self._last_sweep = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name="snapshotter", daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the thread. With drain (the default), queued fragments are
        snapshotted synchronously first — close keeps the same durable
        state a chain of inline snapshots would have left (the WAL alone
        already guarantees recoverability either way)."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
            if t.is_alive():
                # The worker is wedged mid-snapshot (stalled disk): a
                # synchronous drain would run snapshot_background on the
                # SAME fragment concurrently — two writers on one
                # .snapshotting.bg temp can rename interleaved garbage
                # over the live file. Skip the drain; every queued
                # fragment's data is already durable in its WAL.
                return
        if drain:
            while True:
                frag = self._pop(block=False)
                if frag is None:
                    break
                self._snapshot_one(frag)

    # ------------------------------------------------------------- queueing

    def enqueue(self, frag) -> bool:
        """Queue a fragment for a background snapshot. Deduplicated: a
        fragment already waiting is not queued twice. Never blocks (called
        from write paths holding the fragment mutex)."""
        with self._cond:
            if id(frag) in self._pending:
                return False
            self._pending.add(id(frag))
            self._queue.append(frag)
            self.counters["snapshots_deferred"] += 1
            self._cond.notify()
        return True

    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def _pop(self, block: bool = True):
        with self._cond:
            while True:
                if block and self.interval:
                    # Sweep check BEFORE popping: a steadily-busy queue
                    # must not starve the periodic sweep (every pop used
                    # to restart the timer, so quiet fragments carrying
                    # sub-ratio WAL bytes were never aged out).
                    now = time.monotonic()
                    if now - self._last_sweep >= self.interval:
                        self._sweep_locked(now)
                        self._last_sweep = now
                if self._queue:
                    frag = self._queue.popleft()
                    self._pending.discard(id(frag))
                    return frag
                if not block or self._stop.is_set():
                    return None
                self._cond.wait(timeout=self.interval or None)
                if self._stop.is_set() and not self._queue:
                    return None

    def _sweep_locked(self, now: float) -> None:
        """Periodic sweep (holding _cond): queue every fragment whose
        un-snapshotted WAL bytes are OLDER than the interval, bounding
        recovery replay time without churning freshly-written fragments
        the ratio trigger will handle anyway."""
        if self.fragments_fn is None:
            return
        for frag in self.fragments_fn():
            since = getattr(frag, "wal_since", None)
            if (getattr(frag, "wal_bytes", 0) > 0
                    and since is not None
                    and now - since >= self.interval
                    and id(frag) not in self._pending):
                self._pending.add(id(frag))
                self._queue.append(frag)
                self.counters["snapshots_deferred"] += 1

    # ---------------------------------------------------------------- work

    def _run(self) -> None:
        while not self._stop.is_set():
            frag = self._pop()
            if frag is None:
                continue
            self._snapshot_one(frag)

    def _snapshot_one(self, frag) -> None:
        try:
            still_due = frag.snapshot_background()
        except Exception:
            # Disk fault / injected error (OSError, the designed case) or
            # anything unexpected: the fragment's WAL handle stays valid
            # (snapshot_background's contract), the data is safe in the
            # WAL, and a later trigger retries. The thread must survive —
            # a dead snapshotter means WAL bytes grow without bound.
            self.counters["snapshot_errors"] += 1
            if self.stats:
                self.stats.count("snapshotBackgroundError", 1)
            return
        self.counters["snapshots_taken"] += 1
        if self.stats:
            self.stats.count("snapshotBackground", 1)
        if still_due:
            # Writes landed mid-snapshot and alone re-trigger the policy.
            if self.enqueue(frag):
                self.counters["snapshots_requeued"] += 1

    # ---------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.counters)
            out["snapshot_queue_depth"] = len(self._queue)
        return out
