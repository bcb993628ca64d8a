"""CdcManager: the one CDC object the server wires in.

Owns one CdcLog per index (cdc/log.py), the point-in-time fragment
cache (cdc/pit.py) and the standing-query registry (cdc/standing.py).
Fragments call append() from inside their write mutex; the HTTP layer
calls stream()/bootstrap()/standing endpoints; the executor's
at-position path asks for historical fragments through pit.

Jax-free (pilint R2): stdlib + numpy via storage/bitmap.py only.
"""

from __future__ import annotations

import base64
import os
import shutil
import threading
import time
import zlib
from typing import Dict, Optional

from .. import failpoints
from ..errors import CdcGoneError, IndexNotFoundError
from ..obs import span as obs_span
from .log import CdcLog


class CdcManager:
    def __init__(self, config, path: Optional[str], storage_config):
        from .pit import PitCache
        from .standing import StandingRegistry

        self.config = config
        # `<data-dir>/cdc`; None = memory-only (pathless holders/tests).
        self.path = path
        self.storage_config = storage_config
        # Wired by the server right after Holder/Executor construction
        # (the Holder ctor needs the manager, so the manager can't need
        # the holder at ctor time).
        self.holder = None
        self.executor = None
        self._mu = threading.Lock()
        self._logs: Dict[str, CdcLog] = {}
        self.counters: Dict[str, int] = {}
        self.pit = PitCache(self, config.pit_cache)
        self.standing = StandingRegistry(self)
        self.closed = False

    # ---------------------------------------------------------------- logs

    def _log_dir(self, index: str) -> Optional[str]:
        return os.path.join(self.path, index) if self.path else None

    def log(self, index: str, create: bool = False) -> Optional[CdcLog]:
        with self._mu:
            got = self._logs.get(index)
            if got is not None or not create or self.closed:
                return got
            log = CdcLog(index, self._log_dir(index), self.config,
                         self.storage_config, counters=self.counters)
            self._logs[index] = log
            return log

    def require_log(self, index: str) -> CdcLog:
        """The HTTP surface's lookup: the log exists iff the index does
        (register_index creates it eagerly)."""
        log = self.log(index)
        if log is None:
            raise IndexNotFoundError(index)
        return log

    # -------------------------------------------------------- write path

    def append(self, frag, ops: bytes) -> int:
        """Called by Fragment._append_op/_append_bulk_op under the
        fragment mutex (the sanctioned order: frag._mu -> log lock)."""
        log = self.log(frag.index, create=True)
        if log is None:  # closing down
            return 0
        return log.append(frag.field, frag.view, frag.shard, ops)

    # ------------------------------------------------------------ lifecycle

    def register_index(self, index) -> None:
        """Holder calls this at index open/create: creates the change
        log and cuts point-in-time base images for any fragment whose
        data predates change capture (without a base, at-position reads
        would replay onto an empty bitmap and under-report old data)."""
        log = self.log(index.name, create=True)
        if log is None:
            return
        for field in list(index.fields.values()):
            for view in list(field.views.values()):
                for frag in list(view.fragments.values()):
                    log.cut_base(frag)

    def drop_index(self, name: str) -> None:
        """Holder calls this AFTER deleting the index: the log dies with
        it, and a recreated index starts a fresh incarnation so stale
        cursors 410 instead of silently aliasing the new sequence."""
        with self._mu:
            log = self._logs.pop(name, None)
        if log is not None:
            log.close()
        d = self._log_dir(name)
        if d and os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    def interrupt(self) -> None:
        """Unpark every log's long-poll waiters for server shutdown.
        Called by Server.close() BEFORE the HTTP listener shuts down, so
        a handler thread blocked in a /cdc/stream wait returns promptly
        (empty chunk) instead of pinning shutdown until its poll timeout.
        The logs stay open — drop_index keeps its closed->410 path."""
        with self._mu:
            logs = list(self._logs.values())
        for log in logs:
            log.interrupt()

    def close(self) -> None:
        self.standing.close()
        with self._mu:
            self.closed = True
            logs = list(self._logs.values())
            self._logs = {}
        for log in logs:
            log.close()

    # ------------------------------------------------------------ consumers

    def stream(self, index: str, from_pos: int, inc: Optional[str] = None,
               timeout: Optional[float] = None, max_bytes: int = 4 << 20):
        """One long-poll stream chunk: raw framed records for positions
        > from_pos, plus (next_cursor, incarnation) for the consumer's
        resume headers."""
        log = self.require_log(index)
        if timeout is None:
            timeout = self.config.poll_timeout
        with obs_span("cdc.tail", index=index):
            data, nxt = log.read(from_pos, inc=inc, max_bytes=max_bytes,
                                 timeout=timeout)
            failpoints.fire("cdc-deliver")
            return data, nxt, log.incarnation

    def head(self, index: str):
        """(head_position, leader_now) for the stream response's lag
        headers (X-Pilosa-Cdc-Head-Pos/-Time): the newest assigned
        position and THIS node's wall clock, read together so a geo
        follower can anchor 'how far behind is my applied stamp' against
        a single leader-side observation — leader stamps compared to a
        leader clock, never to the follower's."""
        log = self.require_log(index)
        with log.lock:
            return log.last_pos, time.time()

    def bootstrap(self, index: str) -> dict:
        """Snapshot re-seed for a consumer whose cursor fell behind
        retention (the rebalance begin/catch-up shape, generalized):
        compressed roaring images of every live fragment plus the
        position each was cut at. The consumer installs the images and
        resumes the stream from the minimum cut position; overlap is
        harmless because op records apply idempotently."""
        log = self.require_log(index)
        idx = self.holder.index(index) if self.holder else None
        if idx is None:
            raise IndexNotFoundError(index)
        frags = []
        for field in list(idx.fields.values()):
            for view in list(field.views.values()):
                for frag in list(view.fragments.values()):
                    with frag._mu:
                        # Position read under the fragment mutex: the
                        # clone holds exactly this fragment's ops with
                        # position <= pos (same invariant as cut_base).
                        with log.lock:
                            pos = log.last_pos
                        clone = frag.storage.cow_clone()
                    try:
                        failpoints.fire("cdc-snapshot-bootstrap")
                        raw = clone.to_bytes()
                    finally:
                        clone.cow_release()
                    frags.append({
                        "field": frag.field,
                        "view": frag.view,
                        "shard": frag.shard,
                        "position": pos,
                        "data": base64.b64encode(
                            zlib.compress(raw)).decode(),
                    })
        return {
            "index": index,
            "incarnation": log.incarnation,
            "from": min((f["position"] for f in frags),
                        default=log.last_pos),
            # Leader wall clock at the cut: the consumer's applied-stamp
            # baseline after installing the images (geo lag needs a
            # leader-side time even before the first streamed record).
            "now": time.time(),
            "fragments": frags,
        }

    # ------------------------------------------------------------- read path

    def historical_fragment(self, index: str, field: str, view: str,
                            shard: int, position: int):
        return self.pit.materialize(index, field, view, shard, position)

    def check_position(self, index: str, position: int) -> None:
        """Fast 410 gate for at-position queries, before any
        materialization work."""
        log = self.require_log(index)
        with log.lock:
            if position < log.base_pos:
                raise CdcGoneError(
                    f"position {position} of index {index!r} fell behind "
                    f"retention (oldest retained position is "
                    f"{log.base_pos + 1})",
                    first=log.base_pos + 1, last=log.last_pos,
                    incarnation=log.incarnation)

    # ------------------------------------------------------------- counters

    def debug_vars(self) -> dict:
        with self._mu:
            logs = dict(self._logs)
        out = {
            "indexes": {name: log.snapshot() for name, log in
                        sorted(logs.items())},
            "pit": self.pit.snapshot(),
            "standing": self.standing.snapshot(),
        }
        with self._mu:
            out.update(self.counters)
        return out
