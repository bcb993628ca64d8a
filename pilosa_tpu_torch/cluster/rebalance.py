"""Online elastic rebalance: live shard migration with routing epochs.

Replaces the stop-the-world resizeJob (cluster/resize.py, the port of
reference cluster.go:1080-1423) as the default membership-change path:
the cluster keeps serving reads AND writes while shards move.

Protocol, per shard a node is gaining (receiver-driven):

  begin      the source streams a point-in-time base of each fragment
             (the roaring container section, serialized off-lock — the
             reader-tolerant form the background snapshotter relies on)
             plus the WAL position the base corresponds to; replaying
             ops past that position over the base is idempotent, so the
             handoff needs only a brief mutex hold for flush+position.
  catch-up   the receiver repeatedly pulls the WAL tail appended since
             its last position (the OP_BULK/point-op codec from the
             ingest pipeline IS the wire format) and replays it, until
             one round ships fewer than `catchup-threshold-bytes` or
             `max-catchup-rounds` is exhausted.
  freeze     once every gaining replica reports ready, the coordinator
             freezes the shard on every node streaming one of its
             fragments: writes to those fragments raise ShardMovedError
             (callers re-route/wait within the `cutover-pause-max`
             window — nothing is acked into a doomed copy), while READS
             keep serving from the frozen, fully-current source until
             the commit (the gainer has not drained the final tail yet).
  finalize   each gainer drains the now-frozen final tail, seals the
             fragment (cache rebuild + snapshot), and acks.
  commit     the coordinator broadcasts `cutover-commit` with a bumped
             routing epoch: every node's placement for that shard flips
             to the new topology. Reads/writes for every OTHER shard
             never left the old owners — a half-migrated cluster serves
             no holes.

Membership itself flips only at job completion (`rebalance-complete`),
when nodes GC fragments they no longer own — guarded by the routing
epoch: a read forwarded under a stale epoch gets a 409 and one
re-route, never an empty result from a GC'd shard.

The job is resumable: the coordinator checkpoints committed shards to
`<data_dir>/.rebalance.json` after every cutover, and a restarted
coordinator re-issues instructions for the remainder instead of
restarting from zero.

Dependency-light on purpose: this module reaches the holder/client only
through the server object handed in at runtime, so config and framing
are importable from both client and handler without cycles.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .. import failpoints
from ..errors import FragmentNotFoundError, PilosaError
from .node import Node


@dataclass
class RebalanceConfig:
    """The `[rebalance]` config section (TOML + env + CLI, config.py)."""

    # Live migration (routing epochs + WAL catch-up) vs the legacy
    # stop-the-world resizeJob. Offline mode survives as an escape hatch;
    # everything below only applies online.
    online: bool = True
    # Concurrent per-shard migration streams one receiving node runs.
    max_concurrent_streams: int = 2
    # Receiver-side throttle on migration traffic; 0 = unthrottled.
    max_bytes_per_sec: float = 0.0
    # Cutover readiness: a catch-up round shipping at most this many WAL
    # bytes means the receiver is close enough to freeze.
    catchup_threshold_bytes: int = 65536
    # Catch-up rounds before the receiver declares ready regardless (the
    # post-freeze final drain then carries whatever tail remains).
    max_catchup_rounds: int = 16
    # How long a write blocked by a mid-cutover shard re-routes/waits for
    # the commit before surfacing a clean error; freeze->commit windows
    # longer than this count as cutover_pause_overruns.
    cutover_pause_max: float = 2.0
    # Follower resize watchdog (legacy path): a node stuck RESIZING this
    # long probes the coordinator and reverts to NORMAL on the old
    # topology if the coordinator is gone or no longer resizing.
    follower_timeout: float = 30.0

    def validate(self) -> "RebalanceConfig":
        if self.max_concurrent_streams < 1:
            raise ValueError("rebalance.max-concurrent-streams must be >= 1")
        if self.max_bytes_per_sec < 0:
            raise ValueError("rebalance.max-bytes-per-sec must be >= 0")
        if self.catchup_threshold_bytes < 0:
            raise ValueError("rebalance.catchup-threshold-bytes must be >= 0")
        if self.max_catchup_rounds < 1:
            raise ValueError("rebalance.max-catchup-rounds must be >= 1")
        if self.cutover_pause_max < 0:
            raise ValueError("rebalance.cutover-pause-max must be >= 0")
        if self.follower_timeout <= 0:
            raise ValueError("rebalance.follower-timeout must be > 0")
        return self


# ------------------------------------------------------------------ framing

_FRAME_HEADER = struct.Struct("<I")


def pack_framed(header: dict, payload: bytes = b"") -> bytes:
    """Binary migration frame: <u32 header_len><json header><raw payload>.
    The base/delta payloads are raw storage bytes — base64-in-JSON would
    inflate a fragment stream by a third for nothing."""
    h = json.dumps(header).encode()
    return _FRAME_HEADER.pack(len(h)) + h + payload


def unpack_framed(data: bytes) -> Tuple[dict, bytes]:
    if len(data) < _FRAME_HEADER.size:
        raise PilosaError("truncated migration frame: missing header length")
    (n,) = _FRAME_HEADER.unpack_from(data, 0)
    end = _FRAME_HEADER.size + n
    if len(data) < end:
        raise PilosaError("truncated migration frame: short header")
    try:
        header = json.loads(data[_FRAME_HEADER.size:end])
    except ValueError as e:
        raise PilosaError(f"corrupt migration frame header: {e}") from None
    return header, data[end:]


# ------------------------------------------------------------------ stats


class RebalanceStats:
    """Counters + cutover-pause samples shared by the coordinator,
    receiver, and source roles of one node. Surfaces as the `rebalance`
    group in /debug/vars and as diagnostics aggregates."""

    _PAUSE_WINDOW = 512

    def __init__(self, clock=None):
        self.clock = clock or time.monotonic
        self._mu = threading.Lock()
        self.counters: Dict[str, int] = {
            "jobs_started": 0,
            "jobs_completed": 0,
            "jobs_aborted": 0,
            "jobs_resumed": 0,
            "fragments_moved": 0,
            "fragments_skipped": 0,  # source had no data (404 on begin)
            "bytes_streamed": 0,
            "catchup_rounds": 0,
            "catchup_restarts": 0,  # source snapshot invalidated a session
            "shards_cut_over": 0,
            "cutover_pause_overruns": 0,  # freeze->commit > cutover-pause-max
            "stale_epoch_reroutes": 0,
            # Reverse migration (abort with full restore, docs/rebalance.md)
            "jobs_revert_started": 0,
            "jobs_reverted": 0,
            "shards_reverted": 0,
        }
        self.fragments_pending = 0
        self._pauses: deque = deque(maxlen=self._PAUSE_WINDOW)
        self._freeze_at: Dict[Tuple[str, int], float] = {}

    def add(self, key: str, n: int = 1) -> None:
        with self._mu:
            self.counters[key] += n

    def set_pending(self, n: int) -> None:
        with self._mu:
            self.fragments_pending = n

    def add_pending(self, n: int) -> None:
        with self._mu:
            self.fragments_pending = max(0, self.fragments_pending + n)

    def note_freeze(self, index: str, shard: int) -> None:
        """A shard froze on this node (source side): the write-pause
        window opens now and closes when the cutover commit lands."""
        with self._mu:
            self._freeze_at[(index, shard)] = self.clock()

    def note_commit(self, index: str, shard: int,
                    pause_cap: float = 0.0) -> None:
        with self._mu:
            t0 = self._freeze_at.pop((index, shard), None)
            if t0 is None:
                return
            pause = self.clock() - t0
            self._pauses.append(pause)
            if pause_cap and pause > pause_cap:
                self.counters["cutover_pause_overruns"] += 1

    def _pause_quantile(self, q: float) -> Optional[float]:
        # Must hold _mu.
        if not self._pauses:
            return None
        ordered = sorted(self._pauses)
        return ordered[min(len(ordered) - 1, int(len(ordered) * q))]

    def snapshot(self) -> dict:
        with self._mu:
            p50 = self._pause_quantile(0.50)
            p99 = self._pause_quantile(0.99)
            out = dict(self.counters)
            out["fragments_pending"] = self.fragments_pending
            out["cutover_pause_ms_p50"] = (
                round(p50 * 1e3, 3) if p50 is not None else None)
            out["cutover_pause_ms_p99"] = (
                round(p99 * 1e3, 3) if p99 is not None else None)
            return out


def _retry_transport(fn, attempts: int = 6, backoff: float = 0.05):
    """Run `fn` retrying TRANSPORT failures (connect errors / 5xx) with
    small exponential backoff — a migration must ride out a brown-out on
    a peer link instead of aborting the whole job on one dropped
    connection. Application errors (4xx) pass straight through: they are
    deterministic and a retry would just repeat them."""
    from ..server.client import ClientError

    delay = backoff
    for attempt in range(attempts):
        try:
            return fn()
        except ClientError as e:
            if 400 <= e.status < 500:
                raise
            if attempt == attempts - 1:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


class _Throttle:
    """Token-bucket pacing for migration streams (max-bytes-per-sec).
    Shared by every stream of one instruction, so the knob bounds the
    NODE's migration ingress, not each stream's."""

    def __init__(self, rate: float):
        self.rate = rate
        self._mu = threading.Lock()
        self._debt = 0.0
        self._last = time.monotonic()

    def consume(self, nbytes: int) -> None:
        if self.rate <= 0 or nbytes <= 0:
            return
        with self._mu:
            now = time.monotonic()
            self._debt = max(0.0, self._debt - (now - self._last))
            self._last = now
            self._debt += nbytes / self.rate
            wait = self._debt
        if wait > 0.001:
            time.sleep(min(wait, 5.0))


# ------------------------------------------------------------- source side


class _Session:
    __slots__ = ("frag", "pos", "seq", "index", "field", "view", "shard",
                 "created")

    def __init__(self, frag, pos, seq, index, field, view, shard, created):
        self.frag = frag
        self.pos = pos
        self.seq = seq
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.created = created


class MigrationSource:
    """Source-side session registry behind /internal/migrate/*.

    Sessions pin their fragment's snapshot policy (Fragment._migrating)
    so the WAL layout the positions refer to stays put; an inline
    snapshot that slips through anyway (replica restore) bumps
    _snapshot_seq and the next delta answers `restart` instead of
    returning bytes from the wrong file layout.
    """

    SESSION_TTL = 600.0

    def __init__(self, server):
        self.server = server
        self._mu = threading.Lock()
        self._sessions: Dict[str, _Session] = {}

    # -------------------------------------------------------------- begin

    def begin(self, index: str, field: str, view: str, shard: int):
        """Start one fragment's migration stream. Returns (header, data):
        the serialized container base plus the WAL position it matches."""
        failpoints.fire("migrate-begin")
        frag = self.server.holder.fragment(index, field, view, shard)
        if frag is None:
            raise FragmentNotFoundError(f"{index}/{field}/{view}/{shard}")
        if frag.quarantined:
            # Same refusal as the legacy shard-ship endpoint: installing a
            # quarantined (empty, degraded) copy and then GC'ing the
            # healthy replicas would be permanent loss.
            raise PilosaError(
                "fragment is quarantined pending repair; refusing to serve "
                "as a migration source"
            )
        with frag._mu:
            frag._migrating += 1
            storage = frag.storage
            # Copy-on-write handoff (the snapshotter's off-lock serialize
            # discipline, Bitmap.cow_clone): the clone is frozen at
            # exactly the WAL position below, so the base + replayed tail
            # is complete — serializing the LIVE bitmap off-lock instead
            # can tear a racing container insert (stale header n drops
            # the tail value, and replay never restores an OLD bit).
            snap = storage.cow_clone()
            if frag._wal is not None:
                frag._wal.flush()
                pos = os.fstat(frag._wal.fileno()).st_size
            else:
                pos = None  # pathless fragment: no WAL, no deltas
            seq = frag._snapshot_seq
        try:
            data = snap.to_bytes()
        except Exception:
            self._release_fragment(frag)
            raise
        finally:
            with frag._mu:
                storage.cow_release()
        sid = uuid.uuid4().hex
        with self._mu:
            self._expire_locked()
            self._sessions[sid] = _Session(
                frag, pos, seq, index, field, view, shard, time.monotonic())
        return {"session": sid, "pos": pos, "seq": seq}, data

    # -------------------------------------------------------------- delta

    def delta(self, session_id: str, from_pos: Optional[int] = None):
        """WAL bytes appended since `from_pos` (the RECEIVER tracks its
        position and sends it, so a retried pull whose previous response
        was lost in transit re-reads the same chunk instead of skipping
        it — replay is idempotent, a skip is a lost write). Answers
        {"restart": true} when a snapshot rewrote the file under the
        session (positions no longer mean anything)."""
        failpoints.fire("migrate-delta")
        s = self._get(session_id)
        # Activity refreshes the TTL: it guards ORPHANED sessions (a dead
        # receiver), not long-running ones — a throttled multi-GiB stream
        # legitimately outlives any absolute age.
        s.created = time.monotonic()
        frag = s.frag
        pos = s.pos if from_pos is None else int(from_pos)
        if pos is None:
            return {"restart": False, "pos": None}, b""
        with frag._mu:
            if frag._snapshot_seq != s.seq:
                return {"restart": True}, b""
            if frag._wal is None:
                return {"restart": True}, b""
            frag._wal.flush()
            cur = os.fstat(frag._wal.fileno()).st_size
        if cur <= pos:
            return {"restart": False, "pos": pos}, b""
        # Read off-lock: the WAL is append-only, so [pos, cur) is stable —
        # unless a snapshot replaced the inode mid-read, which the seq
        # re-check below turns into a clean restart instead of shipping
        # bytes from the wrong layout.
        with open(frag.path, "rb") as f:
            f.seek(pos)
            data = f.read(cur - pos)
        with frag._mu:
            if frag._snapshot_seq != s.seq:
                return {"restart": True}, b""
        s.pos = cur
        return {"restart": False, "pos": cur}, data

    # ------------------------------------------------------------- freeze

    def freeze(self, index: str, shard: int) -> dict:
        """Freeze the shard on this source: every fragment of (index,
        shard) stops accepting writes (ShardMovedError; a write caught
        here re-routes/waits for the commit, so it is never acked into a
        doomed copy). The final WAL tails stay readable through the open
        sessions — frozen, hence complete. Routing deliberately does NOT
        flip here: reads keep serving from this fully-current frozen
        copy until the cutover COMMIT, because the gainer has not
        drained the final tail yet — flipping reads at freeze served
        counts missing up to a threshold's worth of acked writes."""
        frozen = 0
        t0 = time.monotonic()
        for frag in self._shard_fragments(index, shard):
            with frag._mu:
                if frag._wal is not None:
                    frag._wal.flush()
                frag._moved = True
            frozen += 1
        stats = getattr(self.server, "rebalance_stats", None)
        if stats is not None:
            stats.note_freeze(index, shard)
        return {"frozen": frozen,
                "freezeMs": round((time.monotonic() - t0) * 1e3, 3)}

    def unfreeze(self, keep=()) -> int:
        """Thaw frozen fragments after an abort: shards whose cutover
        never committed revert to this node, and a lingering _moved flag
        would leave them permanently write-dead. `keep` lists committed
        (index, shard) pairs that stay frozen (their data moved)."""
        keep = {(i, int(s)) for i, s in keep}
        thawed = 0
        for index in list(self.server.holder.indexes.values()):
            for field in list(index.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        if frag._moved and (
                                frag.index, frag.shard) not in keep:
                            with frag._mu:
                                frag._moved = False
                            thawed += 1
        return thawed

    def _shard_fragments(self, index: str, shard: int):
        idx = self.server.holder.index(index)
        if idx is None:
            return []
        out = []
        for field in list(idx.fields.values()):
            for view in list(field.views.values()):
                frag = view.fragments.get(shard)
                if frag is not None:
                    out.append(frag)
        return out

    # -------------------------------------------------------------- close

    def close(self, session_ids) -> None:
        with self._mu:
            sessions = [self._sessions.pop(sid, None) for sid in session_ids]
        for s in sessions:
            if s is not None:
                self._release_fragment(s.frag)

    def abort_all(self) -> None:
        with self._mu:
            sessions, self._sessions = list(self._sessions.values()), {}
        for s in sessions:
            self._release_fragment(s.frag)

    def _get(self, session_id: str) -> _Session:
        with self._mu:
            self._expire_locked()
            s = self._sessions.get(session_id)
        if s is None:
            raise PilosaError(f"unknown migration session {session_id!r}")
        return s

    def _expire_locked(self) -> None:
        # Must hold _mu. An orphaned session (receiver died) must not pin
        # its fragment's snapshot policy forever.
        now = time.monotonic()
        for sid in [k for k, s in self._sessions.items()
                    if now - s.created > self.SESSION_TTL]:
            s = self._sessions.pop(sid)
            self._release_fragment(s.frag)

    @staticmethod
    def _release_fragment(frag) -> None:
        with frag._mu:
            frag._migrating = max(0, frag._migrating - 1)


# ----------------------------------------------------------- receiver side


class _ShardMigration:
    """Parked per-shard receiver state between `ready` and `finalize`."""

    __slots__ = ("job_id", "index", "shard", "frag_states", "coordinator")

    def __init__(self, job_id, index, shard, frag_states, coordinator):
        self.job_id = job_id
        self.index = index
        self.shard = shard
        # Per-fragment stream state: [field, view, frag, session, pos,
        # source_uri] — sources may differ per fragment.
        self.frag_states = frag_states
        self.coordinator = coordinator  # (node_id, uri) from the instruction


class RebalanceReceiver:
    """Gaining-node side: streams bases, replays catch-up tails, drains
    the frozen final delta on finalize, seals, and reports per-shard
    progress to the coordinator."""

    _RESTART_LIMIT = 3

    def __init__(self, server):
        self.server = server
        self._mu = threading.Lock()
        self._shards: Dict[Tuple[str, int], _ShardMigration] = {}
        self._cancelled: Set[str] = set()

    @property
    def _cfg(self) -> RebalanceConfig:
        return self.server.rebalance_config

    @property
    def _stats(self) -> RebalanceStats:
        return self.server.rebalance_stats

    # -------------------------------------------------------- instruction

    def handle_instruction(self, msg: dict) -> None:
        """Entry point for a `rebalance-instruction` message (runs on a
        daemon thread spawned by receive_message)."""
        server = self.server
        job_id = msg.get("jobID", "")
        with self._mu:
            # A fresh instruction restarts the job on this node — e.g. a
            # resumed job reusing the jobID of one this node saw aborted.
            self._cancelled.discard(job_id)
        server.holder.apply_schema(msg.get("schema", []))
        for index_name, max_shard in msg.get("maxShards", {}).items():
            idx = server.holder.index(index_name)
            if idx is not None:
                idx.set_remote_max_shard(max_shard)
        node_uris = msg.get("nodeURIs", {})
        moves = msg.get("moves", [])
        # Replies route to the coordinator the INSTRUCTION names: in a
        # static cluster a non-coordinator node may not have learned the
        # coordinator's flag yet (it arrives via monitor merge), and a
        # self-delivered ready would silently vanish.
        coordinator = (msg.get("coordinatorID", ""),
                       msg.get("coordinatorURI", ""))
        throttle = _Throttle(self._cfg.max_bytes_per_sec)
        sem = threading.Semaphore(self._cfg.max_concurrent_streams)
        self._stats.add_pending(sum(len(m.get("fragments", [])) for m in moves))
        for entry in moves:
            threading.Thread(
                target=self._migrate_shard,
                args=(job_id, entry, node_uris, throttle, sem, coordinator),
                name=f"migrate-{entry.get('index')}-{entry.get('shard')}",
                daemon=True,
            ).start()

    def _migrate_shard(self, job_id, entry, node_uris, throttle, sem,
                       coordinator) -> None:
        index, shard = entry["index"], int(entry["shard"])
        server = self.server
        accounted = {"n": 0}  # fragments already resolved (404 skips)
        with sem:
            if job_id in self._cancelled:
                return
            try:
                frag_states = self._stream_shard(
                    job_id, index, shard, node_uris,
                    entry.get("fragments", []), throttle, accounted)
            except Exception as e:
                self._stats.add_pending(
                    -(len(entry.get("fragments", [])) - accounted["n"]))
                self._notify_coordinator({
                    "type": "rebalance-shard-failed", "jobID": job_id,
                    "index": index, "shard": shard,
                    "nodeID": server.node.id, "error": str(e),
                }, coordinator)
                return
        with self._mu:
            self._shards[(index, shard)] = _ShardMigration(
                job_id, index, shard, frag_states, coordinator)
        self._notify_coordinator({
            "type": "rebalance-shard-ready", "jobID": job_id,
            "index": index, "shard": shard, "nodeID": server.node.id,
        }, coordinator)

    def _stream_shard(self, job_id, index, shard, node_uris, fragments,
                      throttle, accounted):
        """Base + catch-up for every fragment of one shard. Returns the
        parked [field, view, frag, session, pos, source_uri] states."""
        from ..server.client import ClientError

        client = self.server.client
        cfg = self._cfg
        frag_states = []
        for f in fragments:
            field, view = f["field"], f["view"]
            source = f["sourceNodeID"]
            source_uri = node_uris.get(source, source)
            try:
                hdr, data = _retry_transport(lambda: client.migrate_begin(
                    source_uri, index, field, view, shard))
            except ClientError as e:
                if e.status == 404:
                    # The source simply has no data for this fragment
                    # (fragment_sources enumerates the schema cartesian);
                    # nothing to move. Counted in `accounted` so a later
                    # shard failure doesn't subtract it from the pending
                    # gauge a second time.
                    self._stats.add("fragments_skipped")
                    self._stats.add_pending(-1)
                    accounted["n"] += 1
                    continue
                raise
            throttle.consume(len(data))
            self._stats.add("bytes_streamed", len(data))
            frag = self._local_fragment(index, field, view, shard)
            frag.migrate_install(data)
            # [field, view, frag, session, next WAL position to pull,
            # source uri] — the receiver owns the cursor so retried
            # pulls re-read, and each fragment remembers its source.
            frag_states.append([field, view, frag, hdr["session"],
                                hdr.get("pos"), source_uri])
        # Catch-up rounds across the shard's fragments until one round's
        # total tail is under the cutover threshold.
        for _ in range(cfg.max_catchup_rounds):
            if job_id in self._cancelled:
                raise PilosaError(f"rebalance job {job_id} aborted")
            total = 0
            for fs in frag_states:
                total += self._pull_delta(fs, index, shard, throttle)
            self._stats.add("catchup_rounds")
            if total <= cfg.catchup_threshold_bytes:
                break
        return frag_states

    def _pull_delta(self, fs, index, shard, throttle) -> int:
        """One delta pull + replay for one fragment; transparently redoes
        begin when the source's file layout changed (bounded restarts)."""
        from ..server.client import ClientError

        client = self.server.client
        field, view, frag, session, pos, source_uri = fs
        for attempt in range(self._RESTART_LIMIT + 1):
            hdr, data = _retry_transport(
                lambda s=session, p=pos: client.migrate_delta(
                    source_uri, s, from_pos=p))
            if not hdr.get("restart"):
                if data:
                    throttle.consume(len(data))
                    self._stats.add("bytes_streamed", len(data))
                    frag.migrate_apply_ops(data)
                fs[4] = hdr.get("pos", pos)
                return len(data)
            # Source snapshot invalidated the session: start this
            # fragment over from a fresh base. Closing the dead session
            # is best-effort — it expires on the source's TTL anyway.
            self._stats.add("catchup_restarts")
            try:
                client.migrate_close(source_uri, [session])
            except ClientError:
                pass
            hdr, data = _retry_transport(lambda: client.migrate_begin(
                source_uri, index, field, view, shard))
            throttle.consume(len(data))
            self._stats.add("bytes_streamed", len(data))
            frag.migrate_install(data)
            fs[3] = session = hdr["session"]
            fs[4] = pos = hdr.get("pos")
        raise PilosaError(
            f"migration of {index}/{field}/{view}/{shard} restarted "
            f"{self._RESTART_LIMIT + 1} times without converging"
        )

    def _local_fragment(self, index, field, view, shard):
        fld = self.server.holder.field(index, field)
        if fld is None:
            raise FragmentNotFoundError(f"{index}/{field} (schema not applied)")
        v = fld.create_view_if_not_exists(view)
        return v.create_fragment_if_not_exists(shard, broadcast=False)

    # ----------------------------------------------------------- finalize

    def handle_finalize(self, msg: dict) -> None:
        """Coordinator says the shard froze at the source: drain the
        final (now-static) tail, seal, flip local routing, ack."""
        from ..server.client import ClientError

        index, shard = msg["index"], int(msg["shard"])
        job_id = msg.get("jobID", "")
        with self._mu:
            st = self._shards.pop((index, shard), None)
        if st is None:
            return  # not ours / already finalized
        client = self.server.client
        try:
            for fs in st.frag_states:
                hdr, data = _retry_transport(
                    lambda s=fs[3], p=fs[4], u=fs[5]: client.migrate_delta(
                        u, s, from_pos=p))
                if hdr.get("restart"):
                    # The final drain has no base to restart from — a
                    # snapshot slipping past the migration pin here means
                    # sealing would silently drop the tail. Fail the
                    # shard; the job aborts clean (or resumes) instead.
                    raise PilosaError(
                        f"final drain of {index}/shard {shard} invalidated "
                        "by a source snapshot")
                if data:
                    self._stats.add("bytes_streamed", len(data))
                    fs[2].migrate_apply_ops(data)
                fs[2].migrate_seal()
        except (ClientError, PilosaError, OSError) as e:
            self._stats.add_pending(-len(st.frag_states))
            self._notify_coordinator({
                "type": "rebalance-shard-failed", "jobID": job_id,
                "index": index, "shard": shard,
                "nodeID": self.server.node.id, "error": str(e),
            }, st.coordinator)
            return
        # Session close is best-effort (sources expire sessions on TTL):
        # a close lost to a flaky link must not fail an already-drained,
        # already-sealed shard.
        self._close_sessions(st)
        self._stats.add("fragments_moved", len(st.frag_states))
        self._stats.add_pending(-len(st.frag_states))
        if msg.get("revert"):
            # Reverse migration (docs/rebalance.md): the shard's data
            # just streamed BACK to this prior owner. Thaw the local
            # fragments (frozen since the forward cutover — the freeze
            # is what made the copy byte-faithful) and flip routing back
            # to the prior topology for this shard.
            for fs in st.frag_states:
                fs[2]._moved = False
            self.server.cluster.revert_cutover(index, shard)
        else:
            self.server.cluster.apply_cutover(index, shard)
        self._notify_coordinator({
            "type": "rebalance-shard-done", "jobID": job_id,
            "index": index, "shard": shard, "nodeID": self.server.node.id,
        }, st.coordinator)

    def handle_abort(self, msg: dict) -> None:
        job_id = msg.get("jobID", "")
        with self._mu:
            self._cancelled.add(job_id)
            parked = [st for st in self._shards.values()
                      if st.job_id == job_id]
            for st in parked:
                self._shards.pop((st.index, st.shard), None)
        for st in parked:
            self._stats.add_pending(-len(st.frag_states))
            self._close_sessions(st)

    def _close_sessions(self, st: _ShardMigration) -> None:
        """Best-effort session close, grouped per source node."""
        from ..server.client import ClientError

        by_source: Dict[str, List[str]] = {}
        for fs in st.frag_states:
            by_source.setdefault(fs[5], []).append(fs[3])
        for source_uri, sessions in by_source.items():
            try:
                self.server.client.migrate_close(source_uri, sessions)
            except (ClientError, PilosaError):
                pass

    def _notify_coordinator(self, msg: dict, coordinator) -> None:
        """Deliver a progress message to the coordinator the instruction
        named (with transport retries: a ready/done message lost to a
        brown-out would stall the whole job)."""
        from ..server.client import ClientError

        server = self.server
        coord_id, coord_uri = coordinator
        try:
            if not coord_id or coord_id == server.node.id:
                server.receive_message(msg)
            else:
                target = Node(id=coord_id, uri=coord_uri or coord_id)
                _retry_transport(
                    lambda: server.client.send_message(target, msg))
        except (ClientError, PilosaError) as e:
            server.logger.error(
                "rebalance: cannot reach coordinator with %s: %s",
                msg.get("type"), e)


# --------------------------------------------------------- coordinator side


class RebalanceJob:
    def __init__(self, job_id: str, new_nodes: List[Node],
                 moves: Dict[str, List[dict]],
                 committed: Optional[Set[Tuple[str, int]]] = None,
                 attempt: int = 0, revert: bool = False):
        self.id = job_id
        # Reverse-migration job (docs/rebalance.md): moves stream
        # committed shards from the TARGET owners back to the PRIOR
        # owners, `committed` counts shards already flipped BACK, and
        # completion fully reverts routing instead of committing the
        # target topology. new_nodes still names the target membership —
        # the URI pool for reaching the reverse-stream sources.
        self.revert = revert
        # Delivery attempt (bumped per resume): rides instruction
        # messages so a re-sent instruction for a resumed job is not
        # swallowed by the receivers' duplicate-delivery dedupe.
        self.attempt = attempt
        # Set by _complete: a straggler shard_committed racing completion
        # must not re-persist the checkpoint after _clear_state removed it
        # (a resurrected stale checkpoint makes a restarted coordinator
        # spuriously resume a finished job).
        self.finalized = False
        self.new_nodes = new_nodes
        # node_id -> [{index, shard, fragments: [{field, view,
        # sourceNodeID}]}] — sources are PER FRAGMENT (source_ok may
        # steer different fragments of one shard to different replicas).
        self.moves = moves
        # (index, shard) -> set of gaining node ids still owing progress.
        self.gainers: Dict[Tuple[str, int], Set[str]] = {}
        # (index, shard) -> every distinct source node streaming any of
        # its fragments; ALL of them freeze at cutover (an unfrozen
        # stream source could take a write after its final drain).
        self.sources: Dict[Tuple[str, int], Set[str]] = {}
        for node_id, entries in moves.items():
            for e in entries:
                key = (e["index"], int(e["shard"]))
                self.gainers.setdefault(key, set()).add(node_id)
                srcs = self.sources.setdefault(key, set())
                for f in e.get("fragments", []):
                    srcs.add(f["sourceNodeID"])
        self.ready: Dict[Tuple[str, int], Set[str]] = {}
        self.done: Dict[Tuple[str, int], Set[str]] = {}
        self.committed: Set[Tuple[str, int]] = set(committed or ())
        self.frozen: Set[Tuple[str, int]] = set()
        # Revert jobs only: shards whose forward cutover is still in
        # force (routing to the target owners). Shrinks as reverse
        # cutovers flip shards back; THIS set is what the checkpoint
        # persists, so a resumed revert re-reverts exactly what's left.
        self.revert_remaining: Set[Tuple[str, int]] = set()
        self.lock = threading.Lock()

    def pending_shards(self) -> List[Tuple[str, int]]:
        return sorted(k for k in self.gainers if k not in self.committed)


class RebalanceCoordinator:
    """Coordinator role of the online rebalance. One job at a time, like
    the legacy ResizeCoordinator; the job checkpoint under the data dir
    makes a crashed/restarted coordinator resume instead of restart."""

    STATE_FILE = ".rebalance.json"

    def __init__(self, server):
        self.server = server
        self.job: Optional[RebalanceJob] = None
        # Autoscaler contract (cluster/autoscale.py): set before an
        # autoscale-initiated begin() so EVERY abort path of that job —
        # operator abort, shard failure, instruction delivery failure —
        # escalates to a reverse migration instead of leaving mixed
        # routing behind. Cleared when the job (or its revert) finishes.
        self.revert_on_abort = False
        self._lock = threading.Lock()
        # Serializes checkpoint writes: concurrent shard_done handlers
        # racing tmp+rename on the same path would FileNotFoundError.
        self._persist_mu = threading.Lock()

    @property
    def _stats(self) -> RebalanceStats:
        return self.server.rebalance_stats

    def _state_path(self) -> Optional[str]:
        if not self.server.data_dir:
            return None
        return os.path.join(self.server.data_dir, self.STATE_FILE)

    # -------------------------------------------------------------- begin

    def begin(self, new_nodes: List[Node],
              resume_committed: Optional[Set[Tuple[str, int]]] = None,
              job_id: Optional[str] = None, attempt: int = 0) -> None:
        from .resize import fragment_sources

        server = self.server
        cluster = server.cluster
        with self._lock:
            if self.job is not None:
                raise PilosaError("a rebalance job is already running")
            from .node import Cluster

            old = Cluster(
                node=cluster.node, nodes=list(cluster.nodes),
                replica_n=cluster.replica_n, partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            new = Cluster(
                node=cluster.node,
                nodes=sorted(new_nodes, key=lambda n: n.id),
                replica_n=cluster.replica_n, partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            schema = server.holder.schema()
            max_shards = {
                name: idx.max_shard()
                for name, idx in server.holder.indexes.items()
            }
            quarantined = {
                (f.index, f.field, f.view, f.shard)
                for f in server.holder.quarantined_fragments()
            }

            def source_ok(node_id, index, field, view, shard):
                if node_id in cluster.unavailable:
                    return False
                if node_id == server.node.id and (
                        (index, field, view, shard) in quarantined):
                    return False
                return True

            sources = fragment_sources(
                old, new, schema, max_shards, source_ok=source_ok)
            committed = set(resume_committed or ())
            moves: Dict[str, List[dict]] = {}
            for node_id, frag_list in sources.items():
                per_shard: Dict[Tuple[str, int], dict] = {}
                for f in frag_list:
                    key = (f["index"], int(f["shard"]))
                    if key in committed:
                        continue  # resumed: this shard already cut over
                    entry = per_shard.setdefault(key, {
                        "index": f["index"], "shard": int(f["shard"]),
                        "fragments": [],
                    })
                    # Source rides per FRAGMENT: source_ok may steer
                    # different fragments of one shard to different
                    # replicas (e.g. one fragment quarantined locally).
                    entry["fragments"].append(
                        {"field": f["field"], "view": f["view"],
                         "sourceNodeID": f["sourceNodeID"]})
                if per_shard:
                    moves[node_id] = [per_shard[k] for k in sorted(per_shard)]
            job = RebalanceJob(
                job_id or uuid.uuid4().hex[:8], new.nodes, moves,
                committed=committed, attempt=attempt)
            self.job = job

        self._stats.add("jobs_started")
        if resume_committed is not None:
            self._stats.add("jobs_resumed")

        if not job.gainers and not committed:
            # Nothing to move (identical placement / empty holder):
            # commit the membership change immediately.
            self._complete(job)
            return

        cluster.begin_rebalance(job.new_nodes, committed=committed)
        participants = set(job.moves)
        for srcs in job.sources.values():
            participants |= srcs
        participants = sorted(participants)
        for nid in participants:
            cluster.health.set_copy_grace(nid)
        self._persist(job)
        begin_msg = {
            "type": "rebalance-begin", "jobID": job.id,
            "attempt": job.attempt,
            "nodes": [n.to_dict() for n in cluster.nodes],
            "newNodes": [n.to_dict() for n in job.new_nodes],
            "participants": participants,
            "committed": sorted([list(k) for k in committed]),
            "epoch": cluster.routing_epoch,
        }
        self._broadcast_all(begin_msg)
        node_uris = {n.id: n.uri for n in cluster.nodes}
        node_uris.update({n.id: n.uri for n in job.new_nodes})
        for node_id, entries in job.moves.items():
            msg = {
                "type": "rebalance-instruction", "jobID": job.id,
                "attempt": job.attempt,
                "coordinatorID": cluster.node.id,
                "coordinatorURI": cluster.node.uri,
                # The snapshot fragment_sources planned the moves against
                # — recomputing here could drift (a field created
                # mid-begin would appear with no corresponding moves).
                "schema": schema,
                "maxShards": max_shards,
                "nodeURIs": node_uris,
                "moves": entries,
            }
            try:
                self._send(node_id, msg)
            except PilosaError as e:
                self.abort(f"cannot deliver rebalance instruction to "
                           f"{node_id}: {e}")
                return

        if not job.pending_shards():
            # Resume found every shard already committed: finish up.
            self._complete(job)

    def resume(self) -> bool:
        """Pick a checkpointed job back up (coordinator restart, or an
        operator retry after an abort that had already committed
        cutovers). Returns False when there is nothing to resume. A
        revert checkpoint resumes the REVERSE migration: the remaining
        still-committed shards stream back until placement is fully
        restored."""
        path = self._state_path()
        if not path or not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                state = json.load(f)
            new_nodes = [Node.from_dict(n) for n in state["newNodes"]]
            committed = {(i, int(s)) for i, s in state.get("committed", [])}
        except (OSError, ValueError, KeyError) as e:
            self.server.logger.error(
                "rebalance: unreadable checkpoint %s: %s", path, e)
            return False
        if state.get("revert"):
            self.server.logger.info(
                "rebalance: resuming REVERT job %s (%d shards still on "
                "target owners)", state.get("jobID"), len(committed))
            self.begin_revert(new_nodes, committed,
                              job_id=state.get("jobID"),
                              attempt=int(state.get("attempt", 0)) + 1)
            return True
        self.server.logger.info(
            "rebalance: resuming job %s (%d shards already committed)",
            state.get("jobID"), len(committed))
        self.begin(new_nodes, resume_committed=committed,
                   job_id=state.get("jobID"),
                   attempt=int(state.get("attempt", 0)) + 1)
        return True

    def begin_revert(self, target_nodes: List[Node],
                     still_committed: Set[Tuple[str, int]],
                     job_id: Optional[str] = None, attempt: int = 0) -> None:
        """Reverse migration (docs/rebalance.md): an aborted job left
        `still_committed` shards routed to the TARGET owners. Stream
        each one's fragments from the target owners back to the prior
        owners (the same freeze -> final-drain -> seal machinery as the
        forward direction, run against the inverted placement diff),
        flip its routing back per shard, and finish by dropping the
        overrides entirely — zero mixed routing, zero _moved freezes,
        byte-identical fragments on the restored owners."""
        from .resize import fragment_sources
        from .node import Cluster

        server = self.server
        cluster = server.cluster
        remaining = {(i, int(s)) for i, s in still_committed}
        with self._lock:
            if self.job is not None:
                raise PilosaError("a rebalance job is already running")
            prior = Cluster(
                node=cluster.node, nodes=list(cluster.nodes),
                replica_n=cluster.replica_n, partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            target = Cluster(
                node=cluster.node,
                nodes=sorted(target_nodes, key=lambda n: n.id),
                replica_n=cluster.replica_n, partition_n=cluster.partition_n,
                hasher=cluster.hasher,
            )
            schema = server.holder.schema()
            max_shards = {
                name: idx.max_shard()
                for name, idx in server.holder.indexes.items()
            }
            # The inverted placement diff: who gains each fragment going
            # target -> prior, restricted to the shards actually cut
            # over. A never-moved shard's fragments never left the prior
            # owners, so streaming them would pull from target owners
            # that may hold no data at all.
            sources = fragment_sources(target, prior, schema, max_shards)
            moves: Dict[str, List[dict]] = {}
            for node_id, frag_list in sources.items():
                per_shard: Dict[Tuple[str, int], dict] = {}
                for f in frag_list:
                    key = (f["index"], int(f["shard"]))
                    if key not in remaining:
                        continue
                    entry = per_shard.setdefault(key, {
                        "index": f["index"], "shard": int(f["shard"]),
                        "fragments": [],
                    })
                    entry["fragments"].append(
                        {"field": f["field"], "view": f["view"],
                         "sourceNodeID": f["sourceNodeID"]})
                if per_shard:
                    moves[node_id] = [per_shard[k] for k in sorted(per_shard)]
            job = RebalanceJob(
                job_id or uuid.uuid4().hex[:8], target.nodes, moves,
                attempt=attempt, revert=True)
            job.revert_remaining = set(remaining)
            self.job = job

        self._stats.add("jobs_revert_started")
        # A restarted coordinator rebuilt its membership from the
        # persisted PRIOR topology with no overrides: reinstall the
        # mixed-routing state the abort left (next=target, migrated=
        # remaining) so per-shard reverse flips have something to flip.
        if cluster.next_nodes is None:
            cluster.begin_rebalance(job.new_nodes, committed=remaining)
        self._persist(job)
        participants = set(job.moves)
        for srcs in job.sources.values():
            participants |= srcs
        participants = sorted(participants)
        begin_msg = {
            "type": "rebalance-begin", "jobID": job.id,
            "attempt": job.attempt, "revert": True,
            "nodes": [n.to_dict() for n in cluster.nodes],
            "newNodes": [n.to_dict() for n in job.new_nodes],
            "participants": participants,
            "committed": sorted([list(k) for k in remaining]),
            "epoch": cluster.routing_epoch,
        }
        self._broadcast_all(begin_msg)
        # Shards whose owner sets don't differ between the two
        # placements (possible at small replica overlaps) need no
        # stream: their data never moved, so routing flips back now.
        for key in sorted(remaining - set(job.gainers)):
            cluster.revert_cutover(key[0], key[1])
            with job.lock:
                job.revert_remaining.discard(key)
            self._stats.add("shards_reverted")
            self._persist(job)
            self._broadcast_all({
                "type": "cutover-revert", "jobID": job.id,
                "index": key[0], "shard": key[1],
                "epoch": cluster.routing_epoch,
            })
        node_uris = {n.id: n.uri for n in cluster.nodes}
        node_uris.update({n.id: n.uri for n in job.new_nodes})
        for node_id, entries in job.moves.items():
            msg = {
                "type": "rebalance-instruction", "jobID": job.id,
                "attempt": job.attempt,
                "coordinatorID": cluster.node.id,
                "coordinatorURI": cluster.node.uri,
                "schema": schema,
                "maxShards": max_shards,
                "nodeURIs": node_uris,
                "moves": entries,
            }
            try:
                self._send(node_id, msg)
            except PilosaError as e:
                self.abort(f"cannot deliver revert instruction to "
                           f"{node_id}: {e}")
                return
        if not job.pending_shards():
            self._complete_revert(job)

    # ----------------------------------------------------------- progress

    def shard_ready(self, msg: dict) -> None:
        from ..server.client import ClientError

        job = self._job_for(msg)
        if job is None:
            return
        key = (msg["index"], int(msg["shard"]))
        with job.lock:
            job.ready.setdefault(key, set()).add(msg.get("nodeID", ""))
            all_ready = job.ready[key] >= job.gainers.get(key, set())
            if not all_ready or key in job.frozen:
                return
            job.frozen.add(key)
        # Every gaining replica is converged: freeze the shard at EVERY
        # node streaming one of its fragments (an unfrozen stream source
        # could still take a write after its final drain), then tell the
        # gainers to drain the final tails.
        for source_id in sorted(job.sources.get(key, ())):
            source = self._node_uri(job, source_id)
            try:
                if source_id == self.server.node.id:
                    self.server.migration_source.freeze(key[0], key[1])
                else:
                    _retry_transport(
                        lambda s=source: self.server.client.migrate_freeze(
                            s, key[0], key[1]))
            except (ClientError, PilosaError) as e:
                self.abort(f"freeze of {key[0]}/shard {key[1]} on "
                           f"{source_id} failed: {e}")
                return
        for node_id in sorted(job.gainers.get(key, ())):
            try:
                self._send(node_id, {
                    "type": "rebalance-finalize", "jobID": job.id,
                    "index": key[0], "shard": key[1],
                    "revert": job.revert,
                })
            except PilosaError as e:
                self.abort(f"cannot deliver finalize for {key} to "
                           f"{node_id}: {e}")
                return

    def shard_done(self, msg: dict) -> None:
        job = self._job_for(msg)
        if job is None:
            return
        key = (msg["index"], int(msg["shard"]))
        with job.lock:
            job.done.setdefault(key, set()).add(msg.get("nodeID", ""))
            if job.done[key] < job.gainers.get(key, set()):
                return
            if key in job.committed:
                return
            job.committed.add(key)
            job.revert_remaining.discard(key)
            all_done = not job.pending_shards()
        cluster = self.server.cluster
        if job.revert:
            # Reverse migration: the shard's data is back on its prior
            # owners — flip routing BACK and tell everyone.
            cluster.revert_cutover(key[0], key[1])
            self._stats.add("shards_reverted")
            self._persist(job)
            self._broadcast_all({
                "type": "cutover-revert", "jobID": job.id,
                "index": key[0], "shard": key[1],
                "epoch": cluster.routing_epoch,
            })
            if all_done:
                self._complete_revert(job)
            return
        cluster.apply_cutover(key[0], key[1])
        # Close the write-pause sample when the COORDINATOR was the
        # shard's source: the broadcast below skips self, so the
        # 'cutover-commit' receive path never runs here (no-op when this
        # node recorded no freeze for the shard).
        self._stats.note_commit(
            key[0], key[1],
            pause_cap=self.server.rebalance_config.cutover_pause_max)
        self._stats.add("shards_cut_over")
        self._persist(job)
        self._broadcast_all({
            "type": "cutover-commit", "jobID": job.id,
            "index": key[0], "shard": key[1],
            "epoch": cluster.routing_epoch,
        })
        if all_done:
            self._complete(job)

    def shard_failed(self, msg: dict) -> None:
        job = self._job_for(msg)
        if job is None:
            return
        self.abort(
            f"node {msg.get('nodeID')} failed migrating "
            f"{msg.get('index')}/shard {msg.get('shard')}: "
            f"{msg.get('error')}"
        )

    def _job_for(self, msg: dict) -> Optional[RebalanceJob]:
        with self._lock:
            job = self.job
        if job is None or (msg.get("jobID") and msg["jobID"] != job.id):
            return None
        return job

    # ----------------------------------------------------- complete/abort

    def _complete(self, job: RebalanceJob) -> None:
        with self._lock:
            if self.job is not job:
                return
            self.job = None
            job.finalized = True
            self.revert_on_abort = False
        server = self.server
        cluster = server.cluster
        old_nodes = list(cluster.nodes)
        cluster.commit_topology(job.new_nodes)
        cluster.health.clear_copy_grace()
        live = {n.id for n in cluster.nodes}
        cluster.health.prune_absent(live)
        for nid in [k for k in server._probe_failures if k not in live]:
            del server._probe_failures[nid]
        server.topology.save(cluster.nodes)
        self._clear_state()
        self._stats.add("jobs_completed")
        msg = {
            "type": "rebalance-complete", "jobID": job.id,
            "attempt": job.attempt,
            "nodes": [n.to_dict() for n in job.new_nodes],
            "epoch": cluster.routing_epoch,
        }
        self._broadcast_all(msg, extra_nodes=old_nodes)
        # Post-cutover GC, epoch-guarded: the routing epoch advanced with
        # the commit, so a read forwarded under the old epoch 409s and
        # re-routes instead of reading the GC'd hole.
        from .topology import HolderCleaner

        removed = HolderCleaner(server).clean_holder()
        if removed:
            server.logger.info(
                "rebalance %s: holder cleaner removed %d fragments",
                job.id, len(removed))
        # Thaw fragments still frozen after the cleaner: with replicas>=2
        # the coordinator can be a migration SOURCE for a shard it keeps
        # owning as a replica — the cleaner keeps that fragment, and a
        # lingering _moved flag would leave it permanently write-dead.
        # (Followers do the same in _adopt_committed_topology.)
        thawed = server.migration_source.unfreeze(keep=())
        if thawed:
            server.logger.info(
                "rebalance %s: thawed %d frozen fragments", job.id, thawed)
        server.logger.info("rebalance job %s complete: %d nodes, epoch %d",
                           job.id, len(cluster.nodes), cluster.routing_epoch)

    def _complete_revert(self, job: RebalanceJob) -> None:
        """Reverse migration finished: every committed shard streamed
        back and flipped. Drop the overrides entirely (full revert to
        the prior topology), thaw everything, clear the checkpoint, and
        broadcast the same rebalance-abort-with-empty-committed the
        followers' full-revert path already handles."""
        with self._lock:
            if self.job is not job:
                return
            self.job = None
            job.finalized = True
            self.revert_on_abort = False
        server = self.server
        cluster = server.cluster
        server.rebalance_receiver.handle_abort(
            {"jobID": job.id, "committed": []})
        server.migration_source.abort_all()
        server.migration_source.unfreeze(keep=())
        cluster.abort_rebalance(committed=set())
        cluster.health.clear_copy_grace()
        self._clear_state()
        self._stats.add("jobs_reverted")
        self._broadcast_all({
            "type": "rebalance-abort", "jobID": job.id,
            "attempt": job.attempt,
            "reason": "reverse migration complete",
            "committed": [],
        }, extra_nodes=job.new_nodes)
        # Members drop fragments for shards they no longer own on the
        # restored topology (the forward copies on surviving members);
        # epoch-guarded like every post-routing-change GC.
        from .topology import HolderCleaner

        removed = HolderCleaner(server).clean_holder()
        if removed:
            server.logger.info(
                "revert %s: holder cleaner removed %d fragments",
                job.id, len(removed))
        server.logger.info(
            "rebalance job %s fully reverted: placement restored, epoch %d",
            job.id, cluster.routing_epoch)

    def abort(self, reason: str, revert: bool = False) -> None:
        """Abort the running job. With revert=False (operator default),
        committed cutovers keep their mixed routing and resume()
        finishes the job FORWARD. With revert=True (the autoscaler's
        contract: an aborted scale job must leave no trace), a reverse
        migration starts immediately after the abort settles, streaming
        committed shards back until the prior placement is fully
        restored."""
        with self._lock:
            job, self.job = self.job, None
            # An autoscale job's abort always reverts (no operator to
            # resume it forward); consult the flag under the lock so a
            # racing begin() can't re-arm it mid-abort.
            revert = revert or self.revert_on_abort
        if job is None:
            return
        server = self.server
        server.logger.error("rebalance job %s aborted: %s", job.id, reason)
        self._stats.add("jobs_aborted")
        if job.revert:
            # Aborting a revert job: per-shard reverse flips already
            # applied stand; what's left stays on the target owners
            # (mixed routing) and the revert checkpoint lets resume()
            # finish the restore.
            with job.lock:
                still = set(job.revert_remaining)
        else:
            still = set(job.committed)
        committed = sorted([list(k) for k in still])
        # The coordinator never receives its own broadcast: apply the
        # local side of the abort here too (it may be a source with
        # frozen fragments, and a receiver with parked streams).
        server.rebalance_receiver.handle_abort(
            {"jobID": job.id, "committed": committed})
        server.migration_source.abort_all()
        server.migration_source.unfreeze(keep=still)
        reverted = server.cluster.abort_rebalance(committed=still)
        server.cluster.health.clear_copy_grace()
        if reverted:
            job.finalized = True
            self._clear_state()
        else:
            # Cutovers already committed cannot be un-committed without a
            # reverse migration: keep the mixed routing AND the checkpoint
            # so resume() can finish the job (forward, or by completing
            # the revert).
            self._persist(job)
            server.logger.error(
                "rebalance job %s aborted after %d cutovers: mixed routing "
                "kept; resume() finishes the job %s",
                job.id, len(still),
                "revert" if job.revert or revert else "forward")
        self._broadcast_all({
            "type": "rebalance-abort", "jobID": job.id,
            "attempt": job.attempt, "reason": reason,
            "committed": committed,
        }, extra_nodes=job.new_nodes)
        if revert and not reverted and not job.revert:
            # Full-restore contract: stream every committed shard back.
            # Runs AFTER the abort broadcast so every node has settled
            # into the mixed-routing state the reverse job starts from.
            self.begin_revert(job.new_nodes, still,
                              attempt=job.attempt + 1)

    # ------------------------------------------------------------ helpers

    def _persist(self, job: RebalanceJob) -> None:
        path = self._state_path()
        if not path:
            return
        with self._persist_mu:
            if job.finalized:
                return
            with job.lock:
                state = {
                    "jobID": job.id,
                    "attempt": job.attempt,
                    "newNodes": [n.to_dict() for n in job.new_nodes],
                    "committed": sorted([list(k) for k in job.committed]),
                }
                if job.revert:
                    # A revert checkpoint records what still needs to
                    # flip BACK (shrinking), not what flipped forward:
                    # resume() re-reverts exactly the remainder.
                    state["revert"] = True
                    state["committed"] = sorted(
                        [list(k) for k in job.revert_remaining])
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            # pilint: allow-blocking(_persist_mu exists only to serialize this tiny checkpoint write; no query-path lock is held)
            os.replace(tmp, path)

    def _clear_state(self) -> None:
        path = self._state_path()
        if not path:
            return
        # Hold _persist_mu so an in-flight _persist finishes its write
        # BEFORE the remove (and any later one sees job.finalized): the
        # checkpoint cannot be resurrected after this returns.
        with self._persist_mu:
            if os.path.exists(path):
                try:
                    os.remove(path)
                except OSError:
                    pass

    def _node_uri(self, job: RebalanceJob, node_id: str) -> str:
        for n in list(self.server.cluster.nodes) + list(job.new_nodes):
            if n.id == node_id:
                return n.uri
        return node_id

    def _send(self, node_id: str, msg: dict) -> None:
        """Deliver a job message to one node (self-delivery dispatches
        through receive_message, which threads the heavy handlers)."""
        server = self.server
        if node_id == server.node.id:
            server.receive_message(msg)
            return
        job = self.job
        target = None
        pool = list(server.cluster.nodes)
        if job is not None:
            pool += list(job.new_nodes)
        for n in pool:
            if n.id == node_id:
                target = n
                break
        if target is None:
            raise PilosaError(f"unknown rebalance target node {node_id}")
        _retry_transport(lambda: server.client.send_message(target, msg))

    def _broadcast_all(self, msg: dict, extra_nodes=()) -> None:
        """Broadcast to the union of current members, the job's target
        membership, and `extra_nodes` — mid-job the joiner is not in
        cluster.nodes yet, and at completion the leaver already isn't."""
        from ..server.client import ClientError

        server = self.server
        seen = {server.node.id}
        job = self.job
        pool = list(server.cluster.nodes) + list(extra_nodes)
        if job is not None:
            pool += list(job.new_nodes)
        for node in pool:
            if node.id in seen:
                continue
            seen.add(node.id)
            try:
                _retry_transport(
                    lambda n=node: server.client.send_message(n, msg),
                    attempts=3)
            except (ClientError, PilosaError) as e:
                server.logger.error(
                    "rebalance broadcast %s to %s failed: %s",
                    msg.get("type"), node.id, e)
