"""GeoManager: role, fencing epoch, and the promotion state machine.

One per server when `[geo] role != "none"`. A follower owns a GeoTailer
(geo/tail.py); a leader just serves the CDC feed and accepts the demote
handshake after losing a fencing race.

The GEO EPOCH is the split-brain fence, reusing the routing-epoch
arithmetic from cluster/node.py (`Cluster._advance_epoch`): a local
promotion bumps it by one, an authoritative epoch from a demote
handshake max-merges in. Both clusters persist (role, epoch, leader)
atomically (tmp + os.replace) BEFORE acting on a transition, so the
fence survives either side's crash:

    promote   follower only. Stop the tail, fire `geo-promote`, persist
              (role=leader, epoch+1), THEN flip in-memory state and
              start the fence thread toward the old leader. Any failure
              before the persist fully reverts (resume tailing, nothing
              durable changed) — an aborted promotion leaves no trace.

    fence     the new leader POSTs /geo/demote {leader, epoch} to the
              deposed leader until one succeeds. Until it lands, the
              deposed leader (if alive) still accepts writes — under
              the OLD epoch, so no write is ever accepted by two
              clusters under the same epoch; the chaos test pins this.

    demote    leader side of the handshake. A presented epoch <= our
              own is refused with StaleGeoEpochError (409): that's a
              stale or duplicate fence, not authority. A higher epoch
              max-merges in; we persist role=follower, wipe tail
              cursors (positions are meaningless against the new
              leader's log; the incarnation mismatch would 410 anyway,
              wiping makes the re-bootstrap deterministic), and re-tail
              the new leader. Our divergent writes are NOT merged out —
              the bootstrap installs the new leader's base images
              wholesale, which is exactly the no-split-brain contract.

    check_write  every external write lands here first. Followers
              refuse with StaleGeoEpochError (409) pointing at the
              leader; a leader tallies the accepting epoch
              (write_epochs) — the bench's fencing evidence.

Jax-free (pilint R2).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, Optional

from .. import failpoints
from ..errors import PilosaError, StaleGeoEpochError
from ..server.client import ClientError
from .tail import GeoTailer

logger = logging.getLogger("pilosa.geo")

FENCE_RETRY = 2.0


class GeoManager:
    def __init__(self, server, config, path: Optional[str],
                 storage_config=None, client=None):
        self.server = server
        self.config = config
        self.path = path  # <data-dir>/geo; None = memory-only (tests)
        self.storage_config = storage_config
        # Dedicated client: tail long-polls must not contend with the
        # executor's fan-out pool, and need their own timeout headroom.
        self.client = client
        self._mu = threading.RLock()
        self.role = config.role
        self.leader = config.leader
        self.epoch = 0
        self._fence_target: Optional[str] = None
        self._fence_thread: Optional[threading.Thread] = None
        self._fence_stop = threading.Event()
        self.write_epochs: Dict[int, int] = {}
        self.counters: Dict[str, int] = {
            "promotions": 0, "promote_aborts": 0, "probe_promotions": 0,
            "demotions": 0, "demotions_refused": 0, "writes_refused": 0,
            "fence_attempts": 0, "fence_acks": 0,
        }
        self._load_state()  # persisted role/epoch override config.role
        self.tailer = GeoTailer(self)
        self.closed = False

    # ----------------------------------------------------------- persistence

    def _state_path(self) -> Optional[str]:
        return os.path.join(self.path, "state") if self.path else None

    def _load_state(self) -> None:
        p = self._state_path()
        if not p or not os.path.exists(p):
            return
        try:
            with open(p) as f:
                d = json.load(f)
            # A promoted follower restarts as the leader it became; the
            # config's static role only seeds the very first boot.
            self.role = d.get("role") or self.role
            self.epoch = int(d.get("epoch") or 0)
            self.leader = d.get("leader") if d.get("leader") is not None \
                else self.leader
            self._fence_target = d.get("fence") or None
        except (OSError, ValueError):
            logger.exception("geo state unreadable; using config role")

    def _persist(self) -> None:
        """Atomic (role, epoch, leader, fence) commit — the durable
        point of every transition. Raises on failure so promote/demote
        revert instead of running with a fence no restart remembers."""
        p = self._state_path()
        if not p:
            return
        os.makedirs(self.path, exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "role": self.role, "epoch": self.epoch,
                "leader": self.leader, "fence": self._fence_target,
            }))
            if self.storage_config is None or \
                    self.storage_config.fsync != "never":
                f.flush()
                # pilint: allow-blocking(the fencing epoch must hit disk before either cluster acts on it; a forgotten epoch reopens split-brain)
                os.fsync(f.fileno())
        os.replace(tmp, p)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.role == "follower":
            self.tailer.start()
        elif self.role == "leader" and self._fence_target:
            # Promotion persisted but the fence never landed before a
            # restart: keep pushing the demote at the deposed leader.
            self._start_fence()

    def close(self) -> None:
        with self._mu:
            if self.closed:
                return
            self.closed = True
        self._fence_stop.set()
        self.tailer.close()
        t = self._fence_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        if self.client is not None and hasattr(self.client, "close"):
            self.client.close()

    # ------------------------------------------------------------- promotion

    def promote(self, reason: str = "operator") -> dict:
        """Follower -> leader under a bumped fencing epoch. Idempotent
        for an already-promoted leader; any failure before the durable
        commit fully reverts to tailing."""
        with self._mu:
            if self.closed:
                raise PilosaError("geo manager is closed")
            if self.role == "leader":
                return self.status()
            if self.role != "follower":
                raise PilosaError(
                    f"promotion requires the follower role; this cluster "
                    f"is {self.role!r}")
        # Stop tailing first (OUTSIDE _mu: pause joins the tail thread,
        # which itself takes _mu via probe_promote): a promotion must
        # not race the tail thread applying one more leader chunk after
        # the flip. wait=False from the tail thread itself.
        from_tail = threading.current_thread() is self.tailer._thread
        self.tailer.pause(wait=not from_tail)
        with self._mu:
            if self.closed:
                raise PilosaError("geo manager is closed")
            if self.role == "leader":  # lost a promote race: idempotent
                return self.status()
            old_leader = self.leader
            prev_role, prev_epoch = self.role, self.epoch
            try:
                failpoints.fire("geo-promote")
                self.role = "leader"
                self.epoch = prev_epoch + 1  # the fence: local bump
                self._fence_target = old_leader
                # pilint: allow-blocking(the epoch bump must be durable before any write is accepted under it)
                self._persist()
            except BaseException:
                # Aborted promotion fully reverts: nothing was
                # persisted (persist is the last, atomic step), so
                # in-memory state rolls back and tailing resumes.
                self.role, self.epoch = prev_role, prev_epoch
                self._fence_target = None
                self.counters["promote_aborts"] += 1
                if not self.closed:
                    self.tailer.resume()
                raise
            self.counters["promotions"] += 1
            if reason == "probe":
                self.counters["probe_promotions"] += 1
            logger.warning(
                "geo promotion (%s): now leader under epoch %d; fencing %r",
                reason, self.epoch, old_leader)
        self._start_fence()
        return self.status()

    def probe_promote(self) -> None:
        """Tail-thread entry: the configured number of consecutive
        leader contacts failed. Best-effort — a lost race with an
        operator promote is fine."""
        try:
            self.promote(reason="probe")
        except PilosaError:
            pass
        except Exception:
            logger.exception("probe-driven promotion failed")

    def _start_fence(self) -> None:
        with self._mu:
            if self._fence_target is None or self.closed:
                return
            if self._fence_thread is not None and \
                    self._fence_thread.is_alive():
                return
            self._fence_stop = threading.Event()
            self._fence_thread = threading.Thread(
                target=self._fence_run, name="geo-fence", daemon=True)
            self._fence_thread.start()

    def _fence_run(self) -> None:
        """Push POST /geo/demote at the deposed leader until it takes.
        It may be dead for hours — that's the normal promotion case —
        so this retries forever (persisted, resumes across restarts)."""
        while not self._fence_stop.is_set():
            with self._mu:
                target = self._fence_target
                epoch = self.epoch
                me = self.server.node.uri
            if target is None:
                return
            self.counters["fence_attempts"] += 1
            try:
                self.client.geo_demote(target, leader=me, epoch=epoch)
            except ClientError as e:
                if e.status == 409:
                    # The deposed leader claims a HIGHER epoch: we lost
                    # a promotion race somewhere. Stop fencing; the
                    # winner's fence will reach us too.
                    logger.error(
                        "geo fence refused by %r (it holds a higher "
                        "epoch than %d); standing down the fence", target,
                        epoch)
                    with self._mu:
                        self._fence_target = None
                        try:
                            # pilint: allow-blocking(standing down must be durable or a restart would resume a fence that already lost its race)
                            self._persist()
                        except OSError:
                            logger.exception("geo state persist failed")
                    return
                self._fence_stop.wait(FENCE_RETRY)
                continue
            except Exception as e:
                logger.debug("geo fence attempt against %r failed: %s",
                             target, e)
                self._fence_stop.wait(FENCE_RETRY)
                continue
            with self._mu:
                self.counters["fence_acks"] += 1
                self._fence_target = None
                try:
                    # pilint: allow-blocking(the fence-done state must be durable before the retry loop exits; a lost ack only re-sends an idempotent demote)
                    self._persist()
                except OSError:
                    logger.exception("geo state persist failed")
            logger.warning("geo fence acknowledged by %r", target)
            return

    # -------------------------------------------------------------- demotion

    def demote(self, leader: str, epoch: int) -> dict:
        """The deposed-leader side of the fencing handshake (also valid
        on a follower: it just re-points the tail). Refuses any epoch
        at or below our own — authority flows only forward."""
        with self._mu:
            if self.closed:
                raise PilosaError("geo manager is closed")
            if epoch <= self.epoch:
                self.counters["demotions_refused"] += 1
                raise StaleGeoEpochError(
                    f"demote presented epoch {epoch} but this cluster is "
                    f"already fenced at epoch {self.epoch}",
                    epoch=epoch, current=self.epoch)
        # Joins happen OUTSIDE _mu (same deadlock shape as promote).
        self.tailer.pause()
        resume = False
        try:
            with self._mu:
                if self.closed:
                    raise PilosaError("geo manager is closed")
                if epoch <= self.epoch:  # fenced further while unlocked
                    self.counters["demotions_refused"] += 1
                    raise StaleGeoEpochError(
                        f"demote presented epoch {epoch} but this cluster "
                        f"is already fenced at epoch {self.epoch}",
                        epoch=epoch, current=self.epoch)
                was = self.role
                self.role = "follower"
                self.epoch = int(epoch)  # authoritative merge (epoch > ours)
                self.leader = leader
                self._fence_target = None
                self._fence_stop.set()
                # pilint: allow-blocking(the demotion must be durable before this cluster refuses writes it would have accepted)
                self._persist()
                self.tailer.reset_links()
                self.counters["demotions"] += 1
                resume = True
                logger.warning(
                    "geo demotion: %s -> follower of %r under epoch %d",
                    was, leader, self.epoch)
        finally:
            # On refusal, a follower goes back to tailing its current
            # leader as if the stale demote never arrived.
            with self._mu:
                if not self.closed and self.role == "follower" \
                        and self.leader:
                    resume = True
            if resume:
                self.tailer.resume()
        return self.status()

    # ------------------------------------------------------------ write gate

    def check_write(self) -> None:
        """Every external write funnels through here before touching a
        fragment. Cheap on the leader: one lock, one dict bump."""
        with self._mu:
            if self.role == "follower":
                self.counters["writes_refused"] += 1
                raise StaleGeoEpochError(
                    f"this cluster is a geo follower of {self.leader!r} "
                    f"(geo epoch {self.epoch}); writes go to the leader",
                    current=self.epoch)
            # Fencing evidence: which epoch accepted this write. Two
            # clusters can never tally the same epoch — the deposed
            # leader only ever accepts under its old one.
            self.write_epochs[self.epoch] = \
                self.write_epochs.get(self.epoch, 0) + 1

    # -------------------------------------------------------------- staleness

    def check_staleness(self, bound: float) -> None:
        """Read-path gate for X-Pilosa-Max-Staleness (executor entry).
        Leaders always pass: local state IS the source of truth."""
        with self._mu:
            if self.role != "follower":
                return
        lag = self.tailer.lag()
        if lag <= bound:
            return
        from ..errors import StaleReadError

        raise StaleReadError(
            f"replication lag {'inf' if lag == float('inf') else f'{lag:.3f}s'} "
            f"exceeds the requested staleness bound {bound:.3f}s",
            lag=lag, bound=bound, position=self.tailer.position())

    def lag(self) -> float:
        return self.tailer.lag()

    # ------------------------------------------------------------ inspection

    def status(self) -> dict:
        with self._mu:
            out = {
                "role": self.role,
                "epoch": self.epoch,
                "leader": self.leader or None,
                "fencing": self._fence_target,
                "writeEpochs": {str(k): v for k, v in
                                sorted(self.write_epochs.items())},
            }
        if out["role"] == "follower":
            lag = self.tailer.lag()
            out["lag"] = lag if lag != float("inf") else None
        return out

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self.counters)

    def debug_vars(self) -> dict:
        out = self.status()
        out["tail"] = self.tailer.snapshot()
        out.update(self.snapshot())
        return out
