"""GeoTailer: the follower side of a geo link.

One daemon thread round-robins the leader's indexes, long-polling
`GET /cdc/stream` per index through a durable checkpointed cursor and
applying each record through the idempotent anti-entropy merge path
(Api.apply_hint_ops -> Fragment.apply_hint_positions, WAL-durable).

Atomic cursor+state commit, without a transaction: records are applied
DURABLY first (the fragment WAL fsyncs per the [storage] policy), then
the cursor file is replaced (tmp + os.replace). A follower SIGKILL
between the two re-applies the window from the stale cursor on restart
— idempotent set/clear, so re-application converges to the same bytes.
That ordering (state before cursor, never the reverse) is the whole
loss-free contract; an advanced cursor over un-applied state would be a
silent gap.

Lag is derived from CDC positions + LEADER-stamped record times against
the leader-reported head time (X-Pilosa-Cdc-Head-Pos/-Time), plus the
follower-MONOTONIC time since the last successful leader contact.
Follower wall clocks never enter the formula, so cross-cluster clock
skew cannot fake freshness (a follower clock ahead of the leader's
would otherwise report negative lag and serve arbitrarily stale reads).

Per-link breaker: consecutive failures double the backoff from
geo.backoff up to geo.backoff-max; the first success resets it. A 410
(cursor behind retention, or index recreated under a new incarnation)
is not a failure — it routes to GET /cdc/bootstrap, which re-pulls
compressed base images, installs them wholesale (merge could not undo
clears between the stale cursor and the cut), and resumes from the
returned cut position; overlap re-applies idempotently.

Jax-free (pilint R2): stdlib + the holder's numpy-backed write path.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, Optional

from .. import failpoints
from ..cdc.log import decode_cdc_records
from ..server.client import ClientError

logger = logging.getLogger("pilosa.geo")

# Long-poll timeout per stream chunk: short enough that a multi-index
# follower round-robins fairly, long enough that a caught-up link parks
# leader-side and wakes on append instead of busy-polling.
POLL_TIMEOUT = 0.25
# Leader schema refresh cadence (new indexes/fields appear as links).
SCHEMA_INTERVAL = 2.0
MAX_BYTES = 4 << 20


class _Link:
    """Per-index tail state: durable cursor + breaker + lag anchors."""

    __slots__ = ("index", "pos", "incarnation", "applied_stamp",
                 "head_pos", "head_time", "contact", "failures",
                 "backoff", "next_attempt", "bootstraps", "records",
                 "cursor_path")

    def __init__(self, index: str, cursor_path: Optional[str]):
        self.index = index
        self.pos = 0                   # last applied+checkpointed position
        self.incarnation = None        # leader log incarnation at cursor
        self.applied_stamp = 0.0       # leader stamp of last applied record
        self.head_pos = None           # leader head at last contact
        self.head_time = 0.0           # leader wall clock at last contact
        self.contact = None            # follower MONOTONIC of last success
        self.failures = 0              # consecutive, resets on success
        self.backoff = 0.0
        self.next_attempt = 0.0        # monotonic gate while backing off
        self.bootstraps = 0
        self.records = 0
        self.cursor_path = cursor_path


class GeoTailer:
    def __init__(self, manager):
        self.manager = manager
        self.config = manager.config
        self.client = manager.client
        self.storage_config = manager.storage_config
        self.path = os.path.join(manager.path, "tail") if manager.path \
            else None
        self._mu = threading.Lock()
        self._links: Dict[str, _Link] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._schema_next = 0.0        # monotonic gate for schema refresh
        self._schema_backoff = 0.0
        self._last_contact = None      # monotonic of last ANY leader success
        self._probe_strikes = 0        # consecutive failed contacts
        self.counters: Dict[str, int] = {
            "polls": 0, "records_applied": 0, "bytes_applied": 0,
            "bootstraps": 0, "bootstrap_cleared": 0, "link_failures": 0,
            "apply_errors": 0, "checkpoints": 0, "schema_syncs": 0,
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = threading.Event()
            self._schema_next = 0.0
            self._thread = threading.Thread(
                target=self._run, name="geo-tail", daemon=True)
            self._thread.start()

    def pause(self, wait: bool = True) -> None:
        """Stop the tail loop. `wait=False` when called FROM the tail
        thread (probe-driven promotion) — the loop exits after the
        current sweep; a join would deadlock on ourselves."""
        self._stop.set()
        t = self._thread
        if wait and t is not None and t is not threading.current_thread():
            t.join(timeout=10)

    def resume(self) -> None:
        """Aborted promotion: back to tailing as if nothing happened."""
        self.start()

    def close(self) -> None:
        self.pause()

    def reset_links(self) -> None:
        """Demotion re-point: old cursors index the PREVIOUS leader's
        log, so wipe them (memory + disk). The re-tail replays the new
        leader's feed from position zero — idempotent over whatever
        this cluster already holds — or 410s into a bootstrap when the
        new leader has folded history. Caller must have paused the
        loop."""
        with self._mu:
            self._links.clear()
        if self.path and os.path.isdir(self.path):
            import shutil

            shutil.rmtree(self.path, ignore_errors=True)

    # ------------------------------------------------------------ the loop

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                did = self._sweep()
            except Exception:
                logger.exception("geo tail sweep failed")
                did = False
            if self._stop.is_set():
                return
            if not did:
                # Nothing ready (every link backing off, or idle): park
                # until the earliest gate instead of spinning.
                self._stop.wait(self._idle_delay())

    def _idle_delay(self) -> float:
        now = time.monotonic()
        gates = [self._schema_next]
        with self._mu:
            gates.extend(l.next_attempt for l in self._links.values())
        ahead = [g - now for g in gates if g > now]
        if not ahead:
            return 0.05
        return max(0.05, min(min(ahead), 1.0))

    def _sweep(self) -> bool:
        leader = self.manager.leader
        did = False
        now = time.monotonic()
        if now >= self._schema_next:
            did |= self._sync_schema(leader)
        with self._mu:
            links = list(self._links.values())
        for link in links:
            if self._stop.is_set():
                return did
            if time.monotonic() < link.next_attempt:
                continue
            did |= self._tail_link(leader, link)
        return did

    # ---------------------------------------------------------- schema sync

    def _sync_schema(self, leader: str) -> bool:
        try:
            schema = self.client.schema(leader)
        except Exception as e:
            logger.debug("geo schema sync against %r failed: %s", leader, e)
            self._contact_failed()
            self._schema_backoff = self._bump(self._schema_backoff)
            self._schema_next = time.monotonic() + self._schema_backoff
            return False
        self._contact_ok()
        self._schema_backoff = 0.0
        self._schema_next = time.monotonic() + SCHEMA_INTERVAL
        self.manager.server.api.apply_schema(schema)
        self.counters["schema_syncs"] += 1
        for info in schema:
            self._link(info["name"])
        live = {info["name"] for info in schema}
        with self._mu:
            # An index dropped on the leader stops being tailed; local
            # data stays (reads keep working) until an operator drops it.
            for name in [n for n in self._links if n not in live]:
                del self._links[name]
        return True

    def _link(self, index: str) -> _Link:
        with self._mu:
            link = self._links.get(index)
            if link is not None:
                return link
            cursor_path = None
            if self.path:
                d = os.path.join(self.path, index)
                os.makedirs(d, exist_ok=True)
                cursor_path = os.path.join(d, "cursor")
            link = _Link(index, cursor_path)
            self._load_cursor(link)
            self._links[index] = link
            return link

    # ------------------------------------------------------- cursor on disk

    def _load_cursor(self, link: _Link) -> None:
        if not link.cursor_path or not os.path.exists(link.cursor_path):
            return
        try:
            with open(link.cursor_path) as f:
                d = json.load(f)
            link.pos = int(d["pos"])
            link.incarnation = d.get("incarnation") or None
            link.applied_stamp = float(d.get("applied_stamp") or 0.0)
        except (OSError, ValueError, KeyError):
            # Unreadable cursor degrades to position 0: the first poll
            # either replays retained records idempotently or 410s into
            # a bootstrap. Slow, never wrong.
            link.pos = 0
            link.incarnation = None
            link.applied_stamp = 0.0

    def _checkpoint(self, link: _Link) -> None:
        """Persist the cursor AFTER its records are durably applied —
        the commit point of the atomic cursor+state contract (module
        docstring). Failure keeps the old cursor: idempotent re-apply,
        not data loss."""
        if not link.cursor_path:
            return
        tmp = link.cursor_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "pos": link.pos,
                    "incarnation": link.incarnation,
                    "applied_stamp": link.applied_stamp,
                }))
                if self.storage_config is None or \
                        self.storage_config.fsync != "never":
                    f.flush()
                    # pilint: allow-blocking(cursor checkpoint is ordered after the durable apply it acknowledges; a stale cursor only re-applies idempotent records)
                    os.fsync(f.fileno())
            os.replace(tmp, link.cursor_path)
            self.counters["checkpoints"] += 1
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # --------------------------------------------------------- link tailing

    def _tail_link(self, leader: str, link: _Link) -> bool:
        try:
            failpoints.fire("geo-tail", leader)
            self.counters["polls"] += 1
            data, headers = self.client.cdc_stream(
                leader, link.index, link.pos, incarnation=link.incarnation,
                timeout=POLL_TIMEOUT, max_bytes=MAX_BYTES)
        except ClientError as e:
            if e.status == 410:
                # Behind retention or recreated index: not a link
                # failure — the prescribed recovery is a base re-pull.
                return self._bootstrap_link(leader, link)
            if e.status == 404:
                # Index gone on the leader; the next schema sync prunes
                # the link. Back off meanwhile.
                self._link_failed(link)
                return False
            self._contact_failed()
            self._link_failed(link)
            return False
        except Exception as e:
            logger.debug("geo tail poll for index %r failed: %s",
                         link.index, e)
            self._contact_failed()
            self._link_failed(link)
            return False
        self._contact_ok()
        try:
            applied, touched = self._apply_chunk(link, data)
        except Exception:
            # Partial application is safe (cursor not advanced, replay
            # is idempotent) but back off: a poisoned record would
            # otherwise hot-loop.
            logger.exception("geo apply failed for index %r", link.index)
            self.counters["apply_errors"] += 1
            self._link_failed(link)
            return False
        nxt = headers.get("x-pilosa-cdc-next")
        link.pos = int(nxt) if nxt is not None else link.pos
        inc = headers.get("x-pilosa-cdc-incarnation")
        if inc:
            link.incarnation = inc
        if applied is not None:
            link.applied_stamp = applied.stamp
        head_pos = headers.get("x-pilosa-cdc-head-pos")
        head_time = headers.get("x-pilosa-cdc-head-time")
        if head_pos is not None:
            link.head_pos = int(head_pos)
        if head_time is not None:
            link.head_time = float(head_time)
        link.contact = time.monotonic()
        link.failures = 0
        link.backoff = 0.0
        link.next_attempt = 0.0
        # The docstring's 'applied DURABLY first' ordering: with
        # fsync=batch the chunk's WAL appends may still be page-cache-
        # only, and durably replacing the cursor over an unsynced WAL
        # tail is exactly the advanced-cursor-over-unapplied-state gap
        # the contract forbids. Force the touched WAL tails down first.
        self._sync_touched(touched)
        self._checkpoint(link)
        return bool(data)

    def _apply_chunk(self, link: _Link, data: bytes):
        api = self.manager.server.api
        last = None
        touched = set()
        for rec, _ in decode_cdc_records(data):
            failpoints.fire("geo-apply")
            api.apply_hint_ops(rec.index, rec.field, rec.view, rec.shard,
                               rec.ops)
            touched.add((rec.index, rec.field, rec.view, rec.shard))
            last = rec
            link.records += 1
            self.counters["records_applied"] += 1
        self.counters["bytes_applied"] += len(data)
        return last, touched

    def _sync_touched(self, touched) -> None:
        """fsync the WAL of every fragment a chunk touched, BEFORE the
        cursor checkpoint claims its positions. No-op under
        fsync=always (already synced per op) and fsync=never (the
        operator opted out of durability entirely)."""
        holder = self.manager.server.holder
        for index, field, view, shard in touched:
            frag = holder.fragment(index, field, view, shard)
            if frag is not None:
                frag.wal_sync()

    def _bootstrap_link(self, leader: str, link: _Link) -> bool:
        """410 recovery: install the leader's base images wholesale and
        resume the stream from the cut. Install REPLACES storage
        (migrate_install) rather than merging — a merge could not undo
        clears that happened between the stale cursor and the cut. All
        images install or the cursor stays put: advancing past a
        skipped fragment would silently lose its pre-cut history."""
        try:
            resp = self.client.cdc_bootstrap(leader, link.index)
        except Exception as e:
            logger.debug("geo bootstrap fetch for index %r failed: %s",
                         link.index, e)
            self._contact_failed()
            self._link_failed(link)
            return False
        self._contact_ok()
        holder = self.manager.server.holder
        try:
            for spec in resp.get("fragments", []):
                fld = holder.field(link.index, spec["field"])
                if fld is None:
                    raise KeyError(
                        f"field {link.index}/{spec['field']} not yet "
                        "synced locally")
                v = fld.create_view_if_not_exists(spec["view"])
                frag = v.create_fragment_if_not_exists(
                    spec["shard"], broadcast=False)
                raw = zlib.decompress(base64.b64decode(spec["data"]))
                frag.migrate_install(raw)
                frag.migrate_seal()
            self._clear_divergent(link.index, resp.get("fragments", []))
        except Exception:
            logger.exception("geo bootstrap install failed for index %r",
                             link.index)
            self.counters["apply_errors"] += 1
            self._link_failed(link)
            return False
        link.pos = int(resp["from"])
        link.incarnation = resp.get("incarnation") or None
        # The leader's clock at the cut anchors lag until the first
        # streamed record carries a fresher stamp.
        link.applied_stamp = float(resp.get("now") or 0.0)
        link.head_pos = None
        link.head_time = 0.0
        link.contact = time.monotonic()
        link.failures = 0
        link.backoff = 0.0
        link.next_attempt = 0.0
        link.bootstraps += 1
        self.counters["bootstraps"] += 1
        self._checkpoint(link)
        return True

    def _clear_divergent(self, index: str, specs) -> None:
        """Bootstrap is documented as REPLACING local state with the
        new leader's view — which must include local fragments the
        response does NOT carry: divergent writes a deposed leader
        accepted before the fence landed, or data since deleted on the
        new leader. Left alone, a demoted cluster would serve that
        divergent data forever. Install an empty base over each (the
        leader's view of a fragment it didn't ship IS empty); replay
        from the cut position reconverges anything live."""
        from ..storage.bitmap import Bitmap

        want = {(s["field"], s["view"], s["shard"]) for s in specs}
        holder = self.manager.server.holder
        idx = holder.index(index)
        if idx is None:
            return
        empty = Bitmap().to_bytes()
        for field in list(idx.fields.values()):
            for view in list(field.views.values()):
                for frag in list(view.fragments.values()):
                    if (frag.field, frag.view, frag.shard) in want:
                        continue
                    frag.migrate_install(empty)
                    frag.migrate_seal()
                    self.counters["bootstrap_cleared"] += 1
                    logger.info(
                        "geo bootstrap cleared divergent fragment "
                        "%s/%s/%s/%s (absent from leader bootstrap)",
                        index, frag.field, frag.view, frag.shard)

    # ------------------------------------------------------------- breakers

    def _bump(self, backoff: float) -> float:
        if backoff <= 0:
            return self.config.backoff
        return min(backoff * 2, self.config.backoff_max)

    def _link_failed(self, link: _Link) -> None:
        link.failures += 1
        link.backoff = self._bump(link.backoff)
        link.next_attempt = time.monotonic() + link.backoff
        self.counters["link_failures"] += 1

    def _contact_ok(self) -> None:
        self._last_contact = time.monotonic()
        self._probe_strikes = 0

    def _contact_failed(self) -> None:
        self._probe_strikes += 1
        if self.config.probe_promote and \
                self._probe_strikes >= self.config.probe_failures:
            self._probe_strikes = 0
            self.manager.probe_promote()

    # ------------------------------------------------------------------ lag

    def lag(self) -> float:
        """Current replication lag in seconds; inf before first contact.
        max over links of: (leader head time - leader stamp of last
        applied record, when behind the head) + follower-monotonic time
        since that link's last successful contact."""
        now = time.monotonic()
        with self._mu:
            links = list(self._links.values())
        if not links:
            if self._last_contact is None:
                return float("inf")
            return now - self._last_contact
        return max(self._link_lag(link, now) for link in links)

    def _link_lag(self, link: _Link, now: float) -> float:
        if link.contact is None:
            return float("inf")
        behind = 0.0
        if link.head_pos is not None and link.pos < link.head_pos:
            if link.applied_stamp <= 0:
                return float("inf")
            behind = max(0.0, link.head_time - link.applied_stamp)
        return behind + (now - link.contact)

    def position(self) -> Optional[int]:
        """Smallest applied cursor across links, for the 409 payload."""
        with self._mu:
            if not self._links:
                return None
            return min(l.pos for l in self._links.values())

    # ----------------------------------------------------------- inspection

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._mu:
            links = dict(self._links)
        lag = self.lag()
        out = {
            "lag": lag if lag != float("inf") else None,
            "links": {},
        }
        for name, link in sorted(links.items()):
            llag = self._link_lag(link, now)
            out["links"][name] = {
                "position": link.pos,
                "incarnation": link.incarnation,
                "headPosition": link.head_pos,
                "lag": llag if llag != float("inf") else None,
                "failures": link.failures,
                "backoff": link.backoff,
                "bootstraps": link.bootstraps,
                "records": link.records,
            }
        out.update(dict(self.counters))
        return out
