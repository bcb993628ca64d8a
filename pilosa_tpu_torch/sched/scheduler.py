"""Admission control: bounded queue, per-class concurrency, load shedding.

The per-process gate between the HTTP handler and the executor. Every
query (and bulk import) is admitted before it may touch the device:

  - a bounded WAITING queue per class — when a class's queue is full the
    request is shed immediately with 429 + Retry-After instead of piling
    another thread onto the compile gate / HBM contention;
  - per-class concurrency limits so import/sync traffic (large, latency
    tolerant) cannot starve interactive queries of executor slots, and
    vice versa — the classes fail independently;
  - wait bounded by the request's deadline: a query that spends its whole
    budget queued is rejected without ever dispatching device work.

All state is process-local (one scheduler per node); cross-node pressure
propagates naturally because a shed coordinator returns 429 upstream.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Tuple

from ..errors import PilosaError
from ..obs import record as obs_record
from .deadline import Deadline, DeadlineExceededError

CLASS_INTERACTIVE = "interactive"
CLASS_BATCH = "batch"


class QueueFullError(PilosaError):
    """Admission queue is full; the caller should retry after a backoff."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


@dataclass
class SchedulerConfig:
    # Bounded admission queue (waiters PER CLASS). 0 disables queueing
    # entirely: anything beyond the concurrency limits sheds.
    max_queue: int = 128
    # Per-class executor concurrency. <= 0 means unlimited for that class.
    interactive_concurrency: int = 8
    batch_concurrency: int = 2
    # Default per-request budget (seconds) when the client sends no
    # X-Pilosa-Deadline header. 0 = no deadline.
    default_deadline: float = 0.0
    # Base Retry-After (seconds) on 429 responses. The advertised value
    # scales with how full the class's queue is and carries +/-
    # retry-jitter, so a flood of shed clients does not retry in
    # lockstep and re-shed as one thundering herd.
    retry_after: float = 1.0
    # Retry-After jitter FRACTION in [0, 1] (0.2 = +/-20%), not a
    # percent — clamped at use so a percent-spelled value degrades to
    # full jitter instead of a negative wait.
    retry_jitter: float = 0.2
    # Micro-batch window bounds (seconds) — see batcher.py. The effective
    # window adapts to queue depth between these bounds; window_max = 0
    # disables coalescing.
    batch_window: float = 0.0005
    batch_window_max: float = 0.002
    # Max queries coalesced into one engine launch.
    batch_max: int = 64


class _Waiter:
    """One parked admission. Slots transfer DIRECTLY from a releaser to
    the queue head (granted flips under the scheduler lock before the
    event fires), so a timed-out waiter can tell a real grant from a
    timeout and hand an unwanted slot to the next in line."""

    __slots__ = ("event", "granted")

    def __init__(self):
        self.event = threading.Event()
        self.granted = False


class QueryScheduler:
    """Admission gate + stats surface. One per server process.

    Slot discipline: per-class slot counts with explicit FIFO waiter
    queues (not bare semaphores — semaphore wakeup order is unspecified
    and a free-slot fast path would let a new arrival barge past parked
    same-class waiters). Each class keeps TWO queues: in-budget and
    over-budget (tenant QoS, sched/qos.py) — a released slot always goes
    to the in-budget head first, so a dry tenant's waiters cannot occupy
    slots ahead of in-budget tenants, while FIFO order holds within each
    queue."""

    # index_traffic rows included in snapshot()/diagnostics: bounded so
    # /debug/vars payloads stop growing with schema churn.
    SNAPSHOT_TRAFFIC_TOP = 32

    def __init__(self, config: Optional[SchedulerConfig] = None, stats=None,
                 clock: Callable[[], float] = time.monotonic, qos=None,
                 rng: Optional[random.Random] = None):
        self.config = config or SchedulerConfig()
        self.stats = stats
        self.clock = clock
        # Tenant budget ledger (sched/qos.py TenantLedger) or None:
        # consulted at admission for the shed/defer verdict, charged the
        # up-front estimate on grant, settled on release.
        self.qos = qos
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._waiting = 0  # total waiters across classes (observability)
        self._waiting_by: Dict[str, int] = {}  # per-class: queue bound + pressure
        self._running: Dict[str, int] = {}
        # Forwarded (remote=True) sub-queries in flight: they bypass
        # admission (the coordinator already admitted the query; re-
        # admitting forms cross-node slot-wait cycles) but still count as
        # coalescing pressure so data nodes open the micro-batch window.
        self._remote_inflight = 0
        # Free slots per class (None = unlimited) + the per-(class,
        # over-budget?) waiter queues. Invariant: a class with free
        # slots has empty queues (releases grant directly).
        self._avail: Dict[str, Optional[int]] = {}
        self._wq: Dict[str, Tuple[Deque[_Waiter], Deque[_Waiter]]] = {}
        for cls, limit in (
            (CLASS_INTERACTIVE, self.config.interactive_concurrency),
            (CLASS_BATCH, self.config.batch_concurrency),
        ):
            self._avail[cls] = limit if limit > 0 else None
            self._wq[cls] = (deque(), deque())
            self._running[cls] = 0
            self._waiting_by[cls] = 0
        # Counters for /debug/vars (mirrors the engine's counters dict).
        self.counters: Dict[str, int] = {
            "admitted": 0, "shed": 0, "shed_tenant": 0,
            "deadline_exceeded": 0,
            "admitted_interactive": 0, "admitted_batch": 0,
            "deferred_over_budget": 0,
        }
        # Per-index query traffic — the tier manager's prefetch signal
        # (docs/tiered-storage.md): a demoted plane whose index is taking
        # queries RIGHT NOW is worth re-promoting before the next query
        # pays the miss. Monotonic counts; consumers diff between reads.
        # Bounded so a schema-churning tenant can't grow it without limit
        # (evicting the coldest entry only forgets history, never breaks
        # correctness — prefetch is advisory).
        self._index_traffic: Dict[str, int] = {}
        self._index_traffic_max = 1024

    # ---------------------------------------------------------- admission

    def queue_depth(self) -> int:
        with self._lock:
            return self._waiting

    def pressure(self, cls: Optional[str] = None) -> int:
        """Requests in flight (waiting + running) — the micro-batcher's
        signal for how long a dispatch is worth holding open: with <= 1 in
        flight there is nobody to coalesce with. `cls` restricts BOTH
        counts to one class; only coalescing-eligible traffic should open
        the window (queued or running imports must not add latency to a
        lone interactive query). Forwarded sub-queries count as
        interactive pressure: on a data node they ARE the concurrent
        count traffic worth coalescing, even though they skip admission."""
        with self._lock:
            if cls is not None:
                n = self._waiting_by.get(cls, 0) + self._running.get(cls, 0)
                if cls == CLASS_INTERACTIVE:
                    n += self._remote_inflight
                return n
            return (self._waiting + sum(self._running.values())
                    + self._remote_inflight)

    @contextmanager
    def track_remote(self):
        """Count a forwarded sub-query as in-flight pressure WITHOUT
        admission (no slot, no queue, never blocks, never sheds)."""
        with self._lock:
            self._remote_inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._remote_inflight -= 1

    def deadline_for(self, header_value: Optional[str]) -> Optional[Deadline]:
        """Request Deadline from its header + the configured default."""
        return Deadline.from_header(
            header_value, self.config.default_deadline, clock=self.clock
        )

    def _derived_retry_after(self, cls: str) -> float:
        """Retry-After scaled by how full the class's queue is, with
        jitter so shed clients don't retry in lockstep. Must hold _lock
        (reads _waiting_by). The jitter knob is a FRACTION; clamp it to
        [0, 1] so a percent-spelled config value (20 instead of 0.2)
        degrades to full +/-100% jitter instead of a negative wait."""
        base = max(0.0, self.config.retry_after)
        cap = max(1, self.config.max_queue)
        fullness = min(1.0, self._waiting_by.get(cls, 0) / cap)
        jitter = min(1.0, max(0.0, self.config.retry_jitter))
        retry = base * (1.0 + fullness) * (1.0 + self._rng.uniform(-jitter, jitter))
        return max(0.05, retry)

    def _grant_next_locked(self, cls: str) -> None:
        """Hand a freed slot to the next waiter (in-budget queue first),
        or bank it in _avail when nobody waits. Must hold _lock."""
        q_in, q_over = self._wq[cls]
        w = q_in.popleft() if q_in else (q_over.popleft() if q_over else None)
        if w is None:
            avail = self._avail[cls]
            if avail is not None:
                self._avail[cls] = avail + 1
            return
        w.granted = True
        w.event.set()

    @contextmanager
    def admit(self, cls: str = CLASS_INTERACTIVE,
              deadline: Optional[Deadline] = None,
              tenant: Optional[str] = None):
        """Admission gate. Raises QueueFullError (-> 429) when the waiting
        queue is full, TenantBudgetError (a QueueFullError) when the
        tenant's budget verdict says shed, DeadlineExceededError when the
        budget expires while queued. Holds a class concurrency slot for
        the body's duration; charges/settles the tenant's budget when a
        QoS ledger is wired."""
        if cls not in self._avail:
            cls = CLASS_INTERACTIVE
        start = self.clock()
        if deadline is not None and deadline.expired():
            self._note_deadline("admission")
        # Tenant budget verdict BEFORE taking a slot or queue space: a
        # shed must cost nothing, and an over-budget admit must park on
        # the over-budget queue (drained only after in-budget waiters).
        over_budget = False
        if self.qos is not None and tenant is not None:
            try:
                over_budget = self.qos.admission_verdict(tenant, cls)
            except QueueFullError:
                with self._lock:
                    self.counters["shed_tenant"] += 1
                if self.stats:
                    self.stats.count("SchedulerShedTenant", 1)
                raise
            if over_budget:
                with self._lock:
                    self.counters["deferred_over_budget"] += 1
        waiter: Optional[_Waiter] = None
        with self._lock:
            q_in, q_over = self._wq[cls]
            avail = self._avail[cls]
            # Fast path: a free slot AND no parked same-class waiters —
            # taking a slot past parked waiters would barge the FIFO.
            # (Invariant says queues are empty whenever avail > 0, but
            # the explicit check makes barging structurally impossible.)
            if (avail is None or avail > 0) and not q_in and not q_over:
                if avail is not None:
                    self._avail[cls] = avail - 1
            else:
                # Queue space is bounded PER CLASS: a batch-import flood
                # parking max_queue waiters must not eat the queue out
                # from under interactive queries (the classes fail
                # independently, queue included).
                if self._waiting_by[cls] >= max(0, self.config.max_queue):
                    self.counters["shed"] += 1
                    retry = self._derived_retry_after(cls)
                    if self.stats:
                        self.stats.count("SchedulerShed", 1)
                    raise QueueFullError(
                        f"admission queue full ({self._waiting_by[cls]} "
                        f"{cls} waiting); retry after {retry:.2f}s",
                        retry_after=retry,
                    )
                waiter = _Waiter()
                (q_over if over_budget else q_in).append(waiter)
                self._waiting += 1
                self._waiting_by[cls] += 1
                if self.stats:
                    self.stats.gauge("SchedulerQueueDepth", self._waiting)
        if waiter is not None:
            # The event wait runs on the REAL clock (an injected fake
            # clock cannot preempt a blocked thread); the deadline
            # bounds it so a saturated class rejects queued work at
            # its budget instead of parking threads forever.
            timeout = deadline.remaining() if deadline is not None else None
            granted = waiter.event.wait(timeout=timeout)
            with self._lock:
                self._waiting -= 1
                self._waiting_by[cls] -= 1
                if not granted:
                    if waiter.granted:
                        # Race: a release granted us between the wait
                        # timing out and taking the lock. We are giving
                        # up anyway — pass the slot on so it isn't lost.
                        self._grant_next_locked(cls)
                    else:
                        # Still parked: unlink so a later release can't
                        # grant a dead waiter.
                        q_in, q_over = self._wq[cls]
                        try:
                            (q_over if over_budget else q_in).remove(waiter)
                        except ValueError:
                            pass
            if not granted:
                self._note_deadline("admission wait")
        wait_ms = (self.clock() - start) * 1000.0
        # Admission wait as a trace stage (docs/observability.md): a slow
        # query that spent its time QUEUED shows it here, not as device
        # time. No-op (contextvar miss) when the query isn't traced.
        obs_record("sched.wait", wait_ms, cls=cls)
        with self._lock:
            self.counters["admitted"] += 1
            self.counters[f"admitted_{cls}"] += 1
            self._running[cls] += 1
        if self.stats:
            self.stats.histogram("SchedulerWaitMs", wait_ms)
            self.stats.count("SchedulerAdmitted", 1)
            self.stats.gauge(f"SchedulerRunning_{cls}", self._running[cls])
        estimate = 0.0
        if self.qos is not None and tenant is not None:
            estimate = self.qos.charge_estimate(tenant)
        try:
            yield
        finally:
            with self._lock:
                self._running[cls] -= 1
                self._grant_next_locked(cls)
            # Settle AFTER the slot is released: a qos-charge failpoint
            # raising here must not leak a concurrency slot.
            if self.qos is not None and tenant is not None:
                from .qos import measured_cost_ms

                self.qos.settle(tenant, estimate, measured_cost_ms())

    def _note_deadline(self, where: str) -> None:
        self.note_deadline_exceeded()
        err = DeadlineExceededError(f"query deadline exceeded at {where}")
        err.counted = True  # already in scheduler stats; API must not recount
        raise err

    def note_index(self, index: str) -> None:
        """Record one query against `index` (called by the API on every
        admitted or forwarded query). Eviction is by RECENCY (the dict is
        kept in last-touch order), not by count: a lifetime-count victim
        rule would perpetually evict newly-created busy indexes while
        idle-but-historically-hot ones squatted the table."""
        with self._lock:
            t = self._index_traffic
            n = t.pop(index, None)
            if n is None and len(t) >= self._index_traffic_max:
                t.pop(next(iter(t)), None)  # least recently touched
            t[index] = (n or 0) + 1

    def index_traffic(self) -> Dict[str, int]:
        """Snapshot of per-index query counts (monotonic; diff to rate)."""
        with self._lock:
            return dict(self._index_traffic)

    def note_deadline_exceeded(self) -> None:
        """Record an expiry detected downstream (executor map/reduce or the
        remote fan-out) so every abort is visible in scheduler stats."""
        with self._lock:
            self.counters["deadline_exceeded"] += 1
        if self.stats:
            self.stats.count("SchedulerDeadlineExceeded", 1)

    # -------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["queue_depth"] = self._waiting
            out["waiting"] = dict(self._waiting_by)
            out["running"] = dict(self._running)
            out["remote_inflight"] = self._remote_inflight
            # index_traffic is bounded to the top-N busiest indexes so
            # /debug/vars and diagnostics payloads stop growing with
            # schema churn; index_traffic() keeps the full table for the
            # tier prefetcher and the autoscaler.
            ranked = sorted(self._index_traffic.items(),
                            key=lambda kv: kv[1], reverse=True)
            out["index_traffic"] = dict(ranked[:self.SNAPSHOT_TRAFFIC_TOP])
            out["index_traffic_total"] = len(self._index_traffic)
        return out
