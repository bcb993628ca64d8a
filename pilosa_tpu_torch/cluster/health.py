"""Per-peer fault-tolerance state: circuit breakers, retry budget, hedging.

Replaces the binary ``Cluster.unavailable`` set with structured per-peer
health shared by the executor (routing, replica retries, hedged reads),
the member monitor (probe damping), the internal client, and the syncer.
Three mechanisms, modeled on the Finagle/Envoy outlier-ejection designs:

  circuit breaker   CLOSED -> OPEN after `breaker_failures` consecutive
                    transport failures; OPEN -> HALF_OPEN once an
                    exponentially-growing backoff elapses; exactly ONE
                    request is admitted as the half-open probe, and its
                    outcome decides re-close vs re-open (doubled backoff).
                    While OPEN, routing skips the peer entirely, so a
                    dead peer costs zero connect timeouts between probes.

  retry budget      a token bucket gating the executor's replica re-map:
                    each successful remote request refills `retry_refill`
                    tokens (capped at `retry_budget`), each re-mapped
                    shard batch spends one. During a brown-out the budget
                    drains and further retries fail cleanly instead of
                    amplifying load onto the surviving replicas.

  hedged reads      after a per-peer hedge delay (fixed, or the rolling
                    p99 of that peer's recent latencies) the same shard
                    batch is fired at a replica and the first good
                    response wins. Hedge volume is capped at
                    `hedge_max_fraction` of remote traffic.

Dependency-light on purpose (stdlib only): the executor and Cluster use
it without pulling in networking, and tests inject a fake clock.
"""

from __future__ import annotations

import threading
from collections import deque
from collections.abc import MutableSet
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

# Breaker states (names surface in /debug/vars and diagnostics).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclass
class ResilienceConfig:
    """The `[resilience]` config section (TOML + env + CLI, config.py)."""

    # Consecutive transport failures before the breaker opens. The default
    # of 1 preserves the reference's mark-dead-on-first-failure routing
    # (executor.go:1498-1508); raise it on lossy networks where a single
    # failed dial is weak evidence.
    breaker_failures: int = 1
    # OPEN -> HALF_OPEN delay: starts at `breaker_backoff` seconds and
    # doubles on every failed half-open probe, capped at the max.
    breaker_backoff: float = 1.0
    breaker_backoff_max: float = 30.0
    # A half-open probe that never reports (caller died mid-request) is
    # treated as failed after this long, so a lost probe cannot wedge the
    # breaker HALF_OPEN forever.
    probe_ttl: float = 60.0
    # Retry token bucket: capacity, and tokens refilled per successful
    # remote request. 0 capacity disables gating (unlimited retries).
    retry_budget: float = 10.0
    retry_refill: float = 0.1
    # Hedged remote reads: fixed delay in seconds, or 0 for the rolling
    # per-peer p99; volume capped at a fraction of remote requests
    # (0 disables hedging entirely).
    hedge_delay: float = 0.0
    hedge_max_fraction: float = 0.05
    # Floor/fallback for the adaptive delay: used while a peer has too few
    # latency samples for a meaningful p99, and as the minimum even after.
    hedge_min_delay: float = 0.02
    # Device-plane breakers (parallel/device_health.py, docs/
    # fault-tolerance.md). Consecutive engine-dispatch failures (any
    # signature) before the PLANE breaker opens and the engine demotes to
    # host execution; the OPEN -> HALF_OPEN backoff doubles per failed
    # probe like the peer breaker, capped at the max. `probe_ttl` above is
    # shared: a claimed device probe that never reports expires the same
    # way a lost peer probe does.
    device_breaker_failures: int = 3
    device_breaker_backoff: float = 2.0
    device_breaker_backoff_max: float = 60.0
    # Consecutive failures of ONE query signature's fused program before
    # that signature alone is quarantined to the per-shard XLA walk.
    device_sig_failures: int = 2
    device_sig_backoff: float = 10.0
    # Collective-plane breakers (parallel/device_health.py
    # CollectivePlaneHealth, docs/multichip.md): consecutive collective
    # failures — barrier timeouts, descriptor-broadcast losses — before
    # the plane (or one mesh slice) stops being offered queries and
    # full-index reads fall back to the HTTP fan-out instantly instead
    # of waiting out a barrier per query. OPEN -> HALF_OPEN doubles from
    # `collective-breaker-backoff` per failed probe, capped at the max;
    # `probe_ttl` above is shared.
    collective_breaker_failures: int = 2
    collective_breaker_backoff: float = 2.0
    collective_breaker_backoff_max: float = 60.0

    def validate(self) -> "ResilienceConfig":
        if self.breaker_failures < 1:
            raise ValueError("resilience.breaker-failures must be >= 1")
        if self.breaker_backoff <= 0:
            raise ValueError("resilience.breaker-backoff must be > 0")
        if self.breaker_backoff_max < self.breaker_backoff:
            raise ValueError(
                "resilience.breaker-backoff-max must be >= breaker-backoff")
        if not 0.0 <= self.hedge_max_fraction <= 1.0:
            raise ValueError(
                "resilience.hedge-max-fraction must be in [0, 1]")
        if self.retry_budget < 0 or self.retry_refill < 0:
            raise ValueError("resilience retry knobs must be >= 0")
        if self.device_breaker_failures < 1 or self.device_sig_failures < 1:
            raise ValueError(
                "resilience.device-breaker-failures / device-sig-failures "
                "must be >= 1")
        if self.device_breaker_backoff <= 0 or self.device_sig_backoff <= 0:
            raise ValueError("resilience device backoffs must be > 0")
        if self.device_breaker_backoff_max < self.device_breaker_backoff:
            raise ValueError(
                "resilience.device-breaker-backoff-max must be >= "
                "device-breaker-backoff")
        if self.collective_breaker_failures < 1:
            raise ValueError(
                "resilience.collective-breaker-failures must be >= 1")
        if self.collective_breaker_backoff <= 0:
            raise ValueError(
                "resilience.collective-breaker-backoff must be > 0")
        if self.collective_breaker_backoff_max < self.collective_breaker_backoff:
            raise ValueError(
                "resilience.collective-breaker-backoff-max must be >= "
                "collective-breaker-backoff")
        return self


# Rolling latency window per peer: enough samples for a stable p99
# without unbounded growth under heavy traffic.
_LATENCY_WINDOW = 128
# Minimum samples before the adaptive p99 is trusted over the floor.
_MIN_SAMPLES = 8


class _Peer:
    __slots__ = (
        "state", "consec_failures", "opened_at", "backoff", "probe_at",
        "latencies", "open_count",
    )

    def __init__(self):
        self.state = CLOSED
        self.consec_failures = 0
        self.opened_at = 0.0
        self.backoff = 0.0  # current OPEN -> HALF_OPEN delay
        self.probe_at = 0.0  # when the half-open probe was claimed
        self.latencies: deque = deque(maxlen=_LATENCY_WINDOW)
        self.open_count = 0


class HealthRegistry:
    """Thread-safe per-peer breaker/budget/latency state for one node's
    view of its cluster. `clock` is injectable for deterministic tests."""

    # A peer under migration copy load (cluster/rebalance.py participants)
    # gets this multiplier on breaker_failures before its breaker opens —
    # slow responses while streaming gigabytes are expected load, not
    # death, and marking a joining node dead mid-copy aborts the join.
    COPY_GRACE_MULT = 4
    COPY_GRACE_TTL = 600.0

    def __init__(self, config: Optional[ResilienceConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        import time

        self.config = config or ResilienceConfig()
        self.clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._peers: Dict[str, _Peer] = {}
        # node id -> grace deadline (clock units). Set by the rebalance
        # coordinator's begin broadcast, cleared at complete/abort; the
        # TTL bounds a lost clear.
        self._copy_grace: Dict[str, float] = {}
        # Retry token bucket (one bucket per node, not per peer: the thing
        # being protected is the SURVIVORS' aggregate load).
        self._retry_tokens = float(self.config.retry_budget)
        self.counters: Dict[str, int] = {
            "requests": 0,
            "breaker_opened": 0,
            "breaker_closed": 0,
            "breaker_short_circuits": 0,  # sends skipped while OPEN
            "half_open_probes": 0,
            "retries_spent": 0,
            "retries_denied": 0,
            "hedges_fired": 0,
            "hedges_won": 0,
            "hedges_suppressed": 0,
        }

    def configure(self, config: ResilienceConfig,
                  clock: Optional[Callable[[], float]] = None) -> None:
        """Install server config onto a registry built with defaults
        (Cluster constructs one eagerly so library use needs no wiring)."""
        with self._mu:
            self.config = config
            if clock is not None:
                self.clock = clock
            self._retry_tokens = float(config.retry_budget)

    def _peer(self, node_id: str) -> _Peer:
        p = self._peers.get(node_id)
        if p is None:
            p = self._peers[node_id] = _Peer()
        return p

    # ------------------------------------------------------------- breaker

    def is_down(self, node_id: str) -> bool:
        """True while the peer's breaker is not CLOSED. Routing excludes
        down peers; re-admission happens only through a half-open probe
        (allow_request) or an explicit force_up (member monitor)."""
        with self._mu:
            p = self._peers.get(node_id)
            return p is not None and p.state != CLOSED

    def down_ids(self) -> List[str]:
        with self._mu:
            return [nid for nid, p in self._peers.items() if p.state != CLOSED]

    def allow_request(self, node_id: str) -> bool:
        """Breaker gate for one outbound request to `node_id`.

        CLOSED -> True. OPEN with backoff elapsed -> atomically claims the
        HALF_OPEN probe slot and returns True (this request IS the probe);
        the caller must report the outcome via record_success /
        record_failure. OPEN within backoff, or HALF_OPEN with a live
        probe in flight -> False (skip, zero connect attempts)."""
        now = self.clock()
        with self._mu:
            p = self._peers.get(node_id)
            if p is None or p.state == CLOSED:
                return True
            if p.state == HALF_OPEN and now - p.probe_at > self.config.probe_ttl:
                # The claimed probe never reported: count it failed.
                self._reopen(p, now)
            if p.state == OPEN and now - p.opened_at >= p.backoff:
                p.state = HALF_OPEN
                p.probe_at = now
                self.counters["half_open_probes"] += 1
                return True
            self.counters["breaker_short_circuits"] += 1
            return False

    def probe_due(self, node_id: str) -> bool:
        """Like allow_request but WITHOUT claiming the probe slot: a
        side-effect-free check for inspection (tests, tooling). The
        member monitor deliberately does NOT gate its probes on this —
        its consecutive-failure streak feeds coordinator failover, which
        must keep counting while a dead coordinator's breaker backs off."""
        now = self.clock()
        with self._mu:
            p = self._peers.get(node_id)
            if p is None or p.state == CLOSED:
                return True
            if p.state == HALF_OPEN:
                return now - p.probe_at > self.config.probe_ttl
            return now - p.opened_at >= p.backoff

    def record_success(self, node_id: str,
                       latency: Optional[float] = None) -> None:
        """A request to the peer completed: close a half-open breaker,
        reset failure streaks, refill the retry budget, record latency."""
        with self._mu:
            self.counters["requests"] += 1
            p = self._peer(node_id)
            p.consec_failures = 0
            if p.state != CLOSED:
                p.state = CLOSED
                p.backoff = 0.0
                self.counters["breaker_closed"] += 1
            if latency is not None:
                p.latencies.append(latency)
            cap = float(self.config.retry_budget)
            if cap:
                self._retry_tokens = min(
                    cap, self._retry_tokens + self.config.retry_refill)

    def set_copy_grace(self, node_id: str,
                       ttl: Optional[float] = None) -> None:
        """Mark a peer as a live-migration participant: its breaker needs
        COPY_GRACE_MULT x the usual consecutive failures to open, and the
        member monitor damps its probe threshold the same way."""
        with self._mu:
            self._copy_grace[node_id] = self.clock() + (
                ttl if ttl is not None else self.COPY_GRACE_TTL)

    def clear_copy_grace(self, node_id: Optional[str] = None) -> None:
        with self._mu:
            if node_id is None:
                self._copy_grace.clear()
            else:
                self._copy_grace.pop(node_id, None)

    def in_copy_grace(self, node_id: str) -> bool:
        with self._mu:
            return self._grace_active(node_id)

    def _grace_active(self, node_id: str) -> bool:
        # Must hold _mu.
        deadline = self._copy_grace.get(node_id)
        if deadline is None:
            return False
        if self.clock() > deadline:
            del self._copy_grace[node_id]
            return False
        return True

    def record_failure(self, node_id: str) -> None:
        """A transport-level failure (connect/5xx/corrupt body) talking to
        the peer: advance the breaker. A failed half-open probe re-opens
        with doubled backoff; `breaker_failures` consecutive failures open
        a closed breaker (scaled up while the peer is under migration
        copy-load grace)."""
        now = self.clock()
        with self._mu:
            p = self._peer(node_id)
            p.consec_failures += 1
            threshold = self.config.breaker_failures
            if self._grace_active(node_id):
                threshold *= self.COPY_GRACE_MULT
            if p.state == HALF_OPEN:
                self._reopen(p, now)
            elif p.state == CLOSED and (
                p.consec_failures >= threshold
            ):
                p.state = OPEN
                p.opened_at = now
                p.backoff = self.config.breaker_backoff
                p.open_count += 1
                self.counters["breaker_opened"] += 1

    def _reopen(self, p: _Peer, now: float) -> None:
        # Must hold _mu. Failed half-open probe: back off harder.
        p.state = OPEN
        p.opened_at = now
        p.backoff = min(
            max(p.backoff, self.config.breaker_backoff) * 2,
            self.config.breaker_backoff_max,
        )
        p.open_count += 1
        self.counters["breaker_opened"] += 1

    def force_down(self, node_id: str) -> None:
        """Open the peer's breaker NOW (mark_unavailable compat: the
        member monitor or an operator declared it dead)."""
        now = self.clock()
        with self._mu:
            p = self._peer(node_id)
            if p.state == CLOSED:
                p.state = OPEN
                p.opened_at = now
                p.backoff = self.config.breaker_backoff
                p.open_count += 1
                self.counters["breaker_opened"] += 1
            elif p.state == HALF_OPEN:
                self._reopen(p, now)
            # Already OPEN: leave opened_at/backoff alone — re-marking a
            # known-dead peer must not postpone its next probe.

    def force_up(self, node_id: str) -> None:
        """Close the peer's breaker NOW (mark_available compat: a live
        /status probe is direct evidence of recovery)."""
        with self._mu:
            p = self._peers.get(node_id)
            if p is None:
                return
            p.consec_failures = 0
            if p.state != CLOSED:
                p.state = CLOSED
                p.backoff = 0.0
                self.counters["breaker_closed"] += 1

    def prune(self, node_id: str) -> None:
        """Drop all state for a removed node, so a later re-add with the
        same id starts with a clean slate."""
        with self._mu:
            self._peers.pop(node_id, None)
            self._copy_grace.pop(node_id, None)

    def prune_absent(self, live_ids) -> None:
        """Drop state for peers no longer in the membership (wholesale
        cluster-status replacement, resize completion)."""
        live = set(live_ids)
        with self._mu:
            for nid in [n for n in self._peers if n not in live]:
                del self._peers[nid]
            for nid in [n for n in self._copy_grace if n not in live]:
                del self._copy_grace[nid]

    # -------------------------------------------------------- retry budget

    def try_spend_retry(self) -> bool:
        """Spend one retry token. False means the budget is exhausted and
        the caller should fail cleanly instead of re-mapping onto
        survivors. A zero-capacity budget disables gating."""
        with self._mu:
            if not self.config.retry_budget:
                self.counters["retries_spent"] += 1
                return True
            if self._retry_tokens >= 1.0:
                self._retry_tokens -= 1.0
                self.counters["retries_spent"] += 1
                return True
            self.counters["retries_denied"] += 1
            return False

    def retry_tokens(self) -> float:
        with self._mu:
            return self._retry_tokens

    # ------------------------------------------------------------- hedging

    def hedge_enabled(self) -> bool:
        return self.config.hedge_max_fraction > 0.0

    def hedge_delay(self, node_id: str) -> float:
        """Seconds to wait on the primary before firing the hedge: the
        configured fixed delay, or the peer's rolling p99 (floored)."""
        if self.config.hedge_delay > 0:
            return self.config.hedge_delay
        with self._mu:
            p = self._peers.get(node_id)
            if p is None or len(p.latencies) < _MIN_SAMPLES:
                return self.config.hedge_min_delay
            ordered = sorted(p.latencies)
            p99 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]
        return max(p99, self.config.hedge_min_delay)

    def allow_hedge(self) -> bool:
        """Volume cap: hedges may be at most `hedge_max_fraction` of
        remote requests. Counts the hedge when allowed."""
        with self._mu:
            frac = self.config.hedge_max_fraction
            if frac <= 0.0:
                return False
            budget = frac * max(self.counters["requests"], 1)
            if self.counters["hedges_fired"] + 1 > max(budget, 1):
                self.counters["hedges_suppressed"] += 1
                return False
            self.counters["hedges_fired"] += 1
            return True

    def note_hedge_won(self) -> None:
        with self._mu:
            self.counters["hedges_won"] += 1

    # ---------------------------------------------------------- inspection

    def state(self, node_id: str) -> str:
        with self._mu:
            p = self._peers.get(node_id)
            return p.state if p is not None else CLOSED

    def snapshot(self) -> dict:
        """Counters + per-peer state for /debug/vars and diagnostics."""
        with self._mu:
            peers = {}
            for nid, p in self._peers.items():
                peers[nid] = {
                    "state": p.state,
                    "consecFailures": p.consec_failures,
                    "backoff": round(p.backoff, 3),
                    "openCount": p.open_count,
                    "latencySamples": len(p.latencies),
                }
            now = self.clock()
            return {
                "peers": peers,
                "retryTokens": round(self._retry_tokens, 2)
                if self.config.retry_budget else None,
                "copyGracePeers": sorted(
                    nid for nid, dl in self._copy_grace.items() if now <= dl
                ),
                **dict(self.counters),
            }


class DownView(MutableSet):
    """Set-like facade over the registry's breaker state, kept as
    ``Cluster.unavailable`` so every existing membership check, test, and
    the reference-shaped routing code keep working: `id in unavailable`
    means "breaker not closed", `add`/`discard` force the breaker."""

    def __init__(self, health: HealthRegistry):
        self._health = health

    def __contains__(self, node_id) -> bool:
        return self._health.is_down(node_id)

    def __iter__(self):
        return iter(self._health.down_ids())

    def __len__(self) -> int:
        return len(self._health.down_ids())

    def add(self, node_id) -> None:
        self._health.force_down(node_id)

    def discard(self, node_id) -> None:
        self._health.force_up(node_id)

    def __repr__(self) -> str:  # debugging aid
        return f"DownView({set(self._health.down_ids())!r})"
