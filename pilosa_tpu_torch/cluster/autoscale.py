"""Trace-driven autoscaler: sustained load -> membership change, with
full revert on abort.

The control loop closes the multi-tenant QoS story (docs/rebalance.md,
docs/scheduler.md): the scheduler measures per-index traffic and the
trace recorder measures per-stage latency; this controller turns a
SUSTAINED excursion of those signals into a rebalance join (scale-out
from a standby pool) or leave (scale-in of a node it added earlier),
through the exact same coordinator path an operator join/leave takes —
there is no second resize mechanism to keep correct.

Design points:

- **Hysteresis, not thresholds.** A decision needs `window` consecutive
  samples on the same side of a watermark (every sample >= scale-out-qps
  to grow, every sample <= scale-in-qps to shrink), plus a `cooldown`
  since the last action. One hot scrape never moves data.
- **Single-flight.** step() is try-lock guarded: the monitor timer, a
  debug trigger, and a test driving the clock can overlap without ever
  running two control decisions concurrently (the hint-daemon pattern,
  cluster/hints.py).
- **Full revert.** Before acting the controller arms
  RebalanceCoordinator.revert_on_abort, so ANY abort of the job it
  started — operator abort, shard failure, lost instruction — escalates
  into the reverse migration (rebalance.py begin_revert): committed
  shards stream back to their prior owners and routing is restored
  byte-identically. An autoscale job either completes or leaves nothing.
- **Only takes back what it gave.** Scale-in removes the most recently
  autoscale-added node; nodes the operator placed are never touched, and
  `min-nodes`/`max-nodes` bound the membership either way. The added-node
  list is checkpointed to `.autoscale.json` so a restarted coordinator
  still knows what it owns.

jax-free (config.py imports AutoscaleConfig at CLI startup).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from .. import failpoints
from ..obs import activate, deactivate
from ..obs import record as obs_record
from .node import Node

STATE_FILE = ".autoscale.json"


@dataclass
class AutoscaleConfig:
    """[autoscale] knobs (TOML + PILOSA_TPU_AUTOSCALE_* env + CLI flags).
    See docs/rebalance.md for how they interact."""

    # Seconds between control steps; 0 disables the controller entirely
    # (no monitor thread is spawned — the [tier] prefetch-interval gating
    # pattern).
    interval: float = 0.0
    # Consecutive samples that must agree before a decision: every sample
    # in the window >= scale-out-qps grows the cluster, every sample
    # <= scale-in-qps shrinks it. Anything mixed is "hold".
    window: int = 3
    # High watermark: cluster-wide queries/sec (summed index_traffic
    # diffs) above which a sustained window triggers scale-out.
    scale_out_qps: float = 100.0
    # Low watermark for scale-in. Must sit strictly below scale-out-qps:
    # the dead band between them is what stops flapping.
    scale_in_qps: float = 10.0
    # Optional latency trigger: when > 0, a window in which the worst
    # per-stage p99 (trace recorder stage histograms) stays above this
    # ALSO counts as sustained-high, even below the qps watermark — a few
    # expensive tenants can saturate devices at low qps. 0 ignores
    # latency.
    p99_ms: float = 0.0
    # Seconds after any scale action before the next one may fire;
    # rebalance jobs also block decisions while in flight.
    cooldown: float = 300.0
    # Membership bounds. max-nodes 0 means "bounded by the standby pool".
    min_nodes: int = 1
    max_nodes: int = 0
    # Comma-separated URIs (host:port) of standby nodes: running servers
    # that are not cluster members. Scale-out admits the first standby
    # not already a member; empty disables scale-out.
    standby: str = ""

    def validate(self) -> "AutoscaleConfig":
        if self.interval < 0:
            raise ValueError("[autoscale] interval must be >= 0")
        if self.window < 1:
            raise ValueError("[autoscale] window must be >= 1")
        if self.scale_out_qps <= 0:
            raise ValueError("[autoscale] scale-out-qps must be > 0")
        if not 0 <= self.scale_in_qps < self.scale_out_qps:
            raise ValueError(
                "[autoscale] scale-in-qps must be in [0, scale-out-qps)")
        if self.p99_ms < 0:
            raise ValueError("[autoscale] p99-ms must be >= 0")
        if self.cooldown < 0:
            raise ValueError("[autoscale] cooldown must be >= 0")
        if self.min_nodes < 1:
            raise ValueError("[autoscale] min-nodes must be >= 1")
        if self.max_nodes and self.max_nodes < self.min_nodes:
            raise ValueError(
                "[autoscale] max-nodes must be 0 or >= min-nodes")
        return self

    def standby_uris(self) -> List[str]:
        return [u.strip() for u in self.standby.split(",") if u.strip()]


def _hist_p99(snap: dict) -> float:
    """p99 upper-bound estimate from a Histogram.snapshot() dict: the
    smallest bucket bound whose cumulative count covers 99% of samples
    (the observed max for the +Inf overflow bucket)."""
    total = snap.get("count", 0)
    if not total:
        return 0.0
    target = 0.99 * total
    seen = 0
    finite = sorted(
        ((float(k), n) for k, n in snap["buckets"].items() if k != "+Inf"),
        key=lambda kv: kv[0])
    for bound, n in finite:
        seen += n
        if seen >= target:
            return bound
    return float(snap.get("max") or 0.0)


class AutoscaleController:
    """One instance per server; step() runs on the server's monitor timer
    (server.py _spawn) and is safe to call directly from tests or a debug
    trigger."""

    def __init__(self, server, config: Optional[AutoscaleConfig] = None,
                 clock=time.monotonic):
        self.server = server
        self.config = (config or AutoscaleConfig()).validate()
        self.clock = clock
        self._flight = threading.Lock()  # single-flight step guard
        self._lock = threading.Lock()  # samples/counters/added
        self._samples: deque = deque(maxlen=max(1, self.config.window))
        self._last_total: Optional[int] = None
        self._last_time: Optional[float] = None
        self._last_action_at: Optional[float] = None
        self.last_decision = "idle"
        # Node ids this controller added (insertion order). Scale-in pops
        # from the tail; the operator's original membership is never
        # shrunk. Survives coordinator restarts via the checkpoint.
        self._added: List[str] = []
        self.counters: Dict[str, int] = {
            "steps": 0,
            "samples": 0,
            "scale_out": 0,
            "scale_in": 0,
            "skipped_inflight": 0,
            "skipped_cooldown": 0,
            "skipped_rebalancing": 0,
            "skipped_bounds": 0,
            "errors": 0,
        }
        self._load_state()

    # ------------------------------------------------------------ persist

    def _state_path(self) -> Optional[str]:
        if not self.server.data_dir:
            return None
        return os.path.join(self.server.data_dir, STATE_FILE)

    def _load_state(self) -> None:
        path = self._state_path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                state = json.load(f)
            self._added = [str(n) for n in state.get("added", [])]
        except (OSError, ValueError) as e:
            self.server.logger.error(
                "autoscale: unreadable checkpoint %s: %s", path, e)

    def _persist(self) -> None:
        path = self._state_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"added": list(self._added)}, f)
        # pilint: allow-blocking(_flight is a try-acquire single-flight busy flag — contenders skip instead of waiting, so nothing can queue behind this tiny checkpoint rename)
        os.replace(tmp, path)

    # ------------------------------------------------------------ sensing

    def _sample(self, now: float) -> Optional[dict]:
        """One observation: cluster-wide qps (index_traffic diff over the
        step interval) and the worst per-stage p99. The first call only
        seeds the traffic baseline."""
        total = sum(self.server.scheduler.index_traffic().values())
        last_total, last_time = self._last_total, self._last_time
        self._last_total, self._last_time = total, now
        if last_total is None or now <= (last_time or now):
            return None
        qps = max(0.0, total - last_total) / (now - last_time)
        p99 = 0.0
        if self.config.p99_ms > 0:
            hists = self.server.trace_recorder.stage_histograms()
            p99 = max(
                (_hist_p99(s) for s in hists.values()), default=0.0)
        return {"qps": qps, "p99_ms": p99}

    def _decide(self) -> str:
        """Pure hysteresis over the sample window; caller handles
        cooldown/bounds/in-flight gating."""
        cfg = self.config
        if len(self._samples) < cfg.window:
            return "hold"
        over = all(
            s["qps"] >= cfg.scale_out_qps
            or (cfg.p99_ms > 0 and s["p99_ms"] >= cfg.p99_ms)
            for s in self._samples)
        if over:
            return "out"
        under = all(
            s["qps"] <= cfg.scale_in_qps
            and (cfg.p99_ms == 0 or s["p99_ms"] < cfg.p99_ms)
            for s in self._samples)
        return "in" if under else "hold"

    # ------------------------------------------------------------- acting

    def _arm_revert(self):
        """Ensure the rebalance coordinator exists and arm its
        revert-on-abort contract for the job this action is about to
        start. Returns the coordinator (to disarm if no job began)."""
        from .rebalance import RebalanceCoordinator

        server = self.server
        if server.rebalance_coordinator is None:
            server.rebalance_coordinator = RebalanceCoordinator(server)
        server.rebalance_coordinator.revert_on_abort = True
        return server.rebalance_coordinator

    def _scale_out(self) -> bool:
        server = self.server
        cluster = server.cluster
        member_uris = {n.uri for n in cluster.nodes}
        uri = next((u for u in self.config.standby_uris()
                    if u not in member_uris), None)
        if uri is None:
            self.counters["skipped_bounds"] += 1
            return False
        try:
            # The standby is a RUNNING server that simply isn't a member:
            # ask it who it is rather than inventing an identity the
            # rebalance plane would then disagree with.
            # pilint: allow-blocking(_flight is a try-acquire single-flight busy flag — contenders skip instead of waiting, so the standby probe blocks nobody)
            status = server.client.status(uri)
            node = Node(id=status["localID"], uri=uri)
        except Exception as e:
            self.counters["errors"] += 1
            server.logger.error(
                "autoscale: standby %s unreachable: %s", uri, e)
            return False
        coord = self._arm_revert()
        server.logger.info(
            "autoscale: sustained load -> scale-out, admitting %s (%s)",
            node.id, uri)
        try:
            server.handle_node_join(node)
        except Exception as e:
            self.counters["errors"] += 1
            server.logger.error("autoscale: join of %s failed: %s",
                                node.id, e)
            coord.revert_on_abort = coord.job is not None
            return False
        with self._lock:
            if node.id not in self._added:
                self._added.append(node.id)
        self._persist()
        if coord.job is None:
            # Empty holder: the join was a plain status broadcast, no
            # rebalance job to guard — don't leave the flag armed for a
            # future operator job.
            coord.revert_on_abort = False
        self.counters["scale_out"] += 1
        return True

    def _scale_in(self) -> bool:
        server = self.server
        with self._lock:
            victim = self._added[-1] if self._added else None
        if victim is None or server.cluster.node_by_id(victim) is None:
            self.counters["skipped_bounds"] += 1
            return False
        coord = self._arm_revert()
        server.logger.info(
            "autoscale: sustained idle -> scale-in, removing %s", victim)
        try:
            server.handle_node_leave(victim)
        except Exception as e:
            self.counters["errors"] += 1
            server.logger.error("autoscale: leave of %s failed: %s",
                                victim, e)
            coord.revert_on_abort = coord.job is not None
            return False
        with self._lock:
            if victim in self._added:
                self._added.remove(victim)
        self._persist()
        if coord.job is None:
            coord.revert_on_abort = False
        self.counters["scale_in"] += 1
        return True

    # --------------------------------------------------------------- step

    def step(self) -> str:
        """One control iteration. Returns the decision taken:
        "out"/"in" (acted), "hold", or a skip reason."""
        if not self._flight.acquire(blocking=False):
            self.counters["skipped_inflight"] += 1
            return "skipped-inflight"
        try:
            return self._step_locked()
        finally:
            self._flight.release()

    def _step_locked(self) -> str:
        failpoints.fire("autoscale-step")
        server = self.server
        self.counters["steps"] += 1
        start = self.clock()
        sample = self._sample(start)
        decision = "seeding"
        if sample is not None:
            self.counters["samples"] += 1
            self._samples.append(sample)
            decision = self._decide()
        # The decision span lands in the trace ring + stage histograms
        # like any query stage; the controller runs outside any request,
        # so it opens its own one-span trace (sample-rate gated).
        t = server.trace_recorder.maybe_start(pql="autoscale")
        tok = activate(t) if t is not None else None
        try:
            obs_record(
                "autoscale.decide", (self.clock() - start) * 1000.0,
                decision=decision,
                qps=round(sample["qps"], 2) if sample else None)
        finally:
            if t is not None:
                deactivate(tok)
                server.trace_recorder.finish(t)
        # Non-coordinators (and offline-rebalance deployments) sample but
        # never act: a failover promotion inherits a warm window, and the
        # reverse-migration revert contract only exists on the online
        # rebalance path — never autoscale through the stop-the-world
        # resize.
        if not server.cluster.is_coordinator():
            return self._note("not-coordinator")
        if not server.rebalance_config.online:
            return self._note("offline-rebalance")
        if decision not in ("out", "in"):
            return self._note(decision)
        coord = server.rebalance_coordinator
        if coord is not None and coord.job is not None:
            self.counters["skipped_rebalancing"] += 1
            return self._note("skipped-rebalancing")
        now = self.clock()
        if (self._last_action_at is not None
                and now - self._last_action_at < self.config.cooldown):
            self.counters["skipped_cooldown"] += 1
            return self._note("skipped-cooldown")
        n = len(server.cluster.nodes)
        if decision == "out":
            cap = self.config.max_nodes
            if cap and n >= cap:
                self.counters["skipped_bounds"] += 1
                return self._note("skipped-bounds")
            acted = self._scale_out()
        else:
            if n <= self.config.min_nodes:
                self.counters["skipped_bounds"] += 1
                return self._note("skipped-bounds")
            acted = self._scale_in()
        if acted:
            self._last_action_at = now
            # A fresh mandate is required for the NEXT action: reuse of a
            # pre-action window would chain scale-outs off one burst.
            self._samples.clear()
            return self._note(decision)
        return self._note("hold")

    def _note(self, decision: str) -> str:
        self.last_decision = decision
        return decision

    # ------------------------------------------------------------ reading

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["added_nodes"] = list(self._added)
            out["window"] = [dict(s) for s in self._samples]
        out["last_decision"] = self.last_decision
        out["interval"] = self.config.interval
        out["scale_out_qps"] = self.config.scale_out_qps
        out["scale_in_qps"] = self.config.scale_in_qps
        out["cooldown"] = self.config.cooldown
        return out
