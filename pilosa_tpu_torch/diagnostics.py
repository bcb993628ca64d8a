"""Anonymized diagnostics collector (port of reference diagnostics.go).

Gathers non-sensitive deployment stats (version, uptime, schema shape,
cluster size, host info) and periodically POSTs them to a configurable
endpoint. Disabled by default (interval 0 / empty endpoint) — the
reference's hourly phone-home to diagnostics.pilosa.com becomes opt-in.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Dict, Optional

from . import __version__
from .sysinfo import system_info


def _sibling_version_url(endpoint: str) -> str:
    """The reference's version URL is a *sibling* of the diagnostics endpoint
    (.../v0/diagnostics vs .../v0/version — diagnostics.go defaultVersionCheckURL),
    not a child: replace the last *path* segment with 'version'. Only the URL
    path is rewritten — a pathless endpoint gets '/version' appended."""
    if not endpoint:
        return ""
    from urllib.parse import urlsplit, urlunsplit

    parts = urlsplit(endpoint)
    path = parts.path.rstrip("/")
    head, _, _ = path.rpartition("/")
    return urlunsplit(parts._replace(path=head + "/version"))


class DiagnosticsCollector:
    def __init__(self, server, endpoint: str = "", interval: float = 0.0, logger=None,
                 version_url: str = ""):
        self.server = server
        self.endpoint = endpoint
        self.interval = interval
        self.logger = logger
        self.version_url = version_url or _sibling_version_url(endpoint)
        self.start_time = time.time()
        self._extra: Dict[str, object] = {}
        self.last_report: Optional[dict] = None

    def set(self, key: str, value) -> None:
        self._extra[key] = value

    def gather(self) -> dict:
        holder = self.server.holder
        num_fields = sum(len(i.fields) for i in holder.indexes.values())
        num_frags = sum(
            len(v.fragments)
            for i in holder.indexes.values()
            for f in i.fields.values()
            for v in f.views.values()
        )
        quarantined = holder.quarantined_fragments() if hasattr(
            holder, "quarantined_fragments") else []
        info = {
            "version": __version__,
            "uptime": int(time.time() - self.start_time),
            "numIndexes": len(holder.indexes),
            "numFields": num_fields,
            "numFragments": num_frags,
            # Fragments serving degraded after their file failed validation
            # at open (awaiting anti-entropy repair): a nonzero count means
            # query results may silently miss this node's share of data.
            "numQuarantinedFragments": len(quarantined),
            "clusterNodes": len(self.server.cluster.nodes),
            "clusterState": self.server.cluster.state,
            "nodeID": self.server.cluster.node.id,
        }
        # Scheduler shape (non-sensitive aggregates): shed/admit totals say
        # whether a deployment is sized right for its load.
        scheduler = getattr(self.server, "scheduler", None)
        if scheduler is not None:
            snap = scheduler.snapshot()
            info["schedAdmitted"] = snap.get("admitted", 0)
            info["schedShed"] = snap.get("shed", 0)
            info["schedDeadlineExceeded"] = snap.get("deadline_exceeded", 0)
        batcher = getattr(self.server, "batcher", None)
        if batcher is not None:
            snap = batcher.snapshot()
            info["schedBatchLaunches"] = snap.get("launches", 0)
            info["schedBatchCoalesced"] = snap.get("coalesced", 0)
        # Multi-tenant QoS shape (docs/scheduler.md "Tenant budgets"):
        # whether budgets are on, how many tenants the ledger tracks, and
        # the charge/shed/defer totals — whether multi-tenant isolation
        # is actively working (per-tenant detail stays in /debug/vars).
        qos = getattr(self.server, "qos", None)
        if qos is not None:
            snap = qos.snapshot()
            info["qosEnabled"] = snap.get("enabled", False)
            info["qosTenants"] = snap.get("tenants", 0)
            info["qosCharged"] = snap.get("charged", 0)
            info["qosShedBatch"] = snap.get("shed_batch", 0)
            info["qosShedInteractive"] = snap.get("shed_interactive", 0)
            info["qosDeferred"] = snap.get("deferred", 0)
        # Autoscaler shape (docs/rebalance.md "Autoscaling"): how often
        # the controller acted and what it last decided — whether the
        # cluster is sizing itself (window/sample detail stays in
        # /debug/vars).
        autoscaler = getattr(self.server, "autoscaler", None)
        if autoscaler is not None:
            snap = autoscaler.snapshot()
            info["autoscaleSteps"] = snap.get("steps", 0)
            info["autoscaleScaleOut"] = snap.get("scale_out", 0)
            info["autoscaleScaleIn"] = snap.get("scale_in", 0)
            info["autoscaleLastDecision"] = snap.get("last_decision")
            info["autoscaleAddedNodes"] = len(snap.get("added_nodes", []))
        # Query-plan compiler shape (docs/query-compiler.md): cache hits
        # dwarfing builds means the per-query canonical lowering is being
        # reused across dispatch sites; reorders/flattens nonzero means
        # canonicalization is actively collapsing respelled query shapes
        # onto shared compiled programs.
        from .plan import snapshot as _plan_snapshot

        snap = _plan_snapshot()
        info["planBuilds"] = snap.get("plan_builds", 0)
        info["planCacheHits"] = snap.get("plan_cache_hits", 0)
        info["planReorders"] = snap.get("plan_reorders", 0)
        info["planFlattens"] = snap.get("plan_flattens", 0)
        # Delta-refresh health under mixed read/write traffic: a deployment
        # whose deltaBytes stays tiny next to fullRefreshBytes is keeping
        # its HBM caches warm through writes; the inverse means writes are
        # forcing full plane re-uploads (journal overflow / bulk ingest).
        # Peek the lazy engine slot only — gathering diagnostics must never
        # be what first opens the device backend.
        engine = getattr(getattr(self.server, "executor", None), "_engine", None)
        if engine is not None:
            # Locked snapshot, not a live dict read — same rule the
            # /debug/vars handler follows (engine counters mutate under
            # the engine lock on the serving path).
            c = engine.snapshot()
            info["engineLeafDeltaHits"] = c.get("leaf_delta_hits", 0)
            info["engineStackDeltaHits"] = c.get("stack_delta_hits", 0)
            info["engineDeltaBytes"] = c.get("delta_bytes", 0)
            info["engineFullRefreshBytes"] = c.get("full_refresh_bytes", 0)
            # Tiered-storage shape: HBM misses answered by the compressed
            # host/disk tiers vs full cold regathers, and how the
            # predictive prefetch is doing. tierPromotions ≫ leafMisses
            # means HBM pressure is being absorbed by the tiers.
            info["engineLeafTierHits"] = c.get("leaf_tier_hits", 0)
            info["engineLeafMisses"] = c.get("leaf_misses", 0)
            # Device-plane fault shape: how often dispatches failed (and
            # how they classified), whether the plane breaker ever opened,
            # and how much serving came off the host ladder — the
            # aggregate story of how healthy this node's accelerator is
            # (per-signature detail stays in /debug/vars device_plane).
            dp = engine.device_health.snapshot()
            info["deviceDispatchFailures"] = dp.get("dispatch_failures", 0)
            info["deviceFailuresOom"] = dp.get("failures_oom", 0)
            info["devicePlaneOpened"] = dp.get("plane_opened", 0)
            info["devicePlaneState"] = dp.get("plane_state")
            info["deviceSigQuarantined"] = dp.get("sig_quarantined", 0)
            info["deviceHostCounts"] = c.get("host_counts", 0)
            info["deviceHostColdCounts"] = c.get("host_cold_counts", 0)
            info["deviceOomBackpressure"] = c.get("oom_backpressure", 0)
            info["deviceWatchdogTimeouts"] = c.get("watchdog_timeouts", 0)
            if engine.tier is not None:
                snap = engine.tier.snapshot()
                info["tierHostBytes"] = snap.get("host_bytes", 0)
                info["tierHostEntries"] = snap.get("host_entries", 0)
                info["tierDiskBytes"] = snap.get("disk_bytes", 0)
                info["tierDemotions"] = (snap.get("demotions_host", 0)
                                         + snap.get("demotions_disk", 0))
                info["tierPromotions"] = (snap.get("promotions_host", 0)
                                          + snap.get("promotions_disk", 0))
                info["tierDeltaFolds"] = snap.get("delta_folds", 0)
                info["tierPrefetchHits"] = snap.get("prefetch_hits", 0)
                info["tierCorruptSpills"] = snap.get("corrupt_spills", 0)
        # Ingest/snapshot shape: WAL bytes awaiting a snapshot and how the
        # background snapshotter is keeping up. A deployment whose
        # ingestWalBytes climbs while snapshot counters stall is ingesting
        # faster than it can rewrite storage (recovery replay grows).
        if hasattr(holder, "ingest_stats"):
            snap = holder.ingest_stats()
            info["ingestWalBytes"] = snap.get("wal_bytes", 0)
            info["ingestSnapshotsDeferred"] = snap.get("snapshots_deferred", 0)
            info["ingestSnapshotsTaken"] = snap.get("snapshots_taken", 0)
            info["ingestSnapshotQueueDepth"] = snap.get(
                "snapshot_queue_depth", 0)
        api = getattr(self.server, "api", None)
        if api is not None:
            info["ingestImportBatches"] = getattr(api, "import_batches", 0)
        # Per-query tracing shape (docs/observability.md): how many
        # queries were traced, and how many crossed the slow-query
        # threshold — the aggregate next to /debug/traces' per-trace
        # detail.
        recorder = getattr(self.server, "trace_recorder", None)
        if recorder is not None:
            snap = recorder.snapshot()
            # traces_started counts the LOCAL sampler's hits; finished
            # also counts adopted (coordinator-sampled) traces and would
            # overstate sampling activity on a rate-0 follower.
            info["obsTracesSampled"] = snap.get("traces_started", 0)
            info["obsTracesAdopted"] = snap.get("traces_adopted", 0)
            info["obsSlowQueries"] = snap.get("slow_queries", 0)
        # Peer fault-tolerance shape: how often breakers tripped, whether
        # replica retries ran into the budget, and how much traffic was
        # hedged — the aggregate story of how rough this node's network
        # neighborhood is (per-peer detail stays in /debug/vars).
        health = getattr(self.server.cluster, "health", None)
        if health is not None:
            snap = health.snapshot()
            info["resilienceBreakerOpened"] = snap.get("breaker_opened", 0)
            info["resilienceShortCircuits"] = snap.get(
                "breaker_short_circuits", 0)
            info["resilienceRetriesDenied"] = snap.get("retries_denied", 0)
            info["resilienceHedgesFired"] = snap.get("hedges_fired", 0)
            info["resilienceHedgesWon"] = snap.get("hedges_won", 0)
            info["resilienceOpenPeers"] = sum(
                1 for p in snap.get("peers", {}).values()
                if p.get("state") != "closed"
            )
        # Internal transport shape (docs/transport.md): how much
        # node-to-node traffic rode the mux vs fell back to HTTP,
        # connection churn, and the frame/byte totals — the aggregate
        # answer to "did flipping [transport] on actually take the RTT
        # tax off this node's hops" (per-peer detail stays in
        # /debug/vars).
        tstats = getattr(self.server, "transport_stats", None)
        if tstats is not None:
            snap = tstats.snapshot()
            tcfg = getattr(self.server, "transport_config", None)
            info["transportEnabled"] = bool(
                tcfg.enabled) if tcfg is not None else False
            info["transportConnects"] = snap.get("connects", 0)
            info["transportReconnects"] = snap.get("reconnects", 0)
            info["transportFramesSent"] = snap.get("frames_sent", 0)
            info["transportFramesReceived"] = snap.get("frames_received", 0)
            info["transportBytesSent"] = snap.get("bytes_sent", 0)
            info["transportBytesReceived"] = snap.get("bytes_received", 0)
            info["transportBatchedFrames"] = snap.get("batched_frames", 0)
            info["transportHandshakeFallbacks"] = snap.get(
                "handshake_fallbacks", 0)
            info["transportInflightHwm"] = snap.get("inflight_hwm", 0)
            info["transportRequestsMux"] = snap.get("requests_mux", 0)
            info["transportRequestsHttp"] = snap.get("requests_http", 0)
        # Durable write replication shape (docs/durability.md): the
        # configured ack level and the hinted-handoff flow — writes a
        # replica missed that are queued, delivered, or expired to the
        # anti-entropy backstop (per-peer backlog detail stays in
        # /debug/vars).
        hints = getattr(self.server, "hints", None)
        if hints is not None:
            snap = hints.snapshot()
            info["replicationWriteConsistency"] = snap.get(
                "writeConsistency", "one")
            info["replicationHintsAppended"] = snap.get("hints_appended", 0)
            info["replicationHintsDelivered"] = snap.get(
                "hints_delivered", 0)
            info["replicationHintsExpired"] = snap.get("hints_expired", 0)
            info["replicationHintsPendingPeers"] = len(snap.get("peers", {}))
            info["replicationHintDrains"] = snap.get("drains", 0)
        # Collective-plane shape (docs/multichip.md): how much full-index
        # serving rode the fused SPMD path vs fell back to the HTTP
        # fan-out, how often barriers timed out, and how well the batched
        # launches + resident stacks amortized the plane's fixed costs
        # (per-reason fallback detail stays in /debug/vars).
        coll = getattr(self.server, "collective", None)
        if coll is not None:
            snap = coll.snapshot()
            info["collectiveServedCount"] = snap.get("served_count", 0)
            info["collectiveServedTopN"] = snap.get("served_topn", 0)
            info["collectiveServedBSI"] = snap.get("served_bsi", 0)
            info["collectiveBatchedEntries"] = snap.get("batched_entries", 0)
            info["collectiveBatchedLaunches"] = snap.get(
                "batched_launches", 0)
            info["collectiveBarrierTimeouts"] = snap.get(
                "barrier_timeouts", 0)
            info["collectiveFallbacks"] = sum(
                snap.get("fallbacks", {}).values())
            info["collectiveResidentHits"] = snap.get("resident_hits", 0)
            info["collectiveDeltaHits"] = snap.get("delta_hits", 0)
            health = snap.get("health", {})
            info["collectivePlaneState"] = health.get("plane_state")
            info["collectivePlaneOpened"] = health.get("plane_opened", 0)
            info["collectiveSliceQuarantined"] = health.get(
                "slice_quarantined", 0)
        # Elastic-rebalance shape: how much data live migrations have
        # moved, what cutovers cost the write path, and whether a job is
        # in flight right now (mid-job routing carries per-shard
        # overrides; per-shard detail stays in /debug/vars).
        stats = getattr(self.server, "rebalance_stats", None)
        if stats is not None:
            snap = stats.snapshot()
            info["rebalanceJobsCompleted"] = snap.get("jobs_completed", 0)
            info["rebalanceJobsAborted"] = snap.get("jobs_aborted", 0)
            info["rebalanceJobsResumed"] = snap.get("jobs_resumed", 0)
            info["rebalanceFragmentsMoved"] = snap.get("fragments_moved", 0)
            info["rebalanceBytesStreamed"] = snap.get("bytes_streamed", 0)
            info["rebalanceShardsCutOver"] = snap.get("shards_cut_over", 0)
            info["rebalanceCutoverPauseMsP99"] = snap.get(
                "cutover_pause_ms_p99")
            info["rebalanceEpoch"] = self.server.cluster.routing_epoch
            info["rebalanceActive"] = (
                self.server.cluster.next_nodes is not None)
        # Geo-replication shape: which role the node plays, what fencing
        # epoch it serves under, and — on followers — how far behind the
        # leader the tail is plus how much work it has replayed. A leader
        # that suddenly reports refused writes is the fleet-level signal
        # of a fenced split-brain survivor (per-link detail stays in
        # /debug/vars under the `geo` group).
        geo = getattr(self.server, "geo", None)
        if geo is not None:
            snap = geo.debug_vars()
            info["geoRole"] = snap.get("role", "none")
            info["geoEpoch"] = snap.get("epoch", 0)
            info["geoPromotions"] = snap.get("promotions", 0)
            info["geoPromoteAborts"] = snap.get("promote_aborts", 0)
            info["geoDemotions"] = snap.get("demotions", 0)
            info["geoWritesRefused"] = snap.get("writes_refused", 0)
            tail = snap.get("tail", {})
            if snap.get("role") == "follower":
                info["geoLagSeconds"] = tail.get("lag")
                info["geoRecordsApplied"] = tail.get("records_applied", 0)
                info["geoBootstraps"] = tail.get("bootstraps", 0)
                info["geoLinkFailures"] = tail.get("link_failures", 0)
        info.update(system_info())
        info.update(self._extra)
        return info

    def flush(self) -> bool:
        """POST one report; returns success. No-op without an endpoint."""
        report = self.gather()
        self.last_report = report
        if not self.endpoint:
            return False
        try:
            req = urllib.request.Request(
                self.endpoint,
                data=json.dumps(report).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=10):
                return True
        except OSError as e:
            if self.logger:
                self.logger.debug("diagnostics flush failed: %s", e)
            return False

    # ------------------------------------------------------- version check

    def check_version(self, version_url: str = "") -> Optional[str]:
        """Fetch the latest release version and log an upgrade hint if the
        local build is behind (diagnostics.go:100-146 CheckVersion /
        compareVersion). Returns the warning string (or None). Fetch
        failures are swallowed — this is best-effort telemetry."""
        version_url = version_url or self.version_url
        if not version_url:
            return None
        try:
            with urllib.request.urlopen(version_url, timeout=10) as rsp:
                latest = json.load(rsp).get("version", "")
        except (OSError, ValueError) as e:
            if self.logger:
                self.logger.debug("version check failed: %s", e)
            return None
        if not latest or latest == getattr(self, "_last_version", None):
            return None
        self._last_version = latest
        warning = self.compare_version(latest)
        if warning and self.logger:
            self.logger.info("%s", warning)
        return warning

    def compare_version(self, latest: str) -> Optional[str]:
        """Major/minor/patch comparison (diagnostics.go:133-146)."""
        cur = _version_segments(latest)
        loc = _version_segments(__version__)
        if loc[0] < cur[0]:
            return (f"Warning: You are running pilosa-tpu {__version__}. "
                    f"A newer version ({latest}) is available")
        if loc[1] < cur[1] and loc[0] == cur[0]:
            return (f"Warning: You are running pilosa-tpu {__version__}. "
                    f"The latest minor release is {latest}")
        if loc[2] < cur[2] and loc[:2] == cur[:2]:
            return f"There is a new patch release of pilosa-tpu available: {latest}"
        return None


def _version_segments(v: str) -> list:
    """'v1.2.3-rc1' -> [1, 2, 3] (diagnostics.go versionSegments)."""
    v = v.lstrip("v").split("-")[0]
    out = []
    for seg in v.split("."):
        try:
            out.append(int(seg))
        except ValueError:
            out.append(0)
    while len(out) < 3:
        out.append(0)
    return out
