"""Configuration: TOML file + PILOSA_TPU_* env vars + CLI flags.

Port of reference server/config.go with viper's precedence model
(cmd/root.go:56-116): flags > environment > config file > defaults.
TOML parsing uses stdlib tomllib.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the baked-in tomli backport
    import tomli as tomllib

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ENV_PREFIX = "PILOSA_TPU_"


@dataclass
class ClusterConfig:
    disabled: bool = True
    coordinator: bool = True
    replicas: int = 1
    hosts: List[str] = field(default_factory=list)
    long_query_time: float = 0.0


@dataclass
class AntiEntropyConfig:
    interval: float = 600.0  # seconds (reference default 10m)
    # De-stampeding fraction: the first sweep starts anywhere in
    # [0, interval*(1+jitter)] and the steady-state period varies by
    # ±jitter, so a restarted cluster's sweeps drift apart instead of
    # landing on every node at the same instant forever. 0 restores the
    # fixed timer.
    jitter: float = 0.1
    # Seconds slept between per-fragment syncs inside one sweep, so a
    # sweep cannot saturate replicas with back-to-back block RPCs.
    pace: float = 0.0


@dataclass
class GossipConfig:
    """Membership-plane knobs (reference server/config.go:121-131 gossip{}).

    The reference's memberlist UDP gossip is redesigned as HTTP heartbeat
    probes + push/pull NodeStatus merge (server/server.py _monitor_members),
    so the surface maps as: probe-interval/probe-timeout -> the heartbeat
    loop's cadence and per-probe deadline; key -> a shared-secret file whose
    contents authenticate inbound /internal/* (the moral equivalent of
    memberlist's transport encryption key: a node without it cannot join
    or deliver cluster messages; /status and other public API routes stay
    open, as in the reference's HTTP plane)."""

    probe_interval: float = 2.0  # seconds between member heartbeat rounds
    probe_timeout: float = 2.0  # per-probe HTTP deadline (seconds)
    # Flap damping: consecutive failed heartbeat probes before the member
    # monitor marks a peer unavailable (1 = mark on the first failure,
    # the pre-damping behavior). The data path's own circuit breaker
    # ([resilience] breaker-failures) is independent of this.
    probe_failures: int = 3
    # Consecutive failed coordinator heartbeats before the deterministic
    # successor (lowest alive node id, majority required) self-promotes;
    # 0 disables automatic failover (reference behavior: manual
    # set-coordinator only, api.go:777).
    failover_probes: int = 3
    key: str = ""  # path to shared-secret file; empty = open cluster


# The [scheduler] section IS the scheduler's own dataclass — one source
# of truth for knob names and defaults (a config-side copy would drift).
# See docs/scheduler.md for how the knobs interact.
from .sched import SchedulerConfig as SchedConfig  # noqa: E402

# And for [qos]: the per-tenant budget knobs live with the ledger the
# scheduler consults (sched/qos.py, jax-free). See docs/scheduler.md.
from .sched import QosConfig  # noqa: E402

# And for [autoscale]: the load-driven membership-control knobs live
# with the controller (cluster/autoscale.py, jax-free). See
# docs/rebalance.md.
from .cluster.autoscale import AutoscaleConfig  # noqa: E402

# Same pattern for [storage]: the durability-policy dataclass lives with
# the storage layer it governs. See docs/durability.md.
from .storage import StorageConfig  # noqa: E402

# And for [ingest]: the bulk-import fan-out knobs (server/api.py's
# parallel shard routing). See docs/ingest.md.
from .ingest import IngestConfig  # noqa: E402

# And for [engine]: the device-cache refresh knobs live with the parallel
# engine (pilosa_tpu/parallel/__init__.py, jax-free so CLI startup stays
# light). See docs/engine-caches.md.
from .parallel import CollectiveConfig, EngineConfig  # noqa: E402

# And for [tier]: the HBM ↔ host-RAM ↔ disk residency budgets live with
# the tier manager (pilosa_tpu/tier/, jax-free). See
# docs/tiered-storage.md.
from .tier import TierConfig  # noqa: E402

# And for [resilience]: the peer fault-tolerance knobs (circuit breakers,
# retry budget, hedged reads) live with the health registry they govern
# (cluster/health.py, stdlib-only). See docs/fault-tolerance.md.
from .cluster.health import ResilienceConfig  # noqa: E402

# And for [rebalance]: the live-migration knobs live with the elastic
# rebalance machinery (cluster/rebalance.py). See docs/rebalance.md.
from .cluster.rebalance import RebalanceConfig  # noqa: E402

# And for [replication]: the durable write-replication knobs (hinted
# handoff, write-consistency ack gating) live with the hint store
# (cluster/hints.py, jax-free). See docs/durability.md.
from .cluster.hints import ReplicationConfig  # noqa: E402

# And for [obs]: the per-query tracing knobs live with the trace recorder
# (pilosa_tpu/obs/, jax-free). See docs/observability.md.
from .obs import ObsConfig  # noqa: E402

# And for [cdc]: the change-capture knobs (stream retention, long-poll
# bounds, standing-query cadence) live with the CDC subsystem
# (pilosa_tpu/cdc/, jax-free). See docs/cdc.md.
from .cdc import CdcConfig  # noqa: E402

# And for [geo]: the geo-replication knobs (cluster role, leader URL,
# tail breaker backoff, probe-driven promotion) live with the geo
# subsystem (pilosa_tpu/geo/, jax-free). See docs/geo-replication.md.
from .geo import GeoConfig  # noqa: E402

# And for [transport]: the pmux internal-transport knobs (enable flag,
# listener port offset, per-peer inflight cap, frame size ceiling,
# handshake timeout) live with the mux module
# (pilosa_tpu/server/mux.py, jax-free). See docs/transport.md.
from .server.mux import TransportConfig  # noqa: E402


@dataclass
class MetricConfig:
    service: str = "inmem"  # inmem | nop
    host: str = ""
    poll_interval: float = 0.0
    diagnostics: bool = False


@dataclass
class TranslationConfig:
    primary_url: str = ""


@dataclass
class TLSConfig:
    # reference server/config.go:67 + TLSConfig struct
    certificate_path: str = ""
    certificate_key_path: str = ""
    skip_verify: bool = False


@dataclass
class HandlerConfig:
    # reference server/config.go:62-63 (CORS allowed origins)
    allowed_origins: List[str] = field(default_factory=list)


@dataclass
class Config:
    data_dir: str = "~/.pilosa_tpu"
    bind: str = "localhost:10101"
    max_writes_per_request: int = 5000
    verbose: bool = False
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    anti_entropy: AntiEntropyConfig = field(default_factory=AntiEntropyConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
    scheduler: SchedConfig = field(default_factory=SchedConfig)
    qos: QosConfig = field(default_factory=QosConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    collective: CollectiveConfig = field(default_factory=CollectiveConfig)
    tier: TierConfig = field(default_factory=TierConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    rebalance: RebalanceConfig = field(default_factory=RebalanceConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    cdc: CdcConfig = field(default_factory=CdcConfig)
    geo: GeoConfig = field(default_factory=GeoConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    metric: MetricConfig = field(default_factory=MetricConfig)
    translation: TranslationConfig = field(default_factory=TranslationConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    handler: HandlerConfig = field(default_factory=HandlerConfig)

    # -------------------------------------------------------------- loading

    @classmethod
    def load(cls, path: Optional[str] = None, flags: Optional[Dict[str, Any]] = None) -> "Config":
        cfg = cls()
        if path:
            with open(path, "rb") as f:
                cfg._apply_dict(tomllib.load(f))
        cfg._apply_env()
        if flags:
            cfg._apply_flags(flags)
        return cfg

    def _apply_dict(self, d: dict) -> None:
        self.data_dir = d.get("data-dir", self.data_dir)
        self.bind = d.get("bind", self.bind)
        self.max_writes_per_request = d.get(
            "max-writes-per-request", self.max_writes_per_request
        )
        self.verbose = d.get("verbose", self.verbose)
        c = d.get("cluster", {})
        self.cluster.disabled = c.get("disabled", self.cluster.disabled)
        self.cluster.coordinator = c.get("coordinator", self.cluster.coordinator)
        self.cluster.replicas = c.get("replicas", self.cluster.replicas)
        self.cluster.hosts = c.get("hosts", self.cluster.hosts)
        self.cluster.long_query_time = c.get("long-query-time", self.cluster.long_query_time)
        a = d.get("anti-entropy", {})
        self.anti_entropy.interval = a.get("interval", self.anti_entropy.interval)
        self.anti_entropy.jitter = a.get("jitter", self.anti_entropy.jitter)
        self.anti_entropy.pace = a.get("pace", self.anti_entropy.pace)
        g = d.get("gossip", {})
        self.gossip.probe_interval = g.get("probe-interval", self.gossip.probe_interval)
        self.gossip.probe_timeout = g.get("probe-timeout", self.gossip.probe_timeout)
        self.gossip.probe_failures = g.get("probe-failures", self.gossip.probe_failures)
        self.gossip.failover_probes = g.get("failover-probes", self.gossip.failover_probes)
        self.gossip.key = g.get("key", self.gossip.key)
        r = d.get("resilience", {})
        self.resilience.breaker_failures = r.get(
            "breaker-failures", self.resilience.breaker_failures)
        self.resilience.breaker_backoff = r.get(
            "breaker-backoff", self.resilience.breaker_backoff)
        self.resilience.breaker_backoff_max = r.get(
            "breaker-backoff-max", self.resilience.breaker_backoff_max)
        self.resilience.probe_ttl = r.get("probe-ttl", self.resilience.probe_ttl)
        self.resilience.retry_budget = r.get(
            "retry-budget", self.resilience.retry_budget)
        self.resilience.retry_refill = r.get(
            "retry-refill", self.resilience.retry_refill)
        self.resilience.hedge_delay = r.get(
            "hedge-delay", self.resilience.hedge_delay)
        self.resilience.hedge_max_fraction = r.get(
            "hedge-max-fraction", self.resilience.hedge_max_fraction)
        self.resilience.hedge_min_delay = r.get(
            "hedge-min-delay", self.resilience.hedge_min_delay)
        self.resilience.device_breaker_failures = r.get(
            "device-breaker-failures", self.resilience.device_breaker_failures)
        self.resilience.device_breaker_backoff = r.get(
            "device-breaker-backoff", self.resilience.device_breaker_backoff)
        self.resilience.device_breaker_backoff_max = r.get(
            "device-breaker-backoff-max",
            self.resilience.device_breaker_backoff_max)
        self.resilience.device_sig_failures = r.get(
            "device-sig-failures", self.resilience.device_sig_failures)
        self.resilience.device_sig_backoff = r.get(
            "device-sig-backoff", self.resilience.device_sig_backoff)
        self.resilience.collective_breaker_failures = r.get(
            "collective-breaker-failures",
            self.resilience.collective_breaker_failures)
        self.resilience.collective_breaker_backoff = r.get(
            "collective-breaker-backoff",
            self.resilience.collective_breaker_backoff)
        self.resilience.collective_breaker_backoff_max = r.get(
            "collective-breaker-backoff-max",
            self.resilience.collective_breaker_backoff_max)
        rp = d.get("replication", {})
        self.replication.write_consistency = rp.get(
            "write-consistency", self.replication.write_consistency)
        self.replication.hint_ttl = rp.get(
            "hint-ttl", self.replication.hint_ttl)
        self.replication.hint_max_bytes = rp.get(
            "hint-max-bytes", self.replication.hint_max_bytes)
        self.replication.deliver_interval = rp.get(
            "deliver-interval", self.replication.deliver_interval)
        self.replication.deliver_batch_bytes = rp.get(
            "deliver-batch-bytes", self.replication.deliver_batch_bytes)
        rb = d.get("rebalance", {})
        self.rebalance.online = rb.get("online", self.rebalance.online)
        self.rebalance.max_concurrent_streams = rb.get(
            "max-concurrent-streams", self.rebalance.max_concurrent_streams)
        self.rebalance.max_bytes_per_sec = rb.get(
            "max-bytes-per-sec", self.rebalance.max_bytes_per_sec)
        self.rebalance.catchup_threshold_bytes = rb.get(
            "catchup-threshold-bytes", self.rebalance.catchup_threshold_bytes)
        self.rebalance.max_catchup_rounds = rb.get(
            "max-catchup-rounds", self.rebalance.max_catchup_rounds)
        self.rebalance.cutover_pause_max = rb.get(
            "cutover-pause-max", self.rebalance.cutover_pause_max)
        self.rebalance.follower_timeout = rb.get(
            "follower-timeout", self.rebalance.follower_timeout)
        ob = d.get("obs", {})
        self.obs.sample_rate = ob.get("sample-rate", self.obs.sample_rate)
        self.obs.ring_size = ob.get("ring-size", self.obs.ring_size)
        self.obs.slow_query_ms = ob.get(
            "slow-query-ms", self.obs.slow_query_ms)
        cd = d.get("cdc", {})
        self.cdc.enabled = cd.get("enabled", self.cdc.enabled)
        self.cdc.retention_bytes = cd.get(
            "retention-bytes", self.cdc.retention_bytes)
        self.cdc.retention_ops = cd.get(
            "retention-ops", self.cdc.retention_ops)
        self.cdc.poll_timeout = cd.get(
            "poll-timeout", self.cdc.poll_timeout)
        self.cdc.standing_interval = cd.get(
            "standing-interval", self.cdc.standing_interval)
        self.cdc.pit_cache = cd.get("pit-cache", self.cdc.pit_cache)
        ge = d.get("geo", {})
        self.geo.role = ge.get("role", self.geo.role)
        self.geo.leader = ge.get("leader", self.geo.leader)
        self.geo.backoff = ge.get("backoff", self.geo.backoff)
        self.geo.backoff_max = ge.get("backoff-max", self.geo.backoff_max)
        self.geo.probe_promote = ge.get(
            "probe-promote", self.geo.probe_promote)
        self.geo.probe_failures = ge.get(
            "probe-failures", self.geo.probe_failures)
        tr = d.get("transport", {})
        self.transport.enabled = tr.get("enabled", self.transport.enabled)
        self.transport.port_offset = tr.get(
            "port-offset", self.transport.port_offset)
        self.transport.max_frames_inflight = tr.get(
            "max-frames-inflight", self.transport.max_frames_inflight)
        self.transport.frame_max_bytes = tr.get(
            "frame-max-bytes", self.transport.frame_max_bytes)
        self.transport.handshake_timeout = tr.get(
            "handshake-timeout", self.transport.handshake_timeout)
        s = d.get("scheduler", {})
        self.scheduler.max_queue = s.get("max-queue", self.scheduler.max_queue)
        self.scheduler.interactive_concurrency = s.get(
            "interactive-concurrency", self.scheduler.interactive_concurrency)
        self.scheduler.batch_concurrency = s.get(
            "batch-concurrency", self.scheduler.batch_concurrency)
        self.scheduler.default_deadline = s.get(
            "default-deadline", self.scheduler.default_deadline)
        self.scheduler.retry_after = s.get("retry-after", self.scheduler.retry_after)
        self.scheduler.retry_jitter = s.get(
            "retry-jitter", self.scheduler.retry_jitter)
        self.scheduler.batch_window = s.get("batch-window", self.scheduler.batch_window)
        self.scheduler.batch_window_max = s.get(
            "batch-window-max", self.scheduler.batch_window_max)
        self.scheduler.batch_max = s.get("batch-max", self.scheduler.batch_max)
        q = d.get("qos", {})
        self.qos.rate = q.get("rate", self.qos.rate)
        self.qos.burst = q.get("burst", self.qos.burst)
        self.qos.default_tenant_share = q.get(
            "default-tenant-share", self.qos.default_tenant_share)
        self.qos.interactive_cap = q.get(
            "interactive-cap", self.qos.interactive_cap)
        self.qos.estimate_ms = q.get("estimate-ms", self.qos.estimate_ms)
        au = d.get("autoscale", {})
        self.autoscale.interval = au.get("interval", self.autoscale.interval)
        self.autoscale.window = au.get("window", self.autoscale.window)
        self.autoscale.scale_out_qps = au.get(
            "scale-out-qps", self.autoscale.scale_out_qps)
        self.autoscale.scale_in_qps = au.get(
            "scale-in-qps", self.autoscale.scale_in_qps)
        self.autoscale.p99_ms = au.get("p99-ms", self.autoscale.p99_ms)
        self.autoscale.cooldown = au.get("cooldown", self.autoscale.cooldown)
        self.autoscale.min_nodes = au.get(
            "min-nodes", self.autoscale.min_nodes)
        self.autoscale.max_nodes = au.get(
            "max-nodes", self.autoscale.max_nodes)
        self.autoscale.standby = au.get("standby", self.autoscale.standby)
        st = d.get("storage", {})
        self.storage.fsync = st.get("fsync", self.storage.fsync)
        self.storage.fsync_batch_ops = st.get(
            "fsync-batch-ops", self.storage.fsync_batch_ops)
        self.storage.snapshot_ratio = st.get(
            "snapshot-ratio", self.storage.snapshot_ratio)
        self.storage.snapshot_interval = st.get(
            "snapshot-interval", self.storage.snapshot_interval)
        ing = d.get("ingest", {})
        self.ingest.import_workers = ing.get(
            "import-workers", self.ingest.import_workers)
        e = d.get("engine", {})
        self.engine.delta_max_fraction = e.get(
            "delta-max-fraction", self.engine.delta_max_fraction)
        self.engine.delta_journal_ops = e.get(
            "delta-journal-ops", self.engine.delta_journal_ops)
        self.engine.gather_workers = e.get(
            "gather-workers", self.engine.gather_workers)
        self.engine.mesh_devices = e.get(
            "mesh-devices", self.engine.mesh_devices)
        self.engine.leaf_cache_bytes = e.get(
            "leaf-cache-bytes", self.engine.leaf_cache_bytes)
        self.engine.stack_cache_bytes = e.get(
            "stack-cache-bytes", self.engine.stack_cache_bytes)
        self.engine.memo_entries = e.get(
            "memo-entries", self.engine.memo_entries)
        self.engine.aux_memo_entries = e.get(
            "aux-memo-entries", self.engine.aux_memo_entries)
        self.engine.dispatch_watchdog = e.get(
            "dispatch-watchdog", self.engine.dispatch_watchdog)
        self.engine.cold_host_count = e.get(
            "cold-host-count", self.engine.cold_host_count)
        self.engine.plan_cache = e.get(
            "plan-cache", self.engine.plan_cache)
        co = d.get("collective", {})
        self.collective.enabled = co.get("enabled", self.collective.enabled)
        self.collective.single_process = co.get(
            "single-process", self.collective.single_process)
        self.collective.timeout_ms = co.get(
            "timeout-ms", self.collective.timeout_ms)
        self.collective.leaf_budget_bytes = co.get(
            "leaf-budget-bytes", self.collective.leaf_budget_bytes)
        self.collective.delta_max_fraction = co.get(
            "delta-max-fraction", self.collective.delta_max_fraction)
        ti = d.get("tier", {})
        self.tier.hbm_bytes = ti.get("hbm-bytes", self.tier.hbm_bytes)
        self.tier.host_bytes = ti.get("host-bytes", self.tier.host_bytes)
        self.tier.disk_bytes = ti.get("disk-bytes", self.tier.disk_bytes)
        self.tier.disk_path = ti.get("disk-path", self.tier.disk_path)
        self.tier.prefetch_interval = ti.get(
            "prefetch-interval", self.tier.prefetch_interval)
        self.tier.prefetch_batch = ti.get(
            "prefetch-batch", self.tier.prefetch_batch)
        m = d.get("metric", {})
        self.metric.service = m.get("service", self.metric.service)
        self.metric.host = m.get("host", self.metric.host)
        self.metric.poll_interval = m.get("poll-interval", self.metric.poll_interval)
        self.metric.diagnostics = m.get("diagnostics", self.metric.diagnostics)
        t = d.get("translation", {})
        self.translation.primary_url = t.get("primary-url", self.translation.primary_url)
        tls = d.get("tls", {})
        self.tls.certificate_path = tls.get("certificate", self.tls.certificate_path)
        self.tls.certificate_key_path = tls.get("key", self.tls.certificate_key_path)
        self.tls.skip_verify = tls.get("skip-verify", self.tls.skip_verify)
        h = d.get("handler", {})
        self.handler.allowed_origins = h.get("allowed-origins", self.handler.allowed_origins)

    def _apply_env(self) -> None:
        def env(name, cast=str):
            v = os.environ.get(ENV_PREFIX + name)
            if v is None:
                return None
            if cast is bool:
                return v.lower() in ("1", "true", "yes")
            if cast is list:
                return [h.strip() for h in v.split(",") if h.strip()]
            return cast(v)

        for attr, name, cast in [
            ("data_dir", "DATA_DIR", str),
            ("bind", "BIND", str),
            ("max_writes_per_request", "MAX_WRITES_PER_REQUEST", int),
            ("verbose", "VERBOSE", bool),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self, attr, v)
        for attr, name, cast in [
            ("disabled", "CLUSTER_DISABLED", bool),
            ("coordinator", "CLUSTER_COORDINATOR", bool),
            ("replicas", "CLUSTER_REPLICAS", int),
            ("hosts", "CLUSTER_HOSTS", list),
            ("long_query_time", "CLUSTER_LONG_QUERY_TIME", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.cluster, attr, v)
        for attr, name, cast in [
            ("interval", "ANTI_ENTROPY_INTERVAL", float),
            ("jitter", "ANTI_ENTROPY_JITTER", float),
            ("pace", "ANTI_ENTROPY_PACE", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.anti_entropy, attr, v)
        for attr, name, cast in [
            ("write_consistency", "REPLICATION_WRITE_CONSISTENCY", str),
            ("hint_ttl", "REPLICATION_HINT_TTL", float),
            ("hint_max_bytes", "REPLICATION_HINT_MAX_BYTES", int),
            ("deliver_interval", "REPLICATION_DELIVER_INTERVAL", float),
            ("deliver_batch_bytes", "REPLICATION_DELIVER_BATCH_BYTES", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.replication, attr, v)
        for attr, name, cast in [
            ("probe_interval", "GOSSIP_PROBE_INTERVAL", float),
            ("probe_timeout", "GOSSIP_PROBE_TIMEOUT", float),
            ("probe_failures", "GOSSIP_PROBE_FAILURES", int),
            ("failover_probes", "GOSSIP_FAILOVER_PROBES", int),
            ("key", "GOSSIP_KEY", str),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.gossip, attr, v)
        for attr, name, cast in [
            ("breaker_failures", "RESILIENCE_BREAKER_FAILURES", int),
            ("breaker_backoff", "RESILIENCE_BREAKER_BACKOFF", float),
            ("breaker_backoff_max", "RESILIENCE_BREAKER_BACKOFF_MAX", float),
            ("probe_ttl", "RESILIENCE_PROBE_TTL", float),
            ("retry_budget", "RESILIENCE_RETRY_BUDGET", float),
            ("retry_refill", "RESILIENCE_RETRY_REFILL", float),
            ("hedge_delay", "RESILIENCE_HEDGE_DELAY", float),
            ("hedge_max_fraction", "RESILIENCE_HEDGE_MAX_FRACTION", float),
            ("hedge_min_delay", "RESILIENCE_HEDGE_MIN_DELAY", float),
            ("device_breaker_failures",
             "RESILIENCE_DEVICE_BREAKER_FAILURES", int),
            ("device_breaker_backoff",
             "RESILIENCE_DEVICE_BREAKER_BACKOFF", float),
            ("device_breaker_backoff_max",
             "RESILIENCE_DEVICE_BREAKER_BACKOFF_MAX", float),
            ("device_sig_failures", "RESILIENCE_DEVICE_SIG_FAILURES", int),
            ("device_sig_backoff", "RESILIENCE_DEVICE_SIG_BACKOFF", float),
            ("collective_breaker_failures",
             "RESILIENCE_COLLECTIVE_BREAKER_FAILURES", int),
            ("collective_breaker_backoff",
             "RESILIENCE_COLLECTIVE_BREAKER_BACKOFF", float),
            ("collective_breaker_backoff_max",
             "RESILIENCE_COLLECTIVE_BREAKER_BACKOFF_MAX", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.resilience, attr, v)
        for attr, name, cast in [
            ("online", "REBALANCE_ONLINE", bool),
            ("max_concurrent_streams", "REBALANCE_MAX_CONCURRENT_STREAMS", int),
            ("max_bytes_per_sec", "REBALANCE_MAX_BYTES_PER_SEC", float),
            ("catchup_threshold_bytes",
             "REBALANCE_CATCHUP_THRESHOLD_BYTES", int),
            ("max_catchup_rounds", "REBALANCE_MAX_CATCHUP_ROUNDS", int),
            ("cutover_pause_max", "REBALANCE_CUTOVER_PAUSE_MAX", float),
            ("follower_timeout", "REBALANCE_FOLLOWER_TIMEOUT", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.rebalance, attr, v)
        for attr, name, cast in [
            ("sample_rate", "OBS_SAMPLE_RATE", float),
            ("ring_size", "OBS_RING_SIZE", int),
            ("slow_query_ms", "OBS_SLOW_QUERY_MS", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.obs, attr, v)
        for attr, name, cast in [
            ("enabled", "CDC_ENABLED", bool),
            ("retention_bytes", "CDC_RETENTION_BYTES", int),
            ("retention_ops", "CDC_RETENTION_OPS", int),
            ("poll_timeout", "CDC_POLL_TIMEOUT", float),
            ("standing_interval", "CDC_STANDING_INTERVAL", float),
            ("pit_cache", "CDC_PIT_CACHE", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.cdc, attr, v)
        for attr, name, cast in [
            ("role", "GEO_ROLE", str),
            ("leader", "GEO_LEADER", str),
            ("backoff", "GEO_BACKOFF", float),
            ("backoff_max", "GEO_BACKOFF_MAX", float),
            ("probe_promote", "GEO_PROBE_PROMOTE", bool),
            ("probe_failures", "GEO_PROBE_FAILURES", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.geo, attr, v)
        for attr, name, cast in [
            ("enabled", "TRANSPORT_ENABLED", bool),
            ("port_offset", "TRANSPORT_PORT_OFFSET", int),
            ("max_frames_inflight", "TRANSPORT_MAX_FRAMES_INFLIGHT", int),
            ("frame_max_bytes", "TRANSPORT_FRAME_MAX_BYTES", int),
            ("handshake_timeout", "TRANSPORT_HANDSHAKE_TIMEOUT", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.transport, attr, v)
        for attr, name, cast in [
            ("max_queue", "SCHED_MAX_QUEUE", int),
            ("interactive_concurrency", "SCHED_INTERACTIVE_CONCURRENCY", int),
            ("batch_concurrency", "SCHED_BATCH_CONCURRENCY", int),
            ("default_deadline", "SCHED_DEFAULT_DEADLINE", float),
            ("retry_after", "SCHED_RETRY_AFTER", float),
            ("retry_jitter", "SCHED_RETRY_JITTER", float),
            ("batch_window", "SCHED_BATCH_WINDOW", float),
            ("batch_window_max", "SCHED_BATCH_WINDOW_MAX", float),
            ("batch_max", "SCHED_BATCH_MAX", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.scheduler, attr, v)
        for attr, name, cast in [
            ("rate", "QOS_RATE", float),
            ("burst", "QOS_BURST", float),
            ("default_tenant_share", "QOS_DEFAULT_TENANT_SHARE", float),
            ("interactive_cap", "QOS_INTERACTIVE_CAP", float),
            ("estimate_ms", "QOS_ESTIMATE_MS", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.qos, attr, v)
        for attr, name, cast in [
            ("interval", "AUTOSCALE_INTERVAL", float),
            ("window", "AUTOSCALE_WINDOW", int),
            ("scale_out_qps", "AUTOSCALE_SCALE_OUT_QPS", float),
            ("scale_in_qps", "AUTOSCALE_SCALE_IN_QPS", float),
            ("p99_ms", "AUTOSCALE_P99_MS", float),
            ("cooldown", "AUTOSCALE_COOLDOWN", float),
            ("min_nodes", "AUTOSCALE_MIN_NODES", int),
            ("max_nodes", "AUTOSCALE_MAX_NODES", int),
            ("standby", "AUTOSCALE_STANDBY", str),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.autoscale, attr, v)
        for attr, name, cast in [
            ("fsync", "STORAGE_FSYNC", str),
            ("fsync_batch_ops", "STORAGE_FSYNC_BATCH_OPS", int),
            ("snapshot_ratio", "STORAGE_SNAPSHOT_RATIO", float),
            ("snapshot_interval", "STORAGE_SNAPSHOT_INTERVAL", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.storage, attr, v)
        v = env("INGEST_IMPORT_WORKERS", int)
        if v is not None:
            self.ingest.import_workers = v
        for attr, name, cast in [
            ("delta_max_fraction", "ENGINE_DELTA_MAX_FRACTION", float),
            ("delta_journal_ops", "ENGINE_DELTA_JOURNAL_OPS", int),
            ("gather_workers", "ENGINE_GATHER_WORKERS", int),
            ("mesh_devices", "ENGINE_MESH_DEVICES", int),
            ("leaf_cache_bytes", "ENGINE_LEAF_CACHE_BYTES", int),
            ("stack_cache_bytes", "ENGINE_STACK_CACHE_BYTES", int),
            ("memo_entries", "ENGINE_MEMO_ENTRIES", int),
            ("aux_memo_entries", "ENGINE_AUX_MEMO_ENTRIES", int),
            ("dispatch_watchdog", "ENGINE_DISPATCH_WATCHDOG", float),
            ("cold_host_count", "ENGINE_COLD_HOST_COUNT", int),
            ("plan_cache", "ENGINE_PLAN_CACHE", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.engine, attr, v)
        # Legacy collective env spellings predate the [collective]
        # section (the backend read them directly); keep honoring them on
        # config-resolved deployments, below the PILOSA_TPU_* spellings.
        for attr, legacy, cast in [
            ("timeout_ms", "PILOSA_COLLECTIVE_TIMEOUT_MS", int),
            ("leaf_budget_bytes", "PILOSA_COLLECTIVE_LEAF_BYTES", int),
        ]:
            v = os.environ.get(legacy)
            if v is not None:
                setattr(self.collective, attr, cast(v))
        for attr, name, cast in [
            ("enabled", "COLLECTIVE_ENABLED", int),
            ("single_process", "COLLECTIVE_SINGLE_PROCESS", int),
            ("timeout_ms", "COLLECTIVE_TIMEOUT_MS", int),
            ("leaf_budget_bytes", "COLLECTIVE_LEAF_BUDGET_BYTES", int),
            ("delta_max_fraction", "COLLECTIVE_DELTA_MAX_FRACTION", float),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.collective, attr, v)
        for attr, name, cast in [
            ("hbm_bytes", "TIER_HBM_BYTES", int),
            ("host_bytes", "TIER_HOST_BYTES", int),
            ("disk_bytes", "TIER_DISK_BYTES", int),
            ("disk_path", "TIER_DISK_PATH", str),
            ("prefetch_interval", "TIER_PREFETCH_INTERVAL", float),
            ("prefetch_batch", "TIER_PREFETCH_BATCH", int),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.tier, attr, v)
        v = env("TRANSLATION_PRIMARY_URL", str)
        if v is not None:
            self.translation.primary_url = v
        for attr, name, cast in [
            ("certificate_path", "TLS_CERTIFICATE", str),
            ("certificate_key_path", "TLS_CERTIFICATE_KEY", str),
            ("skip_verify", "TLS_SKIP_VERIFY", bool),
        ]:
            v = env(name, cast)
            if v is not None:
                setattr(self.tls, attr, v)
        v = env("HANDLER_ALLOWED_ORIGINS", list)
        if v is not None:
            self.handler.allowed_origins = v

    def _apply_flags(self, flags: Dict[str, Any]) -> None:
        mapping = {
            "data_dir": ("data_dir",),
            "bind": ("bind",),
            "max_writes_per_request": ("max_writes_per_request",),
            "verbose": ("verbose",),
            "cluster_hosts": ("cluster", "hosts"),
            "cluster_replicas": ("cluster", "replicas"),
            "cluster_coordinator": ("cluster", "coordinator"),
            "cluster_disabled": ("cluster", "disabled"),
            "long_query_time": ("cluster", "long_query_time"),
            "anti_entropy_interval": ("anti_entropy", "interval"),
            "anti_entropy_jitter": ("anti_entropy", "jitter"),
            "anti_entropy_pace": ("anti_entropy", "pace"),
            "replication_write_consistency":
                ("replication", "write_consistency"),
            "replication_hint_ttl": ("replication", "hint_ttl"),
            "replication_hint_max_bytes": ("replication", "hint_max_bytes"),
            "replication_deliver_interval":
                ("replication", "deliver_interval"),
            "replication_deliver_batch_bytes":
                ("replication", "deliver_batch_bytes"),
            "gossip_probe_interval": ("gossip", "probe_interval"),
            "gossip_probe_timeout": ("gossip", "probe_timeout"),
            "gossip_probe_failures": ("gossip", "probe_failures"),
            "gossip_failover_probes": ("gossip", "failover_probes"),
            "gossip_key": ("gossip", "key"),
            "resilience_breaker_failures": ("resilience", "breaker_failures"),
            "resilience_breaker_backoff": ("resilience", "breaker_backoff"),
            "resilience_breaker_backoff_max":
                ("resilience", "breaker_backoff_max"),
            "resilience_probe_ttl": ("resilience", "probe_ttl"),
            "resilience_retry_budget": ("resilience", "retry_budget"),
            "resilience_retry_refill": ("resilience", "retry_refill"),
            "resilience_hedge_delay": ("resilience", "hedge_delay"),
            "resilience_hedge_max_fraction":
                ("resilience", "hedge_max_fraction"),
            "resilience_hedge_min_delay": ("resilience", "hedge_min_delay"),
            "resilience_device_breaker_failures":
                ("resilience", "device_breaker_failures"),
            "resilience_device_breaker_backoff":
                ("resilience", "device_breaker_backoff"),
            "resilience_device_breaker_backoff_max":
                ("resilience", "device_breaker_backoff_max"),
            "resilience_device_sig_failures":
                ("resilience", "device_sig_failures"),
            "resilience_device_sig_backoff":
                ("resilience", "device_sig_backoff"),
            "resilience_collective_breaker_failures":
                ("resilience", "collective_breaker_failures"),
            "resilience_collective_breaker_backoff":
                ("resilience", "collective_breaker_backoff"),
            "resilience_collective_breaker_backoff_max":
                ("resilience", "collective_breaker_backoff_max"),
            "rebalance_online": ("rebalance", "online"),
            "rebalance_max_concurrent_streams":
                ("rebalance", "max_concurrent_streams"),
            "rebalance_max_bytes_per_sec": ("rebalance", "max_bytes_per_sec"),
            "rebalance_catchup_threshold_bytes":
                ("rebalance", "catchup_threshold_bytes"),
            "rebalance_max_catchup_rounds":
                ("rebalance", "max_catchup_rounds"),
            "rebalance_cutover_pause_max":
                ("rebalance", "cutover_pause_max"),
            "rebalance_follower_timeout": ("rebalance", "follower_timeout"),
            "obs_sample_rate": ("obs", "sample_rate"),
            "obs_ring_size": ("obs", "ring_size"),
            "obs_slow_query_ms": ("obs", "slow_query_ms"),
            "cdc_enabled": ("cdc", "enabled"),
            "cdc_retention_bytes": ("cdc", "retention_bytes"),
            "cdc_retention_ops": ("cdc", "retention_ops"),
            "cdc_poll_timeout": ("cdc", "poll_timeout"),
            "cdc_standing_interval": ("cdc", "standing_interval"),
            "cdc_pit_cache": ("cdc", "pit_cache"),
            "geo_role": ("geo", "role"),
            "geo_leader": ("geo", "leader"),
            "geo_backoff": ("geo", "backoff"),
            "geo_backoff_max": ("geo", "backoff_max"),
            "geo_probe_promote": ("geo", "probe_promote"),
            "geo_probe_failures": ("geo", "probe_failures"),
            "transport_enabled": ("transport", "enabled"),
            "transport_port_offset": ("transport", "port_offset"),
            "transport_max_frames_inflight":
                ("transport", "max_frames_inflight"),
            "transport_frame_max_bytes": ("transport", "frame_max_bytes"),
            "transport_handshake_timeout":
                ("transport", "handshake_timeout"),
            "sched_max_queue": ("scheduler", "max_queue"),
            "sched_interactive_concurrency": ("scheduler", "interactive_concurrency"),
            "sched_batch_concurrency": ("scheduler", "batch_concurrency"),
            "sched_default_deadline": ("scheduler", "default_deadline"),
            "sched_retry_after": ("scheduler", "retry_after"),
            "sched_retry_jitter": ("scheduler", "retry_jitter"),
            "sched_batch_window": ("scheduler", "batch_window"),
            "sched_batch_window_max": ("scheduler", "batch_window_max"),
            "sched_batch_max": ("scheduler", "batch_max"),
            "qos_rate": ("qos", "rate"),
            "qos_burst": ("qos", "burst"),
            "qos_default_tenant_share": ("qos", "default_tenant_share"),
            "qos_interactive_cap": ("qos", "interactive_cap"),
            "qos_estimate_ms": ("qos", "estimate_ms"),
            "autoscale_interval": ("autoscale", "interval"),
            "autoscale_window": ("autoscale", "window"),
            "autoscale_scale_out_qps": ("autoscale", "scale_out_qps"),
            "autoscale_scale_in_qps": ("autoscale", "scale_in_qps"),
            "autoscale_p99_ms": ("autoscale", "p99_ms"),
            "autoscale_cooldown": ("autoscale", "cooldown"),
            "autoscale_min_nodes": ("autoscale", "min_nodes"),
            "autoscale_max_nodes": ("autoscale", "max_nodes"),
            "autoscale_standby": ("autoscale", "standby"),
            "storage_fsync": ("storage", "fsync"),
            "storage_fsync_batch_ops": ("storage", "fsync_batch_ops"),
            "storage_snapshot_ratio": ("storage", "snapshot_ratio"),
            "storage_snapshot_interval": ("storage", "snapshot_interval"),
            "ingest_import_workers": ("ingest", "import_workers"),
            "engine_delta_max_fraction": ("engine", "delta_max_fraction"),
            "engine_delta_journal_ops": ("engine", "delta_journal_ops"),
            "engine_gather_workers": ("engine", "gather_workers"),
            "engine_mesh_devices": ("engine", "mesh_devices"),
            "engine_leaf_cache_bytes": ("engine", "leaf_cache_bytes"),
            "engine_stack_cache_bytes": ("engine", "stack_cache_bytes"),
            "engine_memo_entries": ("engine", "memo_entries"),
            "engine_aux_memo_entries": ("engine", "aux_memo_entries"),
            "engine_dispatch_watchdog": ("engine", "dispatch_watchdog"),
            "engine_cold_host_count": ("engine", "cold_host_count"),
            "engine_plan_cache": ("engine", "plan_cache"),
            "collective_enabled": ("collective", "enabled"),
            "collective_single_process": ("collective", "single_process"),
            "collective_timeout_ms": ("collective", "timeout_ms"),
            "collective_leaf_budget_bytes":
                ("collective", "leaf_budget_bytes"),
            "collective_delta_max_fraction":
                ("collective", "delta_max_fraction"),
            "tier_hbm_bytes": ("tier", "hbm_bytes"),
            "tier_host_bytes": ("tier", "host_bytes"),
            "tier_disk_bytes": ("tier", "disk_bytes"),
            "tier_disk_path": ("tier", "disk_path"),
            "tier_prefetch_interval": ("tier", "prefetch_interval"),
            "tier_prefetch_batch": ("tier", "prefetch_batch"),
            "translation_primary_url": ("translation", "primary_url"),
            "tls_certificate": ("tls", "certificate_path"),
            "tls_certificate_key": ("tls", "certificate_key_path"),
            "tls_skip_verify": ("tls", "skip_verify"),
            "allowed_origins": ("handler", "allowed_origins"),
        }
        for key, path in mapping.items():
            v = flags.get(key)
            if v is None:
                continue
            obj = self
            for p in path[:-1]:
                obj = getattr(obj, p)
            setattr(obj, path[-1], v)

    # -------------------------------------------------------------- dumping

    def to_toml(self) -> str:
        def fmt(v):
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, str):
                return f'"{v}"'
            if isinstance(v, list):
                return "[" + ", ".join(fmt(x) for x in v) + "]"
            return str(v)

        lines = [
            f"data-dir = {fmt(self.data_dir)}",
            f"bind = {fmt(self.bind)}",
            f"max-writes-per-request = {self.max_writes_per_request}",
            f"verbose = {fmt(self.verbose)}",
            "",
            "[cluster]",
            f"disabled = {fmt(self.cluster.disabled)}",
            f"coordinator = {fmt(self.cluster.coordinator)}",
            f"replicas = {self.cluster.replicas}",
            f"hosts = {fmt(self.cluster.hosts)}",
            f"long-query-time = {self.cluster.long_query_time}",
            "",
            "[anti-entropy]",
            f"interval = {self.anti_entropy.interval}",
            f"jitter = {self.anti_entropy.jitter}",
            f"pace = {self.anti_entropy.pace}",
            "",
            "[replication]",
            f"write-consistency = {fmt(self.replication.write_consistency)}",
            f"hint-ttl = {self.replication.hint_ttl}",
            f"hint-max-bytes = {self.replication.hint_max_bytes}",
            f"deliver-interval = {self.replication.deliver_interval}",
            f"deliver-batch-bytes = {self.replication.deliver_batch_bytes}",
            "",
            "[gossip]",
            f"probe-interval = {self.gossip.probe_interval}",
            f"probe-timeout = {self.gossip.probe_timeout}",
            f"probe-failures = {self.gossip.probe_failures}",
            f"failover-probes = {self.gossip.failover_probes}",
            f"key = {fmt(self.gossip.key)}",
            "",
            "[resilience]",
            f"breaker-failures = {self.resilience.breaker_failures}",
            f"breaker-backoff = {self.resilience.breaker_backoff}",
            f"breaker-backoff-max = {self.resilience.breaker_backoff_max}",
            f"probe-ttl = {self.resilience.probe_ttl}",
            f"retry-budget = {self.resilience.retry_budget}",
            f"retry-refill = {self.resilience.retry_refill}",
            f"hedge-delay = {self.resilience.hedge_delay}",
            f"hedge-max-fraction = {self.resilience.hedge_max_fraction}",
            f"hedge-min-delay = {self.resilience.hedge_min_delay}",
            f"device-breaker-failures = {self.resilience.device_breaker_failures}",
            f"device-breaker-backoff = {self.resilience.device_breaker_backoff}",
            f"device-breaker-backoff-max = {self.resilience.device_breaker_backoff_max}",
            f"device-sig-failures = {self.resilience.device_sig_failures}",
            f"device-sig-backoff = {self.resilience.device_sig_backoff}",
            f"collective-breaker-failures = {self.resilience.collective_breaker_failures}",
            f"collective-breaker-backoff = {self.resilience.collective_breaker_backoff}",
            f"collective-breaker-backoff-max = {self.resilience.collective_breaker_backoff_max}",
            "",
            "[rebalance]",
            f"online = {fmt(self.rebalance.online)}",
            f"max-concurrent-streams = {self.rebalance.max_concurrent_streams}",
            f"max-bytes-per-sec = {self.rebalance.max_bytes_per_sec}",
            f"catchup-threshold-bytes = {self.rebalance.catchup_threshold_bytes}",
            f"max-catchup-rounds = {self.rebalance.max_catchup_rounds}",
            f"cutover-pause-max = {self.rebalance.cutover_pause_max}",
            f"follower-timeout = {self.rebalance.follower_timeout}",
            "",
            "[obs]",
            f"sample-rate = {self.obs.sample_rate}",
            f"ring-size = {self.obs.ring_size}",
            f"slow-query-ms = {self.obs.slow_query_ms}",
            "",
            "[cdc]",
            f"enabled = {fmt(self.cdc.enabled)}",
            f"retention-bytes = {self.cdc.retention_bytes}",
            f"retention-ops = {self.cdc.retention_ops}",
            f"poll-timeout = {self.cdc.poll_timeout}",
            f"standing-interval = {self.cdc.standing_interval}",
            f"pit-cache = {self.cdc.pit_cache}",
            "",
            "[geo]",
            f"role = {fmt(self.geo.role)}",
            f"leader = {fmt(self.geo.leader)}",
            f"backoff = {self.geo.backoff}",
            f"backoff-max = {self.geo.backoff_max}",
            f"probe-promote = {fmt(self.geo.probe_promote)}",
            f"probe-failures = {self.geo.probe_failures}",
            "",
            "[transport]",
            f"enabled = {fmt(self.transport.enabled)}",
            f"port-offset = {self.transport.port_offset}",
            f"max-frames-inflight = {self.transport.max_frames_inflight}",
            f"frame-max-bytes = {self.transport.frame_max_bytes}",
            f"handshake-timeout = {self.transport.handshake_timeout}",
            "",
            "[scheduler]",
            f"max-queue = {self.scheduler.max_queue}",
            f"interactive-concurrency = {self.scheduler.interactive_concurrency}",
            f"batch-concurrency = {self.scheduler.batch_concurrency}",
            f"default-deadline = {self.scheduler.default_deadline}",
            f"retry-after = {self.scheduler.retry_after}",
            f"retry-jitter = {self.scheduler.retry_jitter}",
            f"batch-window = {self.scheduler.batch_window}",
            f"batch-window-max = {self.scheduler.batch_window_max}",
            f"batch-max = {self.scheduler.batch_max}",
            "",
            "[qos]",
            f"rate = {self.qos.rate}",
            f"burst = {self.qos.burst}",
            f"default-tenant-share = {self.qos.default_tenant_share}",
            f"interactive-cap = {self.qos.interactive_cap}",
            f"estimate-ms = {self.qos.estimate_ms}",
            "",
            "[autoscale]",
            f"interval = {self.autoscale.interval}",
            f"window = {self.autoscale.window}",
            f"scale-out-qps = {self.autoscale.scale_out_qps}",
            f"scale-in-qps = {self.autoscale.scale_in_qps}",
            f"p99-ms = {self.autoscale.p99_ms}",
            f"cooldown = {self.autoscale.cooldown}",
            f"min-nodes = {self.autoscale.min_nodes}",
            f"max-nodes = {self.autoscale.max_nodes}",
            f"standby = {fmt(self.autoscale.standby)}",
            "",
            "[storage]",
            f"fsync = {fmt(self.storage.fsync)}",
            f"fsync-batch-ops = {self.storage.fsync_batch_ops}",
            f"snapshot-ratio = {self.storage.snapshot_ratio}",
            f"snapshot-interval = {self.storage.snapshot_interval}",
            "",
            "[ingest]",
            f"import-workers = {self.ingest.import_workers}",
            "",
            "[engine]",
            f"delta-max-fraction = {self.engine.delta_max_fraction}",
            f"delta-journal-ops = {self.engine.delta_journal_ops}",
            f"gather-workers = {self.engine.gather_workers}",
            f"mesh-devices = {self.engine.mesh_devices}",
            f"leaf-cache-bytes = {self.engine.leaf_cache_bytes}",
            f"stack-cache-bytes = {self.engine.stack_cache_bytes}",
            f"memo-entries = {self.engine.memo_entries}",
            f"aux-memo-entries = {self.engine.aux_memo_entries}",
            f"dispatch-watchdog = {self.engine.dispatch_watchdog}",
            f"cold-host-count = {self.engine.cold_host_count}",
            f"plan-cache = {self.engine.plan_cache}",
            "",
            "[collective]",
            f"enabled = {self.collective.enabled}",
            f"single-process = {self.collective.single_process}",
            f"timeout-ms = {self.collective.timeout_ms}",
            f"leaf-budget-bytes = {self.collective.leaf_budget_bytes}",
            f"delta-max-fraction = {self.collective.delta_max_fraction}",
            "",
            "[tier]",
            f"hbm-bytes = {self.tier.hbm_bytes}",
            f"host-bytes = {self.tier.host_bytes}",
            f"disk-bytes = {self.tier.disk_bytes}",
            f"disk-path = {fmt(self.tier.disk_path)}",
            f"prefetch-interval = {self.tier.prefetch_interval}",
            f"prefetch-batch = {self.tier.prefetch_batch}",
            "",
            "[metric]",
            f"service = {fmt(self.metric.service)}",
            f"host = {fmt(self.metric.host)}",
            f"poll-interval = {self.metric.poll_interval}",
            f"diagnostics = {fmt(self.metric.diagnostics)}",
            "",
            "[translation]",
            f"primary-url = {fmt(self.translation.primary_url)}",
            "",
            "[tls]",
            f"certificate = {fmt(self.tls.certificate_path)}",
            f"key = {fmt(self.tls.certificate_key_path)}",
            f"skip-verify = {fmt(self.tls.skip_verify)}",
            "",
            "[handler]",
            f"allowed-origins = {fmt(self.handler.allowed_origins)}",
        ]
        return "\n".join(lines) + "\n"

    def build_server(self, **overrides):
        """Construct a Server from this config."""
        from .server.server import Server
        from .stats import new_stats_client

        bind = self.bind
        scheme = "http"
        if "://" in bind:
            scheme, _, bind = bind.partition("://")
        host, _, port = bind.partition(":")
        kw = dict(
            stats=new_stats_client(self.metric.service, self.metric.host),
            data_dir=os.path.expanduser(self.data_dir),
            host=host or "localhost",
            port=int(port or 0),
            scheme=scheme,
            tls_certificate=self.tls.certificate_path or None,
            tls_certificate_key=self.tls.certificate_key_path or None,
            tls_skip_verify=self.tls.skip_verify,
            allowed_origins=self.handler.allowed_origins,
            cluster_hosts=self.cluster.hosts,
            is_coordinator=self.cluster.coordinator,
            replica_n=self.cluster.replicas,
            anti_entropy_interval=self.anti_entropy.interval,
            anti_entropy_jitter=self.anti_entropy.jitter,
            anti_entropy_pace=self.anti_entropy.pace,
            replication_config=self.replication.validate(),
            long_query_time=self.cluster.long_query_time,
            metric_poll_interval=self.metric.poll_interval,
            primary_translate_store_url=self.translation.primary_url or None,
            max_writes_per_request=self.max_writes_per_request,
            member_monitor_interval=self.gossip.probe_interval,
            member_probe_timeout=self.gossip.probe_timeout,
            member_probe_failures=self.gossip.probe_failures,
            coordinator_failover_probes=self.gossip.failover_probes,
            internal_key_path=self.gossip.key or None,
            scheduler_config=self.scheduler,
            qos_config=self.qos.validate(),
            autoscale_config=self.autoscale.validate(),
            storage_config=self.storage.validate(),
            ingest_config=self.ingest.validate(),
            engine_config=self.engine,
            collective_config=self.collective,
            tier_config=self.tier.validate(),
            resilience_config=self.resilience.validate(),
            rebalance_config=self.rebalance.validate(),
            obs_config=self.obs.validate(),
            cdc_config=self.cdc.validate(),
            geo_config=self.geo.validate(),
            transport_config=self.transport.validate(),
        )
        kw.update(overrides)
        return Server(**kw)
