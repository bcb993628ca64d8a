"""Server: node composition root (port of reference server.go).

Owns holder, cluster, executor, translate store, HTTP handler and the
background loops (anti-entropy, cache flush, hint delivery, member
monitor, runtime metrics, diagnostics). A copy of
pilosa_tpu/server/server.py: the constructor keeps the reference's
parameters and construction order and threads `device` (the card unless
the caller asks for the CPU) to the Holder. Cluster membership starts
from `cluster_hosts` (node id equals URI) and changes as in the
reference: a node joins through `join_addr`, the coordinator admits it,
and a live rebalance (cluster/rebalance.py; the legacy stop-the-world
resize, cluster/resize.py, when `rebalance_config.online` is false)
moves shards to their new owners while writes continue; a node leaves
through `/cluster/resize/remove-node`. `replica_n` places each shard on
that many nodes, and any node answers a query by fanning it out to the
owners of the shards it does not hold. A replica follows a primary
translate store, and CDC (cdc/) streams changes, answers point-in-time
reads and pushes standing queries. A geo follower cluster tails a
leader's CDC (geo/), node-to-node traffic rides the persistent mux
transport when `[transport] enabled` (server/mux.py), and the autoscaler
turns sustained load into joins and leaves (cluster/autoscale.py), as in
the reference. `engine_config.mesh_devices` sets the engine's shard
partitions (parallel/mesh.py): N partitions round-robin over the local
cards, one per card by default.

The collective plane: `open()` joins the torch.distributed job the
reference's variables describe (parallel/distributed.py; the reference
joins a jax.distributed one), sets this node's process index to its
rank, and builds the CollectiveBackend (parallel/collective.py) that the
executor serves whole-index Counts, Sum/Min/Max and TopN phase 2
through; peers enter the leader's descriptors from the collective-exec
cluster message.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import List, Optional

from ..cluster.node import Cluster, Node, STATE_NORMAL, STATE_RESIZING, STATE_STARTING
from ..core.holder import Holder, resolve_device
from ..errors import PilosaError
from ..executor import Executor
from ..logger import NopLogger
from ..stats import InMemoryStatsClient
from ..translate import TranslateStore
from .api import API
from .client import ClientError, InternalClient
from .handler import Handler, serve

DEFAULT_ANTI_ENTROPY_INTERVAL = 600.0  # 10m (reference server/config.go:134)
DEFAULT_CACHE_FLUSH_INTERVAL = 60.0  # 1m (reference holder.go:37)
DEFAULT_METRIC_POLL_INTERVAL = 0.0  # disabled unless configured


class Server:
    def __init__(
        self,
        data_dir: Optional[str] = None,
        host: str = "localhost",
        port: int = 0,
        node_id: Optional[str] = None,
        cluster_hosts: Optional[List[str]] = None,
        is_coordinator: bool = True,
        replica_n: int = 1,
        hasher=None,
        anti_entropy_interval: float = DEFAULT_ANTI_ENTROPY_INTERVAL,
        anti_entropy_jitter: float = 0.1,
        anti_entropy_pace: float = 0.0,
        cache_flush_interval: float = DEFAULT_CACHE_FLUSH_INTERVAL,
        metric_poll_interval: float = DEFAULT_METRIC_POLL_INTERVAL,
        long_query_time: float = 0.0,
        logger=None,
        stats=None,
        primary_translate_store_url: Optional[str] = None,
        max_writes_per_request: int = 5000,
        executor_workers: int = 8,
        diagnostics_interval: float = 0.0,
        diagnostics_endpoint: str = "",
        member_monitor_interval: float = 2.0,
        member_probe_timeout: float = 2.0,
        member_probe_failures: int = 3,
        coordinator_failover_probes: int = 3,
        resilience_config=None,
        rebalance_config=None,
        replication_config=None,
        internal_key_path: Optional[str] = None,
        scheduler_config=None,
        qos_config=None,
        autoscale_config=None,
        storage_config=None,
        ingest_config=None,
        engine_config=None,
        collective_config=None,
        tier_config=None,
        obs_config=None,
        cdc_config=None,
        geo_config=None,
        transport_config=None,
        join_addr: Optional[str] = None,
        allowed_origins: Optional[List[str]] = None,
        tls_certificate: Optional[str] = None,
        tls_certificate_key: Optional[str] = None,
        tls_skip_verify: bool = False,
        scheme: str = "http",
        device=None,
    ):
        # The card unless the caller asks for the CPU; without CUDA this
        # raises before anything is built.
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.host = host
        self.port = port
        # TLS (reference server/server.go:203-232: https scheme requires a
        # certificate + key; SkipVerify relaxes peer verification on the
        # internal client).
        self.scheme = scheme
        self.tls_certificate = tls_certificate
        self.tls_certificate_key = tls_certificate_key
        self.tls_skip_verify = tls_skip_verify
        if scheme == "https":
            if not tls_certificate:
                raise ValueError("certificate path is required for TLS sockets")
            if not tls_certificate_key:
                raise ValueError("certificate key path is required for TLS sockets")
        self.logger = logger or NopLogger()
        self.stats = stats or InMemoryStatsClient()
        self.long_query_time = long_query_time
        self.anti_entropy_interval = anti_entropy_interval
        # De-stampeding ([anti-entropy] jitter/pace): every node of a
        # restarted cluster used to start an identical fixed-interval
        # sweep timer at the same instant, so sweeps (full-holder block-
        # checksum walks against every replica) landed cluster-wide
        # simultaneously, forever. The jitter fraction desynchronizes
        # both the first sweep and the steady-state period; `pace`
        # sleeps between per-fragment syncs so one sweep cannot saturate
        # peers with back-to-back block RPCs.
        # Clamped to [0, 1]: jitter is a FRACTION of the interval. An
        # operator's percent-vs-fraction slip (jitter=20) would otherwise
        # make the steady-state wait negative — i.e. back-to-back sweeps,
        # the exact stampede the knob exists to prevent.
        self.anti_entropy_jitter = min(max(anti_entropy_jitter, 0.0), 1.0)
        self.anti_entropy_pace = max(0.0, anti_entropy_pace)
        self.cache_flush_interval = cache_flush_interval
        self.member_monitor_interval = member_monitor_interval
        # Flap damping: consecutive failed heartbeat probes before the
        # monitor marks a peer unavailable (gossip.probe-failures). One
        # transient probe timeout must not reroute every shard the peer
        # owns; <=1 restores the old instant-mark behavior.
        self.member_probe_failures = max(member_probe_failures, 1)
        self.coordinator_failover_probes = coordinator_failover_probes
        # node id -> consecutive failed heartbeat probes (feeds both the
        # flap damping above and coordinator failover).
        self._probe_failures: dict = {}
        self.metric_poll_interval = metric_poll_interval
        self.primary_translate_store_url = primary_translate_store_url

        self.join_addr = join_addr
        self.node_id = node_id or self._load_node_id()
        self.node = Node(
            id=self.node_id, uri=self._uri(host, port),
            is_coordinator=is_coordinator and join_addr is None,
        )
        self.cluster = Cluster(
            node=self.node, replica_n=replica_n, hasher=hasher
        )
        # Install the [resilience] knobs on the cluster's health registry
        # (breakers, retry budget, hedging — cluster/health.py).
        if resilience_config is not None:
            self.cluster.health.configure(resilience_config.validate())
        self._static_hosts = cluster_hosts or []
        # Live-rebalance roles (cluster/rebalance.py): every node can be a
        # migration source and receiver; the coordinator object is built
        # on demand like the legacy resize coordinator.
        from ..cluster.rebalance import (
            MigrationSource, RebalanceConfig, RebalanceReceiver,
            RebalanceStats,
        )

        self.rebalance_config = (
            rebalance_config or RebalanceConfig()).validate()
        self.rebalance_stats = RebalanceStats()
        self.migration_source = MigrationSource(self)
        self.rebalance_receiver = RebalanceReceiver(self)
        self.rebalance_coordinator = None
        # Follower resize watchdog (legacy stop-the-world path): when a
        # cluster-status flipped this node to RESIZING, the monotonic time
        # it happened — a coordinator that died before delivering
        # instructions must not strand us RESIZING forever.
        self._resizing_since: Optional[float] = None
        # Idempotency for rebalance lifecycle messages: transport retries
        # can deliver begin/complete/abort twice, and e.g. a re-applied
        # complete would bump the routing epoch a second time.
        self._rebalance_seen: dict = {}

        # CDC change capture (cdc/, docs/cdc.md): built BEFORE the Holder
        # so the manager threads down Holder -> ... -> Fragment like the
        # snapshotter; the manager's holder/executor backrefs are wired
        # right after those exist. None = capture off (the default).
        from ..cdc import CdcConfig

        self.cdc_config = (cdc_config or CdcConfig()).validate()
        self.cdc = None
        if self.cdc_config.enabled:
            from ..cdc.manager import CdcManager
            from ..storage import StorageConfig

            self.cdc = CdcManager(
                self.cdc_config,
                os.path.join(data_dir, "cdc") if data_dir else None,
                storage_config or StorageConfig(),
            )
        self.holder = Holder(
            os.path.join(data_dir, "indexes") if data_dir else None,
            stats=self.stats,
            broadcast_shard=self._on_new_shard,
            storage_config=storage_config,
            delta_journal_ops=(
                engine_config.delta_journal_ops if engine_config else None),
            cdc=self.cdc,
            device=self.device,
        )
        if self.cdc is not None:
            self.cdc.holder = self.holder
        self.translate_store = TranslateStore(
            os.path.join(data_dir, "keys") if data_dir else None,
            read_only=primary_translate_store_url is not None,
        )
        # Cluster shared secret (reference gossip.Key, server/config.go:126:
        # memberlist transport encryption). Redesigned for the HTTP
        # membership plane: the file's contents ride every internal request
        # as X-Pilosa-Key and peers refuse inbound /internal/* without a
        # match — an unkeyed node can't join or deliver cluster messages.
        # Scope: /internal/* ONLY. /status (which heartbeat probes read)
        # and /cluster/resize/* stay public, matching the reference's HTTP
        # API posture (its memberlist key encrypts only UDP gossip; its
        # HTTP plane has no auth at all).
        self.internal_key: Optional[str] = None
        if internal_key_path:
            from .client import load_cluster_key

            self.internal_key = load_cluster_key(internal_key_path)
        self.client = InternalClient(
            skip_verify=tls_skip_verify, key=self.internal_key
        )
        self._probe_client = InternalClient(
            timeout=member_probe_timeout, skip_verify=tls_skip_verify,
            key=self.internal_key,
        )
        # [transport] pmux (docs/transport.md): persistent multiplexed
        # binary frames for node-to-node traffic with per-peer HTTP
        # fallback. The stats object always exists so the /debug/vars
        # `transport` group is present even when disabled; the client
        # half installs onto the SHARED InternalClient, so fan-out,
        # write forwarding, hints, migration, and CDC tailing all ride
        # the mux with zero call-site changes. The probe client stays
        # HTTP-only: liveness probes should measure the fallback path
        # a demoted peer would actually serve on.
        from .mux import MuxTransport, TransportConfig, TransportStats

        self.transport_config = (
            transport_config or TransportConfig()).validate()
        self.transport_stats = TransportStats()
        self.mux_transport = None
        self.mux_server = None
        if self.transport_config.enabled:
            self.mux_transport = MuxTransport(
                self.transport_config, key=self.internal_key,
                timeout=self.client.timeout, stats=self.transport_stats,
            )
            self.client.mux = self.mux_transport
        # [ingest] knobs consumed by the API's parallel import fan-out.
        from ..ingest import IngestConfig

        self.ingest_config = (ingest_config or IngestConfig()).validate()
        # [tier] residency budgets for the engine's plane tier manager
        # (docs/tiered-storage.md). A disk tier with no explicit path
        # spills under the data dir; a pathless (in-memory) server keeps
        # the disk tier off rather than spilling somewhere surprising.
        if tier_config is not None and data_dir and (
                tier_config.disk_bytes > 0 and not tier_config.disk_path):
            tier_config.disk_path = os.path.join(data_dir, "tier-spill")
        self.executor = Executor(
            self.holder,
            cluster=self.cluster,
            client=self.client,
            translate_store=self.translate_store,
            max_writes_per_request=max_writes_per_request,
            workers=executor_workers,
            engine_config=engine_config,
            tier_config=tier_config,
        )
        # Writes racing a live-rebalance cutover re-route/wait up to this
        # long for the commit broadcast before failing clean.
        self.executor.cutover_wait = self.rebalance_config.cutover_pause_max
        if self.cdc is not None:
            # Standing-query evaluation runs real read queries.
            self.cdc.executor = self.executor
        # Durable write replication (cluster/hints.py, docs/durability.md
        # "Write-path consistency"): per-peer hint logs under the data
        # dir catch writes a replica missed (breaker open / transport
        # failure), a background daemon replays them when the peer
        # returns, and the [replication] write-consistency level gates
        # write acks. The store rides the [storage] fsync policy so a
        # hint's durability matches the WAL's.
        from ..cluster.hints import HintStore, ReplicationConfig

        self.replication_config = (
            replication_config or ReplicationConfig()).validate()
        self.hints = HintStore(
            os.path.join(data_dir, "hints") if data_dir else None,
            config=self.replication_config,
            storage_config=storage_config,
        )
        self.executor.hints = self.hints
        self.executor.replication_config = self.replication_config
        # Query scheduler (sched/): admission control + deadlines +
        # cross-query micro-batching, the gate between the HTTP handler
        # and the executor. The batcher pulls the engine LAZILY so
        # constructing a server never opens the device backend.
        from ..sched import (
            CLASS_INTERACTIVE, MicroBatcher, QosConfig, QueryScheduler,
            SchedulerConfig, TenantLedger,
        )

        sched_cfg = scheduler_config or SchedulerConfig()
        # Per-tenant QoS ledger ([qos], docs/scheduler.md): trace-charged
        # token buckets the scheduler consults at admission. Always
        # constructed — with rate 0 (the default) it is disabled and
        # admission short-circuits past it.
        self.qos_config = (qos_config or QosConfig()).validate()
        self.qos = TenantLedger(self.qos_config)
        self.scheduler = QueryScheduler(
            sched_cfg, stats=self.stats, qos=self.qos)
        # Traffic signal for the tier manager's predictive prefetch: the
        # scheduler's per-index query counters tell the prefetcher which
        # indexes are hot RIGHT NOW. Wired before any query can build the
        # engine (the executor's engine property reads it lazily).
        self.executor.tier_traffic_fn = self.scheduler.index_traffic
        self.batcher = MicroBatcher(
            lambda: self.executor.engine,
            window=sched_cfg.batch_window,
            window_max=sched_cfg.batch_window_max,
            batch_max=sched_cfg.batch_max,
            # Interactive pressure only: batch-class imports are never
            # coalescing candidates, so they must not hold the window open.
            depth_fn=lambda: self.scheduler.pressure(CLASS_INTERACTIVE),
            stats=self.stats,
        )
        self.executor.batcher = self.batcher
        # Per-query trace recorder (docs/observability.md): sampled stage
        # spans through the whole serving path, /debug/traces ring,
        # slow-query log, per-stage histograms for /metrics. The handler
        # starts/adopts traces; everything downstream records via the
        # obs contextvar.
        from ..obs import GcHook, ObsConfig, TraceRecorder

        self.obs_config = (obs_config or ObsConfig()).validate()
        self.trace_recorder = TraceRecorder(
            self.obs_config, stats=self.stats, logger=self.logger,
        )
        # Collections' pauses (open to close): gc.pause spans in the
        # trace a collection stopped, and the runtime gauges
        # gcCollectionsGen<g> / gcPauseMsGen<g> / gcPauseMs. Every
        # server of a process counts every pause of the process.
        self.gc_pauses = GcHook()
        self.api = API(self)
        # Geo replication (geo/, docs/geo-replication.md): follower
        # clusters tail this (or another) cluster's CDC stream. Built
        # after the API (the tailer applies through api.apply_hint_ops)
        # with its OWN client — tail long-polls must not contend with
        # the executor's fan-out pool. None = [geo] role "none".
        from ..geo import GeoConfig

        self.geo_config = (geo_config or GeoConfig()).validate()
        self.geo = None
        if self.geo_config.role != "none":
            from ..geo.manager import GeoManager

            self.geo = GeoManager(
                self,
                self.geo_config,
                os.path.join(data_dir, "geo") if data_dir else None,
                storage_config=storage_config,
                client=InternalClient(
                    skip_verify=tls_skip_verify, key=self.internal_key,
                ),
            )
            self.executor.geo = self.geo
        # Trace-driven autoscaler ([autoscale], docs/rebalance.md):
        # coordinator-only control loop turning sustained load into
        # rebalance join/leave, with full revert on abort. Always
        # constructed (jax-free, cheap); the monitor thread only spawns
        # when interval > 0.
        from ..cluster.autoscale import AutoscaleConfig, AutoscaleController

        self.autoscale_config = (
            autoscale_config or AutoscaleConfig()).validate()
        self.autoscaler = AutoscaleController(self, self.autoscale_config)
        self.handler = Handler(
            self.api, logger=self.logger, allowed_origins=allowed_origins,
            internal_key=self.internal_key,
        )
        if self.transport_config.enabled:
            from .mux import MuxServer

            self.mux_server = MuxServer(
                self.handler, self.transport_config,
                key=self.internal_key, stats=self.transport_stats,
            )

        from ..cluster.topology import Topology
        from ..diagnostics import DiagnosticsCollector

        self.topology = Topology.load(
            os.path.join(data_dir, ".topology") if data_dir else None
        )
        self.diagnostics = DiagnosticsCollector(
            self, endpoint=diagnostics_endpoint, interval=diagnostics_interval,
            logger=self.logger,
        )
        self.resize_coordinator = None  # set on demand by coordinators
        self.collective = None  # CollectiveBackend, constructed in open()
        # Resolved [collective] section (None = backend env fallbacks).
        self.collective_config = collective_config
        self._httpd = None
        self._http_thread = None
        self._join_lock = threading.Lock()  # admission may race solicit vs HTTP
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.opened = False

    # ------------------------------------------------------------ lifecycle

    def _uri(self, host: str, port: int) -> str:
        """Node URI; carries the scheme only when non-default (https)."""
        return f"https://{host}:{port}" if self.scheme == "https" else f"{host}:{port}"

    def _ssl_context(self):
        if self.scheme != "https":
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.tls_certificate, self.tls_certificate_key)
        return ctx

    def _load_node_id(self) -> str:
        """Stable node id persisted in the data dir (reference holder.go:518)."""
        if not self.data_dir:
            return uuid.uuid4().hex[:12]
        os.makedirs(self.data_dir, exist_ok=True)
        id_path = os.path.join(self.data_dir, ".id")
        if os.path.exists(id_path):
            with open(id_path) as f:
                return f.read().strip()
        node_id = uuid.uuid4().hex[:12]
        with open(id_path, "w") as f:
            f.write(node_id)
        return node_id

    def open(self) -> "Server":
        """Open sequence (reference server.go:311-357)."""
        self._raise_file_limit()
        self.gc_pauses.open()
        # Collective query plane (leader + peer sides). Constructed for
        # every server; one-process jobs serve through it only with
        # `[collective] single-process` on a one-node cluster.
        from ..parallel import distributed
        from ..parallel.collective import DEFAULT_TIMEOUT_MS, CollectiveBackend

        self.collective = CollectiveBackend(self, self.collective_config)
        # Multi-process job: join the torch.distributed job when
        # configured (PILOSA_JAX_COORDINATOR/NUM_PROCESSES/PROCESS_ID, the
        # reference's names). No-op for one-process deployments. The
        # reduce group's timeout is the collective plane's barrier
        # timeout; its device is the plane's partition 0 on this rank,
        # which picks the job's reduce backend (NCCL or gloo).
        timeout_ms = (self.collective_config.timeout_ms
                      if self.collective_config is not None
                      else DEFAULT_TIMEOUT_MS)
        if distributed.initialize(timeout_ms=timeout_ms,
                                  reduce_device=self.collective.partitions()[0]):
            self.node.process_idx = distributed.process_index()
            self.logger.info(
                "joined torch.distributed job: rank %d of %d, reduce backend %s%s",
                distributed.process_index(), distributed.process_count(),
                distributed.reduce_backend(),
                f" (no group: {distributed.group_error()})"
                if distributed.group_error() else "")
        self.executor.collective = self.collective
        self.executor.logger = self.logger
        self.translate_store.open()
        self._httpd, self._http_thread, actual_port = serve(
            self.handler, self.host, self.port, ssl_context=self._ssl_context()
        )
        self.port = actual_port
        self.node.uri = self._uri(self.host, actual_port)

        # Static cluster membership: node list from config. Node identity
        # must agree across peers without gossip, so in static mode the URI
        # is the node id (reference `cluster.disabled` mode behaves the same
        # way, cluster.go:1804+).
        if self._static_hosts:
            def hostport(u: str) -> str:
                return u.split("://", 1)[-1]

            def normalize(u: str) -> str:
                # Entries may be schemeless or http://-prefixed; node ids must
                # agree across peers, so the canonical form is host:port for
                # http and scheme://host:port otherwise — an https cluster
                # still needs peers dialed over https.
                if u.startswith("http://"):
                    u = u[len("http://"):]
                if "://" in u or self.scheme == "http":
                    return u
                return f"{self.scheme}://{u}"

            self.node.id = normalize(self.node.uri)
            self.node.uri = self.node.id
            self.node_id = self.node.id
            self.cluster.nodes = [self.node]
            for host in self._static_hosts:
                if hostport(host) != hostport(self.node.uri):
                    peer = normalize(host)
                    self.cluster.add_node(Node(id=peer, uri=peer))
            self.cluster.nodes.sort(key=lambda n: n.id)
            # Re-apply persisted coordinator flags: a runtime promotion
            # (coordinator failover) must survive restart — the config only
            # knows the ORIGINAL role, so a promoted successor restarting
            # on config alone would silently drop the claim and leave the
            # cluster with zero coordinators. Only when the checkpoint
            # covers this node (else it describes some other membership);
            # an operator overrides with set-coordinator or by removing
            # the .topology file.
            saved_flags = {n.id: n.is_coordinator for n in self.topology.nodes}
            if saved_flags.get(self.node.id) is not None and any(
                saved_flags.values()
            ):
                for n in self.cluster.nodes:
                    if n.id in saved_flags:
                        n.is_coordinator = saved_flags[n.id]

        # pmux listener (docs/transport.md): opens on http_port +
        # port-offset once the real HTTP port is known (tests bind port
        # 0). A bind failure is survivable — peers' handshakes fail and
        # they demote this node to HTTP.
        if self.mux_server is not None:
            self.mux_transport.node_uri = self.node.uri
            self.mux_server.open(self.host, self.port)

        self.holder.open()
        if self._needs_topology_quorum():
            # Reference considerTopology + haveTopologyAgreement
            # (cluster.go:1582-1613, 941-946): a restarting coordinator with
            # a persisted multi-node topology stays STARTING until every
            # previously-known node rejoins — serving or resizing against a
            # partial cluster could lose acknowledged writes.
            self.cluster.state = STATE_STARTING
            pending = sorted(set(self.topology.node_ids) - {self.node.id})
            self.logger.info(
                "cluster STARTING: waiting for topology quorum, pending nodes: %s",
                pending,
            )
            # Actively solicit prior members: if only the coordinator
            # restarted, the healthy peers have no reason to re-send
            # node-join (they only do so from their own open()), so a
            # passive wait wedges the cluster in STARTING forever. Probing
            # each persisted member and treating a live /status as a rejoin
            # is our stand-in for the reference's memberlist re-join events
            # (cluster.go:1615 nodeJoin via gossip).
            self._spawn(self._solicit_topology_members, 0.5)
        else:
            self.cluster.state = STATE_NORMAL

        if self.anti_entropy_interval > 0 and self.cluster.replica_n > 1:
            # Jittered: a cluster restart must not stampede every node's
            # sweep onto the same instant (see anti_entropy_jitter above).
            self._spawn(self._monitor_anti_entropy, self.anti_entropy_interval,
                        jitter=self.anti_entropy_jitter)
        if self.replication_config.deliver_interval > 0:
            self._spawn(self._monitor_hints,
                        self.replication_config.deliver_interval)
        if self.cache_flush_interval > 0:
            self._spawn(self._monitor_cache_flush, self.cache_flush_interval)
        if self.cdc is not None and self.cdc_config.standing_interval > 0:
            # The staleness sweep: cheap (an epoch compare per
            # registration) when nothing changed, so a short cadence is
            # safe. 0 = tests drive evaluate_once() by hand.
            self._spawn(self._monitor_standing_queries,
                        self.cdc_config.standing_interval)
        if self.metric_poll_interval > 0:
            self._spawn(self._monitor_runtime, self.metric_poll_interval)
        if self.autoscale_config.interval > 0:
            # Jittered like anti-entropy: a restarted fleet's control
            # loops must not all sample at the same instants (only the
            # coordinator acts, but every node runs the timer in case of
            # failover promotion).
            self._spawn(self._monitor_autoscale,
                        self.autoscale_config.interval, jitter=0.1)
        if self.primary_translate_store_url:
            self._spawn(self._monitor_translate_replication, 1.0)
        if self.diagnostics.interval > 0:
            self._spawn(self._monitor_diagnostics, self.diagnostics.interval)
        if self.member_monitor_interval > 0 and (
            len(self.cluster.nodes) > 1 or self.join_addr
        ):
            # Joiners start with only themselves in the node list; the
            # monitor must still run so they pick up peer schema and
            # max-shard state after admission.
            self._spawn(self._monitor_members, self.member_monitor_interval)
        if self.cluster.state == STATE_NORMAL:
            # While STARTING on topology quorum the persisted node list is
            # the source of truth for who must rejoin — don't clobber it
            # with the partial membership.
            self.topology.save(self.cluster.nodes)
        if self.geo is not None:
            # After the HTTP plane is up (the fence thread advertises
            # node.uri, which is final only post-bind) and the holder is
            # open (the tailer applies into live fragments).
            self.geo.start()
        self.opened = True
        if self.join_addr:
            self._join_cluster()
        elif (
            self.node.is_coordinator
            and self.data_dir
            and self.cluster.state == STATE_NORMAL
            and self.rebalance_config.online
            and os.path.exists(os.path.join(self.data_dir, ".rebalance.json"))
        ):
            # A checkpointed rebalance job survived a coordinator restart:
            # resume it (committed shards skip straight past) once the
            # HTTP plane is up and peers have had a beat to answer.
            def _resume():
                time.sleep(1.0)
                if not self._stop.is_set():
                    self.maybe_resume_rebalance()

            threading.Thread(
                target=_resume, name="rebalance-resume", daemon=True
            ).start()
        return self

    def _needs_topology_quorum(self) -> bool:
        """True when this coordinator must wait for previously-known nodes
        before going NORMAL. Static clusters skip the check (the reference's
        Static mode does too); joiners are admitted by the coordinator."""
        if self._static_hosts or self.join_addr or not self.node.is_coordinator:
            return False
        known = set(self.topology.node_ids)
        if not known or known == {self.node.id}:
            return False
        if self.node.id not in known:
            raise PilosaError(
                f"coordinator {self.node.id} is not in topology: "
                f"{self.topology.node_ids}"
            )
        return not known <= {n.id for n in self.cluster.nodes}

    def _topology_agreement_reached(self) -> bool:
        return set(self.topology.node_ids) <= {n.id for n in self.cluster.nodes}

    def _join_cluster(self) -> None:
        """Join an existing cluster (the reference's gossip join event,
        cluster.go:1615 ReceiveEvent -> nodeJoin). In static mode node id ==
        uri; the coordinator admits us (triggering a resize if data exists)
        and broadcasts the new cluster status."""
        self.node.id = self.node.uri
        self.node_id = self.node.uri
        self.cluster.nodes = [self.node]
        self.client.send_message(
            Node(id=self.join_addr, uri=self.join_addr),
            {"type": "node-join", "node": self.node.to_dict()},
        )
        deadline = time.time() + 30
        while time.time() < deadline:
            if len(self.cluster.nodes) > 1 and self.cluster.node_by_id(self.node.id):
                # Admission while the coordinator is STARTING on topology
                # quorum counts as a successful join: the cluster goes
                # NORMAL once the remaining known nodes arrive, which may
                # take arbitrarily long in a staggered restart.
                if self.cluster.state in (STATE_NORMAL, STATE_STARTING):
                    return
            if self.cluster.next_nodes is not None and any(
                n.id == self.node.id for n in self.cluster.next_nodes
            ):
                # Admission via a live rebalance: this node is in the
                # TARGET membership and shard migration is running; it
                # joins `nodes` when the job completes. The join call
                # itself is done.
                return
            time.sleep(0.05)
        raise PilosaError(f"timed out joining cluster via {self.join_addr}")

    def _solicit_topology_members(self) -> None:
        """While STARTING on topology quorum, probe each persisted prior
        member; a live /status is treated as a rejoin. Covers the
        only-the-coordinator-restarted case where no peer will ever re-send
        node-join on its own (see ADVICE r2; reference analog is memberlist
        gossip re-join, cluster.go:1615)."""
        if self.cluster.state != STATE_STARTING:
            return
        for node in list(self.topology.nodes):
            if self.cluster.state != STATE_STARTING:
                return
            if node.id == self.node.id or self.cluster.node_by_id(node.id):
                continue
            try:
                self._probe_client.status(node.uri)
            except PilosaError:
                continue
            # Re-admit with the coordinator flag cleared: this node is the
            # acting coordinator now, whatever the checkpoint says.
            rejoined = Node(id=node.id, uri=node.uri)
            self.logger.info("soliciting prior member %s: alive, rejoining", node.id)
            self.handle_node_join(rejoined)

    def handle_node_join(self, node: Node) -> None:
        """Coordinator-side admission (cluster.go:1638 nodeJoin)."""
        if not self.node.is_coordinator:
            coordinator = self.cluster.coordinator_node()
            if coordinator is None:
                raise PilosaError("no coordinator to forward join to")
            self.client.send_message(
                coordinator, {"type": "node-join", "node": node.to_dict()}
            )
            return
        with self._join_lock:
            # pilint: allow-blocking(admission is a rare control-plane op: status/schema pushes stay under the lock so concurrent joins can't interleave topology broadcasts)
            self._admit_node(node)

    def _admit_node(self, node: Node) -> None:
        if self.cluster.node_by_id(node.id) is not None:
            # Already a member: re-send the cluster status (idempotent join).
            self.client.send_message(node, self._status_message())
            return
        if self.cluster.state == STATE_STARTING and self.topology.node_ids:
            # Topology-quorum mode (reference nodeJoin, cluster.go:1641-1662):
            # these are prior members rejoining after a restart, NOT a
            # membership change — no resize. Unknown hosts are refused until
            # the cluster is NORMAL.
            if node.id not in self.topology.node_ids:
                self.logger.info("refusing join during STARTING: %s not in topology",
                                 node.id)
                return
            self.cluster.add_node(node)
            if self._topology_agreement_reached():
                self.cluster.state = STATE_NORMAL
                self.topology.save(self.cluster.nodes)
                self.logger.info("topology quorum reached; cluster NORMAL")
                self.broadcast_message(self._status_message())
            # While still STARTING, only the rejoining node hears back —
            # broadcasting partial membership would make peers overwrite
            # their persisted topology with an incomplete node list.
            self.client.send_message(node, self._status_message())
            self._send_schema(node)
            return
        new_nodes = sorted(self.cluster.nodes + [node], key=lambda n: n.id)
        self._retopologize(new_nodes, extra_recipients=[node])
        self._send_schema(node)

    def _send_schema(self, node: Node) -> None:
        """Push the local schema to a (re)joining node so it converges
        immediately rather than waiting for its next member-monitor probe
        (reference applies schema via gossip NodeStatus merge,
        gossip/gossip.go:240-273 MergeRemoteState)."""
        schema = self.holder.schema()
        if not schema:
            return
        try:
            self.client.send_message(node, {"type": "schema", "schema": schema})
        except ClientError as e:
            self.logger.error("schema push to %s failed: %s", node.id, e)

    def handle_node_leave(self, node_id: str) -> None:
        """Coordinator-side removal (api.go:777 RemoveNode): shards the
        leaving node exclusively held are re-fetched by new owners before
        the status flips (it stays reachable as a source during the job)."""
        if not self.node.is_coordinator:
            coordinator = self.cluster.coordinator_node()
            if coordinator is None:
                raise PilosaError("no coordinator to forward leave to")
            self.client.send_message(
                coordinator, {"type": "node-leave", "nodeID": node_id}
            )
            return
        if self.cluster.node_by_id(node_id) is None:
            return
        new_nodes = [n for n in self.cluster.nodes if n.id != node_id]
        self._retopologize(new_nodes)

    def _retopologize(self, new_nodes: List[Node], extra_recipients=()) -> None:
        """Apply a membership change: resize job when data exists (the
        live online rebalance by default, the legacy stop-the-world
        resizeJob when [rebalance] online=false), plain status broadcast
        otherwise."""
        if self.holder.indexes:
            if self.rebalance_config.online:
                from ..cluster.rebalance import RebalanceCoordinator

                if self.rebalance_coordinator is None:
                    self.rebalance_coordinator = RebalanceCoordinator(self)
                self.rebalance_coordinator.begin(new_nodes)
                return
            from ..cluster.resize import ResizeCoordinator

            if self.resize_coordinator is None:
                self.resize_coordinator = ResizeCoordinator(self)
            self.resize_coordinator.begin(new_nodes)
        else:
            self.cluster.nodes = list(new_nodes)
            live = {n.id for n in new_nodes}
            self.cluster.health.prune_absent(live)
            for nid in [k for k in self._probe_failures if k not in live]:
                del self._probe_failures[nid]
            self.topology.save(self.cluster.nodes)
            self.broadcast_message(self._status_message())
            for node in extra_recipients:
                if all(n.id != node.id for n in self.cluster.nodes):
                    self.client.send_message(node, self._status_message())

    def _status_message(self) -> dict:
        return {
            "type": "cluster-status",
            "state": self.cluster.state,
            "nodes": [n.to_dict() for n in self.cluster.nodes],
        }

    def close(self) -> None:
        self._stop.set()
        if self.cdc is not None:
            # Unpark /cdc/stream long-poll waiters BEFORE the HTTP
            # shutdown: a handler thread blocked in a stream wait would
            # otherwise pin shutdown() until its poll timeout expires.
            # The logs stay open; this only releases parked readers.
            self.cdc.interrupt()
        if self.geo is not None:
            # Stop tailing/fencing before the holder flushes: the tail
            # thread applies into live fragments.
            self.geo.close()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        # Mux halves before executor.close: tearing the transport down
        # fails any pending waiters promptly instead of letting executor
        # threads ride out full response timeouts.
        if self.mux_server is not None:
            self.mux_server.close()
        if self.mux_transport is not None:
            self.mux_transport.close()
        if self.collective is not None:
            self.collective.close()
        # Executor.close also drains the shared internal client's
        # keep-alive pools; the probe client has its own.
        self.executor.close()
        self._probe_client.close()
        self.hints.close()
        if self.cdc is not None:
            # After the holder stops accepting writes would be ideal, but
            # append() on a closed log is a no-op return, so closing here
            # (before holder.close flushes fragments) is safe either way.
            self.cdc.close()
        self.holder.close()
        self.translate_store.close()
        self.gc_pauses.close()
        self.opened = False

    def _spawn(self, fn, interval: float, jitter: float = 0.0) -> None:
        """Run `fn` every `interval` seconds on a daemon thread. `jitter`
        (a fraction of the interval) desynchronizes a fleet: the first
        wait starts anywhere in [0, interval*(1+jitter)] and every later
        period varies by ±jitter, so identically-configured nodes
        restarted together drift apart instead of firing in lockstep."""
        import random

        def loop():
            first = True
            while True:
                wait = interval
                if jitter > 0:
                    if first:
                        wait = random.uniform(0, interval * (1.0 + jitter))
                    else:
                        wait = interval * (
                            1.0 + random.uniform(-jitter, jitter))
                first = False
                # Event.wait(negative) returns immediately — never let a
                # mis-set jitter turn the timer into a busy loop.
                if self._stop.wait(max(wait, 0.0)):
                    return
                try:
                    fn()
                except Exception as e:  # pragma: no cover - monitor resilience
                    self.logger.error("monitor error: %s", e)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)

    # ---------------------------------------------------------- monitors

    def _monitor_anti_entropy(self) -> None:
        from ..cluster.syncer import HolderSyncer

        start = time.monotonic()
        self.stats.count("AntiEntropy", 1)
        HolderSyncer(self).sync_holder()
        self.stats.histogram("AntiEntropyDuration", (time.monotonic() - start) * 1000)

    def _monitor_cache_flush(self) -> None:
        self.holder.flush_caches()

    def _monitor_standing_queries(self) -> None:
        """Standing-query staleness sweep (cdc/standing.py): re-evaluate
        registrations whose index write epoch moved, push only changed
        results to their long-poll waiters."""
        self.cdc.standing.evaluate_once()

    def _monitor_autoscale(self) -> None:
        """Autoscale control step (cluster/autoscale.py): sample load,
        decide via hysteresis, act through the coordinator's join/leave
        path. Single-flight inside step(); non-coordinators sample-and-
        return so a failover promotion starts from a warm window."""
        self.autoscaler.step()

    def _monitor_hints(self) -> None:
        """Hinted-handoff delivery sweep (cluster/hints.py): replay
        pending per-peer hint logs toward peers whose breakers admit a
        request. Backoff between retries IS the peer's breaker backoff,
        and a delivery success doubles as the half-open probe that
        re-closes it."""
        self.hints.deliver_once(self.cluster, self.client,
                                logger=self.logger)

    def _monitor_diagnostics(self) -> None:
        """Periodic telemetry flush + best-effort version check
        (reference server.go:605-653 monitorDiagnostics)."""
        self.diagnostics.flush()
        if self.diagnostics.endpoint:
            # Version URL is a sibling of the diagnostics endpoint (the
            # collector derives it; diagnostics.go defaultVersionCheckURL).
            self.diagnostics.check_version()

    @staticmethod
    def _raise_file_limit() -> None:
        """Raise RLIMIT_NOFILE to its hard max (reference holder.go:470):
        one open WAL handle per fragment needs headroom."""
        try:
            import resource

            soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
            if soft < hard:
                resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
        except (ImportError, ValueError, OSError):
            pass

    def _monitor_runtime(self) -> None:
        """Process gauges (reference server.go:655-697 monitorRuntime +
        gcnotify GC counting)."""
        import gc
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        self.stats.gauge("maxRSS", usage.ru_maxrss)
        self.stats.gauge("threads", threading.active_count())
        counts = gc.get_stats()
        self.stats.gauge("garbageCollections", sum(s["collections"] for s in counts))
        try:
            self.stats.gauge("openFiles", len(os.listdir("/proc/self/fd")))
        except OSError:
            pass

    def publish_gc_pauses(self) -> None:
        """The gc hook's collections and pause milliseconds by generation
        since this server opened, as runtime gauges: published at each
        /debug/vars scrape (and so each /metrics scrape)."""
        for name, value in self.gc_pauses.snapshot().items():
            self.stats.gauge(name, value)

    def _monitor_members(self) -> None:
        """Heartbeat failure detector (the reference's memberlist gossip
        probes, gossip/gossip.go). Probes peer /status; marks nodes
        unavailable so the executor routes around them, and re-marks them
        available on recovery."""
        self._check_resize_watchdog()
        for node in list(self.cluster.nodes):
            if node.id == self.node.id:
                continue
            try:
                status = self._probe_client.status(node.uri)
            except PilosaError:
                self._probe_failures[node.id] = \
                    self._probe_failures.get(node.id, 0) + 1
                was_down = node.id in self.cluster.unavailable
                # Copy-load grace (live rebalance): a peer streaming
                # migration data answers probes slowly under expected
                # load — require proportionally more consecutive misses
                # before rerouting every shard it owns.
                probe_threshold = self.member_probe_failures
                if self.cluster.health.in_copy_grace(node.id):
                    probe_threshold *= self.cluster.health.COPY_GRACE_MULT
                if was_down or (
                    self._probe_failures[node.id] >= probe_threshold
                ):
                    # Flap damping (gossip.probe-failures): a single
                    # transient probe timeout no longer reroutes every
                    # shard the peer owns; a peer the data path already
                    # ejected stays down without waiting out the streak.
                    if not was_down:
                        self.logger.info("node %s marked unavailable "
                                         "(%d consecutive failed probes)",
                                         node.id,
                                         self._probe_failures[node.id])
                    self.cluster.mark_unavailable(node.id)
                if node.is_coordinator:
                    self._consider_coordinator_failover(node)
            else:
                self._probe_failures[node.id] = 0
                if node.id in self.cluster.unavailable:
                    self.logger.info("node %s recovered", node.id)
                self.cluster.mark_available(node.id)
                self._reconcile_dual_coordinator(node, status)
                # Merge the peer's NodeStatus (gossip push/pull sync,
                # gossip/gossip.go:240-273): schema first — a node that was
                # down during a create-field broadcast converges here — then
                # max shards. apply_schema is create-if-not-exists, so the
                # merge is a monotonic union exactly like the reference's
                # MergeRemoteState.
                schema = status.get("schema")
                if schema:
                    try:
                        self.holder.apply_schema(schema)
                    except PilosaError as e:
                        self.logger.error(
                            "schema merge from %s failed: %s", node.id, e
                        )
                for index_name, max_shard in status.get("maxShards", {}).items():
                    idx = self.holder.index(index_name)
                    if idx is not None:
                        idx.set_remote_max_shard(max_shard)
                # The peer's jax process index rides its status (static
                # clusters build peer Nodes from config, which can't know
                # it); the collective plane needs every node's index.
                if status.get("processIdx") is not None:
                    node.process_idx = status["processIdx"]
                # Learn the peer's own coordinator claim the same way: a
                # static config only sets the LOCAL node's flag, so without
                # this merge a non-coordinator node never knows which peer
                # to forward joins to — and cannot detect the coordinator's
                # death for failover. Conflicting claims are settled by
                # _reconcile_dual_coordinator (lowest id wins). Merge ONLY
                # when the payload actually carries a nodes list: a partial
                # response (older build, truncated body) must not silently
                # clear the peer's flag and erase the only known
                # coordinator.
                if "nodes" in status:
                    node.is_coordinator = any(
                        n.get("id") == node.id and n.get("isCoordinator")
                        for n in status.get("nodes", [])
                    )
                if node.is_coordinator:
                    # An ALIVE self-claimer supersedes a dead flagged
                    # holdover (a survivor that missed the failover
                    # broadcast would otherwise route joins to the corpse
                    # forever — no probe of the dead node can ever clear
                    # its flag).
                    for other in self.cluster.nodes:
                        if (
                            other.id != node.id
                            and other.is_coordinator
                            and other.id in self.cluster.unavailable
                        ):
                            other.is_coordinator = False
                elif (
                    not self.node.is_coordinator
                    and self.cluster.coordinator_node() is None
                ):
                    # We know of NO coordinator (e.g. this node started
                    # after the coordinator died): adopt the peer's view of
                    # who holds the role — without this, a late-starting
                    # successor can never learn whose death to detect.
                    claimed = next(
                        (x for x in status.get("nodes", [])
                         if x.get("isCoordinator")),
                        None,
                    )
                    if claimed is not None:
                        tgt = self.cluster.node_by_id(claimed.get("id"))
                        if tgt is not None:
                            tgt.is_coordinator = True
                # Topology anti-entropy: the COORDINATOR on a newer
                # routing epoch with NO rebalance in flight holds the
                # authoritative post-job topology this node missed (the
                # rebalance-complete/abort broadcasts are retried but not
                # guaranteed — a brown-out can eat every attempt, leaving
                # this follower mid-rebalance forever with un-GC'd
                # fragments for shards it no longer owns). Adopt it with
                # the full completion side effects. Coordinator-only — so
                # this sits AFTER the claim merge above: a non-participant
                # that merely saw a cutover-commit also shows (high epoch,
                # midRebalance=False) but still carries the OLD nodes
                # list; adopting that mid-job would wipe a participant's
                # next_nodes/migrated overrides and route cut-over shards
                # back to their old owners. Skip while coordinating a job
                # ourselves: the coordinator's own commit drives the epoch
                # forward, never a probe.
                peer_epoch = status.get("routingEpoch")
                if (
                    peer_epoch is not None
                    and peer_epoch > self.cluster.routing_epoch
                    and not status.get("midRebalance")
                    and node.is_coordinator
                    and status.get("nodes")
                    and not (self.rebalance_coordinator is not None
                             and self.rebalance_coordinator.job is not None)
                ):
                    self.logger.info(
                        "adopting committed topology from %s (epoch %d > "
                        "local %d)", node.id, peer_epoch,
                        self.cluster.routing_epoch)
                    self._adopt_committed_topology(
                        [Node.from_dict(n) for n in status["nodes"]],
                        peer_epoch, anti_entropy=True)
                # A probed peer reporting STARTING without us in its node
                # list is a restarted coordinator waiting on topology
                # quorum: re-send node-join so it can count us (the
                # reference gets this for free from memberlist join events).
                if status.get("state") == STATE_STARTING and not any(
                    n.get("id") == self.node.id for n in status.get("nodes", [])
                ):
                    try:
                        self.client.send_message(
                            node,
                            {"type": "node-join", "node": self.node.to_dict()},
                        )
                    except ClientError:
                        pass

    def _consider_coordinator_failover(self, dead: Node) -> None:
        """Converge on a deterministic successor when the coordinator dies
        (the reference requires a manual SetCoordinator, api.go:777, and
        its joins/resizes block until one arrives — considerTopology,
        cluster.go:1582-1613). Rules:
          - only after coordinator_failover_probes CONSECUTIVE failed
            heartbeats (one blip must not depose a healthy coordinator);
          - only the successor (lowest node id among members not marked
            unavailable) promotes itself — everyone else keeps probing and
            learns the outcome from its set-coordinator broadcast;
          - only with a strict majority of the membership alive, so a
            partitioned minority can never elect a second coordinator."""
        if self.coordinator_failover_probes <= 0:
            return
        if self._probe_failures.get(dead.id, 0) < self.coordinator_failover_probes:
            return
        alive = [
            n for n in self.cluster.nodes
            if n.id not in self.cluster.unavailable
        ]
        if 2 * len(alive) <= len(self.cluster.nodes):
            return  # no strict majority: could be our own partition
        successor = min(alive, key=lambda n: n.id)
        if successor.id != self.node.id:
            return
        self.logger.info(
            "coordinator %s failed %d consecutive probes; assuming "
            "coordinatorship as deterministic successor",
            dead.id, self._probe_failures.get(dead.id, 0),
        )
        for n in self.cluster.nodes:
            n.is_coordinator = n.id == self.node.id
        self.node.is_coordinator = True
        self.topology.save(self.cluster.nodes)
        for n in alive:
            if n.id == self.node.id:
                continue
            try:
                self.client.send_message(
                    n, {"type": "set-coordinator", "nodeID": self.node.id}
                )
            except ClientError as e:
                self.logger.error(
                    "set-coordinator broadcast to %s failed: %s", n.id, e)

    def _reconcile_dual_coordinator(self, peer: Node, status: dict) -> None:
        """After a failover, a restarted old coordinator and the successor
        can both claim the role. Deterministic resolution: lowest node id
        wins; the loser clears its flag and adopts the winner. Applies
        ONLY when both this node and the probed peer claim coordinatorship
        themselves — a configured coordinator that simply isn't the lowest
        id is never deposed by this rule."""
        if not self.node.is_coordinator:
            return
        peer_id = status.get("localID")
        peer_coord = next(
            (n for n in status.get("nodes", []) if n.get("isCoordinator")),
            None,
        )
        if not peer_coord or peer_coord.get("id") != peer_id:
            return  # peer does not claim the role itself
        if peer_id == self.node.id:
            return
        if peer_id < self.node.id:
            self.logger.info(
                "dual coordinator detected; yielding to %s (lower id)", peer_id)
            for n in self.cluster.nodes:
                n.is_coordinator = n.id == peer_id
            self.node.is_coordinator = False
            # Persist the DEMOTION too: open() restores flags from the
            # checkpoint with authority over config, so a yield that only
            # lives in memory would resurrect this node as a second
            # coordinator on its next restart.
            self.topology.save(self.cluster.nodes)
        else:
            try:
                self.client.send_message(
                    peer, {"type": "set-coordinator", "nodeID": self.node.id}
                )
            except ClientError:
                pass

    def _monitor_translate_replication(self) -> None:
        data = self.client.translate_data(
            self.primary_translate_store_url, self.translate_store.size()
        )
        if data:
            self.translate_store.apply_log(data)

    # ---------------------------------------------------------- messaging

    def broadcast_message(self, msg: dict) -> None:
        """Send a cluster message to every other node (broadcast.go SendSync)."""
        for node in self.cluster.nodes:
            if node.id == self.node.id:
                continue
            try:
                self.client.send_message(node, msg)
            except ClientError as e:
                self.logger.error("broadcast to %s failed: %s", node.id, e)

    def receive_message(self, msg: dict) -> None:
        """Dispatch the 16 cluster message types (server.go:434-518)."""
        from ..core.field import FieldOptions
        from ..core.index import IndexOptions

        typ = msg.get("type")
        if typ == "create-index":
            self.holder.create_index_if_not_exists(
                msg["index"], IndexOptions.from_dict(msg.get("options", {}))
            )
        elif typ == "delete-index":
            try:
                self.holder.delete_index(msg["index"])
            except PilosaError:
                pass
        elif typ == "create-field":
            idx = self.holder.index(msg["index"])
            if idx is not None:
                idx.create_field_if_not_exists(
                    msg["field"], FieldOptions.from_dict(msg.get("options", {}))
                )
        elif typ == "delete-field":
            idx = self.holder.index(msg["index"])
            if idx is not None:
                try:
                    idx.delete_field(msg["field"])
                except PilosaError:
                    pass
        elif typ == "create-view":
            fld = self.holder.field(msg["index"], msg["field"])
            if fld is not None:
                fld.create_view_if_not_exists(msg["view"])
        elif typ == "delete-view":
            fld = self.holder.field(msg["index"], msg["field"])
            if fld is not None and msg["view"] in fld.views:
                fld.views.pop(msg["view"]).close()
        elif typ == "create-shard":
            fld = self.holder.field(msg["index"], msg["field"])
            if fld is not None:
                view = fld.create_view_if_not_exists(msg.get("view", "standard"))
                # broadcast=False: applying a peer's message must not echo it.
                view.create_fragment_if_not_exists(msg["shard"], broadcast=False)
            idx = self.holder.index(msg["index"])
            if idx is not None:
                idx.set_remote_max_shard(msg["shard"])
        elif typ == "schema":
            self.holder.apply_schema(msg["schema"])
        elif typ == "cluster-status":
            prev_state = self.cluster.state
            self.cluster.state = msg.get("state", self.cluster.state)
            self.cluster.nodes = [Node.from_dict(n) for n in msg.get("nodes", [])]
            # Wholesale membership replacement: drop health/probe state
            # for ids no longer in the cluster, so a departed node's
            # stale breaker can't shadow a later re-add of the same id.
            live = {n.id for n in self.cluster.nodes}
            self.cluster.health.prune_absent(live)
            for nid in [k for k in self._probe_failures if k not in live]:
                del self._probe_failures[nid]
            for n in self.cluster.nodes:
                # Our own jax process index is authoritative locally; a
                # status assembled before our join reported it would
                # otherwise erase it from the membership view.
                if n.id == self.node.id and n.process_idx is None:
                    n.process_idx = self.node.process_idx
            if self.cluster.state == STATE_NORMAL:
                # Only NORMAL membership is checkpointed: a STARTING status
                # carries partial membership and must not clobber the
                # persisted topology peers use for their own quorum.
                self.topology.save(self.cluster.nodes)
            # Follower resize watchdog bookkeeping (legacy stop-the-world
            # path): remember when RESIZING started so a dead coordinator
            # can't strand this node in it forever.
            if self.cluster.state == STATE_RESIZING:
                if not self.node.is_coordinator and self._resizing_since is None:
                    self._resizing_since = time.monotonic()
            else:
                self._resizing_since = None
            if prev_state == STATE_RESIZING and self.cluster.state == STATE_NORMAL:
                # Post-resize GC of shards this node no longer owns
                # (reference holderCleaner, holder.go:777-835).
                from ..cluster.topology import HolderCleaner

                removed = HolderCleaner(self).clean_holder()
                if removed:
                    self.logger.info("holder cleaner removed %d fragments", len(removed))
        elif typ == "set-coordinator":
            for n in self.cluster.nodes:
                n.is_coordinator = n.id == msg["nodeID"]
            # Persisted so a restart doesn't re-flag the deposed
            # coordinator from a stale checkpoint (open() restores flags).
            self.topology.save(self.cluster.nodes)
        elif typ == "remove-node":
            # remove_node prunes the cluster-side health state; the
            # monitor's probe streak lives here.
            self.cluster.remove_node(msg["nodeID"])
            self._probe_failures.pop(msg["nodeID"], None)
        elif typ == "recalculate-caches":
            for index in self.holder.indexes.values():
                for field in index.fields.values():
                    for view in field.views.values():
                        for frag in view.fragments.values():
                            frag.cache.invalidate(force=True)
        elif typ == "resize-instruction":
            from ..cluster.resize import follow_resize_instruction

            # Asynchronously: fragment transfers can take minutes, and the
            # coordinator's send_message must return as soon as the
            # instruction is DELIVERED (a slow transfer is not an
            # undeliverable instruction). The ack rides a resize-complete
            # message when the work finishes (cluster.go:1179).
            threading.Thread(
                target=follow_resize_instruction, args=(self, msg),
                name="resize-follower", daemon=True,
            ).start()
        elif typ == "resize-complete":
            from ..cluster.resize import mark_resize_instruction_complete

            mark_resize_instruction_complete(self, msg)
        elif typ == "node-join":
            self.handle_node_join(Node.from_dict(msg["node"]))
        elif typ == "node-leave":
            self.handle_node_leave(msg["nodeID"])
        elif typ == "node-update":
            # Metadata refresh (reference nodeUpdate, event.go:23):
            # never a membership change.
            upd = Node.from_dict(msg["node"])
            existing = self.cluster.node_by_id(upd.id)
            if existing is not None:
                existing.uri = upd.uri or existing.uri
                if upd.process_idx is not None:
                    existing.process_idx = upd.process_idx
        elif typ == "collective-exec":
            # Non-leader side of leader-driven collective serving: enqueue
            # the descriptor for the runner thread (entry happens in
            # cluster-wide seq order; the handler thread must not block
            # inside the collective). See parallel/collective.py.
            self.collective.receive(msg)
        elif typ == "node-state":
            pass  # coordinator bookkeeping; static clusters are always NORMAL
        elif typ == "rebalance-begin":
            self._handle_rebalance_begin(msg)
        elif typ == "rebalance-instruction":
            # Migration streams can run minutes; the handler thread must
            # return as soon as the instruction is DELIVERED (same shape
            # as the legacy resize-instruction follower). Deduped on
            # (jobID, attempt): a transport-retried duplicate must not
            # double-stream, but a RESUMED job reuses its jobID with a
            # bumped attempt and must stream again.
            if not self._rebalance_dedupe("instruction", msg):
                threading.Thread(
                    target=self.rebalance_receiver.handle_instruction,
                    args=(msg,), name="rebalance-receiver", daemon=True,
                ).start()
        elif typ == "rebalance-finalize":
            threading.Thread(
                target=self.rebalance_receiver.handle_finalize,
                args=(msg,), name="rebalance-finalize", daemon=True,
            ).start()
        elif typ == "rebalance-shard-ready":
            if self.rebalance_coordinator is not None:
                self.rebalance_coordinator.shard_ready(msg)
        elif typ == "rebalance-shard-done":
            if self.rebalance_coordinator is not None:
                self.rebalance_coordinator.shard_done(msg)
        elif typ == "rebalance-shard-failed":
            if self.rebalance_coordinator is not None:
                self.rebalance_coordinator.shard_failed(msg)
        elif typ == "cutover-commit":
            # The freeze->commit window is the shard's effective write
            # pause; a freeze this node performed as the source closes
            # its sample here.
            self.rebalance_stats.note_commit(
                msg["index"], int(msg["shard"]),
                pause_cap=self.rebalance_config.cutover_pause_max)
            self.cluster.apply_cutover(
                msg["index"], int(msg["shard"]), epoch=msg.get("epoch"))
        elif typ == "cutover-revert":
            # Reverse migration (docs/rebalance.md): one shard's routing
            # flips BACK to the prior owners — its data has been
            # streamed back. Idempotent like apply_cutover.
            self.cluster.revert_cutover(
                msg["index"], int(msg["shard"]), epoch=msg.get("epoch"))
        elif typ == "rebalance-complete":
            self._handle_rebalance_complete(msg)
        elif typ == "rebalance-abort":
            self._handle_rebalance_abort(msg)
        else:
            self.logger.error("unknown cluster message type: %s", typ)

    # ------------------------------------------------------- live rebalance

    def _rebalance_dedupe(self, kind: str, msg: dict) -> bool:
        """True when this lifecycle message was already applied for the
        message's (jobID, attempt) — duplicate delivery via transport
        retry. The attempt rides every lifecycle message because a
        RESUMED job reuses its jobID: deduping on jobID alone would
        swallow the resumed begin/abort (e.g. a committed set persisted
        just before a coordinator crash, whose commit broadcast never
        went out, reaches peers only via the resumed begin)."""
        job_id = msg.get("jobID")
        if not job_id:
            return False
        token = f"{job_id}#{msg.get('attempt', 0)}"
        if self._rebalance_seen.get(kind) == token:
            return True
        self._rebalance_seen[kind] = token
        return False

    def _handle_rebalance_begin(self, msg: dict) -> None:
        if self._rebalance_dedupe("begin", msg):
            return
        new_nodes = [Node.from_dict(n) for n in msg.get("newNodes", [])]
        current = [Node.from_dict(n) for n in msg.get("nodes", [])]
        if (
            current
            and len(self.cluster.nodes) <= 1
            and not any(n.id == self.node.id for n in current)
        ):
            # A joining node: adopt the CURRENT membership for placement
            # (it owns nothing until cutovers commit; adding itself to the
            # node list would corrupt the jump-hash placement every other
            # node computes).
            self.cluster.nodes = current
        self.cluster.begin_rebalance(
            new_nodes,
            committed=[tuple(x) for x in msg.get("committed", [])],
            epoch=msg.get("epoch"),
        )
        for nid in msg.get("participants", []):
            self.cluster.health.set_copy_grace(nid)

    def _handle_rebalance_complete(self, msg: dict) -> None:
        if self._rebalance_dedupe("complete", msg):
            return
        nodes = [Node.from_dict(n) for n in msg.get("nodes", [])]
        self._adopt_committed_topology(nodes, msg.get("epoch"))

    def _adopt_committed_topology(self, nodes, epoch,
                                  anti_entropy: bool = False) -> None:
        """Commit a finished rebalance's topology and run the follower-side
        completion effects (grace/health cleanup, persisted topology,
        epoch-guarded GC). Reached from the rebalance-complete broadcast
        AND from the member monitor's epoch sync (anti_entropy=True), so a
        follower that lost the broadcast still converges. The anti-entropy
        path re-validates its decision atomically under the routing lock:
        the monitor evaluated the adopt condition outside it, and a
        rebalance-begin landing in between must not have its
        next_nodes/migrated overrides wiped by this late commit."""
        if anti_entropy:
            if not self.cluster.adopt_topology_if_ahead(nodes, epoch):
                self.logger.info(
                    "topology adoption skipped: a rebalance began (or the "
                    "epoch caught up) since the probe")
                return
        else:
            self.cluster.commit_topology(nodes, epoch=epoch)
        self.cluster.health.clear_copy_grace()
        live = {n.id for n in self.cluster.nodes}
        self.cluster.health.prune_absent(live)
        for nid in [k for k in self._probe_failures if k not in live]:
            del self._probe_failures[nid]
        self.topology.save(self.cluster.nodes)
        # Epoch-guarded GC: the commit advanced the routing epoch, so a
        # read still routed under the old placement 409s and re-routes
        # instead of reading the removed fragment as empty.
        from ..cluster.topology import HolderCleaner

        removed = HolderCleaner(self).clean_holder()
        if removed:
            self.logger.info(
                "rebalance complete: holder cleaner removed %d fragments",
                len(removed))
        # Thaw any fragment still frozen for a cutover of the job that
        # just ended. After the cleaner, every remaining fragment belongs
        # to a shard this node owns under the adopted topology — on the
        # missed-ABORT recovery path (the job reverted, routing came back
        # to us), and on a normal complete where this node was a
        # migration source yet keeps the shard as a replica, a lingering
        # _moved flag would leave it permanently write-dead.
        thawed = self.migration_source.unfreeze(keep=())
        if thawed:
            self.logger.info(
                "rebalance complete: thawed %d frozen fragments", thawed)

    def _handle_rebalance_abort(self, msg: dict) -> None:
        if self._rebalance_dedupe("abort", msg):
            return
        self.rebalance_receiver.handle_abort(msg)
        self.migration_source.abort_all()
        committed = [tuple(x) for x in msg.get("committed", [])]
        # Thaw fragments frozen for never-committed cutovers: routing for
        # those shards reverts to this node, and a lingering _moved flag
        # would leave them permanently write-dead.
        self.migration_source.unfreeze(keep=committed)
        reverted = self.cluster.abort_rebalance(committed=committed)
        self.cluster.health.clear_copy_grace()
        if reverted and any(n.id == self.node.id for n in self.cluster.nodes):
            # Members drop half-fetched fragments for shards they don't
            # own on the reverted topology. A JOINER skips this: it is in
            # no topology at all here, and a cleaner pass would delete any
            # pre-existing local data it brought to the join.
            from ..cluster.topology import HolderCleaner

            HolderCleaner(self).clean_holder()

    def maybe_resume_rebalance(self) -> bool:
        """Pick up a checkpointed rebalance job after a coordinator
        restart. Returns True when a job was resumed."""
        if not self.node.is_coordinator or not self.rebalance_config.online:
            return False
        from ..cluster.rebalance import RebalanceCoordinator

        if self.rebalance_coordinator is None:
            self.rebalance_coordinator = RebalanceCoordinator(self)
        try:
            return self.rebalance_coordinator.resume()
        except PilosaError as e:
            self.logger.error("rebalance resume failed: %s", e)
            return False

    def _check_resize_watchdog(self) -> None:
        """Follower resize watchdog (legacy stop-the-world path): a
        coordinator that died after broadcasting RESIZING but before (or
        during) instruction delivery strands followers — membership never
        flipped, so after `rebalance.follower-timeout` with a coordinator
        that is unreachable or no longer resizing, revert to NORMAL on
        the old topology. A live coordinator still mid-job resets the
        timer instead."""
        if (
            self.cluster.state != STATE_RESIZING
            or self.node.is_coordinator
            or self._resizing_since is None
        ):
            return
        if time.monotonic() - self._resizing_since < (
            self.rebalance_config.follower_timeout
        ):
            return
        coordinator = self.cluster.coordinator_node()
        coordinator_resizing = False
        if coordinator is not None:
            try:
                status = self._probe_client.status(coordinator.uri)
                coordinator_resizing = status.get("state") == STATE_RESIZING
            except PilosaError:
                coordinator_resizing = False
        if coordinator_resizing:
            self._resizing_since = time.monotonic()  # job still live
            return
        self.logger.error(
            "resize watchdog: coordinator %s gone or no longer resizing "
            "after %.0fs in RESIZING; reverting to NORMAL on the old "
            "topology",
            coordinator.id if coordinator else "<unknown>",
            self.rebalance_config.follower_timeout,
        )
        self.cluster.state = STATE_NORMAL
        self._resizing_since = None

    def _on_new_shard(self, index: str, field: str, shard: int) -> None:
        """View created a new shard fragment -> broadcast (view.go:210-257)."""
        if self.opened:
            self.broadcast_message(
                {"type": "create-shard", "index": index, "field": field, "shard": shard}
            )

    def resize_abort(self) -> None:
        rebalancer = getattr(self, "rebalance_coordinator", None)
        if rebalancer is not None and rebalancer.job is not None:
            rebalancer.abort("operator requested abort")
            return
        coordinator = getattr(self, "resize_coordinator", None)
        if coordinator is not None and coordinator.job is not None:
            # Drop the job too: state-only reset would leave the job live,
            # block every future resize, and still flip membership when
            # the in-flight followers eventually ack.
            coordinator.abort("operator requested abort")
        elif self.cluster.state == STATE_RESIZING:
            self.cluster.state = STATE_NORMAL
