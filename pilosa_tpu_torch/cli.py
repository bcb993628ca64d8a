"""CLI: server / import / export / inspect / check / config / generate-config.

Port of the reference's cobra command tree (cmd/root.go:32-87, ctl/) on
argparse. Config precedence: flags > PILOSA_TPU_* env > TOML file.

The port's `server` runs on the card unless `--device cpu` asks for the
CPU; no config key selects the device.
"""

from __future__ import annotations

import argparse
import csv
import os
import signal
import sys
import time
from typing import List, Optional

from .config import Config
from .errors import PilosaError

def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="path to TOML config file")
    p.add_argument("--data-dir", dest="data_dir")
    p.add_argument("--bind")
    p.add_argument("--max-writes-per-request", dest="max_writes_per_request", type=int)
    p.add_argument("--verbose", action="store_const", const=True, default=None)
    p.add_argument("--cluster-hosts", dest="cluster_hosts",
                   type=lambda s: [h.strip() for h in s.split(",") if h.strip()])
    p.add_argument("--cluster-replicas", dest="cluster_replicas", type=int)
    p.add_argument("--long-query-time", dest="long_query_time", type=float)
    p.add_argument("--anti-entropy-interval", dest="anti_entropy_interval", type=float)
    p.add_argument("--anti-entropy-jitter", dest="anti_entropy_jitter",
                   type=float,
                   help="sweep-interval jitter fraction (de-stampedes a "
                        "restarted cluster's anti-entropy timers)")
    p.add_argument("--anti-entropy-pace", dest="anti_entropy_pace",
                   type=float,
                   help="seconds slept between per-fragment syncs inside "
                        "one anti-entropy sweep")
    p.add_argument("--replication-write-consistency",
                   dest="replication_write_consistency",
                   choices=["one", "quorum", "all"],
                   help="owners that must apply before a write acks; an "
                        "unmet level is a retryable 503 after hints were "
                        "enqueued for the missed owners")
    p.add_argument("--replication-hint-ttl", dest="replication_hint_ttl",
                   type=float,
                   help="seconds before an undelivered hint expires to "
                        "priority anti-entropy")
    p.add_argument("--replication-hint-max-bytes",
                   dest="replication_hint_max_bytes", type=int,
                   help="per-peer hint log byte budget (0 = unbounded)")
    p.add_argument("--replication-deliver-interval",
                   dest="replication_deliver_interval", type=float,
                   help="hint delivery daemon sweep cadence in seconds "
                        "(0 disables background delivery)")
    p.add_argument("--replication-deliver-batch-bytes",
                   dest="replication_deliver_batch_bytes", type=int,
                   help="max hint-log bytes replayed toward one peer per "
                        "delivery sweep")
    p.add_argument("--gossip-probe-interval", dest="gossip_probe_interval", type=float)
    p.add_argument("--gossip-failover-probes", dest="gossip_failover_probes", type=int)
    p.add_argument("--gossip-probe-timeout", dest="gossip_probe_timeout", type=float)
    p.add_argument("--gossip-probe-failures", dest="gossip_probe_failures",
                   type=int,
                   help="consecutive failed heartbeat probes before a peer "
                        "is marked unavailable (flap damping)")
    p.add_argument("--gossip-key", dest="gossip_key",
                   help="path to cluster shared-secret file")
    p.add_argument("--resilience-breaker-failures",
                   dest="resilience_breaker_failures", type=int,
                   help="consecutive transport failures before a peer's "
                        "circuit breaker opens")
    p.add_argument("--resilience-breaker-backoff",
                   dest="resilience_breaker_backoff", type=float,
                   help="initial open->half-open breaker backoff in seconds "
                        "(doubles per failed probe)")
    p.add_argument("--resilience-breaker-backoff-max",
                   dest="resilience_breaker_backoff_max", type=float)
    p.add_argument("--resilience-probe-ttl", dest="resilience_probe_ttl",
                   type=float,
                   help="seconds before an unreported half-open probe "
                        "counts as failed")
    p.add_argument("--resilience-retry-budget",
                   dest="resilience_retry_budget", type=float,
                   help="retry token bucket capacity gating replica "
                        "re-maps (0 = unlimited)")
    p.add_argument("--resilience-retry-refill",
                   dest="resilience_retry_refill", type=float,
                   help="retry tokens refilled per successful remote "
                        "request")
    p.add_argument("--resilience-hedge-delay",
                   dest="resilience_hedge_delay", type=float,
                   help="fixed hedge delay in seconds (0 = adaptive "
                        "per-peer p99)")
    p.add_argument("--resilience-hedge-max-fraction",
                   dest="resilience_hedge_max_fraction", type=float,
                   help="cap on hedged reads as a fraction of remote "
                        "requests (0 disables hedging)")
    p.add_argument("--resilience-hedge-min-delay",
                   dest="resilience_hedge_min_delay", type=float)
    p.add_argument("--resilience-device-breaker-failures",
                   dest="resilience_device_breaker_failures", type=int,
                   help="consecutive engine dispatch failures before the "
                        "device plane demotes to host execution")
    p.add_argument("--resilience-device-breaker-backoff",
                   dest="resilience_device_breaker_backoff", type=float,
                   help="initial open->half-open backoff in seconds for the "
                        "device plane breaker (doubles per failed probe)")
    p.add_argument("--resilience-device-breaker-backoff-max",
                   dest="resilience_device_breaker_backoff_max", type=float)
    p.add_argument("--resilience-device-sig-failures",
                   dest="resilience_device_sig_failures", type=int,
                   help="consecutive failures of one query signature's fused "
                        "program before that signature is quarantined to the "
                        "per-shard path")
    p.add_argument("--resilience-device-sig-backoff",
                   dest="resilience_device_sig_backoff", type=float)
    p.add_argument("--resilience-collective-breaker-failures",
                   dest="resilience_collective_breaker_failures", type=int,
                   help="consecutive collective failures (barrier timeouts, "
                        "broadcast losses) before the collective plane stops "
                        "being offered queries")
    p.add_argument("--resilience-collective-breaker-backoff",
                   dest="resilience_collective_breaker_backoff", type=float,
                   help="initial open->half-open backoff in seconds for the "
                        "collective plane/slice breakers (doubles per "
                        "failed probe)")
    p.add_argument("--resilience-collective-breaker-backoff-max",
                   dest="resilience_collective_breaker_backoff_max",
                   type=float)
    p.add_argument("--rebalance-online", dest="rebalance_online",
                   type=lambda s: s.lower() in ("1", "true", "yes"),
                   metavar="{true,false}",
                   help="live shard migration with routing epochs (default "
                        "true); false restores the legacy stop-the-world "
                        "resize")
    p.add_argument("--rebalance-max-concurrent-streams",
                   dest="rebalance_max_concurrent_streams", type=int,
                   help="concurrent per-shard migration streams one "
                        "receiving node runs")
    p.add_argument("--rebalance-max-bytes-per-sec",
                   dest="rebalance_max_bytes_per_sec", type=float,
                   help="receiver-side migration throughput cap in bytes/s "
                        "(0 = unthrottled)")
    p.add_argument("--rebalance-catchup-threshold-bytes",
                   dest="rebalance_catchup_threshold_bytes", type=int,
                   help="WAL-tail bytes per catch-up round under which a "
                        "migrating shard is ready for cutover")
    p.add_argument("--rebalance-max-catchup-rounds",
                   dest="rebalance_max_catchup_rounds", type=int,
                   help="catch-up rounds before a migrating shard declares "
                        "ready regardless")
    p.add_argument("--rebalance-cutover-pause-max",
                   dest="rebalance_cutover_pause_max", type=float,
                   help="seconds a write caught in a cutover window "
                        "re-routes/waits for the commit before failing "
                        "clean")
    p.add_argument("--rebalance-follower-timeout",
                   dest="rebalance_follower_timeout", type=float,
                   help="seconds a follower stays RESIZING before probing "
                        "the coordinator and reverting to NORMAL (legacy "
                        "resize watchdog)")
    p.add_argument("--obs-sample-rate", dest="obs_sample_rate", type=float,
                   help="fraction of queries traced end-to-end (0 disables "
                        "local sampling; 1 traces every query)")
    p.add_argument("--obs-ring-size", dest="obs_ring_size", type=int,
                   help="completed traces retained for GET /debug/traces")
    p.add_argument("--obs-slow-query-ms", dest="obs_slow_query_ms",
                   type=float,
                   help="log queries slower than this with their full "
                        "stage breakdown (0 disables the slow-query log)")
    p.add_argument("--cdc-enabled", dest="cdc_enabled", type=int,
                   metavar="{0,1}",
                   help="1 turns on change data capture: per-index CDC "
                        "streams, point-in-time reads, standing queries")
    p.add_argument("--cdc-retention-bytes", dest="cdc_retention_bytes",
                   type=int,
                   help="per-index CDC log size that triggers folding the "
                        "oldest records into base images (cursors behind "
                        "the fold get 410)")
    p.add_argument("--cdc-retention-ops", dest="cdc_retention_ops", type=int,
                   help="per-index CDC log op count that triggers folding")
    p.add_argument("--cdc-poll-timeout", dest="cdc_poll_timeout", type=float,
                   help="default long-poll park time in seconds for "
                        "/cdc/stream and standing-query polls")
    p.add_argument("--cdc-standing-interval", dest="cdc_standing_interval",
                   type=float,
                   help="seconds between standing-query staleness sweeps "
                        "(0 disables the background evaluator)")
    p.add_argument("--cdc-pit-cache", dest="cdc_pit_cache", type=int,
                   help="materialized historical fragments kept in the "
                        "point-in-time LRU")
    p.add_argument("--geo-role", dest="geo_role",
                   choices=["none", "leader", "follower"],
                   help="geo replication role: a follower tails the "
                        "leader's CDC streams, refuses writes, and serves "
                        "bounded-staleness reads (docs/geo-replication.md)")
    p.add_argument("--geo-leader", dest="geo_leader", metavar="HOST:PORT",
                   help="leader cluster URL a geo follower tails "
                        "(required with --geo-role follower)")
    p.add_argument("--geo-backoff", dest="geo_backoff", type=float,
                   help="initial per-link tail breaker backoff in seconds "
                        "(doubles per consecutive failed leader contact)")
    p.add_argument("--geo-backoff-max", dest="geo_backoff_max", type=float,
                   help="tail breaker backoff ceiling in seconds")
    p.add_argument("--geo-probe-promote", dest="geo_probe_promote", type=int,
                   metavar="{0,1}",
                   help="1 lets a follower promote itself (bumping the "
                        "fencing geo epoch) after geo-probe-failures "
                        "consecutive failed leader contacts")
    p.add_argument("--geo-probe-failures", dest="geo_probe_failures",
                   type=int,
                   help="consecutive failed leader contacts before a "
                        "probe-driven promotion fires")
    p.add_argument("--transport-enabled", dest="transport_enabled", type=int,
                   metavar="{0,1}",
                   help="1 turns on the pmux internal transport: one "
                        "persistent multiplexed binary connection per peer "
                        "pair for node-to-node traffic, with per-peer HTTP "
                        "fallback (docs/transport.md)")
    p.add_argument("--transport-port-offset", dest="transport_port_offset",
                   type=int,
                   help="mux listener binds on http-port + this offset; "
                        "every node of a cluster must agree")
    p.add_argument("--transport-max-frames-inflight",
                   dest="transport_max_frames_inflight", type=int,
                   help="concurrent unanswered frames per peer connection; "
                        "excess requests ride HTTP")
    p.add_argument("--transport-frame-max-bytes",
                   dest="transport_frame_max_bytes", type=int,
                   help="largest mux frame accepted or sent; oversized "
                        "payloads (e.g. big migration chunks) ride HTTP")
    p.add_argument("--transport-handshake-timeout",
                   dest="transport_handshake_timeout", type=float,
                   help="seconds to wait for the mux version/key handshake "
                        "before demoting the peer to HTTP")
    p.add_argument("--sched-max-queue", dest="sched_max_queue", type=int,
                   help="bounded admission queue; full requests get 429")
    p.add_argument("--sched-interactive-concurrency",
                   dest="sched_interactive_concurrency", type=int)
    p.add_argument("--sched-batch-concurrency",
                   dest="sched_batch_concurrency", type=int)
    p.add_argument("--sched-default-deadline", dest="sched_default_deadline",
                   type=float, help="default per-query budget in seconds (0 = none)")
    p.add_argument("--sched-retry-after", dest="sched_retry_after", type=float)
    p.add_argument("--sched-retry-jitter", dest="sched_retry_jitter",
                   type=float,
                   help="±fraction applied to derived Retry-After values "
                        "so shed clients don't return in lockstep "
                        "(clamped to [0, 1])")
    p.add_argument("--sched-batch-window", dest="sched_batch_window", type=float,
                   help="micro-batch base window in seconds")
    p.add_argument("--sched-batch-window-max", dest="sched_batch_window_max",
                   type=float)
    p.add_argument("--sched-batch-max", dest="sched_batch_max", type=int,
                   help="max queries coalesced into one device launch")
    p.add_argument("--qos-rate", dest="qos_rate", type=float,
                   help="per-tenant budget refill: ms of measured query "
                        "cost per second per unit share (0 disables QoS)")
    p.add_argument("--qos-burst", dest="qos_burst", type=float,
                   help="tenant bucket capacity in ms of measured cost "
                        "at share 1.0")
    p.add_argument("--qos-default-tenant-share",
                   dest="qos_default_tenant_share", type=float,
                   help="rate/burst multiplier for tenants with no "
                        "explicit share override")
    p.add_argument("--qos-interactive-cap", dest="qos_interactive_cap",
                   type=float,
                   help="interactive queries shed only past this "
                        "multiple of the tenant's burst in debt")
    p.add_argument("--qos-estimate-ms", dest="qos_estimate_ms", type=float,
                   help="static cost charged at admission, reconciled "
                        "to the traced cost at query end")
    p.add_argument("--autoscale-interval", dest="autoscale_interval",
                   type=float,
                   help="seconds between autoscale control steps "
                        "(0 disables the controller)")
    p.add_argument("--autoscale-window", dest="autoscale_window", type=int,
                   help="consecutive agreeing samples required before a "
                        "scale decision")
    p.add_argument("--autoscale-scale-out-qps",
                   dest="autoscale_scale_out_qps", type=float,
                   help="cluster-wide qps high watermark for scale-out")
    p.add_argument("--autoscale-scale-in-qps",
                   dest="autoscale_scale_in_qps", type=float,
                   help="qps low watermark for scale-in (the gap below "
                        "scale-out-qps is the anti-flap dead band)")
    p.add_argument("--autoscale-p99-ms", dest="autoscale_p99_ms", type=float,
                   help="optional stage-p99 latency trigger in ms "
                        "(0 ignores latency)")
    p.add_argument("--autoscale-cooldown", dest="autoscale_cooldown",
                   type=float,
                   help="seconds after a scale action before the next")
    p.add_argument("--autoscale-min-nodes", dest="autoscale_min_nodes",
                   type=int, help="never scale in below this many nodes")
    p.add_argument("--autoscale-max-nodes", dest="autoscale_max_nodes",
                   type=int,
                   help="never scale out past this many nodes "
                        "(0 = bounded by the standby pool)")
    p.add_argument("--autoscale-standby", dest="autoscale_standby",
                   help="comma-separated host:port URIs of running "
                        "standby servers scale-out may admit")
    p.add_argument("--storage-fsync", dest="storage_fsync",
                   choices=["never", "batch", "always"],
                   help="WAL/snapshot durability: never (page cache only), "
                        "batch (sync every N ops, the default), always "
                        "(sync per write)")
    p.add_argument("--storage-fsync-batch-ops", dest="storage_fsync_batch_ops",
                   type=int, help="ops between WAL fsyncs in batch mode")
    p.add_argument("--storage-snapshot-ratio", dest="storage_snapshot_ratio",
                   type=float,
                   help="snapshot a fragment when its op-log bytes exceed "
                        "this fraction of its storage bytes (0 disables the "
                        "byte trigger)")
    p.add_argument("--storage-snapshot-interval",
                   dest="storage_snapshot_interval", type=float,
                   help="background sweep seconds: snapshot any fragment "
                        "carrying WAL bytes older than this (0 disables)")
    p.add_argument("--ingest-import-workers", dest="ingest_import_workers",
                   type=int,
                   help="max shard batches of one bulk import applied/"
                        "forwarded concurrently (1 = serial)")
    p.add_argument("--engine-delta-max-fraction",
                   dest="engine_delta_max_fraction", type=float,
                   help="max changed fraction of a resident device tensor "
                        "refreshed by a scattered delta (0 disables deltas)")
    p.add_argument("--engine-delta-journal-ops",
                   dest="engine_delta_journal_ops", type=int,
                   help="per-fragment dirty-word journal bound; overflow "
                        "falls back to full cache regathers")
    p.add_argument("--engine-mesh-devices", dest="engine_mesh_devices",
                   type=int,
                   help="shard partitions of the per-node engine, placed "
                        "round-robin over the local devices (0 = one per "
                        "local card, one on the CPU)")
    p.add_argument("--engine-gather-workers", dest="engine_gather_workers",
                   type=int,
                   help="threads for cold-path per-shard plane gathers "
                        "(0 = auto)")
    p.add_argument("--engine-leaf-cache-bytes", dest="engine_leaf_cache_bytes",
                   type=int,
                   help="device leaf-plane cache budget in bytes "
                        "(0 = tier hbm-bytes split, else platform default)")
    p.add_argument("--engine-stack-cache-bytes",
                   dest="engine_stack_cache_bytes", type=int,
                   help="device stacked-tensor cache budget in bytes "
                        "(0 = tier hbm-bytes split, else platform default)")
    p.add_argument("--engine-memo-entries", dest="engine_memo_entries",
                   type=int,
                   help="host count-memo entry budget (0 = default)")
    p.add_argument("--engine-aux-memo-entries",
                   dest="engine_aux_memo_entries", type=int,
                   help="host composite-result memo entry budget "
                        "(0 = default)")
    p.add_argument("--engine-dispatch-watchdog",
                   dest="engine_dispatch_watchdog", type=float,
                   help="seconds a device dispatch may block before the "
                        "watchdog abandons it as a timeout fault "
                        "(0 disables)")
    p.add_argument("--engine-cold-host-count",
                   dest="engine_cold_host_count", type=int,
                   metavar="{0,1}",
                   help="1 answers a one-off Count on fully-demoted planes "
                        "straight from the compressed host tier (no decode "
                        "+ device_put); 0 disables")
    p.add_argument("--engine-plan-cache",
                   dest="engine_plan_cache", type=int,
                   metavar="{0,1}",
                   help="1 caches each query tree's canonical plan "
                        "(signature + lowering) on the Call, keyed by the "
                        "index write epoch; 0 recompiles per dispatch site")
    p.add_argument("--collective-enabled",
                   dest="collective_enabled", type=int, metavar="{0,1}",
                   help="0 turns the multi-chip collective serving plane "
                        "off; every full-index query takes the HTTP fan-out")
    p.add_argument("--collective-single-process",
                   dest="collective_single_process", type=int,
                   metavar="{0,1}",
                   help="1 lets a single-process, single-node deployment "
                        "serve whole-index queries through the collective "
                        "plane over its local device mesh")
    p.add_argument("--collective-timeout-ms",
                   dest="collective_timeout_ms", type=int,
                   help="collective barrier timeout in milliseconds")
    p.add_argument("--collective-leaf-budget-bytes",
                   dest="collective_leaf_budget_bytes", type=int,
                   help="resident sharded-stack budget per process; "
                        "LRU-evicted planes demote through the tier manager")
    p.add_argument("--collective-delta-max-fraction",
                   dest="collective_delta_max_fraction", type=float,
                   help="dirty-word budget for delta-refreshing a stale "
                        "resident collective plane (fraction of the tensor; "
                        "0 disables deltas)")
    p.add_argument("--tier-hbm-bytes", dest="tier_hbm_bytes", type=int,
                   help="combined device-cache budget split across the "
                        "leaf/stack caches (0 = platform default)")
    p.add_argument("--tier-host-bytes", dest="tier_host_bytes", type=int,
                   help="budget for container-compressed demoted planes "
                        "held in host RAM (0 disables the host tier)")
    p.add_argument("--tier-disk-bytes", dest="tier_disk_bytes", type=int,
                   help="budget for compressed planes spilled to disk "
                        "(0 disables the disk tier)")
    p.add_argument("--tier-disk-path", dest="tier_disk_path",
                   help="spill directory (default <data-dir>/tier-spill)")
    p.add_argument("--tier-prefetch-interval", dest="tier_prefetch_interval",
                   type=float,
                   help="seconds between prefetch sweeps re-promoting "
                        "demoted planes of hot indexes (0 disables)")
    p.add_argument("--tier-prefetch-batch", dest="tier_prefetch_batch",
                   type=int, help="max planes promoted per prefetch sweep")
    p.add_argument("--translation-primary-url", dest="translation_primary_url")
    p.add_argument("--tls-certificate", dest="tls_certificate")
    p.add_argument("--tls-certificate-key", dest="tls_certificate_key")
    p.add_argument("--tls-skip-verify", dest="tls_skip_verify",
                   action="store_const", const=True, default=None)
    p.add_argument("--handler-allowed-origins", dest="allowed_origins",
                   type=lambda s: [h.strip() for h in s.split(",") if h.strip()])


def _load_config(args) -> Config:
    flags = {k: v for k, v in vars(args).items() if v is not None}
    return Config.load(getattr(args, "config", None), flags)


def cmd_server(args) -> int:
    from .logger import Logger

    cfg = _load_config(args)
    server = cfg.build_server(logger=Logger(verbose=cfg.verbose),
                              device=args.device)
    server.open()
    from .server.client import _node_url

    print(f"pilosa-tpu server listening on {_node_url(server.node.uri)}", flush=True)
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.close()
    return 0


def _ctl_client(args):
    """InternalClient for ctl subcommands, carrying the cluster shared
    secret when the target cluster is keyed (--gossip-key, same flag and
    file format as the server)."""
    from .server.client import InternalClient, load_cluster_key

    path = getattr(args, "gossip_key", None)
    key = load_cluster_key(path) if path else None
    return InternalClient(key=key)


def cmd_import(args) -> int:
    client = _ctl_client(args)
    if getattr(args, "both_keys", False):
        args.index_keys = args.field_keys = True
    if args.create:
        client.ensure_index(args.host, args.index, {"keys": args.index_keys})
        field_opts = {
            "type": args.field_type,
            "cacheType": args.field_cache_type,
            "cacheSize": args.field_cache_size,
            "keys": args.field_keys,
        }
        if args.field_type == "int":
            field_opts["min"] = args.field_min
            field_opts["max"] = args.field_max
        if args.field_time_quantum:
            field_opts["type"] = "time"
            field_opts["timeQuantum"] = args.field_time_quantum
        client.create_field(args.host, args.index, args.field, field_opts)

    total = 0
    for path in args.paths:
        fh = sys.stdin if path == "-" else open(path)
        try:
            reader = csv.reader(fh)
            batch: List = []
            for line in reader:
                if not line:
                    continue
                if args.field_type == "int":
                    col = line[0] if args.index_keys else int(line[0])
                    batch.append((col, int(line[1])))  # col, value
                else:
                    row = line[0] if args.field_keys else int(line[0])
                    col = line[1] if args.index_keys else int(line[1])
                    if len(line) >= 3 and line[2]:
                        batch.append((row, col, line[2]))
                    else:
                        batch.append((row, col))
                if len(batch) >= args.batch_size:
                    _flush_import(client, args, batch)
                    total += len(batch)
                    batch = []
            if batch:
                _flush_import(client, args, batch)
                total += len(batch)
        finally:
            if fh is not sys.stdin:
                fh.close()
    print(f"imported {total} records", file=sys.stderr)
    return 0


def _flush_import(client, args, batch) -> None:
    if args.field_type == "int":
        client.import_values(args.host, args.index, args.field, batch)
    else:
        client.import_bits(args.host, args.index, args.field, batch)


def cmd_export(args) -> int:
    client = _ctl_client(args)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        shards = client.shards_max(args.host).get(args.index, 0)
        import urllib.request

        for shard in range(shards + 1):
            url = (f"http://{args.host}/export?index={args.index}"
                   f"&field={args.field}&shard={shard}")
            with urllib.request.urlopen(url) as resp:
                out.write(resp.read().decode())
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_inspect(args) -> int:
    from .storage.bitmap import Bitmap, _as_container

    for path in args.paths:
        with open(path, "rb") as f:
            data = f.read()
        try:
            bm = Bitmap.from_bytes(data)
        except ValueError as e:
            print(f"{path}: INVALID ({e})")
            continue
        forms = {"array": 0, "dense": 0, "run": 0}
        lines = []
        for key, c in sorted(bm.containers.items()):
            # _as_container is a no-op for plain from_bytes output today,
            # but keeps inspect correct if a container-factory tier (the
            # btree store swap) ever hands back non-Container payloads.
            cc = _as_container(c)
            form = ("run" if cc.runs is not None
                    else "dense" if cc.bits is not None else "array")
            forms[form] += 1
            if args.containers:
                lines.append(f"  key={key} n={len(cc)} form={form}")
        print(f"{path}: containers={len(bm.containers)} bits={bm.count()} "
              f"ops={bm.op_n} array={forms['array']} dense={forms['dense']} "
              f"run={forms['run']}")
        for line in lines:
            print(line)
    return 0


def cmd_check(args) -> int:
    """Offline integrity check (reference ctl/check.go:47-123)."""
    from .storage.bitmap import Bitmap

    bad = 0
    for path in args.paths:
        if path.endswith((".cache", ".snapshotting", ".corrupt")):
            # .corrupt files are already-quarantined bytes kept for forensics.
            print(f"{path}: skipped")
            continue
        try:
            with open(path, "rb") as f:
                bm = Bitmap.from_bytes(f.read())
        except (ValueError, OSError) as e:
            print(f"{path}: CORRUPT ({e})")
            bad += 1
            continue
        problems = bm.check()
        if problems:
            print(f"{path}: INCONSISTENT ({'; '.join(problems)})")
            bad += 1
        else:
            print(f"{path}: ok")
    return 1 if bad else 0


def cmd_config(args) -> int:
    print(_load_config(args).to_toml(), end="")
    return 0


def cmd_generate_config(args) -> int:
    print(Config().to_toml(), end="")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pilosa-tpu",
                                     description="GPU-native distributed bitmap index (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("server", help="run a pilosa-tpu node")
    _add_config_flags(p)
    p.add_argument("--device", default=None,
                   help="torch device for the planes (default: the CUDA "
                        "card; 'cpu' asks for the CPU)")
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("import", help="bulk-import CSV data")
    p.add_argument("--host", default="localhost:10101")
    p.add_argument("--gossip-key", dest="gossip_key",
                   help="path to cluster shared-secret file")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("--create", action="store_true", help="create index/field first")
    p.add_argument("--batch-size", type=int, default=10_000_000)
    p.add_argument("--index-keys", action="store_true")
    p.add_argument("--field-keys", action="store_true")
    p.add_argument("-k", "--keys", dest="both_keys", action="store_true",
                   help="treat both column and row values as string keys "
                        "(shorthand for --index-keys --field-keys, the "
                        "reference's import -k)")
    p.add_argument("--field-type", default="set", choices=["set", "int", "time"])
    p.add_argument("--field-min", type=int, default=0)
    p.add_argument("--field-max", type=int, default=0)
    p.add_argument("--field-cache-type", default="ranked")
    p.add_argument("--field-cache-size", type=int, default=50000)
    p.add_argument("--field-time-quantum", default="")
    p.add_argument("paths", nargs="+", help="CSV files ('-' for stdin)")
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export", help="export a field as CSV")
    p.add_argument("--host", default="localhost:10101")
    p.add_argument("--gossip-key", dest="gossip_key",
                   help="path to cluster shared-secret file")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--field", required=True)
    p.add_argument("-o", "--output", default="-")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("inspect", help="inspect fragment files")
    p.add_argument("--containers", action="store_true")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("check", help="check fragment file integrity")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("config", help="print effective configuration")
    _add_config_flags(p)
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("generate-config", help="print default configuration")
    p.set_defaults(fn=cmd_generate_config)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except PilosaError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
