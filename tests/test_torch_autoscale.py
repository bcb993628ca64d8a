"""The cases of tests/test_autoscale.py, run against the port on the CPU.

Autoscaler tests: hysteresis, bounds, checkpoint, and full revert.

The decision logic runs against a stub server on the fake clock (every
sample is hand-fed, every gate asserted by counter); the cluster-level
tests drive a REAL coordinator + standby through the scale-out/scale-in
loop and the abort-mid-migration reverse migration.
"""

import json
import logging
import os
import time

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cluster.autoscale import (
    STATE_FILE,
    AutoscaleConfig,
    AutoscaleController,
    _hist_p99,
)
from pilosa_tpu_torch.cluster.node import Node
from pilosa_tpu_torch.cluster.rebalance import RebalanceConfig
from pilosa_tpu_torch.obs import ObsConfig, TraceRecorder
from pilosa_tpu_torch.sched import QueryScheduler, SchedulerConfig
from pilosa_tpu_torch.stats import Histogram


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


# ------------------------------------------------------------------ config


def test_autoscale_config_validation():
    AutoscaleConfig().validate()  # defaults legal (and disabled: interval 0)
    for bad in (
        AutoscaleConfig(interval=-1),
        AutoscaleConfig(window=0),
        AutoscaleConfig(scale_out_qps=0),
        AutoscaleConfig(scale_in_qps=200.0),  # >= scale-out-qps
        AutoscaleConfig(scale_in_qps=-1),
        AutoscaleConfig(p99_ms=-1),
        AutoscaleConfig(cooldown=-1),
        AutoscaleConfig(min_nodes=0),
        AutoscaleConfig(min_nodes=3, max_nodes=2),
    ):
        with pytest.raises(ValueError):
            bad.validate()


def test_standby_uris_parsing():
    cfg = AutoscaleConfig(standby=" h1:1, h2:2 ,,h3:3 ")
    assert cfg.standby_uris() == ["h1:1", "h2:2", "h3:3"]
    assert AutoscaleConfig().standby_uris() == []


# ---------------------------------------------------------------- _hist_p99


def test_hist_p99_from_log_buckets():
    h = Histogram()
    for _ in range(99):
        h.observe(1.0)
    h.observe(1000.0)
    p99 = _hist_p99(h.snapshot())
    # The smallest bucket bound covering 99% of samples: the 1.0ms mass,
    # not the single outlier.
    assert 1.0 <= p99 <= 2.0
    # Empty histogram -> 0; all-overflow mass falls back to observed max.
    assert _hist_p99({"count": 0, "buckets": {}}) == 0.0
    assert _hist_p99(
        {"count": 10, "max": 123.0, "buckets": {"+Inf": 10}}) == 123.0


# ------------------------------------------------------------ decision unit


class _StubCluster:
    def __init__(self):
        self.nodes = [Node(id="n0", uri="localhost:1")]
        self.coord = True

    def is_coordinator(self):
        return self.coord

    def node_by_id(self, node_id):
        return next((n for n in self.nodes if n.id == node_id), None)


class _StubCoordinator:
    def __init__(self):
        self.job = None
        self.revert_on_abort = False


class _StubClient:
    def __init__(self):
        self.statuses = {}

    def status(self, uri):
        st = self.statuses.get(uri)
        if st is None:
            raise OSError(f"standby {uri} unreachable")
        return st


class _StubServer:
    """The slice of Server the controller touches, nothing else."""

    def __init__(self, tmp_path, sample_rate=0.0):
        self.data_dir = str(tmp_path)
        self.logger = logging.getLogger("test-autoscale")
        self.scheduler = QueryScheduler(SchedulerConfig())
        self.trace_recorder = TraceRecorder(ObsConfig(sample_rate=sample_rate))
        self.cluster = _StubCluster()
        self.rebalance_config = RebalanceConfig()
        self.rebalance_coordinator = _StubCoordinator()
        self.client = _StubClient()
        self.joins = []
        self.leaves = []
        self.join_makes_job = False

    def handle_node_join(self, node):
        self.joins.append(node.id)
        self.cluster.nodes.append(node)
        if self.join_makes_job:
            self.rebalance_coordinator.job = object()

    def handle_node_leave(self, node_id):
        self.leaves.append(node_id)
        self.cluster.nodes = [
            n for n in self.cluster.nodes if n.id != node_id]


def ctrl(server, fake_clock, **kw):
    kw.setdefault("interval", 1.0)
    kw.setdefault("window", 3)
    kw.setdefault("scale_out_qps", 100.0)
    kw.setdefault("scale_in_qps", 10.0)
    kw.setdefault("cooldown", 60.0)
    kw.setdefault("standby", "localhost:9")
    return AutoscaleController(
        server, AutoscaleConfig(**kw), clock=fake_clock)


def drive(server, c, fake_clock, qps, steps=1):
    """Advance one second per step, planting `qps` queries of traffic."""
    out = []
    for _ in range(steps):
        fake_clock.advance(1.0)
        for _ in range(int(qps)):
            server.scheduler.note_index("i")
        out.append(c.step())
    return out


def test_first_step_seeds_baseline(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    c = ctrl(s, fake_clock)
    assert c.step() == "seeding"
    assert c.counters["samples"] == 0
    assert c.counters["steps"] == 1


def test_hysteresis_needs_full_agreeing_window(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    c = ctrl(s, fake_clock)
    c.step()  # seed
    # Two high samples: window of 3 not yet full -> hold, no action.
    assert drive(s, c, fake_clock, 150, 2) == ["hold", "hold"]
    assert s.joins == []
    # A mixed window (high, high, low) must also hold: one cool sample
    # resets the excursion, that's the whole point of hysteresis.
    assert drive(s, c, fake_clock, 5, 1) == ["hold"]
    assert drive(s, c, fake_clock, 150, 2) == ["hold", "hold"]
    assert s.joins == []
    # The third consecutive high sample acts.
    assert drive(s, c, fake_clock, 150, 1) == ["out"]
    assert s.joins == ["s1"]
    assert c.counters["scale_out"] == 1


def test_scale_out_checkpoint_and_revert_arming(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    s.join_makes_job = True
    c = ctrl(s, fake_clock)
    c.step()
    drive(s, c, fake_clock, 150, 3)
    # The standby's REPORTED identity was admitted (never an invented id),
    # the revert contract is armed while the join's job is in flight, and
    # the added-node list survives restarts via the checkpoint.
    assert s.joins == ["s1"]
    assert s.rebalance_coordinator.revert_on_abort is True
    with open(os.path.join(s.data_dir, STATE_FILE)) as f:
        assert json.load(f)["added"] == ["s1"]
    # The window was consumed: the NEXT action needs a fresh mandate.
    assert c.snapshot()["window"] == []


def test_join_without_job_disarms_revert(tmp_path, fake_clock):
    # An empty-holder join is a plain status broadcast — no job to guard;
    # leaving the flag armed would hijack a later operator abort.
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    s.join_makes_job = False
    c = ctrl(s, fake_clock)
    c.step()
    drive(s, c, fake_clock, 150, 3)
    assert s.joins == ["s1"]
    assert s.rebalance_coordinator.revert_on_abort is False


def test_inflight_job_and_cooldown_block_actions(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    s.join_makes_job = True
    c = ctrl(s, fake_clock, cooldown=60.0, max_nodes=9)
    c.step()
    drive(s, c, fake_clock, 150, 3)  # acts: job now in flight
    assert c.counters["scale_out"] == 1
    # Sustained load continues, but the running rebalance blocks.
    assert drive(s, c, fake_clock, 150, 3)[-1] == "skipped-rebalancing"
    # Job completes; the cooldown still holds the next action.
    s.rebalance_coordinator.job = None
    assert drive(s, c, fake_clock, 150, 1) == ["skipped-cooldown"]
    assert c.counters["skipped_cooldown"] == 1
    # Past the cooldown the controller may act again — but the standby
    # pool is exhausted (s1 already a member) -> bounds skip, not a join.
    # (Four steps: the long idle gap dilutes the first sample's qps, so a
    # fresh 3-high window needs three more.)
    fake_clock.advance(61.0)
    drive(s, c, fake_clock, 150, 4)
    assert c.counters["skipped_bounds"] >= 1
    assert s.joins == ["s1"]  # still just the one


def test_membership_bounds(tmp_path, fake_clock):
    # max-nodes stops scale-out before the standby is even probed.
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    c = ctrl(s, fake_clock, max_nodes=1, cooldown=0.0)
    c.step()
    drive(s, c, fake_clock, 150, 3)
    assert s.joins == [] and c.counters["skipped_bounds"] == 1
    # min-nodes stops scale-in at the floor.
    s2 = _StubServer(tmp_path / "b")
    c2 = ctrl(s2, fake_clock, min_nodes=1, cooldown=0.0)
    c2.step()
    drive(s2, c2, fake_clock, 0, 3)
    assert s2.leaves == [] and c2.counters["skipped_bounds"] == 1


def test_scale_in_only_takes_back_added_nodes(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    # Two-node cluster the OPERATOR built: sustained idle must not
    # shrink it — the controller only removes nodes it added.
    s.cluster.nodes.append(Node(id="op1", uri="localhost:2"))
    c = ctrl(s, fake_clock, cooldown=0.0)
    c.step()
    assert drive(s, c, fake_clock, 0, 3)[-1] == "hold"
    assert s.leaves == [] and c.counters["skipped_bounds"] == 1
    # After its own scale-out, the controller takes that node back.
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    drive(s, c, fake_clock, 150, 3)
    assert s.joins == ["s1"]
    assert drive(s, c, fake_clock, 0, 3)[-1] == "in"
    assert s.leaves == ["s1"]
    with open(os.path.join(s.data_dir, STATE_FILE)) as f:
        assert json.load(f)["added"] == []


def test_non_coordinator_samples_but_never_acts(tmp_path, fake_clock):
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    s.cluster.coord = False
    c = ctrl(s, fake_clock)
    c.step()
    assert drive(s, c, fake_clock, 150, 3) == ["not-coordinator"] * 3
    assert s.joins == [] and c.counters["samples"] == 3
    # Failover promotion: the window is already warm, the promoted
    # coordinator can act on its very next step.
    s.cluster.coord = True
    assert drive(s, c, fake_clock, 150, 1) == ["out"]
    assert s.joins == ["s1"]


def test_offline_rebalance_never_acts(tmp_path, fake_clock):
    # The revert contract only exists on the online rebalance path; the
    # stop-the-world resize must never be autoscale-triggered.
    s = _StubServer(tmp_path)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    s.rebalance_config = RebalanceConfig(online=False)
    c = ctrl(s, fake_clock)
    c.step()
    assert drive(s, c, fake_clock, 150, 3) == ["offline-rebalance"] * 3
    assert s.joins == []


def test_p99_trigger_scales_out_at_low_qps(tmp_path, fake_clock):
    # A few expensive tenants can saturate devices at low qps: the
    # latency watermark counts as sustained-high on its own.
    s = _StubServer(tmp_path, sample_rate=1.0)
    s.client.statuses["localhost:9"] = {"localID": "s1"}
    for _ in range(20):
        t = s.trace_recorder.maybe_start(index="i", pql="q")
        t.record("device.dispatch", 400.0)
        s.trace_recorder.finish(t)
    c = ctrl(s, fake_clock, p99_ms=50.0, scale_out_qps=1e9)
    c.step()
    assert drive(s, c, fake_clock, 2, 3)[-1] == "out"
    assert s.joins == ["s1"]


def test_checkpoint_reload_and_corruption(tmp_path, fake_clock):
    with open(os.path.join(str(tmp_path), STATE_FILE), "w") as f:
        json.dump({"added": ["a", "b"]}, f)
    c = ctrl(_StubServer(tmp_path), fake_clock)
    assert c.snapshot()["added_nodes"] == ["a", "b"]
    # A corrupt checkpoint logs and starts empty — never bricks startup.
    with open(os.path.join(str(tmp_path), STATE_FILE), "w") as f:
        f.write("{nope")
    c2 = ctrl(_StubServer(tmp_path), fake_clock)
    assert c2.snapshot()["added_nodes"] == []


def test_step_is_single_flight(tmp_path, fake_clock):
    c = ctrl(_StubServer(tmp_path), fake_clock)
    assert c._flight.acquire(blocking=False)
    try:
        assert c.step() == "skipped-inflight"
        assert c.counters["skipped_inflight"] == 1
    finally:
        c._flight.release()


def test_autoscale_step_failpoint(tmp_path, fake_clock):
    c = ctrl(_StubServer(tmp_path), fake_clock)
    failpoints.configure("autoscale-step", "error", count=1,
                         message="injected controller fault")
    try:
        with pytest.raises(failpoints.InjectedFault):
            c.step()
    finally:
        failpoints.reset()
    assert c.step() == "seeding"  # flight lock released on the error path


# --------------------------------------------------------- cluster-level


from pilosa_tpu_torch.constants import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.server.client import InternalClient  # noqa: E402
from pilosa_tpu_torch.server.server import Server as _Server  # noqa: E402

N_SHARDS = 4
INDEX = "asc"


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scale_ports(min_gains=1):
    """A (coordinator, standby) port pair whose 1->2 placement actually
    hands the standby >= min_gains shards (node ids derive from random
    ports; an arbitrary pair can be a no-op placement)."""
    from pilosa_tpu_torch.cluster.hash import partition as partition_of

    for _ in range(64):
        ports = [free_port(), free_port()]
        hosts = [f"localhost:{p}" for p in ports]
        ordered = sorted(hosts)
        gains = [sh for sh in range(N_SHARDS)
                 if ordered[partition_of(INDEX, sh, 256) % 2] == hosts[1]]
        if min_gains <= len(gains) < N_SHARDS:
            return ports, hosts, gains
    raise RuntimeError("could not find a scaling port pair")


def make_server(tmp_path, name, port, **kw):
    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.cluster.health import ResilienceConfig

    kw.setdefault("cache_flush_interval", 0)
    kw.setdefault("member_monitor_interval", 0)
    kw.setdefault("anti_entropy_interval", 0)
    kw.setdefault("executor_workers", 0)
    kw.setdefault("hasher", ModHasher())
    kw.setdefault("rebalance_config", RebalanceConfig(
        catchup_threshold_bytes=256, max_catchup_rounds=8,
        cutover_pause_max=2.0,
    ))
    kw.setdefault("resilience_config", ResilienceConfig(
        breaker_backoff=0.1, breaker_backoff_max=0.5,
        retry_budget=100.0, retry_refill=1.0,
    ))
    s = Server(data_dir=str(tmp_path / name), port=port, **kw)
    s.open()
    return s


def wait_for(cond, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.03)
    return False


def load_base(client, h0):
    client.ensure_index(h0, INDEX)
    client.ensure_field(h0, INDEX, "f")
    time.sleep(0.05)
    cols = [sh * SHARD_WIDTH + 7 for sh in range(N_SHARDS)]
    for col in cols:
        client.query(h0, INDEX, f"Set({col}, f=1)")
    assert client.query(
        h0, INDEX, "Count(Row(f=1))")["results"][0] == N_SHARDS
    return cols


def pump_traffic(server, n=200):
    for _ in range(n):
        server.scheduler.note_index(INDEX)


@pytest.mark.chaos
def test_cluster_scale_out_then_in(tmp_path):
    """Load-driven membership, no operator action: sustained traffic
    admits the standby through the real coordinator join path; sustained
    idle takes exactly that node back. Data serves throughout."""
    ports, hosts, gains = scale_ports()
    h0srv = make_server(tmp_path, "n0", ports[0], cluster_hosts=[hosts[0]])
    standby = make_server(tmp_path, "s1", ports[1],
                          cluster_hosts=[hosts[1]], is_coordinator=True)
    servers = [h0srv, standby]
    client = InternalClient(timeout=10.0)
    h0 = h0srv.node.uri
    try:
        load_base(client, h0)
        c = AutoscaleController(h0srv, AutoscaleConfig(
            interval=1.0, window=1, scale_out_qps=5.0, scale_in_qps=1.0,
            cooldown=0.0, standby=hosts[1],
        ))
        assert c.step() == "seeding"
        time.sleep(0.05)
        pump_traffic(h0srv)
        assert c.step() == "out"
        stats = h0srv.rebalance_stats.counters
        assert wait_for(
            lambda: stats["jobs_completed"] >= 1
            and len(h0srv.cluster.nodes) == 2
            and h0srv.cluster.next_nodes is None
        ), "autoscale join did not complete"
        # Revert arming is transient: a completed job clears it.
        assert h0srv.rebalance_coordinator.revert_on_abort is False
        assert client.query(
            h0, INDEX, "Count(Row(f=1))")["results"][0] == N_SHARDS
        for sh in gains:
            assert standby.holder.fragment(
                INDEX, "f", "standard", sh) is not None
        with open(os.path.join(h0srv.data_dir, STATE_FILE)) as f:
            assert json.load(f)["added"] == [standby.node.id]

        # Sustained idle: the controller removes ONLY the node it added.
        # (The verification queries above count as traffic; poll until
        # the rate decays under the low watermark.)
        assert wait_for(lambda: c.step() == "in", timeout=10), \
            "sustained idle did not trigger scale-in"
        assert wait_for(
            lambda: stats["jobs_completed"] >= 2
            and len(h0srv.cluster.nodes) == 1
            and h0srv.cluster.next_nodes is None
        ), "autoscale leave did not complete"
        assert client.query(
            h0, INDEX, "Count(Row(f=1))")["results"][0] == N_SHARDS
        with open(os.path.join(h0srv.data_dir, STATE_FILE)) as f:
            assert json.load(f)["added"] == []
        assert c.counters["scale_out"] == 1 and c.counters["scale_in"] == 1
    finally:
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


@pytest.mark.chaos
def test_abort_mid_migration_fully_reverts(tmp_path):
    """THE autoscale revert test: an autoscale-started join aborted
    after >= 1 shard committed escalates (revert_on_abort) into the
    reverse migration — routing restored with zero mixed state, zero
    frozen fragments, all acked data served by the prior owner."""
    ports, hosts, gains = scale_ports(min_gains=2)
    throttled = RebalanceConfig(
        catchup_threshold_bytes=256, max_catchup_rounds=8,
        cutover_pause_max=2.0, max_bytes_per_sec=8192,
    )
    h0srv = make_server(tmp_path, "n0", ports[0], cluster_hosts=[hosts[0]],
                        rebalance_config=throttled)
    standby = make_server(tmp_path, "s1", ports[1],
                          cluster_hosts=[hosts[1]], is_coordinator=True,
                          rebalance_config=throttled)
    servers = [h0srv, standby]
    client = InternalClient(timeout=10.0)
    h0 = h0srv.node.uri
    try:
        load_base(client, h0)
        # Fatten the LAST gaining shard so it streams for seconds under
        # the byte throttle while the first commits quickly — a wide,
        # deterministic abort window between the two cutovers.
        fat = gains[-1]
        offs = [o for o in range(0, 200000, 10) if o != 7]
        client.import_bits(
            h0, INDEX, "f",
            [(1, fat * SHARD_WIDTH + o) for o in offs])
        acked = N_SHARDS + len(offs)
        assert client.query(
            h0, INDEX, "Count(Row(f=1))")["results"][0] == acked

        c = AutoscaleController(h0srv, AutoscaleConfig(
            interval=1.0, window=1, scale_out_qps=5.0, scale_in_qps=1.0,
            cooldown=0.0, standby=hosts[1],
        ))
        c.step()
        time.sleep(0.05)
        pump_traffic(h0srv)
        # Deterministic abort window: the per-instruction byte throttle is
        # SHARED across the concurrent shard streams, so both can drain
        # together and their cutovers cluster at job end — polling for
        # committed >= 1 then races a millisecond window. A count=1
        # latency delays exactly ONE shard's catch-up pull: the other
        # commits >= 1.5s before the job can complete, whatever the
        # stream interleaving.
        failpoints.configure("migrate-delta", "latency", count=1,
                             arg=1500.0)
        assert c.step() == "out"
        coord = h0srv.rebalance_coordinator
        assert coord is not None and coord.revert_on_abort is True

        def committed_one():
            job = coord.job
            return (job is not None and not job.revert
                    and len(job.committed) >= 1)

        # Generous timeout: under full-suite CPU load the throttled fat
        # shard stream can crawl, but the tiny shards always commit first.
        assert wait_for(committed_one, timeout=90.0), \
            "no shard committed before the abort window"
        # Chaos: abort mid-migration. No revert=True needed — the
        # autoscaler's armed contract escalates the plain abort.
        coord.abort("chaos: injected mid-migration abort")
        stats = h0srv.rebalance_stats.counters
        assert wait_for(
            lambda: stats.get("jobs_reverted", 0) >= 1
            and coord.job is None
        ), "reverse migration did not complete"
        # Routing fully restored: prior membership, no overrides, no
        # mixed per-shard state, flag disarmed.
        assert len(h0srv.cluster.nodes) == 1
        assert h0srv.cluster.next_nodes is None
        assert h0srv.cluster.migrated == set()
        assert coord.revert_on_abort is False
        # Every shard is served by the prior owner again...
        for sh in range(N_SHARDS):
            owners = [n.id for n in h0srv.cluster.shard_nodes(INDEX, sh)]
            assert owners == [h0srv.node.id]
        # ...with zero lost acked writes, byte-for-byte.
        assert client.query(
            h0, INDEX, "Count(Row(f=1))")["results"][0] == acked
        # And nothing stayed frozen: new writes land immediately.
        client.query(h0, INDEX, f"Set({gains[0] * SHARD_WIDTH + 99}, f=1)")
        assert client.query(
            h0, INDEX, "Count(Row(f=1))")["results"][0] == acked + 1
    finally:
        failpoints.reset()
        for s in servers:
            try:
                s.close()
            except Exception:
                pass
