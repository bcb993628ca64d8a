"""tests/test_health.py against the port: unit tests for the peer
fault-tolerance layer (cluster/health.py):
circuit breaker lifecycle, retry budget, hedging math, the DownView set
facade, and the executor integration (zero connects while a breaker is
open, budget-gated replica re-map, hedged remote reads)."""

import pytest

from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.health import (
    CLOSED, HALF_OPEN, OPEN, HealthRegistry, ResilienceConfig,
)
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.errors import PilosaError
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.server.client import ClientError


def make_health(clock, **kw):
    return HealthRegistry(ResilienceConfig(**kw).validate(), clock=clock)


# ----------------------------------------------------------- breaker core


def test_breaker_opens_after_threshold(fake_clock):
    h = make_health(fake_clock, breaker_failures=3)
    h.record_failure("n1")
    h.record_failure("n1")
    assert h.state("n1") == CLOSED and not h.is_down("n1")
    h.record_failure("n1")
    assert h.state("n1") == OPEN and h.is_down("n1")
    assert h.counters["breaker_opened"] == 1


def test_breaker_success_resets_streak(fake_clock):
    h = make_health(fake_clock, breaker_failures=2)
    h.record_failure("n1")
    h.record_success("n1")
    h.record_failure("n1")
    assert h.state("n1") == CLOSED  # streak broken by the success


def test_breaker_half_open_single_probe_and_reclose(fake_clock):
    h = make_health(fake_clock, breaker_backoff=1.0)
    h.record_failure("n1")  # default threshold 1 -> OPEN
    assert not h.allow_request("n1")
    assert h.counters["breaker_short_circuits"] == 1
    fake_clock.advance(1.0)
    # Backoff elapsed: exactly ONE request claims the probe slot.
    assert h.allow_request("n1")
    assert h.state("n1") == HALF_OPEN
    assert not h.allow_request("n1")
    h.record_success("n1")
    assert h.state("n1") == CLOSED and not h.is_down("n1")
    assert h.allow_request("n1")


def test_breaker_failed_probe_doubles_backoff(fake_clock):
    h = make_health(fake_clock, breaker_backoff=1.0, breaker_backoff_max=3.0)
    h.record_failure("n1")
    fake_clock.advance(1.0)
    assert h.allow_request("n1")  # probe
    h.record_failure("n1")  # probe failed -> backoff 2.0
    fake_clock.advance(1.0)
    assert not h.allow_request("n1")
    fake_clock.advance(1.0)
    assert h.allow_request("n1")  # next probe at +2.0
    h.record_failure("n1")  # backoff would be 4.0, capped at 3.0
    fake_clock.advance(2.9)
    assert not h.allow_request("n1")
    fake_clock.advance(0.2)
    assert h.allow_request("n1")


def test_breaker_unreported_probe_expires(fake_clock):
    h = make_health(fake_clock, breaker_backoff=1.0, probe_ttl=5.0)
    h.record_failure("n1")
    fake_clock.advance(1.0)
    assert h.allow_request("n1")  # probe claimed, caller dies silently
    fake_clock.advance(5.1)
    # TTL expired: the lost probe counts as failed (backoff doubled to
    # 2.0) and the slot is claimable again after it.
    assert not h.allow_request("n1")
    fake_clock.advance(2.0)
    assert h.allow_request("n1")


def test_probe_due_does_not_claim(fake_clock):
    h = make_health(fake_clock, breaker_backoff=1.0)
    h.record_failure("n1")
    fake_clock.advance(1.0)
    assert h.probe_due("n1")
    assert h.probe_due("n1")  # no side effects
    assert h.allow_request("n1")  # the claim still available


# ------------------------------------------------------------ retry budget


def test_retry_budget_drains_and_refills(fake_clock):
    h = make_health(fake_clock, retry_budget=2.0, retry_refill=0.5)
    assert h.try_spend_retry()
    assert h.try_spend_retry()
    assert not h.try_spend_retry()
    assert h.counters["retries_denied"] == 1
    # Two successes refill one token.
    h.record_success("n1")
    h.record_success("n1")
    assert h.try_spend_retry()
    assert not h.try_spend_retry()


def test_retry_budget_zero_means_unlimited(fake_clock):
    h = make_health(fake_clock, retry_budget=0.0)
    for _ in range(100):
        assert h.try_spend_retry()
    assert h.counters["retries_denied"] == 0


# ----------------------------------------------------------------- hedging


def test_hedge_delay_fixed_and_adaptive(fake_clock):
    h = make_health(fake_clock, hedge_delay=0.2)
    assert h.hedge_delay("n1") == 0.2
    h = make_health(fake_clock, hedge_delay=0.0, hedge_min_delay=0.05)
    assert h.hedge_delay("n1") == 0.05  # no samples -> floor
    for ms in range(1, 101):
        h.record_success("n1", latency=ms / 1000.0)
    # p99 of 1..100ms ~ 0.1s, well above the floor.
    assert 0.09 <= h.hedge_delay("n1") <= 0.1


def test_hedge_volume_cap(fake_clock):
    h = make_health(fake_clock, hedge_max_fraction=0.1)
    for _ in range(100):
        h.record_success("n1")
    fired = sum(1 for _ in range(50) if h.allow_hedge())
    # 10% of 100 requests -> ~10 hedges allowed, the rest suppressed.
    assert fired == 10
    assert h.counters["hedges_suppressed"] == 40
    h2 = make_health(fake_clock, hedge_max_fraction=0.0)
    assert not h2.hedge_enabled()
    assert not h2.allow_hedge()


# ------------------------------------------------------- DownView facade


def test_downview_set_semantics(fake_clock):
    c = Cluster(node=Node(id="n0"),
                nodes=[Node(id="n0"), Node(id="n1"), Node(id="n2")])
    c.health.clock = fake_clock
    assert c.unavailable == set()
    c.mark_unavailable("n1")
    assert "n1" in c.unavailable
    assert set(c.unavailable) == {"n1"}
    assert c.unavailable  # truthy
    c.unavailable.add("n2")
    assert len(c.unavailable) == 2
    c.unavailable.clear()
    assert c.unavailable == set()
    # mark_available is exact: re-marking a healthy node is a no-op.
    c.mark_unavailable("n1")
    c.mark_available("n1")
    assert c.health.state("n1") == CLOSED


def test_remove_node_prunes_health(fake_clock):
    c = Cluster(node=Node(id="n0"), nodes=[Node(id="n0"), Node(id="n1")])
    c.health.clock = fake_clock
    c.mark_unavailable("n1")
    assert "n1" in c.unavailable
    assert c.remove_node("n1")
    # A re-add with the same id must start with a clean breaker.
    assert "n1" not in c.unavailable
    assert c.health.state("n1") == CLOSED
    c.add_node(Node(id="n1"))
    assert "n1" not in c.unavailable


# ------------------------------------------------- executor integration


class CountingClient:
    """query_node double that fails with a given status, counting calls."""

    def __init__(self, status=0):
        self.status = status
        self.calls = 0

    def query_node(self, node, index, query, shards=None, remote=True):
        self.calls += 1
        raise ClientError("boom", status=self.status)


def _exec_fixture(fake_clock, replica_n=1, client=None, **resilience):
    nodes = [Node(id="n0"), Node(id="n1"), Node(id="n2")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=replica_n,
                      hasher=ModHasher())
    cluster.health.configure(
        ResilienceConfig(**resilience).validate(), clock=fake_clock
    )
    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("hx")
    idx.create_field("f")
    client = client or CountingClient()
    ex = Executor(holder, cluster=cluster, client=client, workers=0)
    return ex, cluster, client


def test_executor_zero_connects_while_breaker_open(fake_clock):
    """Acceptance: a blackholed peer costs ZERO connect attempts on the
    query path between half-open probes, and the counters prove it."""
    ex, cluster, client = _exec_fixture(fake_clock, breaker_backoff=2.0)
    remote_shard = next(
        s for s in range(4) if cluster.shard_nodes("hx", s)[0].id == "n1"
    )
    with pytest.raises(PilosaError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == 1
    assert "n1" in cluster.unavailable

    # Steady state: repeated queries never dial the dead peer.
    for _ in range(5):
        with pytest.raises(PilosaError):
            ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == 1
    assert cluster.health.counters["breaker_short_circuits"] >= 5

    # Backoff elapses: exactly one query becomes the half-open probe.
    fake_clock.advance(2.0)
    with pytest.raises(PilosaError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == 2
    assert cluster.health.counters["half_open_probes"] == 1
    # The failed probe re-opened with doubled backoff: still no dials.
    with pytest.raises(PilosaError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == 2


def test_executor_retry_budget_bounds_remap(fake_clock):
    """Replica re-map volume stays within the configured budget: once the
    bucket drains, the query fails cleanly instead of walking replicas."""
    ex, cluster, client = _exec_fixture(
        fake_clock, replica_n=2, retry_budget=1.0, retry_refill=0.0
    )
    remote_shard = next(
        s for s in range(8)
        if all(n.id != "n0" for n in cluster.shard_nodes("hx", s))
    )
    # Both owners are remote and failing: the first failure spends the
    # only retry token, the second re-map is denied.
    with pytest.raises(PilosaError, match="retry budget exhausted"):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == 2  # primary + the one budgeted retry
    assert cluster.health.counters["retries_denied"] == 1


def test_executor_recovery_recloses_breaker(fake_clock):
    """A peer that comes back is readmitted through one successful
    half-open probe, after which traffic flows normally again."""

    class FlappingClient:
        def __init__(self):
            self.calls = 0
            self.dead = True

        def query_node(self, node, index, query, shards=None, remote=True):
            self.calls += 1
            if self.dead:
                raise ClientError("down", status=0)
            return [len(shards or [])]

    client = FlappingClient()
    ex, cluster, _ = _exec_fixture(fake_clock, client=client,
                                   breaker_backoff=1.0)
    remote_shard = next(
        s for s in range(4) if cluster.shard_nodes("hx", s)[0].id == "n1"
    )
    with pytest.raises(PilosaError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    client.dead = False
    fake_clock.advance(1.0)
    out = ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert out == [1]
    assert cluster.health.state("n1") == CLOSED
    assert "n1" not in cluster.unavailable
    # Fully readmitted: subsequent queries dial it directly.
    before = client.calls
    ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == before + 1


def test_hedged_read_first_good_response_wins(fake_clock):
    """A slow primary triggers a hedge to a replica owning the same shard
    batch; the replica's answer is returned and counted as a hedge win."""
    import threading

    release = threading.Event()

    class SlowPrimaryClient:
        def __init__(self):
            self.targets = []

        def query_node(self, node, index, query, shards=None, remote=True):
            self.targets.append(node.id)
            if node.id == "n1":
                release.wait(5.0)  # primary stuck until the test ends
            return [7]

    nodes = [Node(id="n0"), Node(id="n1"), Node(id="n2")]
    cluster = Cluster(node=nodes[0], nodes=nodes, replica_n=2,
                      hasher=ModHasher())
    cluster.health.configure(
        ResilienceConfig(hedge_delay=0.01, hedge_max_fraction=1.0).validate()
    )
    holder = Holder(None, device="cpu")
    holder.open()
    idx = holder.create_index("hx")
    idx.create_field("f")
    client = SlowPrimaryClient()
    ex = Executor(holder, cluster=cluster, client=client, workers=4)
    try:
        # A shard whose owner set is {n1, n2} (n0 not a replica): primary
        # n1 stalls, the hedge goes to n2.
        shard = next(
            s for s in range(8)
            if {n.id for n in cluster.shard_nodes("hx", s)} == {"n1", "n2"}
        )
        out = ex.execute("hx", "Count(Row(f=1))", shards=[shard])
        assert out == [7]
        assert client.targets[0] == "n1" and "n2" in client.targets
        assert cluster.health.counters["hedges_fired"] == 1
        assert cluster.health.counters["hedges_won"] == 1
    finally:
        release.set()
        ex.close()


def test_half_open_probe_4xx_recloses_breaker(fake_clock):
    """A half-open probe answered with a 4xx proves the peer is
    TRANSPORT-healthy: the breaker must re-close (the app error still
    surfaces), not wedge HALF_OPEN until probe_ttl."""

    class PhaseClient:
        def __init__(self):
            self.status = 0
            self.calls = 0

        def query_node(self, node, index, query, shards=None, remote=True):
            self.calls += 1
            raise ClientError("boom", status=self.status)

    client = PhaseClient()
    ex, cluster, _ = _exec_fixture(fake_clock, client=client,
                                   breaker_backoff=1.0)
    remote_shard = next(
        s for s in range(4) if cluster.shard_nodes("hx", s)[0].id == "n1"
    )
    with pytest.raises(PilosaError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert cluster.health.state("n1") == OPEN

    client.status = 400  # peer restarted; transport fine, schema lagging
    fake_clock.advance(1.0)
    with pytest.raises(ClientError):  # the 4xx surfaces to the caller
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert cluster.health.state("n1") == CLOSED
    # Fully readmitted: the next query dials it again immediately.
    before = client.calls
    with pytest.raises(ClientError):
        ex.execute("hx", "Count(Row(f=1))", shards=[remote_shard])
    assert client.calls == before + 1
