"""The cases of tests/test_qos.py, run against the port on the CPU.

Tenant QoS tests: trace-charged budgets, SLO-classed shedding.

Ledger math runs on the fake monotonic clock from conftest (refill only
moves when the test advances time), scheduler integration uses real
threads parked on the admission queues, and the HTTP tests drive the
X-Pilosa-Tenant header end to end through a live server.
"""

import json
import random
import threading

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.obs.trace import Trace
from pilosa_tpu_torch.sched import (
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    Deadline,
    QosConfig,
    QueryScheduler,
    QueueFullError,
    SchedulerConfig,
    TenantBudgetError,
    TenantLedger,
)
from pilosa_tpu_torch.sched.qos import measured_cost_ms


def Server(*args, **kw):
    """The port's server on the CPU."""
    from pilosa_tpu_torch.server.server import Server as _Server

    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


def ledger(fake_clock, **kw):
    kw.setdefault("rate", 10.0)       # 10 ms of budget per second
    kw.setdefault("burst", 100.0)
    kw.setdefault("estimate_ms", 50.0)
    return TenantLedger(QosConfig(**kw), clock=fake_clock,
                        rng=random.Random(7))


# ------------------------------------------------------------------ config


def test_qos_config_validation():
    QosConfig().validate()  # defaults are legal (and disabled: rate 0)
    for bad in (
        QosConfig(rate=-1),
        QosConfig(burst=0),
        QosConfig(default_tenant_share=0),
        QosConfig(interactive_cap=0.5),
        QosConfig(estimate_ms=-1),
    ):
        with pytest.raises(ValueError):
            bad.validate()


def test_disabled_ledger_is_free(fake_clock):
    led = ledger(fake_clock, rate=0.0)
    assert not led.enabled
    assert led.admission_verdict("t", CLASS_BATCH) is False
    assert led.charge_estimate("t") == 0.0
    led.settle("t", 0.0, 123.0)  # no-op, no bucket created
    assert led.snapshot()["tenants"] == 0
    assert led.snapshot()["enabled"] is False


# ----------------------------------------------------------------- buckets


def test_refill_and_burst_cap(fake_clock):
    led = ledger(fake_clock)
    # A new bucket starts full at burst x share.
    assert led.balance("t") == pytest.approx(100.0)
    led.charge_estimate("t")
    assert led.balance("t") == pytest.approx(50.0)
    # Refill at rate x share ms per second of wall time...
    fake_clock.advance(2.0)
    assert led.balance("t") == pytest.approx(70.0)
    # ...capped at burst x share, no matter how long the idle.
    fake_clock.advance(3600.0)
    assert led.balance("t") == pytest.approx(100.0)


def test_share_scales_rate_and_cap(fake_clock):
    led = ledger(fake_clock)
    led.set_share("gold", 2.0)
    for _ in range(4):
        led.charge_estimate("gold")  # 200 charged
    assert led.balance("gold") == pytest.approx(-100.0)
    fake_clock.advance(5.0)  # refills 10 * 2.0 * 5 = 100
    assert led.balance("gold") == pytest.approx(0.0)
    fake_clock.advance(3600.0)
    assert led.balance("gold") == pytest.approx(200.0)  # burst x share
    with pytest.raises(ValueError):
        led.set_share("gold", 0.0)


# ------------------------------------------------------------ shed ordering


def test_batch_sheds_at_dry_with_derived_retry_after(fake_clock):
    led = ledger(fake_clock)
    for _ in range(3):
        led.charge_estimate("noisy")  # balance 100 - 150 = -50
    with pytest.raises(TenantBudgetError) as ei:
        led.admission_verdict("noisy", CLASS_BATCH)
    # Typed 429: the tenant rides the error so a multiplexing client can
    # throttle one stream, and Retry-After is derived from THIS tenant's
    # deficit: (debt + estimate) / rate = (50 + 50) / 10 = 10s, +/-25%.
    assert ei.value.tenant == "noisy"
    assert 10.0 * 0.75 <= ei.value.retry_after <= 10.0 * 1.25
    assert led.counters["shed_batch"] == 1
    # Other tenants are untouched: fresh bucket, no shed.
    assert led.admission_verdict("quiet", CLASS_BATCH) is False


def test_interactive_defers_until_hard_cap(fake_clock):
    led = ledger(fake_clock, interactive_cap=2.0)  # cap: 200ms of debt
    for _ in range(3):
        led.charge_estimate("t")  # balance -50: dry but under the cap
    assert led.admission_verdict("t", CLASS_INTERACTIVE) is True
    assert led.counters["deferred"] == 1
    for _ in range(4):
        led.charge_estimate("t")  # balance -250: past 2.0 x 100 debt
    with pytest.raises(TenantBudgetError):
        led.admission_verdict("t", CLASS_INTERACTIVE)
    assert led.counters["shed_interactive"] == 1
    # Batch for the same tenant shed the whole time.
    with pytest.raises(TenantBudgetError):
        led.admission_verdict("t", CLASS_BATCH)


def test_retry_after_clamped(fake_clock):
    # A huge deficit must not advertise a wait past RETRY_MAX...
    led = ledger(fake_clock, rate=0.001)
    for _ in range(10):
        led.charge_estimate("t")
    with pytest.raises(TenantBudgetError) as ei:
        led.admission_verdict("t", CLASS_BATCH)
    assert ei.value.retry_after == TenantLedger.RETRY_MAX
    # ...and a tiny one never says "0" (stampede).
    led2 = ledger(fake_clock, rate=1e9)
    led2.charge_estimate("t")
    led2._buckets["t"].balance = -1e-9
    with pytest.raises(TenantBudgetError) as ei:
        led2.admission_verdict("t", CLASS_BATCH)
    assert ei.value.retry_after >= TenantLedger.RETRY_MIN


# ---------------------------------------------------------------- charging


def test_settle_reconciles_estimate_to_measured(fake_clock):
    led = ledger(fake_clock)
    est = led.charge_estimate("t")
    assert est == 50.0
    led.settle("t", est, measured=200.0)
    # Net charge is the MEASURED cost: 100 - 200.
    assert led.balance("t") == pytest.approx(-100.0)
    assert led.counters["settled_traced"] == 1
    # First sample seeds the EWMA; the second folds in at 0.1.
    snap = led.snapshot()
    assert snap["top"]["t"]["mean_ms"] == pytest.approx(200.0)
    led.settle("t", led.charge_estimate("t"), measured=100.0)
    assert led.snapshot()["top"]["t"]["mean_ms"] == pytest.approx(190.0)


def test_untraced_query_charged_rolling_mean(fake_clock):
    led = ledger(fake_clock)
    # No samples yet: an untraced settle stands on the estimate.
    led.settle("t", led.charge_estimate("t"), measured=None)
    assert led.balance("t") == pytest.approx(50.0)
    assert led.counters["settled_untraced"] == 1
    # With a traced mean established, untraced queries charge the mean —
    # a low sample rate cannot starve the ledger.
    led.settle("t", led.charge_estimate("t"), measured=30.0)  # 50-30 = 20
    led.settle("t", led.charge_estimate("t"), measured=None)  # 20-30 = -10
    assert led.balance("t") == pytest.approx(-10.0)


def test_measured_cost_sums_charged_spans_only(fake_clock):
    t = Trace("00ff", clock=fake_clock)
    t.record("device.dispatch", 5.0)
    t.record("gather", 3.0)
    t.record("tier.promote", 2.0)
    t.record("sched.wait", 400.0)  # queueing is the penalty, not the crime
    t.record("parse", 1.0)
    assert measured_cost_ms(t) == pytest.approx(10.0)
    # No active trace and no argument -> None (caller uses the mean).
    assert measured_cost_ms() is None


# ----------------------------------------------------------------- bounds


def test_tenant_table_recency_eviction(fake_clock):
    led = ledger(fake_clock)
    led.TENANTS_MAX = 3  # instance override; class default is 1024
    for t in ("a", "b", "c"):
        led.charge_estimate(t)
    led.charge_estimate("a")  # refresh a: b is now least recent
    led.charge_estimate("d")  # evicts b
    snap = led.snapshot()
    assert snap["tenants"] == 3
    assert led.counters["tenants_evicted"] == 1
    assert "b" not in snap["top"] and "a" in snap["top"]
    # An evicted tenant only forgot history: it comes back with a full
    # bucket, never an error.
    assert led.balance("b") == pytest.approx(100.0)


def test_snapshot_bounded_top_n(fake_clock):
    led = ledger(fake_clock)
    for i in range(10):
        for _ in range(i + 1):
            led.settle(f"t{i}", 0.0, measured=10.0)
    snap = led.snapshot(top_n=3)
    assert snap["tenants"] == 10
    assert len(snap["top"]) == 3
    # Ranked by cumulative charged cost: the busiest three.
    assert set(snap["top"]) == {"t9", "t8", "t7"}


# ------------------------------------------------- scheduler integration


def test_scheduler_sheds_dry_tenant(fake_clock):
    led = ledger(fake_clock, estimate_ms=60.0)
    sched = QueryScheduler(SchedulerConfig(), qos=led)
    with sched.admit(CLASS_BATCH, tenant="noisy"):
        pass  # charges 60, settles at the estimate (untraced, no mean)
    with sched.admit(CLASS_BATCH, tenant="noisy"):
        pass  # balance now -20: dry
    with pytest.raises(TenantBudgetError) as ei:
        with sched.admit(CLASS_BATCH, tenant="noisy"):
            pass  # pragma: no cover - shed before entry
    assert ei.value.tenant == "noisy"
    assert sched.counters["shed_tenant"] == 1
    # A shed costs nothing: no slot taken, no admitted tick.
    assert sched.counters["admitted_batch"] == 2
    # The quiet tenant is unaffected by the noisy one's debt.
    with sched.admit(CLASS_BATCH, tenant="quiet"):
        pass
    assert sched.counters["admitted_batch"] == 3


def test_over_budget_waiter_yields_to_in_budget(fake_clock):
    """The shed ordering contract's queue half: a released slot goes to
    the in-budget queue head even when an over-budget waiter has been
    parked longer."""
    led = ledger(fake_clock, interactive_cap=100.0)
    led.charge_estimate("noisy")
    led.charge_estimate("noisy")  # balance 0: over budget, defers
    sched = QueryScheduler(
        SchedulerConfig(interactive_concurrency=1, max_queue=8), qos=led)
    order = []
    hold, entered = threading.Event(), threading.Event()

    def occupant():
        with sched.admit(CLASS_INTERACTIVE, tenant="quiet"):
            entered.set()
            hold.wait(timeout=10)

    def runner(tenant):
        with sched.admit(CLASS_INTERACTIVE, tenant=tenant):
            order.append(tenant)

    t0 = threading.Thread(target=occupant)
    t0.start()
    assert entered.wait(timeout=5)
    t_noisy = threading.Thread(target=runner, args=("noisy",))
    t_noisy.start()
    assert wait_until(lambda: sched.queue_depth() == 1)
    t_quiet = threading.Thread(target=runner, args=("quiet",))
    t_quiet.start()
    assert wait_until(lambda: sched.queue_depth() == 2)
    assert sched.counters["deferred_over_budget"] == 1
    hold.set()
    for t in (t0, t_noisy, t_quiet):
        t.join(timeout=10)
    # The quiet (in-budget) tenant admitted first despite arriving last.
    assert order == ["quiet", "noisy"]


def wait_until(cond, timeout=5.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return False


def test_qos_charge_failpoint_does_not_leak_slot(fake_clock):
    """Settle happens AFTER the slot release: a qos-charge fault
    surfaces to the caller but never wedges the concurrency gate."""
    led = ledger(fake_clock)
    sched = QueryScheduler(
        SchedulerConfig(interactive_concurrency=1), qos=led)
    failpoints.configure("qos-charge", "error", count=1,
                         message="injected settle fault")
    try:
        with pytest.raises(failpoints.InjectedFault,
                           match="injected settle fault"):
            with sched.admit(CLASS_INTERACTIVE, tenant="t"):
                pass
        # The slot came back: this admit must not park (a leaked slot
        # would park it until the deadline trips).
        with sched.admit(CLASS_INTERACTIVE, tenant="t",
                         deadline=Deadline(2.0)):
            pass
        assert sched.counters["admitted"] == 2
    finally:
        failpoints.reset()


# --------------------------------------------------------------- HTTP e2e


@pytest.fixture
def qos_server(tmp_path):
    from tests.test_torch_qos import Server

    s = Server(
        data_dir=str(tmp_path / "node0"), cache_flush_interval=0,
        qos_config=QosConfig(rate=0.001, burst=5.0, interactive_cap=2.0,
                             estimate_ms=5.0),
    )
    s.open()
    yield s
    s.close()


def _post(port, path, body, headers=None):
    import http.client

    conn = http.client.HTTPConnection(f"localhost:{port}", timeout=30)
    try:
        conn.request("POST", path, body=body.encode(),
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_http_tenant_header_end_to_end(qos_server):
    from pilosa_tpu_torch.server.client import InternalClient

    s = qos_server
    client = InternalClient()
    host = f"localhost:{s.port}"
    client.create_index(host, "i")
    client.create_field(host, "i", "f")
    client.query(host, "i", "Set(1, f=1)")

    # Explicit tenant header: query admits, bucket charged, trace tagged.
    status, _, body = _post(s.port, "/index/i/query", "Count(Row(f=1))",
                            {"X-Pilosa-Tenant": "acme"})
    assert status == 200
    assert json.loads(body)["results"][0] == 1
    snap = s.qos.snapshot()
    assert "acme" in snap["top"] and snap["top"]["acme"]["queries"] == 1
    traces = [t for t in s.trace_recorder.traces()
              if t.get("tags", {}).get("tenant") == "acme"]
    assert traces, "traced query must carry the tenant tag"
    # ...and the ledger billed it as a qos.charge span.
    assert any(sp["name"] == "qos.charge" for sp in traces[0]["spans"])

    # Shed ordering over HTTP. Default tenant is the index name: drain
    # "i" to dry-but-under-the-hard-cap by hand (2 x 5ms > burst-less
    # refill at rate 0.001).
    s.qos.charge_estimate("i")
    s.qos.charge_estimate("i")
    assert s.qos.balance("i") <= 0
    # Interactive still admits (deferred, not shed)...
    status, _, body = _post(s.port, "/index/i/query", "Count(Row(f=1))")
    assert status == 200
    # ...but batch (an import) sheds with the typed 429.
    payload = json.dumps({"shard": 0, "rowIDs": [2], "columnIDs": [9]})
    status, headers, body = _post(
        s.port, "/index/i/field/f/import", payload,
        {"Content-Type": "application/json"})
    assert status == 429
    assert headers.get("X-Pilosa-Tenant") == "i"
    assert float(headers.get("Retry-After")) >= 1
    # Past the hard cap (2.0 x 5.0 = 10ms of debt), interactive sheds too.
    for _ in range(4):
        s.qos.charge_estimate("i")
    status, headers, _ = _post(s.port, "/index/i/query", "Count(Row(f=1))")
    assert status == 429
    assert headers.get("X-Pilosa-Tenant") == "i"
    snap = s.qos.snapshot()
    assert snap["shed_batch"] >= 1 and snap["shed_interactive"] >= 1

    # The ledger is a /debug/vars group (docs/observability.md).
    import urllib.request

    with urllib.request.urlopen(f"http://{host}/debug/vars") as resp:
        dv = json.load(resp)
    assert dv["qos"]["enabled"] is True
    assert dv["qos"]["shed_batch"] >= 1
    assert "autoscale" in dv  # controller group rides along, even idle
