"""The device-fault ladder: the port against the JAX package on the CPU.

Mirrors tests/test_device_faults.py, each case run on both packages
(pilosa_tpu and pilosa_tpu_torch, holder on device="cpu") with the same
seeded data, the same failpoints and the same fake breaker clock: dispatch
failures are classified (oom / compile / runtime / timeout), the
per-signature and plane breakers route around the device (per-shard walk,
then host execution), an OOM gets backpressure and a retry instead of a
client error, half-open probes re-close the breakers, and every answer,
breaker snapshot and shared counter delta equals the reference's.

The deadline gates between TopN's device chunks and at its phase-2
boundary (TestDeadlineBetweenChunks) and the chaos test's routing-epoch
churn (rebalance begin / cutover / commit on the executor's own
one-node cluster) run on both packages too. Left out: the
`device-compile` cases (the port compiles nothing per shape, so it has
no such failpoint). Added: a kernel that cannot be built (ops/kernels.py KernelBuildError) is
not a device fault: it raises out of the engine and out of
Executor.execute, untouched by the breakers, the counters and the ladder.
"""

import random
import threading
import time
from concurrent.futures import TimeoutError as FutTimeout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu import executor as jexecutor
from pilosa_tpu import failpoints as jfailpoints
from pilosa_tpu import stats as jstats
from pilosa_tpu.cluster.health import ResilienceConfig as JResilienceConfig
from pilosa_tpu.constants import SHARD_WIDTH
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.parallel import device_health as jdh
from pilosa_tpu.parallel import engine as jengine
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu.sched import deadline as jdeadline
from pilosa_tpu.tier import TierConfig as JTierConfig
from pilosa_tpu_torch import executor as texecutor
from pilosa_tpu_torch import failpoints as tfailpoints
from pilosa_tpu_torch import stats as tstats
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import EngineConfig as TEngineConfig
from pilosa_tpu_torch.parallel import device_health as tdh
from pilosa_tpu_torch.parallel import engine as tengine
from pilosa_tpu_torch.pql.parser import parse as tparse
from pilosa_tpu_torch.sched import deadline as tdeadline
from pilosa_tpu_torch.tier import TierConfig as TTierConfig

N_SHARDS = 2
SHARDS = tuple(range(N_SHARDS))

JAX = SimpleNamespace(
    name="jax", pkg=pilosa_tpu, fp=jfailpoints, dh=jdh, Res=JResilienceConfig,
    Engine=jengine.ShardedQueryEngine, EngineConfig=JEngineConfig,
    TierConfig=JTierConfig, Leaf=jengine.Leaf, pop=jengine._pop_elems,
    parse=jparse, FieldOptions=JFieldOptions, Stats=jstats.InMemoryStatsClient,
    ExecOptions=jexecutor.ExecOptions, Deadline=jdeadline.Deadline,
    DeadlineExceededError=jdeadline.DeadlineExceededError,
    Holder=lambda **kw: pilosa_tpu.Holder(None, **kw))
TORCH = SimpleNamespace(
    name="torch", pkg=pilosa_tpu_torch, fp=tfailpoints, dh=tdh, Res=tdh.ResilienceConfig,
    Engine=tengine.ShardedQueryEngine, EngineConfig=TEngineConfig,
    TierConfig=TTierConfig, Leaf=tengine.Leaf, pop=tengine._pop_elems,
    parse=tparse, FieldOptions=TFieldOptions, Stats=tstats.InMemoryStatsClient,
    ExecOptions=texecutor.ExecOptions, Deadline=tdeadline.Deadline,
    DeadlineExceededError=tdeadline.DeadlineExceededError,
    Holder=lambda **kw: pilosa_tpu_torch.Holder(None, device="cpu", **kw))
BOTH = (JAX, TORCH)

# Counters both engines keep with the same meaning. The delta counters are
# compared in tests/test_torch_delta.py: a single Count's refresh lands in
# stack_delta_hits in the port (K1 reads a stack) and in leaf_delta_hits,
# once per leaf, in the reference.
SHARED = ("memo_hits", "memo_misses", "leaf_tier_hits", "host_counts",
          "host_cold_counts", "host_topn",
          "oom_backpressure", "oom_retries", "oom_batch_splits",
          "watchdog_timeouts", "device_dispatch_errors", "count_dispatches")
LADDER_STATS = ("DeviceLadderFallback", "DeviceHostRouted", "DeviceSigQuarantined")


def call(pk, q):
    return pk.parse(q).calls[0]


def make_holder(pk):
    """tests/test_device_faults.py's data: 6 rows over 2 shards, seed 11."""
    h = pk.Holder(stats=pk.Stats())
    h.open()
    fld = h.create_index("i").create_field("f")
    rng = np.random.default_rng(11)
    for row in range(6):
        for shard in SHARDS:
            cols = rng.choice(4096, size=60 + 13 * row, replace=False)
            for c in cols:
                fld.set_bit(row, shard * SHARD_WIDTH + int(c))
    return h


def counters(eng, base=None):
    snap = eng.snapshot()
    return {k: snap[k] - (base or {}).get(k, 0) for k in SHARED}


def ladder_stats(holder):
    got = holder.stats.snapshot()["counters"]
    return {k: got.get(k, 0) for k in LADDER_STATS}


def make_engine(pk, holder, **kw):
    tier = kw.pop("tier_config", pk.TierConfig(host_bytes=1 << 26, prefetch_interval=0))
    return pk.Engine(holder, tier_config=tier, **kw)


def make_executor(pk, holder, **resilience):
    if pk is JAX:
        ex = pilosa_tpu.Executor(holder, workers=0)
        if resilience:
            ex.cluster.health.configure(JResilienceConfig(**resilience).validate())
        return ex
    cfg = tdh.ResilienceConfig(**resilience).validate() if resilience else None
    return pilosa_tpu_torch.Executor(holder, resilience_config=cfg)


def both(body):
    """Run body(pk, holder) on a fresh holder of each package, failpoints
    reset around it; returns {name: result}."""
    out = {}
    for pk in BOTH:
        h = make_holder(pk)
        try:
            out[pk.name] = body(pk, h)
        finally:
            pk.fp.reset()
            h.close()
    return out


def same(body):
    out = both(body)
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ------------------------------------------------------ classification


CLASSIFY = [
    ("RESOURCE_EXHAUSTED: out of memory allocating", "oom"),
    ("Out of memory while trying to allocate", "oom"),
    ("injected HBM OOM at failpoint 'device-dispatch'", "oom"),
    ("INVALID_ARGUMENT: bad operand", "compile"),
    ("Compilation failure: unsupported op", "compile"),
    ("Mosaic lowering failed", "compile"),
    ("boom", "runtime"),
]


@pytest.mark.parametrize("msg, kind", CLASSIFY)
def test_classify_like_jax(msg, kind):
    for pk in BOTH:
        assert pk.dh.classify_device_error(RuntimeError(msg)) == kind, pk.name


@pytest.mark.parametrize("exc", [
    lambda pk: pk.dh.DeviceDispatchTimeout("x"), lambda pk: TimeoutError(),
    lambda pk: FutTimeout()], ids=["watchdog", "builtin", "futures"])
def test_timeout_by_type_like_jax(exc):
    for pk in BOTH:
        assert pk.dh.classify_device_error(exc(pk)) == "timeout", pk.name


@pytest.mark.parametrize("exc, kind", [
    # torch.cuda.OutOfMemoryError's own text.
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 4.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.02 GiB is free."), "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (RuntimeError("cudaErrorMemoryAllocation"), "oom"),
    (RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"), "oom"),
    # ops/kernels.py _check_launch's text, and a sticky fault.
    (RuntimeError("gather_expr_count (staged) kernel launch failed: cudaError 700"),
     "runtime"),
    (RuntimeError("masked_plane_counts kernel launch failed: cudaError 2"), "runtime"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "runtime"),
    (RuntimeError("CUDA error: no kernel image is available for execution on the "
                  "device"), "compile"),
], ids=["torch_oom", "runtime_oom", "cuda_enum", "cublas", "launch_failed",
        "launch_failed_2", "illegal_address", "no_kernel_image"])
def test_classify_cuda_spellings(exc, kind):
    assert tdh.classify_device_error(exc) == kind


# ------------------------------------------------------ breaker lifecycle


def _plane_opens_and_probe_recloses(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(device_breaker_failures=3,
                                        device_breaker_backoff=2.0).validate(), clock=clock)
    trace = []
    for _ in range(2):
        dh.record_failure(("a",), "runtime")
    trace += [dh.plane_state(), dh.plan()]
    dh.record_failure(("a",), "runtime")
    trace += [dh.plane_state(), dh.plan()]
    clock.advance(2.0)
    trace += [dh.plan(), dh.plane_state(), dh.plan()]
    dh.record_success(("a",))
    trace.append(dh.plane_state())
    assert trace == ["closed", "device", "open", "host", "device", "half-open", "host",
                     "closed"]
    return trace, dh.snapshot()


def _failed_probe_doubles_backoff(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(
        device_breaker_failures=1, device_breaker_backoff=2.0,
        device_breaker_backoff_max=5.0).validate(), clock=clock)
    trace = []
    dh.record_failure(None, "runtime")
    clock.advance(2.0)
    trace.append(dh.plan())
    dh.record_failure(None, "runtime")
    trace.append(dh.plane_state())
    for step in (3.9, 0.1):
        clock.advance(step)
        trace.append(dh.plan())
    dh.record_failure(None, "runtime")
    for step in (4.9, 0.1):
        clock.advance(step)
        trace.append(dh.plan())
    assert trace == ["device", "open", "host", "device", "host", "device"]
    return trace, dh.snapshot()


def _sig_quarantine(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(
        device_breaker_failures=100, device_sig_failures=2,
        device_sig_backoff=10.0).validate(), clock=clock)
    bad, good = ("bad",), ("good",)
    trace = []
    dh.record_failure(bad, "compile")
    trace.append(dh.plan(bad))
    dh.record_failure(bad, "compile")
    trace += [dh.plan(bad), dh.plan(good), dh.plan(), dh.sig_state(bad)]
    clock.advance(10.0)
    trace.append(dh.plan(bad))
    dh.record_success(bad)
    trace.append(dh.sig_state(bad))
    assert trace == ["device", "shard", "device", "device", "open", "device", "closed"]
    return trace, dh.snapshot()


def _unresolved_probe_reclaims(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(device_breaker_failures=1,
                                        device_breaker_backoff=2.0).validate(), clock=clock)
    dh.record_failure(None, "runtime")
    trace = []
    for step in (2.0, 1.0, 1.0):
        clock.advance(step)
        trace.append(dh.plan())
    assert trace == ["device", "host", "device"]
    return trace, dh.snapshot()


def _quarantined_sig_never_probes(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(
        device_breaker_failures=2, device_sig_failures=1, device_breaker_backoff=2.0,
        device_sig_backoff=10.0).validate(), clock=clock)
    bad = ("bad",)
    dh.record_failure(bad, "compile")
    dh.record_failure(bad, "compile")
    trace = [dh.plane_state(), dh.sig_state(bad)]
    clock.advance(2.0)
    trace += [dh.plan(bad), dh.plan(("good",))]
    dh.record_success(("good",))
    trace.append(dh.plane_state())
    assert trace == ["open", "open", "host", "device", "closed"]
    return trace, dh.snapshot()


def _single_sig_recovers(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(
        device_breaker_failures=2, device_sig_failures=1, device_breaker_backoff=2.0,
        device_sig_backoff=10.0).validate(), clock=clock)
    bad = ("only",)
    dh.record_failure(bad, "runtime")
    dh.record_failure(bad, "runtime")
    trace = [dh.plane_state()]
    for step in (5.0, 5.0):
        clock.advance(step)
        trace.append(dh.plan(bad))
    dh.record_success(bad)
    trace += [dh.plane_state(), dh.sig_state(bad)]
    assert trace == ["open", "host", "device", "closed", "closed"]
    return trace, dh.snapshot()


def _lost_probe_expires(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(device_breaker_failures=1,
                                        device_breaker_backoff=2.0,
                                        probe_ttl=30.0).validate(), clock=clock)
    dh.record_failure(None, "runtime")
    clock.advance(2.0)
    assert dh.plan() == "device"
    before = dh.snapshot()["plane_open_count"]
    clock.advance(31.0)
    dh.plan()
    assert dh.snapshot()["plane_open_count"] == before + 1
    return dh.snapshot()


def _sig_backoff_own_knob(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res(
        device_breaker_failures=100, device_sig_failures=1, device_breaker_backoff=2.0,
        device_breaker_backoff_max=60.0, device_sig_backoff=300.0).validate(), clock=clock)
    bad = ("bad",)
    dh.record_failure(bad, "compile")
    trace = []
    for step in (299.9, 0.1):
        clock.advance(step)
        trace.append(dh.plan(bad))
    dh.record_failure(bad, "compile")
    for step in (299.9, 0.2):
        clock.advance(step)
        trace.append(dh.plan(bad))
    assert trace == ["shard", "device", "shard", "device"]
    return trace, dh.snapshot()


def _counters_by_kind(pk, clock):
    dh = pk.dh.DevicePlaneHealth(pk.Res().validate(), clock=clock)
    for kind in ("oom", "compile", "timeout"):
        dh.record_failure(None, kind)
    snap = dh.snapshot()
    assert (snap["failures_oom"], snap["failures_compile"], snap["failures_timeout"],
            snap["dispatch_failures"]) == (1, 1, 1, 3)
    return snap


BREAKER = {
    "plane_opens_and_probe_recloses": _plane_opens_and_probe_recloses,
    "failed_probe_doubles_backoff": _failed_probe_doubles_backoff,
    "sig_quarantine_routes_only_that_sig": _sig_quarantine,
    "unresolved_probe_reclaims_after_backoff": _unresolved_probe_reclaims,
    "quarantined_sig_never_serves_as_plane_probe": _quarantined_sig_never_probes,
    "single_sig_workload_still_recovers": _single_sig_recovers,
    "lost_probe_expires_as_failure": _lost_probe_expires,
    "sig_backoff_honors_its_own_knob": _sig_backoff_own_knob,
    "counters_by_kind": _counters_by_kind,
}


@pytest.mark.parametrize("name", sorted(BREAKER))
def test_breaker_lifecycle_like_jax(name):
    """The same events on the same fake clock give the same routing and
    the same breaker snapshot in both packages."""
    from tests.conftest import FakeClock

    out = {pk.name: BREAKER[name](pk, FakeClock()) for pk in BOTH}
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("kw", [
    {"device_breaker_failures": 0}, {"device_sig_failures": 0},
    {"device_sig_backoff": 0}, {"device_breaker_backoff": 0},
    {"device_breaker_backoff": 2.0, "device_breaker_backoff_max": 1.0},
], ids=["plane_failures", "sig_failures", "sig_backoff", "plane_backoff", "max_below"])
def test_validate_rejects_bad_device_knobs_like_jax(kw):
    for pk in BOTH:
        with pytest.raises(ValueError):
            pk.Res(**kw).validate()


def test_resilience_defaults_like_jax():
    j, t = JResilienceConfig(), tdh.ResilienceConfig()
    for k in t.__dataclass_fields__:
        assert getattr(t, k) == getattr(j, k), k


# ------------------------------------------------------ failpoint action


@pytest.mark.parametrize("spec, needle", [("device-dispatch=2*oom", None),
                                          ("device-dispatch=oom(hbm full)", "hbm full")])
def test_oom_failpoint_classifies_oom_like_jax(spec, needle):
    for pk in BOTH:
        try:
            pk.fp.activate(spec)
            if not needle:
                assert pk.fp.active()["device-dispatch"] == "2*oom"
            with pytest.raises(pk.fp.InjectedFault) as ei:
                pk.fp.fire("device-dispatch")
            assert pk.dh.classify_device_error(ei.value) == "oom"
            if needle:
                assert needle in str(ei.value)
        finally:
            pk.fp.reset()


# ------------------------------------------------------ engine dispatch


def test_dispatch_error_is_typed_and_recorded_like_jax():
    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            pk.fp.configure("device-dispatch", "error")
            with pytest.raises(pk.dh.DeviceDispatchError) as ei:
                eng.count("i", call(pk, "Count(Row(f=0))").children[0], SHARDS)
            return (ei.value.kind, counters(eng),
                    eng.device_health.snapshot()["failures_runtime"])
        finally:
            eng.close()

    kind, c, fails = same(body)
    assert kind == "runtime" and c["device_dispatch_errors"] == 1 and fails == 1


def test_oom_backpressure_retry_never_errors_like_jax():
    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            healthy = eng.count("i", call(pk, "Row(f=0)"), SHARDS)
            leaf_budget = eng.budgets["leaf_cache_bytes"]
            pk.fp.configure("device-dispatch", "oom", count=1)
            got = eng.count("i", call(pk, "Row(f=1)"), SHARDS)
            assert got == eng.host_count("i", call(pk, "Row(f=1)"), SHARDS)
            assert eng.budgets["leaf_cache_bytes"] == max(leaf_budget // 2, 1 << 20)
            assert eng.device_health.plane_state() == "closed"
            assert healthy == eng.count("i", call(pk, "Row(f=0)"), SHARDS)
            return healthy, got, counters(eng)
        finally:
            eng.close()

    _, _, c = same(body)
    assert c["oom_backpressure"] == 1 and c["oom_retries"] == 1


def test_oom_batch_splits_in_half_like_jax(monkeypatch):
    # Memo off: the batch must really dispatch, or the failpoint never
    # fires.
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")

    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            calls = [call(pk, f"Row(f={r})") for r in range(4)]
            expect = [eng.host_count("i", c, SHARDS) for c in calls]
            # 2*oom: the full batch and its same-size retry fail, the two
            # halves succeed.
            pk.fp.configure("device-dispatch", "oom", count=2)
            got = [int(x) for x in eng.count_batch("i", calls, SHARDS)]
            assert got == expect
            c = counters(eng)
            return got, c["oom_batch_splits"], c["oom_backpressure"]
        finally:
            eng.close()

    _, splits, backpressure = same(body)
    assert splits == 1 and backpressure >= 1


def test_watchdog_times_out_wedged_dispatch_like_jax():
    def body(pk, h):
        eng = make_engine(pk, h, config=pk.EngineConfig(dispatch_watchdog=0.05,
                                                        gather_workers=2))
        try:
            pk.fp.configure("device-dispatch", "latency", arg=500)
            with pytest.raises(pk.dh.DeviceDispatchError) as ei:
                eng.count("i", call(pk, "Row(f=0)"), SHARDS)
            return (ei.value.kind, eng.counters["watchdog_timeouts"] >= 1,
                    eng.device_health.snapshot()["failures_timeout"] >= 1)
        finally:
            eng.close()

    assert same(body) == ("timeout", True, True)


def test_watchdog_inflight_bound_runs_inline_like_jax():
    def body(pk, h):
        eng = make_engine(pk, h, config=pk.EngineConfig(dispatch_watchdog=0.05,
                                                        gather_workers=2))
        try:
            pk.fp.configure("device-dispatch", "latency", arg=150)
            with eng._lock:
                eng._watchdog_inflight = eng._WATCHDOG_WORKERS
            got = eng.count("i", call(pk, "Row(f=3)"), SHARDS)  # blocks ~150 ms
            assert got == eng.host_count("i", call(pk, "Row(f=3)"), SHARDS)
            with eng._lock:
                eng._watchdog_inflight = 0
            return got, eng.counters["watchdog_timeouts"]
        finally:
            eng.close()

    assert same(body)[1] == 0


def test_watchdog_uses_dedicated_pool_not_gather_pool():
    """A wedged dispatch parks a pilosa-dispatch worker, never a gather
    one, and the host ladder still serves meanwhile (the port's engine;
    the reference's test polls its jit compile, which the port has not)."""
    h = make_holder(TORCH)
    eng = make_engine(TORCH, h, config=TEngineConfig(dispatch_watchdog=0.05,
                                                      gather_workers=2))
    try:
        tfailpoints.configure("device-dispatch", "latency", arg=200)
        with pytest.raises(tdh.DeviceDispatchError):
            eng.count("i", call(TORCH, "Row(f=2)"), SHARDS)
        assert eng._watchdog_pool is not None
        assert any(t.name.startswith("pilosa-dispatch") for t in threading.enumerate())
        with eng._lock:
            assert eng._watchdog_inflight >= 1
        tfailpoints.reset()
        assert eng.host_count("i", call(TORCH, "Row(f=2)"), SHARDS) == \
            eng.host_count("i", call(TORCH, "Row(f=2)"), (0, 1))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with eng._lock:
                if eng._watchdog_inflight == 0:
                    break
            time.sleep(0.05)
        with eng._lock:
            assert eng._watchdog_inflight == 0
    finally:
        tfailpoints.reset()
        eng.close()
        h.close()


def test_transfer_stage_failure_engages_breaker_like_jax(monkeypatch):
    """A device that dies at the upload (not the kernel) is classified and
    recorded like a dispatch failure."""
    import jax as _jax

    def dead(*a, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")

    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            with monkeypatch.context() as m:
                if pk is JAX:
                    m.setattr(_jax, "device_put", dead)
                else:
                    m.setattr(eng, "_upload", dead)
                with pytest.raises(pk.dh.DeviceDispatchError) as ei:
                    eng.count("i", call(pk, "Row(f=0)"), SHARDS)
            return ei.value.kind, eng.device_health.snapshot()["dispatch_failures"]
        finally:
            eng.close()

    assert same(body) == ("runtime", 1)


@pytest.mark.parametrize("q", ["Row(f=0)", "Intersect(Row(f=0), Row(f=1))",
                               "Union(Row(f=0), Row(f=1), Row(f=2))",
                               "Difference(Row(f=3), Row(f=1))", "Xor(Row(f=2), Row(f=4))"])
def test_host_count_bit_exact_vs_device_like_jax(q):
    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            dev = eng.count("i", call(pk, q), SHARDS)
            host = eng.host_count("i", call(pk, q), (0, 1))
            assert dev == host
            return dev, counters(eng)
        finally:
            eng.close()

    same(body)


def test_host_count_reads_demoted_tier_bytes_like_jax(monkeypatch):
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")

    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            healthy = eng.count("i", call(pk, "Row(f=0)"), SHARDS)
            eng.tier.demote(("i", pk.Leaf("f", "standard", 0), SHARDS))
            assert eng.tier.drain()
            base = eng.tier.snapshot()["promotions_host"]
            assert eng.host_count("i", call(pk, "Row(f=0)"), SHARDS) == healthy
            return (healthy, eng.tier.snapshot()["promotions_host"] - base,
                    counters(eng)["host_counts"])
        finally:
            eng.close()

    assert same(body)[1:] == (1, 1)


@pytest.mark.parametrize("src", ["Row(f=0)", "Union(Row(f=1), Row(f=5))", None])
def test_host_topn_matches_device_like_jax(src):
    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            s = call(pk, src) if src else None
            dev = eng.topn_shard_counts("i", "f", [1, 2, 3, 4, 2], SHARDS, s,
                                        need_row_counts=True)
            host = eng.host_topn_shard_counts("i", "f", [1, 2, 3, 4, 2], SHARDS, s,
                                              need_row_counts=True)
            out = []
            for d, hh in zip(dev, host):
                if d is None:
                    assert hh is None
                    out.append(None)
                    continue
                d = np.asarray(d)[..., :N_SHARDS]
                np.testing.assert_array_equal(d, np.asarray(hh)[..., :N_SHARDS])
                out.append(d.tolist())
            return out, counters(eng)["host_topn"]
        finally:
            eng.close()

    same(body)


def test_pop_elems_like_jax():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint32)
    want = sum(bin(int(x)).count("1") for x in arr.flat)
    for pk in BOTH:
        assert int(pk.pop(arr).sum()) == want


# ------------------------------------------------- compressed-domain cold


def test_cold_count_skips_device_then_promotes_on_repeat_like_jax(monkeypatch):
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")

    def body(pk, h):
        eng = make_engine(pk, h)
        try:
            healthy = eng.count("i", call(pk, "Row(f=5)"), SHARDS)
            base = counters(eng)
            key = ("i", pk.Leaf("f", "standard", 5), SHARDS)
            eng.tier.demote(key)
            assert eng.tier.drain()
            with eng._lock:
                ent = eng._leaf_cache.pop(key, None)
                if ent is not None:
                    eng._leaf_bytes -= ent[1].nbytes
                # The port's Count reads a stack of its leaves: drop the
                # one-leaf stack too, so the leaf is demoted everywhere.
                for skey in [k for k in getattr(eng, "_stack_cache", {})
                             if k[1] == (key[1],)]:
                    eng._stack_bytes -= eng._stack_cache.pop(skey)[1].nbytes
            got1 = eng.count("i", call(pk, "Row(f=5)"), SHARDS)
            first = counters(eng, base)
            got2 = eng.count("i", call(pk, "Row(f=5)"), SHARDS)
            second = counters(eng, base)
            assert healthy == got1 == got2
            assert first["host_cold_counts"] == 1 and first["count_dispatches"] == 0
            assert second["leaf_tier_hits"] == 1 and second["count_dispatches"] == 1
            return healthy, first, second
        finally:
            eng.close()

    same(body)


def test_cold_count_disabled_by_knob_like_jax(monkeypatch):
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")

    def body(pk, h):
        eng = make_engine(pk, h, config=pk.EngineConfig(cold_host_count=0))
        try:
            eng.tier.demote(("i", pk.Leaf("f", "standard", 4), SHARDS))
            assert eng.tier.drain()
            got = eng.count("i", call(pk, "Row(f=4)"), SHARDS)
            return got, eng.counters["host_cold_counts"]
        finally:
            eng.close()

    assert same(body)[1] == 0


# ------------------------------------------------------ executor ladder


def test_count_served_by_host_ladder_under_fault_like_jax():
    def body(pk, h):
        ex = make_executor(pk, h)
        try:
            healthy = ex.execute("i", "Count(Intersect(Row(f=1),Row(f=2)))")[0]
            pk.fp.configure("device-dispatch", "error")
            got = ex.execute("i", "Count(Intersect(Row(f=2),Row(f=1)))")[0]
            fresh = ex.execute("i", "Count(Intersect(Row(f=0),Row(f=1)))")[0]
            healthy2 = ex.execute("i", "Count(Intersect(Row(f=1),Row(f=2)))")[0]
            assert got == healthy == healthy2
            pk.fp.reset()
            fld = h.index("i").field("f")
            fld.set_bit(0, 8000)
            fld.clear_bit(0, 8000)
            assert fresh == ex.execute("i", "Count(Intersect(Row(f=0),Row(f=1)))")[0]
            c = counters(ex.engine)
            assert c["host_counts"] >= 1
            return healthy, fresh, c, ladder_stats(h)
        finally:
            ex.close()

    _, _, _, stats = same(body)
    assert stats["DeviceLadderFallback"] == 1


def test_plane_opens_then_host_routed_then_recloses_like_jax():
    def body(pk, h):
        ex = make_executor(pk, h, device_breaker_failures=2, device_breaker_backoff=1.0)
        try:
            queries = [f"Count(Union(Row(f=0),Row(f={r})))" for r in (1, 2, 3, 4)]
            expect = [ex.execute("i", q)[0] for q in queries]
            pk.fp.configure("device-dispatch", "error")
            dh = ex.engine.device_health
            fld = h.index("i").field("f")
            fld.set_bit(0, 8000)
            got = [ex.execute("i", q)[0] for q in queries]
            assert got == [e + 1 for e in expect]
            fld.clear_bit(0, 8000)
            assert [ex.execute("i", q)[0] for q in queries] == expect
            assert dh.plane_state() == "open"
            degraded = counters(ex.engine)
            pk.fp.reset()
            dh.clock = (lambda base=time.monotonic: base() + 60.0)
            dispatches = ex.engine.counters["count_dispatches"]
            got = ex.execute("i", "Count(Xor(Row(f=0),Row(f=5)))")[0]
            assert got == ex.engine.host_count("i", call(pk, "Xor(Row(f=0),Row(f=5))"),
                                               SHARDS)
            assert dh.plane_state() == "closed"
            assert ex.engine.counters["count_dispatches"] == dispatches + 1
            return expect, got, degraded, ladder_stats(h)
        finally:
            ex.close()

    _, _, degraded, stats = same(body)
    assert degraded["host_counts"] >= 2 and stats["DeviceHostRouted"] >= 1


def test_sig_quarantine_leaves_other_sigs_on_device_like_jax():
    def body(pk, h):
        ex = make_executor(pk, h, device_breaker_failures=100, device_sig_failures=1)
        try:
            bad = "Count(Difference(Row(f=0),Row(f=2)))"
            good = "Count(Union(Row(f=3),Row(f=4)))"
            expect_bad = ex.engine.host_count(
                "i", call(pk, "Difference(Row(f=0),Row(f=2))"), SHARDS)
            fld = h.index("i").field("f")
            fld.set_bit(0, 8001)
            fld.clear_bit(0, 8001)
            pk.fp.configure("device-dispatch", "error", count=1)
            assert ex.execute("i", bad)[0] == expect_bad
            dispatches = ex.engine.counters["count_dispatches"]
            fld.set_bit(0, 8002)
            fld.clear_bit(0, 8002)
            assert ex.execute("i", bad)[0] == expect_bad
            assert ex.engine.counters["count_dispatches"] == dispatches
            ex.execute("i", good)
            assert ex.engine.counters["count_dispatches"] == dispatches + 1
            return expect_bad, counters(ex.engine), ladder_stats(h)
        finally:
            ex.close()

    _, _, stats = same(body)
    assert stats["DeviceSigQuarantined"] == 1


def test_topn_correct_under_device_fault_like_jax():
    def body(pk, h):
        ex = make_executor(pk, h)
        try:
            q = "TopN(f, Row(f=0), n=3)"
            healthy = [(p.id, p.count) for p in ex.execute("i", q)[0]]
            pk.fp.configure("device-dispatch", "error")
            fld = h.index("i").field("f")
            fld.set_bit(0, 4500)
            fld.clear_bit(0, 4500)
            degraded = [(p.id, p.count) for p in ex.execute("i", q)[0]]
            assert degraded == healthy
            c = counters(ex.engine)
            assert c["host_topn"] >= 1
            return healthy, c["host_topn"], ladder_stats(h)
        finally:
            ex.close()

    same(body)


def _bsi_field(pk, h, name, hi, cols, mod):
    idx = h.index("i")
    idx.create_field_if_not_exists(name, pk.FieldOptions(type="int", min=0, max=hi))
    fld = idx.field(name)
    for col in cols:
        fld.set_value(col, col % mod)
    return fld


def test_topn_with_bsi_src_takes_per_shard_rung_like_jax():
    def body(pk, h):
        _bsi_field(pk, h, "v", 100, range(0, 200, 3), 70)
        q = "TopN(f, Range(v > 10), n=3)"
        ex = make_executor(pk, h)
        try:
            healthy = [(p.id, p.count) for p in ex.execute("i", q)[0]]
            assert healthy
            fld = h.index("i").field("f")
            fld.set_bit(0, 8003)
            fld.clear_bit(0, 8003)
            pk.fp.configure("device-dispatch", "error")
            degraded = [(p.id, p.count) for p in ex.execute("i", q)[0]]
            assert degraded == healthy
            return healthy, counters(ex.engine)["host_topn"], ladder_stats(h)
        finally:
            ex.close()

    same(body)


@pytest.mark.parametrize("kind", ["Sum", "Min", "Max"])
def test_bsi_short_circuits_to_per_shard_when_plane_open_like_jax(kind):
    def body(pk, h):
        fld = _bsi_field(pk, h, "w", 50, range(0, 60, 2), 40)
        ex = make_executor(pk, h, device_breaker_failures=1)
        q = f"{kind}(field=w)"

        def vc():
            r = ex.execute("i", q)[0]
            return int(r.val), int(r.count)

        try:
            healthy = vc()
            pk.fp.configure("device-dispatch", "error")
            fld.set_value(1, 45)  # busts the aux memo and moves every answer
            degraded = vc()
            assert ex.engine.device_health.plane_state() == "open"
            failures = ex.engine.device_health.snapshot()["dispatch_failures"]
            fld.set_value(3, 0)
            after = vc()
            assert ex.engine.device_health.snapshot()["dispatch_failures"] == failures
            return healthy, degraded, after, ladder_stats(h)
        finally:
            ex.close()

    same(body)


def test_bitmap_falls_back_per_shard_like_jax():
    def body(pk, h):
        ex = make_executor(pk, h)
        try:
            q = "Intersect(Row(f=0), Row(f=1))"
            healthy = ex.execute("i", q)[0]
            pk.fp.configure("device-dispatch", "error")
            degraded = ex.execute("i", q)[0]
            assert degraded.count() == healthy.count()
            assert list(degraded.columns()) == list(healthy.columns())
            return degraded.count(), ladder_stats(h)
        finally:
            ex.close()

    same(body)


# ------------------------------------------- kernel build failures


def _broken_build(monkeypatch, tmp_path):
    """Point the kernel build at an empty directory and a missing nvcc,
    and make the count kernels load the library first, as they do on a
    CUDA tensor: the first launch then fails in kernels.build()."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(kernels, "_lib", None)
    # K1's launches go through gather_expr_count_blocks (gather_expr_count
    # calls it too).
    for name in ("gather_expr_count_blocks", "masked_plane_counts", "bsi_minmax"):
        real = getattr(kernels, name)

        def loading(*a, real=real, **kw):
            kernels.load()
            return real(*a, **kw)

        monkeypatch.setattr(kernels, name, loading)


def test_kernel_build_failure_propagates_through_device_call(monkeypatch, tmp_path):
    h = make_holder(TORCH)
    eng = make_engine(TORCH, h)
    try:
        _broken_build(monkeypatch, tmp_path)
        before = (dict(eng.snapshot()), eng.device_health.snapshot())
        with pytest.raises(kernels.KernelBuildError, match="cannot run nvcc"):
            eng._device_call(("sig",), lambda: kernels.load())
        with pytest.raises(kernels.KernelBuildError):
            eng._oom_guard(None, lambda: kernels.load())
        assert (dict(eng.snapshot()), eng.device_health.snapshot()) == before
    finally:
        eng.close()
        h.close()


@pytest.mark.parametrize("q", [
    "Count(Intersect(Row(f=0), Row(f=1)))", "TopN(f, Row(f=0), n=3)", "Sum(field=w)",
    "Max(Row(f=1), field=w)"], ids=["count", "topn", "sum", "max"])
def test_kernel_build_failure_raises_out_of_execute(monkeypatch, tmp_path, q):
    """Never answered by the host or the per-shard rung: the breakers, the
    dispatch-error counter and the ladder stats stay as they were."""
    h = make_holder(TORCH)
    _bsi_field(TORCH, h, "w", 50, range(0, 60, 2), 40)
    ex = make_executor(TORCH, h)
    try:
        _broken_build(monkeypatch, tmp_path)
        with pytest.raises(kernels.KernelBuildError):
            ex.execute("i", q)
        snap = ex.engine.snapshot()
        assert snap["device_dispatch_errors"] == 0
        assert snap["host_counts"] == snap["host_topn"] == 0
        assert ex.engine.device_health.snapshot()["dispatch_failures"] == 0
        assert ex.engine.device_health.plane_state() == "closed"
        assert ladder_stats(h) == dict.fromkeys(LADDER_STATS, 0)
    finally:
        ex.close()
        h.close()



# -------------------------------------------- kernel faults on the card
#
# An engine whose device is a card answers no query from a lower rung for
# a real fault of its kernels. The CPU engine below takes the card's
# branch with its device set to "cuda" once every tensor the queries read
# is resident (the device's type is all the fault path reads), and with
# each kernel wrapper failing as the card would.

CARD_QUERIES = ["Count(Intersect(Row(f=0), Row(f=1)))", "TopN(f, Row(f=0), n=3)",
                "Sum(Row(f=1), field=w)", "Max(field=w)"]
CARD_FAULTS = [
    ("gather_expr_count (streaming) kernel launch failed: cudaError 700", "runtime"),
    ("CUDA error: an illegal memory access was encountered", "runtime"),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "oom"),
]


def _on_card(monkeypatch, ex, queries, fault=None):
    """Make every tensor `queries` read resident, then point the engine at
    the card and (with `fault`) make each kernel wrapper raise it; returns
    the list of the kernel calls that raised."""
    with ex.engine.memos_off():
        for q in queries:
            ex.execute("i", q)
    monkeypatch.setattr(ex.engine, "device", torch.device("cuda"))
    raised = []
    if fault is not None:
        for name in ("gather_expr_count_blocks", "masked_plane_counts", "bsi_minmax"):
            def failing(*a, name=name, **kw):
                raised.append(name)
                raise RuntimeError(fault)

            monkeypatch.setattr(kernels, name, failing)
    return raised


@pytest.mark.parametrize("msg, kind", CARD_FAULTS, ids=["launch", "sticky", "oom"])
@pytest.mark.parametrize("q", CARD_QUERIES, ids=["count", "topn", "sum", "max"])
def test_kernel_fault_on_card_raises_out_of_execute(monkeypatch, q, msg, kind):
    """Classified and recorded into the breakers, then raised as
    DeviceKernelFault: not answered by the host or the per-shard rung."""
    h = make_holder(TORCH)
    _bsi_field(TORCH, h, "w", 50, range(0, 60, 2), 40)
    ex = make_executor(TORCH, h)
    try:
        raised = _on_card(monkeypatch, ex, [q], msg)
        with ex.engine.memos_off(), pytest.raises(tdh.DeviceKernelFault) as fe:
            ex.execute("i", q)
        assert raised and fe.value.kind == kind
        assert not isinstance(fe.value, tdh.DeviceDispatchError)
        snap = ex.engine.snapshot()
        assert snap["host_counts"] == snap["host_topn"] == 0
        assert snap["kernel_faults"] == 1 and snap["device_dispatch_errors"] == 1
        assert snap["oom_backpressure"] == (kind == "oom")
        assert ex.engine.device_health.snapshot()[f"failures_{kind}"] == 1
        assert ladder_stats(h) == dict.fromkeys(LADDER_STATS, 0)
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("q", ["Count(Union(Row(f=2), Row(f=3)))", "Min(field=w)",
                               "TopN(f, Row(f=2), n=3)"], ids=["count", "min", "topn"])
def test_open_breaker_after_kernel_fault_raises_on_card(monkeypatch, q):
    """A plane breaker opened by a kernel fault on the card does not route
    the next queries to the host: they raise before any dispatch."""
    h = make_holder(TORCH)
    _bsi_field(TORCH, h, "w", 50, range(0, 60, 2), 40)
    ex = make_executor(TORCH, h, device_breaker_failures=1)
    try:
        first = "Count(Intersect(Row(f=0), Row(f=1)))"
        raised = _on_card(monkeypatch, ex, [first, q],
                          "gather_expr_count kernel launch failed: cudaError 719")
        with ex.engine.memos_off(), pytest.raises(tdh.DeviceKernelFault):
            ex.execute("i", first)
        assert ex.engine.device_health.plane_state() == "open"
        n = len(raised)
        with ex.engine.memos_off(), pytest.raises(tdh.DeviceKernelFault, match="breaker open"):
            ex.execute("i", q)
        assert len(raised) == n
        snap = ex.engine.snapshot()
        assert snap["host_counts"] == snap["host_topn"] == 0
        assert ladder_stats(h) == dict.fromkeys(LADDER_STATS, 0)
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("q", CARD_QUERIES[:2], ids=["count", "topn"])
def test_injected_fault_on_card_takes_the_ladder(monkeypatch, q):
    """The device-dispatch failpoint stays the way to drive the ladder on
    the card: an injected fault is served one rung down, as on the CPU."""
    h = make_holder(TORCH)
    ex = make_executor(TORCH, h)
    try:
        with ex.engine.memos_off():
            want = ex.execute("i", q)[0]
        _on_card(monkeypatch, ex, [q])
        TORCH.fp.configure("device-dispatch", "error")
        with ex.engine.memos_off():
            got = ex.execute("i", q)[0]
        if isinstance(want, list):
            want, got = [(p.id, p.count) for p in want], [(p.id, p.count) for p in got]
        assert got == want
        snap = ex.engine.snapshot()
        assert snap["host_counts"] + snap["host_topn"] >= 1 and snap["kernel_faults"] == 0
        assert ladder_stats(h)["DeviceLadderFallback"] >= 1
    finally:
        TORCH.fp.reset()
        ex.close()
        h.close()


def test_memos_off_restores_the_memos():
    """engine.memos_off(): repeats inside the block dispatch, the memo's
    entries and budgets come back after it."""
    h = make_holder(TORCH)
    eng = make_engine(TORCH, h)
    try:
        c = call(TORCH, "Intersect(Row(f=0), Row(f=1))")
        want = eng.count("i", c, SHARDS)
        budgets = dict(eng.budgets)
        base = eng.snapshot()
        with eng.memos_off():
            assert eng.count("i", c, SHARDS) == want
            assert eng.count("i", c, SHARDS) == want
        mid = eng.snapshot()
        assert mid["count_dispatches"] == base["count_dispatches"] + 2
        assert mid["memo_hits"] == base["memo_hits"]
        assert eng.count("i", c, SHARDS) == want
        end = eng.snapshot()
        assert end["memo_hits"] == mid["memo_hits"] + 1
        assert end["count_dispatches"] == mid["count_dispatches"]
        assert eng.budgets == budgets
    finally:
        eng.close()
        h.close()


def test_kernel_build_failure_raises_out_of_count_batch(monkeypatch, tmp_path):
    h = make_holder(TORCH)
    eng = make_engine(TORCH, h)
    try:
        _broken_build(monkeypatch, tmp_path)
        calls = [call(TORCH, f"Row(f={r})") for r in range(3)]
        with pytest.raises(kernels.KernelBuildError):
            eng.count_batch("i", calls, SHARDS)
        assert eng.snapshot()["device_dispatch_errors"] == 0
        assert eng.device_health.plane_state() == "closed"
    finally:
        eng.close()
        h.close()


# ------------------------------------------------------------ chaos combo


# --------------------------------------------- deadline between chunks


class TestDeadlineBetweenChunks:
    """tests/test_device_faults.py's TestDeadlineBetweenChunks on both
    packages: a deadline checked between TopN's device chunks answers a
    503 (DeadlineExceededError) mid-flight, and the phase-2 gate counts
    DeadlineMidQuery."""

    def test_multichunk_topn_503s_midflight_like_jax(self, monkeypatch):
        # Force one candidate row per device chunk.
        monkeypatch.setenv("PILOSA_TOPN_CHUNK_BYTES", "1")

        def body(pk, h):
            ex = make_executor(pk, h)
            ticks = {"n": 0}

            def clock():
                ticks["n"] += 1
                return float(ticks["n"])

            try:
                opt = pk.ExecOptions(deadline=pk.Deadline(10.0, clock=clock))
                with pytest.raises(pk.DeadlineExceededError) as ei:
                    ex.execute("i", "TopN(f, Row(f=0), n=5)", shards=list(SHARDS), opt=opt)
                return type(ei.value).__name__
            finally:
                ex.close()

        assert same(body) == "DeadlineExceededError"

    def test_phase_boundary_check_counts_like_jax(self):
        def body(pk, h):
            ex = make_executor(pk, h)
            clock = {"now": 0.0}
            try:
                opt = pk.ExecOptions(deadline=pk.Deadline(5.0, clock=lambda: clock["now"]))
                # Expire the budget before the second phase starts: the
                # phase-2 gate must 503 and count.
                orig = ex._execute_topn_shards

                def expiring(index, c, shards, o):
                    out = orig(index, c, shards, o)
                    clock["now"] = 100.0
                    return out

                ex._execute_topn_shards = expiring
                with pytest.raises(pk.DeadlineExceededError):
                    ex.execute("i", "TopN(f, n=3)", shards=list(SHARDS), opt=opt)
                return h.stats.snapshot()["counters"].get("DeadlineMidQuery", 0)
            finally:
                ex.close()

        assert same(body) >= 1


# ------------------------------------------------------------ chaos combo


def _chaos(pk, h, cutover):
    """The combination proof: seed-pinned device-dispatch faults (error,
    oom) toggle per round while planes churn through the tier and, with
    `cutover`, routing epochs advance mid-round (rebalance begin /
    cutover / commit on the executor's own one-node cluster: placement
    never changes, the epoch re-read gates still fire). Every query is
    correct; after the faults clear the breakers re-close and a final
    round runs with zero host-ladder reads."""
    from tests.conftest import FakeClock

    rng = random.Random(1234)
    clock = FakeClock()
    ex = make_executor(pk, h, device_breaker_failures=2, device_breaker_backoff=1.0,
                       device_sig_failures=2)
    eng = ex.engine
    eng.device_health.clock = clock
    queries = ["Count(Row(f=0))", "Count(Intersect(Row(f=0),Row(f=1)))",
               "Count(Union(Row(f=1),Row(f=2),Row(f=3)))",
               "Count(Difference(Row(f=4),Row(f=0)))", "Count(Xor(Row(f=2),Row(f=5)))"]
    expect = [ex.execute("i", q)[0] for q in queries]
    fld = h.index("i").field("f")
    node = ex.cluster.node
    actions, epochs = [], []
    try:
        for rnd in range(8):
            pk.fp.reset()
            action = rng.choice(["none", "error", "oom", "error"])
            actions.append(action)
            if action == "error":
                pk.fp.configure("device-dispatch", "error", count=rng.randint(1, 3))
            elif action == "oom":
                pk.fp.configure("device-dispatch", "oom", count=rng.randint(1, 2))
            for row in rng.sample(range(6), 2):
                eng.tier.demote(("i", pk.Leaf("f", "standard", row), SHARDS))
            eng.tier.drain()
            if cutover:
                ex.cluster.begin_rebalance([node])
                ex.cluster.apply_cutover("i", rng.randrange(N_SHARDS))
            col = 4097 + rnd
            fld.set_bit(0, col)
            fld.clear_bit(0, col)
            for q, want in zip(queries, expect):
                assert ex.execute("i", q)[0] == want, (rnd, action, q)
            if cutover:
                ex.cluster.commit_topology([node])
                epochs.append(ex.cluster.routing_epoch)
            clock.advance(rng.choice([0.2, 1.1, 2.5]))
        pk.fp.reset()
        for _ in range(6):
            clock.advance(2.0)
            fld.set_bit(0, 5000)
            fld.clear_bit(0, 5000)
            for q, want in zip(queries, expect):
                assert ex.execute("i", q)[0] == want
            if eng.device_health.plane_state() == "closed":
                break
        assert eng.device_health.plane_state() == "closed"
        host_before = eng.counters["host_counts"] + eng.counters["host_topn"]
        dispatches = eng.counters["count_dispatches"]
        fld.set_bit(0, 5001)
        fld.clear_bit(0, 5001)
        for q, want in zip(queries, expect):
            assert ex.execute("i", q)[0] == want
        assert eng.counters["host_counts"] + eng.counters["host_topn"] == host_before
        assert eng.counters["count_dispatches"] > dispatches
        return expect, actions, epochs
    finally:
        pk.fp.reset()
        ex.close()


@pytest.mark.chaos
def test_device_chaos_with_tier_churn_like_jax(monkeypatch):
    """tests/test_device_faults.py's combination proof, its device and
    tier half: the same answers and fault schedule in both packages."""
    same(lambda pk, h: _chaos(pk, h, cutover=False))


@pytest.mark.chaos
def test_device_chaos_with_tier_churn_and_cutover_like_jax(monkeypatch):
    """The same proof with the routing-epoch churn of
    test_device_chaos_with_tier_churn_and_cutover: the epochs advance
    alike in both packages and every answer stays correct."""
    expect, actions, epochs = same(lambda pk, h: _chaos(pk, h, cutover=True))
    assert len(epochs) == 8 and epochs == sorted(epochs) and epochs[0] < epochs[-1]
