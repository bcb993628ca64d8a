"""The cases of tests/test_lockcheck.py, run against the port on the CPU.

lockcheck self-test: the runtime lock-order / blocking-under-lock
checker (pilosa_tpu_torch/devtools/lockcheck.py) proven on deliberate
violations — an AB/BA order inversion, a sleep under a lock, a join
under a lock — and on clean patterns that must stay silent, then the
enforcement runs: an instrumented subprocess pass over the concurrency-
heavy test files (chaos/tier/rebalance) asserting ZERO findings in
tier-1, and the full suite instrumented the same way marked `slow`.
See docs/static-analysis.md.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from pilosa_tpu_torch.devtools import lockcheck

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# When the whole session is already instrumented (tests/torch_lockcheck_run.py
# installed the port's checker before pytest imported this module), the
# unit tests below must not run: they uninstall the session's
# instrumentation on exit and their DELIBERATE violations would land in
# the session-wide findings list that the outer test asserts is empty.
# The outer (uninstrumented) tier-1 run covers them; the instrumented run
# covers the production tree.
INSTRUMENTED = lockcheck.active()

needs_own_install = pytest.mark.skipif(
    INSTRUMENTED,
    reason="session already instrumented; unit tests own install/uninstall",
)


@pytest.fixture
def lc():
    assert not lockcheck.active()
    lockcheck.install()
    lockcheck.reset()
    try:
        yield lockcheck
    finally:
        lockcheck.reset()
        lockcheck.uninstall()


def kinds(fs):
    return sorted(f["kind"] for f in fs)


# ------------------------------------------------------------ order graph


@needs_own_install
class TestLockOrder:
    def test_ab_ba_inversion_across_threads(self, lc):
        """THE deadlock shape: thread 1 takes A then B, thread 2 takes B
        then A. Run sequentially (joined between) so the test itself can
        never deadlock — the order graph is global, so the inverted edge
        still closes the cycle."""
        a, b = threading.Lock(), threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        t1 = threading.Thread(target=ab)
        t1.start()
        t1.join(timeout=10)
        assert not t1.is_alive()
        t2 = threading.Thread(target=ba)
        t2.start()
        t2.join(timeout=10)
        assert not t2.is_alive()

        fs = lc.findings()
        assert kinds(fs) == ["lock-order-cycle"]
        cycle = fs[0]
        assert len(cycle["locks"]) == 2
        # Both creation sites point into this file, and the closing edge
        # names the acquisition sites — the report is actionable.
        assert all("test_torch_lockcheck.py" in s for s in cycle["locks"])
        assert "test_torch_lockcheck.py" in cycle["closing_edge"]["acquired_at"]

    def test_consistent_nesting_is_clean(self, lc):
        """A -> B taken in the same order from two threads is the
        sanctioned nested-lock pattern: no cycle, no findings."""
        a, b = threading.Lock(), threading.Lock()

        def ab():
            with a:
                with b:
                    pass

        for _ in range(2):
            t = threading.Thread(target=ab)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with a:
            with b:
                pass
        assert lc.findings() == []

    def test_contended_condition_wait_keeps_bookkeeping_honest(self, lc):
        """Regression: _RLockProxy._release_save used to release the
        inner lock BEFORE resetting owner/count, so a concurrent
        acquire() landing in that window got its ownership claim stomped
        by the waiter's late `self._owner = None` — notify() then raised
        'cannot notify on un-acquired lock' and the stale held-stack
        entry turned every later deny-listed call into a false
        blocking-under-lock finding. Hammer a default (RLock-backed)
        Condition with waiters and notifiers under an aggressive thread
        switch interval and assert nobody crashes and the checker stays
        silent."""
        old_interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            cond = threading.Condition()
            stop = threading.Event()
            errors = []

            def waiter():
                try:
                    while not stop.is_set():
                        with cond:
                            cond.wait(timeout=0.01)
                except RuntimeError as e:  # the historical crash
                    errors.append(e)

            def notifier():
                try:
                    while not stop.is_set():
                        with cond:
                            cond.notify_all()
                        # Outside the with: clean UNLESS a stomped
                        # release left the lock stranded in this
                        # thread's held stack — then it reports as a
                        # false blocking-under-lock finding below.
                        time.sleep(0)
                except RuntimeError as e:
                    errors.append(e)

            threads = [threading.Thread(target=waiter) for _ in range(4)]
            threads += [threading.Thread(target=notifier) for _ in range(2)]
            for t in threads:
                t.start()
            time.sleep(0.5)
            stop.set()
            with cond:
                cond.notify_all()
            for t in threads:
                t.join(timeout=5)
            assert not any(t.is_alive() for t in threads)
            assert errors == []
            assert lc.findings() == []
        finally:
            sys.setswitchinterval(old_interval)

    def test_rlock_reacquisition_adds_no_edges(self, lc):
        """Re-entering an RLock you own is not a second acquisition: no
        self-edge, no cycle, and the held stack stays balanced."""
        r = threading.RLock()
        with r:
            with r:
                pass
        with r:
            pass
        assert lc.findings() == []

    def test_three_lock_cycle(self, lc):
        """Cycles longer than 2 (A->B, B->C, C->A) are found by the path
        walk, not just direct inversions."""
        a, b, c = threading.Lock(), threading.Lock(), threading.Lock()
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        fs = lc.findings()
        assert kinds(fs) == ["lock-order-cycle"]
        assert len(fs[0]["locks"]) == 3


# ------------------------------------------------------ blocking under lock


@needs_own_install
class TestBlockingUnderLock:
    def test_sleep_under_lock(self, lc):
        mu = threading.Lock()
        with mu:
            time.sleep(0.001)
        fs = lc.findings()
        assert kinds(fs) == ["blocking-under-lock"]
        f = fs[0]
        assert f["call"] == "time.sleep"
        assert "test_torch_lockcheck.py" in f["site"]
        assert any("test_torch_lockcheck.py" in h for h in f["held"])

    def test_sleep_outside_lock_is_clean(self, lc):
        mu = threading.Lock()
        with mu:
            pass
        time.sleep(0.001)
        assert lc.findings() == []

    def test_annotation_on_call_line_suppresses(self, lc):
        mu = threading.Lock()
        with mu:
            time.sleep(0.001)  # pilint: allow-blocking(fixture: proves the runtime checker shares pilint's annotation grammar)
        assert lc.findings() == []

    def test_caller_annotation_covers_callee(self, lc):
        """The frame holding the lock takes responsibility for blocking
        work in its callees: an allow-blocking on the CALL SITE suppresses
        a sleep that only happens inside the helper."""

        def helper():
            time.sleep(0.001)

        mu = threading.Lock()
        with mu:
            # pilint: allow-blocking(fixture: the lock-holding caller vouches for its callee's blocking work)
            helper()
        assert lc.findings() == []

    def test_join_under_lock(self, lc):
        t = threading.Thread(target=lambda: None, name="lc-join-target")
        t.start()
        mu = threading.Lock()
        with mu:
            t.join(timeout=10)
        assert not t.is_alive()
        fs = lc.findings()
        assert kinds(fs) == ["join-under-lock"]
        assert fs[0]["thread"] == "lc-join-target"

    def test_duplicate_findings_collapse(self, lc):
        """The same violation hit in a loop reports once — the report is
        a work list, not a frequency histogram."""
        mu = threading.Lock()
        for _ in range(3):
            with mu:
                time.sleep(0.0)
        assert len(lc.findings()) == 1


# ------------------------------------------------------------- reporting


@needs_own_install
class TestReports:
    def test_report_text_and_json_are_deterministic(self, lc, tmp_path):
        mu = threading.Lock()
        with mu:
            time.sleep(0.0)
        text1, text2 = lc.report(), lc.report()
        assert text1 == text2
        assert "blocking-under-lock: time.sleep" in text1
        assert "1 finding" in text1

        out = tmp_path / "findings.json"
        lc.write_report(str(out))
        payload = json.loads(out.read_text())
        assert payload["count"] == 1
        assert payload["findings"][0]["kind"] == "blocking-under-lock"
        # Stable across a rewrite (sorted keys + sorted findings).
        first = out.read_text()
        lc.write_report(str(out))
        assert out.read_text() == first

    def test_empty_report(self, lc, tmp_path):
        assert lc.report() == "lockcheck: 0 findings"
        out = tmp_path / "empty.json"
        lc.write_report(str(out))
        assert json.loads(out.read_text()) == {"count": 0, "findings": []}

    def test_reset_clears_findings_and_graph(self, lc):
        a, b = threading.Lock(), threading.Lock()
        with a:
            with b:
                time.sleep(0.0)
        assert lc.findings()
        lc.reset()
        assert lc.findings() == []
        # The A->B edge is gone too: B->A after reset closes no cycle.
        with b:
            with a:
                pass
        assert lc.findings() == []


# -------------------------------------------------- schedule perturbation


@needs_own_install
class TestSchedPerturbation:
    """Opt-in seeded yields at acquire boundaries
    (PILOSA_TPU_LOCKCHECK_SCHED): one global PRNG behind the checker
    lock, so a fixed acquire sequence replays the exact same decision
    sequence under the same seed."""

    def _drive(self):
        locks = [threading.Lock() for _ in range(4)]
        for _ in range(40):
            for lk in locks:
                with lk:
                    pass

    def test_disarmed_by_default(self, lc):
        self._drive()
        assert lc.sched_trace() == []

    def test_same_seed_replays_the_same_decisions(self, lc):
        lc.configure_sched(42)
        self._drive()
        first = lc.sched_trace()
        assert len(first) == 160
        assert any(y for y, _ in first), "seed 42 yielded nowhere in 160 draws"
        assert not all(y for y, _ in first)
        lc.configure_sched(42)
        self._drive()
        assert lc.sched_trace() == first
        lc.configure_sched(None)

    def test_different_seed_different_decisions(self, lc):
        lc.configure_sched(42)
        self._drive()
        first = lc.sched_trace()
        lc.configure_sched(7)
        self._drive()
        assert lc.sched_trace() != first
        lc.configure_sched(None)

    def test_non_numeric_env_seed_does_not_crash_install(self, lc, monkeypatch):
        # someone treats the knob as a boolean toggle: install() derives
        # a stable seed instead of dying mid-patch with a ValueError
        lc.uninstall()
        monkeypatch.setenv("PILOSA_TPU_LOCKCHECK_SCHED", "on")
        lc.install()
        with threading.Lock():
            pass
        assert len(lc.sched_trace()) == 1
        lc.configure_sched(None)

    def test_yields_produce_no_findings(self, lc):
        # the perturbation sleeps through the ORIGINAL time.sleep, so it
        # must never self-report blocking-under-lock — even when a yield
        # fires while another instrumented lock is held
        lc.configure_sched(3)
        outer = threading.Lock()
        inner = [threading.Lock() for _ in range(4)]
        with outer:
            for _ in range(40):
                for lk in inner:
                    with lk:
                        pass
        assert any(y for y, _ in lc.sched_trace())
        assert lc.findings() == []
        lc.configure_sched(None)


# ------------------------------------------------------- enforcement runs


def _run_instrumented(test_args, out_path, timeout, allow_test_failures=False,
                      sched_seed=None):
    """pytest in a subprocess under the port's checker
    (tests/torch_lockcheck_run.py). PILOSA_TPU_LOCKCHECK stays unset:
    it would install the reference's checker from tests/conftest.py."""
    env = dict(os.environ)
    env.pop("PILOSA_TPU_LOCKCHECK", None)
    env.pop("PILOSA_TPU_LOCKCHECK_SCHED", None)
    if sched_seed is not None:
        env["PILOSA_TPU_LOCKCHECK_SCHED"] = str(sched_seed)
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "tests", "torch_lockcheck_run.py"),
         str(out_path), "-q", "-m", "not slow", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", *test_args],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=timeout,
    )
    # rc 1 = "some tests failed": the full-suite run tolerates it; the
    # report is still written. Anything else (collection error, crash) is
    # a real problem either way.
    ok = (0, 1) if allow_test_failures else (0,)
    assert proc.returncode in ok, proc.stdout[-4000:] + proc.stderr[-2000:]
    payload = json.loads(open(out_path).read())
    return payload


@needs_own_install  # recursion guard: never re-spawn from inside a run
@pytest.mark.time_limit(600)  # its instrumented run's own bound
def test_instrumented_smoke_chaos_tier_rebalance(tmp_path):
    """Tier-1 enforcement over the port's server (device cpu): the
    concurrency-heavy port test files run fully instrumented under the
    port's checker and must produce zero lock-order cycles and zero
    blocking-under-lock findings. The set is the reference smoke's,
    cut to fit a tier-1 file's time: chaos fault injection, the tier's
    demote/promote workers racing queries and writes, hinted handoff
    under replica flaps, the CDC log nested in the fragment mutex, the
    geo fencing chaos leg and the autoscale abort-with-revert leg. The
    rebalance and device-fault files are left to the full instrumented
    run (marked slow). Torch's own threads run under the checker too:
    it patches the lock factories before torch is imported."""
    payload = _run_instrumented(
        ["tests/test_torch_chaos.py", "tests/test_torch_tier.py",
         "tests/test_torch_replication.py", "tests/test_torch_cdc.py",
         "tests/test_torch_geo.py::test_geo_chaos_fencing_no_shared_epoch",
         "tests/test_torch_autoscale.py::test_abort_mid_migration_fully_reverts"],
        tmp_path / "lockcheck.json", timeout=600,
        # Seeded schedule perturbation, replayable with the same seed.
        sched_seed=1337,
    )
    assert payload["count"] == 0, json.dumps(payload["findings"], indent=2)


@needs_own_install
@pytest.mark.slow
@pytest.mark.time_limit(900)  # its instrumented run's own bound
def test_instrumented_full_suite(tmp_path):
    """The whole tier-1 suite under instrumentation (slow: ~2x the plain
    runtime). Run locally before touching lock topology:
    python tests/torch_lockcheck_run.py OUT.json tests/ -m "not slow"."""
    payload = _run_instrumented(
        sorted(os.path.join("tests", f) for f in os.listdir(
            os.path.join(REPO_ROOT, "tests")) if f.startswith("test_torch_")),
        tmp_path / "lockcheck.json", timeout=900,
        allow_test_failures=True,
    )
    assert payload["count"] == 0, json.dumps(payload["findings"], indent=2)
