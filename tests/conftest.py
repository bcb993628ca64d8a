"""Force tests onto a virtual 8-device CPU platform.

Multi-chip TPU hardware is unavailable in CI; shardings are validated on an
8-device CPU mesh (the driver separately dry-run-compiles multi-chip via
__graft_entry__.dryrun_multichip). jax is pre-imported by the environment,
so platform selection must go through jax.config (env vars are too late) —
this works as long as no backend has been initialized yet.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except AttributeError:
    pass  # older jax: XLA_FLAGS above covers it


import subprocess
import sys
import threading
import time

import pytest

# Lock-order / blocking-under-lock instrumentation (devtools/lockcheck.py):
# opt-in via PILOSA_TPU_LOCKCHECK=1, installed HERE — before any test
# imports pilosa_tpu — so module-level locks (failpoints._mu, native._lock)
# and every instance lock are constructed through the instrumented
# factories. Loaded by FILE PATH, not `from pilosa_tpu.devtools import
# lockcheck`: the package import would execute pilosa_tpu/__init__ first,
# constructing those module-level locks as raw _thread locks before
# install() patches the factories. lockcheck.py is stdlib-only so a path
# load is safe; seeding sys.modules makes later package imports reuse this
# instance (one global checker state). tests/test_lockcheck.py drives an
# instrumented subprocess run of the chaos/tier/rebalance tests through
# this hook and asserts the report (written at sessionfinish, path in
# PILOSA_TPU_LOCKCHECK_OUT) comes back empty.
_LOCKCHECK = os.environ.get("PILOSA_TPU_LOCKCHECK") == "1"
if _LOCKCHECK:
    import importlib.util

    _lc_spec = importlib.util.spec_from_file_location(
        "pilosa_tpu.devtools.lockcheck",
        os.path.join(os.path.dirname(__file__), "..",
                     "pilosa_tpu", "devtools", "lockcheck.py"))
    _lockcheck = importlib.util.module_from_spec(_lc_spec)
    sys.modules["pilosa_tpu.devtools.lockcheck"] = _lockcheck
    _lc_spec.loader.exec_module(_lockcheck)
    _lockcheck.install()


def pytest_sessionfinish(session, exitstatus):
    if not _LOCKCHECK:
        return
    out = os.environ.get("PILOSA_TPU_LOCKCHECK_OUT")
    if out:
        _lockcheck.write_report(out)
    fs = _lockcheck.findings()
    if fs:
        print("\n" + _lockcheck.report())


def pytest_configure(config):
    # Registered here (no pytest.ini in this repo) so tier-1's
    # `-m 'not slow'` selection works without unknown-mark warnings.
    config.addinivalue_line(
        "markers",
        "slow: timing-sensitive tests (real micro-batch windows, device "
        "benchmarks) excluded from the tier-1 CPU run",
    )
    config.addinivalue_line(
        "markers",
        "chaos: network-fault-injection cluster tests (tests/test_chaos.py)."
        " The deterministic seed-pinned smoke runs in tier-1; the"
        " randomized sweep is additionally marked slow (CHAOS_SMOKE=1"
        " shrinks it to the fast deterministic mode).",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the pilosa_tpu_torch kernels have no "
        "interpret mode); skipped where torch.cuda.is_available() is false",
    )


class FakeClock:
    """Deterministic monotonic clock for scheduler tests.

    Injectable wherever sched/ takes `clock` (Deadline, QueryScheduler):
    time() only moves when a test calls advance() or when a sleeper
    'sleeps' (sleep advances the clock immediately instead of blocking),
    so deadline tests run deterministically on CPU with zero wall-clock
    waits. Batcher window tests drive its `wait_window` hook instead."""

    def __init__(self, start: float = 1000.0):
        self._now = start
        self._lock = threading.Lock()

    def time(self) -> float:
        with self._lock:
            return self._now

    __call__ = time  # usable directly as the `clock` callable

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)


@pytest.fixture
def fake_clock():
    return FakeClock()


@pytest.fixture(autouse=True)
def _release_engines(thread_leak_guard):
    """Close every ShardedQueryEngine a test constructs (directly or via
    a lazy Executor.engine) at teardown: the cold-gather pool's workers
    are non-daemon, and tests build engines ad hoc in dozens of places —
    tracking construction here keeps the thread-leak guard honest
    without threading an engine fixture through every test signature.
    Depending on the guard fixture orders finalization: engines release
    FIRST, the guard's census runs after. Double-close is safe
    (pool.shutdown is idempotent), so tests/servers that already close
    their executors are unaffected."""
    from pilosa_tpu.parallel import engine as engine_mod

    created = []
    orig_init = engine_mod.ShardedQueryEngine.__init__

    def tracking_init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        created.append(self)

    engine_mod.ShardedQueryEngine.__init__ = tracking_init
    try:
        yield
    finally:
        engine_mod.ShardedQueryEngine.__init__ = orig_init
        for e in created:
            try:
                e.close()
            except Exception:
                pass


@pytest.fixture(autouse=True)
def thread_leak_guard(request):
    """Fail any test that leaves NON-DAEMON background threads running at
    teardown (un-shut-down executor/hedge/import pools, migration stream
    workers) — with the thread census printed so the leak is attributable
    to a thread, not a flaky downstream test. Daemon threads are exempt:
    the process can exit through them, and monitors/snapshotters are
    daemonized by design. A short grace lets threads that were ALREADY
    shutting down (pool.shutdown(wait=False)) finish their exit."""
    before = {t.ident for t in threading.enumerate()}
    yield

    def leaked():
        return [
            t for t in threading.enumerate()
            if t.ident not in before and not t.daemon and t.is_alive()
        ]

    remaining = leaked()
    deadline = time.monotonic() + 5.0
    while remaining and time.monotonic() < deadline:
        for t in remaining:
            t.join(timeout=0.2)
        remaining = leaked()
    if remaining:
        census = "\n".join(
            f"  - {t.name} (ident={t.ident}, daemon={t.daemon})"
            for t in remaining
        )
        pytest.fail(
            f"test leaked {len(remaining)} non-daemon background "
            f"thread(s) still running at teardown:\n{census}"
        )


@pytest.fixture(scope="session")
def tls_cert(tmp_path_factory):
    """Self-signed localhost cert/key pair, generated once per session."""
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "node.crt", d / "node.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    return str(cert), str(key)
