"""Guards of the test suite under tests/: each pytest-xdist worker computes
on its share of the CPUs, and each phase of a test has a time limit.

pytest loads this file before tests/conftest.py, so the thread settings
are in place before JAX starts a backend and before any torch op runs.

Under xdist the share is the CPUs the process may use, divided among the
workers (at least 1): torch, XLA, OpenMP and numpy's BLAS get that many
threads, so that N workers do not each ask for every core and spend the
run waiting on each other. A run without xdist keeps the libraries' own
thread counts.

Each test's set-up, call and teardown under tests/ runs under a time limit
of its own: TEST_TIME_LIMIT_S, the `time_limit` marker's, or the limit
named in OWN_LIMITS. At the limit SIGALRM dumps every thread's stack to
stderr and fails the phase: a join(), a lock's acquire() and a sleep() all
return to Python on a signal. A wait inside native code (a collective, a
C extension's lock) never returns to Python, so faulthandler's watchdog
backs the alarm up: later by the limit again, 30 s at most, it dumps the
stacks and, in an xdist worker, ends the process. xdist reports the test
as failed and starts a new worker for the rest of its file. Either way a
hung test costs the run one test, not its clock.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import threading

import pytest

_ROOT = os.path.dirname(os.path.abspath(__file__))
_GUARDED = os.path.join(_ROOT, "tests") + os.sep

IN_XDIST_WORKER = "PYTEST_XDIST_WORKER" in os.environ


def _worker_cpu_share():
    """CPUs for this xdist worker's compute threads; None outside xdist."""
    if not IN_XDIST_WORKER:
        return None
    workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    return max(1, len(os.sched_getaffinity(0)) // workers)


CPU_SHARE = _worker_cpu_share()

if CPU_SHARE is not None:
    flags = os.environ.get("XLA_FLAGS", "")
    # jaxlib takes no intra-op thread count: one Eigen thread is the
    # nearest it comes to a share.
    if "xla_cpu_multi_thread_eigen" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_cpu_multi_thread_eigen=false").strip()
    # Inherited by every process a test starts.
    os.environ["OMP_NUM_THREADS"] = str(CPU_SHARE)
    os.environ["MKL_NUM_THREADS"] = str(CPU_SHARE)

    import torch
    from threadpoolctl import threadpool_limits

    torch.set_num_threads(CPU_SHARE)
    torch.set_num_interop_threads(1)
    # jaxtyping's pytest plugin loads numpy before this file runs, so
    # numpy's OpenBLAS sized its pool before OMP_NUM_THREADS was set.
    threadpool_limits(CPU_SHARE)


# Seconds each phase of a test (set-up, call, teardown) may take. In
# whole runs on 8 CPUs with one compute thread a worker, the longest
# test without a limit of its own took 45 s. A test that needs longer
# says so with @pytest.mark.time_limit(seconds).
TEST_TIME_LIMIT_S = 120.0

# The JAX package's tests carry no marker. Those that bound a subprocess
# run of their own past TEST_TIME_LIMIT_S get that bound here.
OWN_LIMITS = {
    # The instrumented pytest run's own timeout.
    "tests/test_lockcheck.py::test_instrumented_smoke_chaos_tier_rebalance":
        600.0,
    "tests/test_lockcheck.py::test_instrumented_full_suite": 900.0,
    # One bench run of up to 300 s, then any ratio gate's rerun.
    "tests/test_bench_smoke.py::test_bench_smoke_runs_every_stanza": 600.0,
}

# Most seconds the watchdog waits past the limit for the alarm's failure
# to unwind the phase.
BACKSTOP_GRACE_S = 30.0

# The watchdog writes to the stderr pytest found, not to the file that
# captures a test's stderr: a worker it ends leaves no report.
_watchdog_file = sys.__stderr__


def _limit_of(item):
    marker = item.get_closest_marker("time_limit")
    if marker:
        return float(marker.args[0])
    key = os.path.relpath(item.path, _ROOT).replace(os.sep, "/")
    return OWN_LIMITS.get(f"{key}::{item.name}", TEST_TIME_LIMIT_S)


@contextlib.contextmanager
def _time_limit(item, when):
    """Bound one phase of `item` (see the module's docstring)."""
    if not str(item.path).startswith(_GUARDED):
        yield
        return
    limit = _limit_of(item)
    alarm = (hasattr(signal, "setitimer")
             and threading.current_thread() is threading.main_thread())
    faulthandler.dump_traceback_later(
        limit + min(limit, BACKSTOP_GRACE_S) if alarm else limit,
        exit=IN_XDIST_WORKER, file=_watchdog_file)
    if alarm:
        def expire(signum, frame):
            __tracebackhide__ = True
            faulthandler.dump_traceback(file=sys.__stderr__)
            pytest.fail(f"{when} of {item.nodeid} ran past its time limit "
                        f"of {limit:g} s")

        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        if alarm:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _time_limit(item, "teardown"):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    """Run a test that crashed its worker once. Under --dist loadfile
    xdist queues the crashed test again with the rest of its file, and a
    test that ended its worker at the watchdog would end every worker
    that takes the file. A file already handed to a worker (the queue
    held nothing else) runs it again."""
    queue = getattr(sched, "workqueue", {})
    for scope, unit in list(queue.items()):
        if crashitem in unit:
            unit[crashitem] = True
            if all(unit.values()):
                del queue[scope]


def pytest_configure(config):
    global _watchdog_file
    _watchdog_file = os.fdopen(os.dup(sys.__stderr__.fileno()), "w")
    config.addinivalue_line(
        "markers",
        "time_limit(seconds): this test's own limit for each of its "
        "phases, in place of TEST_TIME_LIMIT_S",
    )
