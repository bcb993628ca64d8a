"""The suite's own guards (the repo's root conftest.py): each phase of a
test under tests/ runs under a time limit, and each xdist worker computes
on its share of the CPUs.

The cases that must fail run in a pytest of their own, in a subprocess
with its own timeout, so that they fail inside it and these tests pass.
Its conftest is a copy of the root one, and its tests sit under tests/.
"""

import os
import subprocess
import sys

pytest_plugins = ["pytester"]

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")

# After teardown: what a test leaves armed for the next one.
TIMER_LOG = """

def pytest_runtest_logfinish(nodeid, location):
    with open("timers.txt", "a") as fh:
        fh.write(f"{nodeid} {signal.getitimer(signal.ITIMER_REAL)} "
                 f"{signal.getsignal(signal.SIGALRM) is signal.SIG_DFL}\\n")
"""

LIMITS = """
import signal
import threading
import time

import pytest
from conftest import TEST_TIME_LIMIT_S


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(60)


@pytest.mark.time_limit(1)
def test_blocks_on_an_event():
    threading.Event().wait()


def test_ends_inside_its_limit():
    remaining, interval = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < remaining <= TEST_TIME_LIMIT_S and interval == 0


def test_keeps_its_threads_outside_xdist():
    import os

    import torch

    assert torch.get_num_threads() == {default_threads}
    assert "OMP_NUM_THREADS" not in os.environ
    assert "XLA_FLAGS" not in os.environ
"""

# The benchmark's own tests (gpubench/tests) run cells at full size on a
# card: the limit holds only under tests/.
UNGUARDED = """
import signal


def test_runs_without_a_limit():
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
"""

SHARE = """
import os

import torch
from threadpoolctl import threadpool_info


def test_computes_on_its_share():
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    assert os.environ["PYTEST_XDIST_WORKER_COUNT"] == "2"
    assert torch.get_num_threads() == share
    blas = [p for p in threadpool_info() if p["user_api"] == "blas"]
    assert blas and all(p["num_threads"] == share for p in blas), blas
    assert os.environ["OMP_NUM_THREADS"] == str(share)
    assert os.environ["MKL_NUM_THREADS"] == str(share)
    assert os.environ["XLA_FLAGS"] == "--xla_cpu_multi_thread_eigen=false"
"""

HANGS = """
import signal
import time

import pytest


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(60)


@pytest.mark.time_limit(1)
def test_waits_in_native_code():
    # No signal reaches Python here, as in a wait inside a C extension.
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_runs_after_the_hang():
    pass
"""


def _plain_environment(monkeypatch):
    """The environment of a run outside xdist, whatever runs this test."""
    for var in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT",
                "PYTEST_XDIST_TESTRUNUID", "OMP_NUM_THREADS",
                "MKL_NUM_THREADS", "XLA_FLAGS"):
        monkeypatch.delenv(var, raising=False)


def _suite(pytester, **files):
    """The root conftest with TIMER_LOG, and `files` under tests/."""
    with open(ROOT_CONFTEST) as fh:
        pytester.makeconftest(fh.read() + TIMER_LOG)
    for name, source in files.items():
        path = pytester.path / name
        path.parent.mkdir(exist_ok=True)
        path.write_text(source)


def test_a_phase_past_its_limit_fails_and_leaves_no_timer(
        pytester, monkeypatch):
    _plain_environment(monkeypatch)
    default_threads = int(subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True, timeout=60).stdout)
    _suite(pytester, **{
        "tests/test_limits.py": LIMITS.format(default_threads=default_threads),
        "other/test_unguarded.py": UNGUARDED,
    })

    result = pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-p", "no:xdist", "tests", "other",
        timeout=90)

    result.assert_outcomes(passed=3, failed=2)
    result.stdout.fnmatch_lines([
        "*call of tests/test_limits.py::test_sleeps_past_its_limit ran past "
        "its time limit of 1 s*",
        "*call of tests/test_limits.py::test_blocks_on_an_event ran past its "
        "time limit of 1 s*",
    ])
    # faulthandler's dump of every thread lands in the phase's stderr.
    result.stdout.fnmatch_lines(["*Captured stderr call*",
                                 "*most recent call first*"])
    # The 60 s sleep and the endless wait were cut at their limit.
    assert result.duration < 45, result.duration

    timers = (pytester.path / "timers.txt").read_text().splitlines()
    assert len(timers) == 5, timers
    for line in timers:
        assert line.endswith(" (0.0, 0.0) True"), line


def test_an_xdist_worker_computes_on_its_share(pytester, monkeypatch):
    _plain_environment(monkeypatch)
    _suite(pytester, **{"tests/test_share.py": SHARE})

    result = pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-p", "xdist", "-n", "2", timeout=90)

    result.assert_outcomes(passed=1)


def test_an_xdist_worker_fails_a_hung_test_and_goes_on(pytester, monkeypatch):
    _plain_environment(monkeypatch)
    _suite(pytester, **{"tests/test_hangs.py": HANGS})

    result = pytester.runpytest_subprocess(
        "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
        "--dist", "loadfile", timeout=90)

    # The sleep fails at the alarm; the wait that no signal reaches ends
    # its worker at the watchdog, once, and the file goes on in another.
    result.assert_outcomes(passed=1, failed=2)
    result.stdout.fnmatch_lines([
        "*call of tests/test_hangs.py::test_sleeps_past_its_limit ran past "
        "its time limit of 1 s*",
    ])
    crashes = [line for line in result.stdout.lines if
               "crashed while running 'tests/test_hangs.py::"
               "test_waits_in_native_code'" in line]
    assert len(crashes) == 1, result.stdout.str()
    result.stderr.fnmatch_lines(["Timeout (0:00:02)!",
                                 "*in test_waits_in_native_code*"])
    assert result.duration < 60, result.duration
