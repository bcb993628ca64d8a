"""Failpoints: deterministic fault injection for crash-safety tests.

A tiny registry of named code points (WAL append, snapshot rename,
fragment open, client send) that is a no-op in production and lets tests
inject IO errors or hard crashes at exact moments. Modeled on the
technique behind Go's gofail / TiKV's failpoint crates: the hook call is
compiled into the hot path permanently, so the injection points cannot
rot, and the inactive cost is one module-global boolean check.

Activation:
  - env:  PILOSA_TPU_FAILPOINTS="wal-append=error;snapshot-rename=1*crash"
  - code: failpoints.configure("wal-append", "error", count=2)

Spec grammar per point: `[count*]action[(arg)]` where action is
  error        raise InjectedFault (an OSError subclass, so existing
               IO-error handling paths classify it as a disk fault);
               arg is the message
  crash        os._exit(86) — the moral equivalent of kill -9 at that
               line; buffers are NOT flushed, finalizers do NOT run
  drop         raise InjectedFault styled as a dropped connection — the
               network blackhole action (the client classifies it as a
               transport failure, status 0)
  oom          raise InjectedFault styled as an HBM RESOURCE_EXHAUSTED —
               the device-plane action: the engine's error classifier
               (parallel/device_health.py) reads it as OOM and runs the
               backpressure path a real allocation failure would
  latency(ms)  sleep `ms` milliseconds, then continue (slow network /
               wedged device dispatch — pairs with the dispatch watchdog)
  flaky(p)     with probability `p` (0..1) behave like `drop`, else pass;
               draws come from a module RNG seeded by seed() /
               PILOSA_TPU_FAILPOINTS_SEED so chaos runs are reproducible
and `count` limits how many hits trigger (default: unlimited). A point
whose count is exhausted stays registered but inert, so tests can assert
`hits(name)` afterward.

Per-peer targeting: fire sites on network paths pass `target` (the peer's
host:port), and a spec named `point@target` binds to exactly that peer —
`client-send@localhost:10102=drop` blackholes one node while the rest of
the cluster stays healthy. An untargeted `client-send=...` spec still
matches every send; the targeted entry wins when both exist.

Keep `fire()` free of locks and allocation when inactive: it guards on a
single global bool. The registry mutates under a lock; flipping `_enabled`
last publishes a fully-built table (CPython attribute stores are atomic).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

__all__ = [
    "InjectedFault",
    "InjectedCrash",
    "fire",
    "configure",
    "activate",
    "deactivate",
    "reset",
    "active",
    "hits",
    "seed",
    "CRASH_EXIT_CODE",
]

# Distinctive exit status so a test supervising a crashed subprocess can
# tell an injected crash from a real fault.
CRASH_EXIT_CODE = 86


class InjectedFault(OSError):
    """IO error raised by an `error` failpoint. An OSError so callers'
    existing disk-fault handling (quarantine, retry, degrade) exercises
    the same code path a real EIO would."""


class InjectedCrash(SystemExit):  # pragma: no cover - never raised, doc only
    """Placeholder type: `crash` failpoints never raise — they os._exit."""


class _Point:
    __slots__ = ("action", "remaining", "message", "arg", "hit_count")

    def __init__(self, action: str, count: Optional[int], message: str,
                 arg: float = 0.0):
        self.action = action
        self.remaining = count  # None = unlimited
        self.message = message
        self.arg = arg  # latency ms / flaky probability
        self.hit_count = 0


_enabled = False
_points: Dict[str, _Point] = {}
_mu = threading.Lock()
# Seeded RNG for probabilistic actions (flaky): chaos tests pin the seed
# so a failing schedule replays bit-identically.
import random as _random  # noqa: E402

_rng = _random.Random(0)

_SPEC_RE = re.compile(
    r"^(?:(?P<count>\d+)\*)?(?P<action>error|crash|drop|oom|latency|flaky)"
    r"(?:\((?P<msg>[^)]*)\))?$"
)


def fire(name: str, target: Optional[str] = None) -> None:
    """The hook threaded through production code. MUST stay cheap when
    inactive: one global-bool load, no dict lookup, no lock. `target`
    scopes network points to a peer: a `name@target` registration matches
    only that peer, a bare `name` matches every target."""
    if not _enabled:
        return
    _fire_slow(name, target)


def _fire_slow(name: str, target: Optional[str] = None) -> None:
    with _mu:
        p = None
        hit_name = name
        if target is not None:
            hit_name = f"{name}@{target}"
            p = _points.get(hit_name)
        if p is None:
            hit_name = name
            p = _points.get(name)
        if p is None:
            return
        p.hit_count += 1
        if p.remaining is not None:
            if p.remaining <= 0:
                return
            p.remaining -= 1
        action, message, arg = p.action, p.message, p.arg
        if action == "flaky" and _rng.random() >= arg:
            return  # this draw passes clean
    if action == "crash":
        # The whole point is to model kill -9: no stack unwinding, no
        # atexit, no buffer flush. os._exit is the only faithful stand-in.
        os._exit(CRASH_EXIT_CODE)
    if action == "latency":
        import time

        time.sleep(arg / 1000.0)
        return
    if action in ("drop", "flaky"):
        raise InjectedFault(
            message or f"injected network drop at failpoint {hit_name!r}")
    if action == "oom":
        # The RESOURCE_EXHAUSTED spelling is load-bearing: it is what the
        # device-plane classifier keys on, so the injected fault takes the
        # same backpressure path a real HBM allocation failure would. A
        # custom message rides BEHIND the prefix — replacing it would
        # silently turn an OOM-rung test into a generic-failure test.
        detail = message or f"injected HBM OOM at failpoint {hit_name!r}"
        raise InjectedFault(f"RESOURCE_EXHAUSTED: {detail}")
    raise InjectedFault(message or f"injected fault at failpoint {hit_name!r}")


def configure(name: str, action: str, count: Optional[int] = None,
              message: str = "", arg: float = 0.0) -> None:
    """Register (or replace) one failpoint programmatically. For network
    actions `arg` is the latency in ms (latency) or the failure
    probability (flaky)."""
    if action not in ("error", "crash", "drop", "oom", "latency", "flaky"):
        raise ValueError(f"unknown failpoint action {action!r}")
    if action == "flaky" and not 0.0 <= arg <= 1.0:
        raise ValueError("flaky probability must be in [0, 1]")
    if action == "latency" and arg < 0:
        raise ValueError("latency ms must be >= 0")
    global _enabled
    with _mu:
        _points[name] = _Point(action, count, message, arg)
        _enabled = True


def seed(n: int) -> None:
    """Re-seed the RNG behind probabilistic actions (flaky)."""
    with _mu:
        _rng.seed(n)


def activate(spec: str) -> None:
    """Parse and register a `name=spec[;name=spec...]` string (the
    PILOSA_TPU_FAILPOINTS format)."""
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, eq, rhs = part.partition("=")
        m = _SPEC_RE.match(rhs.strip()) if eq else None
        if not name.strip() or m is None:
            raise ValueError(f"bad failpoint spec {part!r} "
                             "(want name[@target]=[count*]action[(arg)])")
        action = m.group("action")
        raw = m.group("msg") or ""
        arg, message = 0.0, raw
        if action in ("latency", "flaky"):
            # The paren content is numeric for network actions.
            try:
                arg = float(raw)
            except ValueError:
                raise ValueError(
                    f"bad failpoint spec {part!r}: {action} needs a number")
            message = ""
        configure(
            name.strip(),
            action,
            int(m.group("count")) if m.group("count") else None,
            message,
            arg,
        )


def deactivate(name: str) -> None:
    global _enabled
    with _mu:
        _points.pop(name, None)
        if not _points:
            _enabled = False


def reset() -> None:
    """Drop every registered point (test teardown)."""
    global _enabled
    with _mu:
        _points.clear()
        _enabled = False


def active() -> Dict[str, str]:
    """name -> action summary, for diagnostics/debug endpoints."""
    with _mu:
        out = {}
        for n, p in _points.items():
            desc = p.action
            if p.action in ("latency", "flaky"):
                desc = f"{p.action}({p.arg:g})"
            if p.remaining is not None:
                desc = f"{p.remaining}*{desc}"
            out[n] = desc
        return out


def hits(name: str) -> int:
    """How many times `fire(name)` reached a registered point."""
    with _mu:
        p = _points.get(name)
        return p.hit_count if p else 0


# Env activation at import: the subprocess crash tests set the var before
# exec'ing the child, so the child's fragments come up armed with no code
# changes. A bad spec here must not brick server startup half-configured —
# reset and re-raise so the operator sees the error with a clean registry.
_env_seed = os.environ.get("PILOSA_TPU_FAILPOINTS_SEED")
if _env_seed:
    seed(int(_env_seed))
_env_spec = os.environ.get("PILOSA_TPU_FAILPOINTS")
if _env_spec:
    try:
        activate(_env_spec)
    except ValueError:
        reset()
        raise
