"""Runtime lock-order / blocking-under-lock checker (opt-in).

Python ships neither a race detector nor `go vet`; this is the fraction
of both that pilosa-tpu's concurrency rules actually need, cheap enough
to run under the whole tier-1 suite:

  (a) lock-order inversion: every acquisition of lock B while holding
      lock A records the edge A->B in a global directed graph over lock
      *instances*; a new edge that closes a cycle is a potential
      deadlock, reported with both acquisition sites.
  (b) blocking call under a lock: deny-listed blocking primitives
      (time.sleep, os.fsync/fdatasync/replace/rename, socket connect)
      called while the thread holds any instrumented lock — the
      off-lock serialization rules from docs/durability.md and
      docs/tiered-storage.md, enforced at runtime.
  (c) thread join under a lock: Thread.join while holding a lock wedges
      every other user of that lock behind an unbounded wait.

Activation: set PILOSA_TPU_LOCKCHECK=1 and call install() before the
code under test constructs its locks (tests/conftest.py does this for
the whole suite). install() monkeypatches threading.Lock/RLock — the
repo constructs locks exclusively via those module attributes — so
default threading.Condition/Event/Queue objects are instrumented too.

Suppression shares pilint's annotation grammar: a deny-listed call whose
source line (or the line above) carries `# pilint: allow-blocking(reason)`
is not a finding. Lock-order cycles have no annotation escape — order
them or fix them.

Schedule perturbation (opt-in, PILOSA_TPU_LOCKCHECK_SCHED=<seed>): the
lock proxies inject tiny seeded randomized yields at acquire boundaries,
widening the interleavings the instrumented chaos smokes explore beyond
what the OS scheduler happens to pick. Every yield decision is drawn
from ONE seeded PRNG serialized behind the checker's raw lock, so a
given acquire sequence replays deterministically under the same seed
(tests/test_lockcheck.py proves it); the yield sleeps through the
ORIGINAL time.sleep, so the perturbation can never self-report as a
blocking-under-lock finding.

Stdlib-only, and all checker state lives at module level guarded by a
RAW (_thread.allocate_lock) lock so the checker cannot deadlock with or
instrument itself.
"""

from __future__ import annotations

import _thread
import json
import os
import re
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

_ANNOT_RE = re.compile(r"#\s*pilint:\s*allow-blocking\(([^)]+)\)")

# ----------------------------------------------------------------- state

_glock = _thread.allocate_lock()  # guards everything below
_installed = False
_uid_counter = [0]
_sites: Dict[int, str] = {}  # lock uid -> creation site "file:line"
_succ: Dict[int, Set[int]] = {}  # instance lock-order graph
_edge_sites: Dict[Tuple[int, int], Tuple[str, str]] = {}  # edge -> acquire sites
_findings: List[dict] = []
_finding_keys: Set[tuple] = set()
_tls = threading.local()
_annot_cache: Dict[str, Set[int]] = {}  # filename -> annotated line numbers

_orig: Dict[str, object] = {}

# Schedule perturbation: seeded RNG + decision trace (for deterministic-
# replay assertions), armed by configure_sched(). Probability and sleep
# ceiling are deliberately tiny — the point is nudging interleavings,
# not slowing the suite.
_sched: Dict[str, object] = {"rng": None, "trace": []}
_SCHED_YIELD_P = 0.25
_SCHED_MAX_SLEEP = 0.0005
_SCHED_TRACE_CAP = 20000

_SKIP_FILES = (os.sep + "devtools" + os.sep + "lockcheck",
               os.sep + "threading.py")
_STDLIB_DIR = os.path.dirname(os.__file__)


def _caller_site(extra_skip: Tuple[str, ...] = ()) -> str:
    """file:line of the nearest frame outside lockcheck/threading."""
    f = sys._getframe(1)
    skip = _SKIP_FILES + extra_skip
    while f is not None:
        fn = f.f_code.co_filename
        if not any(s in fn for s in skip):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _is_stdlib(filename: str) -> bool:
    return filename.startswith(_STDLIB_DIR) or "site-packages" in filename


def _blocking_call_stack() -> Tuple[Optional[Tuple[str, int]], list]:
    """(site, frames) for a deny-listed call: `site` is the nearest frame
    outside the stdlib (the repo line to blame — a connect fired deep in
    http.client should point at the send_message caller, not socket.py);
    `frames` is every (file, line) up-stack, so annotation checks can
    honor an allow-blocking carried by ANY caller: the frame holding the
    lock takes responsibility for blocking work in its callees."""
    site: Optional[Tuple[str, int]] = None
    frames: list = []
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(s in fn for s in _SKIP_FILES):
            frames.append((fn, f.f_lineno))
            if site is None and not _is_stdlib(fn):
                site = (fn, f.f_lineno)
        f = f.f_back
    if site is None and frames:
        site = frames[0]
    return site, frames


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _site_annotated(filename: str, lineno: int) -> bool:
    """Shared escape hatch: `# pilint: allow-blocking(reason)` on the
    call line or the line above suppresses the runtime finding too."""
    lines = _annot_cache.get(filename)
    if lines is None:
        lines = set()
        try:
            with open(filename, "r", encoding="utf-8", errors="replace") as f:
                for i, text in enumerate(f, start=1):
                    if _ANNOT_RE.search(text):
                        lines.add(i)
                        lines.add(i + 1)  # applies to the line below too
        except OSError:
            pass
        _annot_cache[filename] = lines
    return lineno in lines


def _record(kind: str, key: tuple, detail: dict) -> None:
    with _glock:
        if key in _finding_keys:
            return
        _finding_keys.add(key)
        _findings.append({"kind": kind, **detail})


# -------------------------------------------------------- order tracking


def _find_path(src: int, dst: int) -> Optional[List[int]]:
    """DFS path src->dst in the instance graph (caller holds _glock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _succ.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquired(proxy) -> None:
    held = _held()
    if held:
        my_site = None
        for h in held:
            edge = (h._uid, proxy._uid)
            with _glock:
                if edge in _edge_sites:
                    continue
                if my_site is None:
                    my_site = _caller_site()
                _edge_sites[edge] = (h._last_acquire or h._site, my_site)
                _succ.setdefault(h._uid, set()).add(proxy._uid)
                # Does the new edge close a cycle? (path new -> ... -> held)
                path = _find_path(proxy._uid, h._uid)
            if path is not None:
                cycle = path  # proxy ... h; the new edge closes it
                cycle_sites = tuple(sorted(_sites.get(u, "?") for u in cycle))
                _record(
                    "lock-order-cycle",
                    ("cycle", cycle_sites),
                    {
                        "locks": [_sites.get(u, "?") for u in cycle],
                        "closing_edge": {
                            "held": _sites.get(h._uid, "?"),
                            "held_acquired_at": _edge_sites[edge][0],
                            "acquiring": _sites.get(proxy._uid, "?"),
                            "acquired_at": _edge_sites[edge][1],
                        },
                    },
                )
        proxy._last_acquire = my_site or proxy._last_acquire
    held.append(proxy)


def _note_released(proxy) -> None:
    held = _held()
    # Release order is usually LIFO but the checker must not assume it.
    for i in range(len(held) - 1, -1, -1):
        if held[i] is proxy:
            del held[i]
            return


# ---------------------------------------------------- schedule perturbation


def configure_sched(seed: Optional[int]) -> None:
    """Arm (or, with None, disarm) the acquire-boundary perturbation.
    Re-arming with the same seed restarts the decision sequence — the
    deterministic-replay contract."""
    import random

    with _glock:
        _sched["rng"] = None if seed is None else random.Random(int(seed))
        _sched["trace"] = []


def sched_trace():
    """The (yielded, delay) decision sequence drawn so far — what the
    determinism test asserts replays exactly under one seed."""
    with _glock:
        return list(_sched["trace"])


def _sched_yield() -> None:
    """Maybe sleep a tiny seeded-random interval before an acquire. The
    draw is serialized behind the checker lock (one global sequence);
    the sleep itself happens OUTSIDE it, through the original
    time.sleep so the deny-list wrapper never sees it."""
    with _glock:
        rng = _sched["rng"]
        if rng is None:
            return
        r = rng.random()
        yielded = r < _SCHED_YIELD_P
        delay = (r / _SCHED_YIELD_P) * _SCHED_MAX_SLEEP if yielded else 0.0
        trace = _sched["trace"]
        trace.append((yielded, round(delay, 7)))
        if len(trace) > _SCHED_TRACE_CAP:
            del trace[: _SCHED_TRACE_CAP // 2]
    if yielded:
        sleep = _orig.get("time.sleep") or time.sleep
        sleep(delay)


# ----------------------------------------------------------- lock proxies


class _LockProxy:
    """Instrumented non-reentrant lock. Quacks enough like thread.lock for
    threading.Condition (which falls back to acquire/release when the
    _release_save protocol is absent — absent here on purpose, so the
    fallback routes through our bookkeeping)."""

    _kind = "Lock"

    def __init__(self, inner):
        self._inner = inner
        with _glock:
            _uid_counter[0] += 1
            self._uid = _uid_counter[0]
        self._site = _caller_site()
        self._last_acquire: Optional[str] = None
        with _glock:
            _sites[self._uid] = f"{self._kind}@{self._site}"

    def acquire(self, blocking=True, timeout=-1):
        _sched_yield()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        _note_released(self)

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # os.register_at_fork handlers call this on stdlib locks
        # (concurrent.futures.thread registers one at import time).
        self._inner._at_fork_reinit()
        self._last_acquire = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockcheck {self._kind} {self._site}>"


class _RLockProxy(_LockProxy):
    """Instrumented reentrant lock. Re-acquisition by the owner adds no
    order edges (depth bookkeeping only). Implements the Condition
    protocol (_release_save/_acquire_restore/_is_owned) so Condition
    waits keep the held-stack honest."""

    _kind = "RLock"

    def __init__(self, inner):
        super().__init__(inner)
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking=True, timeout=-1):
        me = _thread.get_ident()
        if self._owner == me:
            # Reentrant re-acquire: no perturbation (the owner cannot
            # contend with itself) and no order edges.
            self._inner.acquire(blocking, timeout)
            self._count += 1
            return True
        _sched_yield()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            _note_acquired(self)
        return ok

    def release(self):
        if self._owner != _thread.get_ident():
            # Delegate the error to the real lock.
            self._inner.release()
            return
        self._count -= 1
        last = self._count == 0
        if last:
            self._owner = None
        self._inner.release()
        if last:
            _note_released(self)

    def _release_save(self):
        # Bookkeeping BEFORE the inner release (mirroring release()):
        # once _release_save() returns the lock is free, and a concurrent
        # acquire() would race our owner/count writes — a late
        # `self._owner = None` stomps the new owner's claim and strands
        # the lock in its held stack.
        saved_count = self._count
        self._owner = None
        self._count = 0
        _note_released(self)
        state = self._inner._release_save()
        return (state, saved_count)

    def _acquire_restore(self, saved):
        state, count = saved
        self._inner._acquire_restore(state)
        self._owner = _thread.get_ident()
        self._count = count
        _note_acquired(self)

    def _is_owned(self):
        return self._owner == _thread.get_ident()

    def _at_fork_reinit(self):
        super()._at_fork_reinit()
        self._owner = None
        self._count = 0


# ------------------------------------------------------ deny-list wrappers


def _check_blocking(name: str, extra: Optional[dict] = None) -> None:
    if not getattr(_tls, "held", None):
        return
    site, frames = _blocking_call_stack()
    if any(_site_annotated(fn, ln) for fn, ln in frames):
        return
    site_s = f"{site[0]}:{site[1]}" if site else "<unknown>"
    kind = "join-under-lock" if name == "Thread.join" else "blocking-under-lock"
    detail = {"call": name, "site": site_s, "held": [p._site for p in _held()]}
    if extra:
        detail.update(extra)
    _record(kind, (kind, name, site_s), detail)


def _blocking_wrapper(name: str, fn):
    def wrapper(*args, **kwargs):
        _check_blocking(name)
        return fn(*args, **kwargs)

    wrapper.__name__ = getattr(fn, "__name__", name)
    wrapper.__lockcheck_wrapped__ = fn
    return wrapper


def _join_wrapper(orig_join):
    def join(self, timeout=None):
        _check_blocking("Thread.join", {"thread": self.name})
        return orig_join(self, timeout)

    join.__lockcheck_wrapped__ = orig_join
    return join


# --------------------------------------------------------------- lifecycle


def install() -> None:
    """Patch threading/time/os/socket. Idempotent; reversed by
    uninstall(). Must run before the code under test constructs locks."""
    global _installed
    if _installed:
        return
    _installed = True

    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["time.sleep"] = time.sleep
    _orig["os.fsync"] = os.fsync
    _orig["os.fdatasync"] = getattr(os, "fdatasync", None)
    _orig["os.replace"] = os.replace
    _orig["os.rename"] = os.rename
    _orig["socket.connect"] = socket.socket.connect
    _orig["Thread.join"] = threading.Thread.join

    raw_lock, raw_rlock = threading.Lock, threading.RLock
    threading.Lock = lambda: _LockProxy(raw_lock())
    threading.RLock = lambda: _RLockProxy(raw_rlock())
    time.sleep = _blocking_wrapper("time.sleep", time.sleep)
    os.fsync = _blocking_wrapper("os.fsync", os.fsync)
    if _orig["os.fdatasync"] is not None:
        os.fdatasync = _blocking_wrapper("os.fdatasync", os.fdatasync)
    os.replace = _blocking_wrapper("os.replace", os.replace)
    os.rename = _blocking_wrapper("os.rename", os.rename)

    def _connect(self, address, _orig_connect=socket.socket.connect):
        _check_blocking("socket.connect")
        return _orig_connect(self, address)

    socket.socket.connect = _connect
    threading.Thread.join = _join_wrapper(threading.Thread.join)

    seed = os.environ.get("PILOSA_TPU_LOCKCHECK_SCHED")
    if seed:
        try:
            n = int(seed)
        except ValueError:
            # Non-numeric value (someone treated the knob as a boolean
            # toggle): derive a stable seed instead of crashing install()
            # after the monkey-patches are already applied — the run
            # stays deterministic for that spelling.
            import zlib

            n = zlib.crc32(seed.encode("utf-8"))
        configure_sched(n)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    time.sleep = _orig["time.sleep"]
    os.fsync = _orig["os.fsync"]
    if _orig["os.fdatasync"] is not None:
        os.fdatasync = _orig["os.fdatasync"]
    os.replace = _orig["os.replace"]
    os.rename = _orig["os.rename"]
    socket.socket.connect = _orig["socket.connect"]
    threading.Thread.join = _orig["Thread.join"]
    configure_sched(None)


def active() -> bool:
    return _installed


def reset() -> None:
    """Drop findings + order graph (NOT the installed patches)."""
    with _glock:
        _findings.clear()
        _finding_keys.clear()
        _succ.clear()
        _edge_sites.clear()


def findings() -> List[dict]:
    with _glock:
        return [dict(f) for f in _findings]


def report() -> str:
    fs = sorted(findings(), key=lambda f: (f["kind"], json.dumps(f, sort_keys=True)))
    if not fs:
        return "lockcheck: 0 findings"
    lines = []
    for f in fs:
        if f["kind"] == "lock-order-cycle":
            lines.append(
                "lock-order-cycle: " + " -> ".join(f["locks"])
                + f" (closing edge: {f['closing_edge']['held_acquired_at']}"
                + f" then {f['closing_edge']['acquired_at']})")
        elif f["kind"] == "blocking-under-lock":
            lines.append(
                f"blocking-under-lock: {f['call']} at {f['site']} holding "
                + ", ".join(f["held"]))
        else:
            lines.append(
                f"join-under-lock: join({f['thread']}) at {f['site']} "
                "holding " + ", ".join(f["held"]))
    lines.append(f"lockcheck: {len(fs)} finding(s)")
    return "\n".join(lines)


def write_report(path: str) -> None:
    """Deterministic JSON report (the conftest hook calls this at session
    end so an outer process can assert on the findings)."""
    fs = sorted(findings(), key=lambda f: (f["kind"], json.dumps(f, sort_keys=True)))
    payload = {"findings": fs, "count": len(fs)}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    replace = _orig.get("os.replace", os.replace)
    replace(tmp, path)
