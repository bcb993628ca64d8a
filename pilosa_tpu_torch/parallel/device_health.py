"""Device-plane fault state: error classification and the dispatch breakers.

A jax-free copy of pilosa_tpu/parallel/device_health.py (the
collective-plane breakers wait for the multi-GPU slice), taught CUDA's
spellings. An engine dispatch that raises — a CUDA allocation failure
(``torch.cuda.OutOfMemoryError``, "CUDA out of memory"), a failed
kernel launch, a hang caught by the dispatch watchdog — is first
CLASSIFIED (oom / compile / runtime / timeout), then fed into two
breakers modeled on the reference's per-peer circuit breaker:

  per-signature     a query STRUCTURE whose device dispatch keeps failing
                    is quarantined: the executor routes that signature
                    down to the per-shard walk while every other
                    signature keeps the device path. Re-admission is a
                    half-open probe after an exponential backoff.

  plane-wide        consecutive dispatch failures across signatures mean
                    the DEVICE is sick, not one program: the whole engine
                    demotes to host execution (popcounts from host-tier
                    compressed bytes / live containers, no device work at
                    all) until a half-open probe dispatch succeeds.

``plan(sig)`` is the routing gate the executor consults before device
work: ``"device"`` (dispatch normally — possibly AS the half-open
probe), ``"shard"`` (signature quarantined: per-shard walk), or
``"host"`` (plane demoted: host execution ladder). The engine reports
every dispatch outcome through ``record_success``/``record_failure``,
which is what re-closes a probing breaker.

A kernel that cannot be BUILT is not a dispatch fault:
ops/kernels.py raises KernelBuildError, which the engine re-raises
untouched (no classification, no breaker record, no ladder) — a broken
build must stop the run, not be served from the host.

On the card the ladder below the device is closed to real faults: a
dispatch of the port's own kernels that fails there (a refused launch,
a sticky illegal-address fault at the read-back, an OOM that outlives
its backpressure retry, a watchdog timeout) is classified and recorded
into the breakers like any other, then raised as DeviceKernelFault,
which no rung catches. Only a CPU-device engine, or a fault injected
through the ``device-dispatch`` failpoint, is served one rung down.

Stdlib-only: the routing decisions and the breaker-lifecycle tests need
no torch, and the clock is injectable for deterministic tests.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Optional, Tuple

from ..cluster.health import ResilienceConfig
from ..errors import PilosaError

# Breaker states (the reference's peer-breaker vocabulary; the strings
# surface in snapshot()).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# Classification kinds (counter suffixes, DeviceDispatchError.kind).
OOM = "oom"
COMPILE = "compile"
RUNTIME = "runtime"
TIMEOUT = "timeout"

# Bound on tracked signatures: a long-lived server seeing endless query
# shapes must not grow breaker state without bound; CLOSED entries are
# dropped oldest-first past this.
_MAX_SIGS = 1024


class DeviceDispatchError(PilosaError):
    """A device dispatch failed after classification (and, for OOM, after
    backpressure + one retry). Carries the classified kind so the
    executor's ladder can choose the right fallback rung; the original
    exception rides ``__cause__``."""

    def __init__(self, kind: str, sig=None, message: str = ""):
        super().__init__(
            message or f"device dispatch failed ({kind})")
        self.kind = kind
        self.sig = sig


class DeviceKernelFault(PilosaError):
    """A dispatch of the port's kernels failed on the card for a real
    cause (module docstring). Classified and recorded like a
    DeviceDispatchError, but deliberately not one: the executor's ladder
    does not catch it, so the query fails instead of being answered on
    the host."""

    def __init__(self, kind: str, sig=None, message: str = ""):
        super().__init__(
            message or f"device kernel fault ({kind})")
        self.kind = kind
        self.sig = sig


class DeviceDispatchTimeout(PilosaError):
    """Raised by the engine's dispatch watchdog when a device call does
    not return within ``[engine] dispatch-watchdog`` seconds. The
    underlying dispatch thread cannot be killed — it parks a worker of
    the engine's dedicated dispatch pool until the runtime answers — so
    the watchdog's job is to free the SERVING thread and let the breaker
    stop sending work at a wedged device."""


# CUDA's spellings beside the reference's: torch.cuda.OutOfMemoryError
# says "CUDA out of memory. Tried to allocate ...", the runtime's
# cudaErrorMemoryAllocation reads "out of memory", cuBLAS
# "CUBLAS_STATUS_ALLOC_FAILED"; "no kernel image is available for
# execution on the device" is a kernel compiled for another card. A
# failed launch (ops/kernels.py "kernel launch failed: cudaError N") and
# a sticky fault ("CUDA error: an illegal memory access ...") match
# neither and classify `runtime`.
_OOM_RE = re.compile(
    r"resource_exhausted|out of memory|out_of_memory|\boom\b"
    r"|while trying to allocate|failed to allocate"
    r"|cudaerrormemoryallocation|alloc_failed")
_COMPILE_RE = re.compile(
    r"compil|invalid_argument|unimplemented|lowering|unsupported|mosaic"
    r"|no kernel image")


def classify_device_error(e: BaseException) -> str:
    """Map a dispatch exception to oom / compile / timeout / runtime.

    Classification is by type first (watchdog timeouts carry their own
    type), then by message substring — torch and the CUDA runtime name
    the failure in the exception text, and the injected-fault failpoints
    use the reference's spellings (``RESOURCE_EXHAUSTED``) so a fault
    test classifies exactly like the real error would."""
    if isinstance(e, DeviceDispatchTimeout) or isinstance(e, TimeoutError):
        return TIMEOUT
    try:
        from concurrent.futures import TimeoutError as _FutTimeout

        if isinstance(e, _FutTimeout):
            return TIMEOUT
    except ImportError:  # pragma: no cover - stdlib always has it
        pass
    text = f"{type(e).__name__}: {e}".lower()
    if _OOM_RE.search(text):
        return OOM
    if _COMPILE_RE.search(text):
        return COMPILE
    return RUNTIME


class _Breaker:
    __slots__ = ("state", "consec_failures", "opened_at", "backoff",
                 "probe_at", "open_count")

    def __init__(self):
        self.state = CLOSED
        self.consec_failures = 0
        self.opened_at = 0.0
        self.backoff = 0.0
        self.probe_at = 0.0
        self.open_count = 0


class DevicePlaneHealth:
    """Thread-safe device-plane breaker state for one engine.

    `config` is a ``cluster.health.ResilienceConfig`` (the device knobs
    of the `[resilience]` section); `clock` is injectable for
    deterministic tests."""

    def __init__(self, config=None, clock: Optional[Callable[[], float]] = None):
        import time

        if config is None:
            config = ResilienceConfig()
        self.config = config
        self.clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._plane = _Breaker()
        self._sigs: Dict[Tuple, _Breaker] = {}
        self.counters: Dict[str, int] = {
            "dispatch_failures": 0,
            "failures_oom": 0, "failures_compile": 0,
            "failures_runtime": 0, "failures_timeout": 0,
            "plane_opened": 0, "plane_closed": 0, "plane_probes": 0,
            "plane_short_circuits": 0,
            "sig_quarantined": 0, "sig_restored": 0, "sig_probes": 0,
            "sig_short_circuits": 0,
        }

    # ------------------------------------------------------------- routing

    def plan(self, sig: Optional[Tuple] = None) -> str:
        """Routing decision for one dispatch of structure `sig` (None =
        structure unknown; only the plane breaker applies).

        "device": dispatch normally. When a breaker's backoff has
        elapsed this call atomically claims the half-open probe — the
        dispatch it gates IS the probe, and the engine's
        record_success/record_failure resolves it. A claimed probe that
        never reports (the query was answered by a memo, the caller
        died) expires after `probe_ttl` and counts as failed, exactly
        like the peer breaker's lost probes.

        "shard": this signature is quarantined — run the per-shard walk
        instead of the device program.

        "host": the plane breaker is open — no device work at all;
        answer from host execution."""
        now = self.clock()
        with self._mu:
            s = self._sigs.get(sig) if sig is not None else None
            sig_base = self.config.device_sig_backoff
            if self._plane.state != CLOSED:
                if (s is not None and s.state != CLOSED
                        and not self._due_locked(s, now, sig_base)):
                    # A quarantined signature inside its OWN backoff must
                    # not serve as the plane's half-open probe: its
                    # program fails for its own reasons (bad compile,
                    # shape-specific bug), and letting it probe would
                    # re-open a healthy plane on every attempt. Once the
                    # SIG's backoff elapses it becomes a legitimate joint
                    # probe — without that, a workload whose every query
                    # shares the quarantined signature could never
                    # re-close the plane at all. (Side-effect-free check:
                    # the sig probe slot is only CLAIMED below, after the
                    # plane gate admits a dispatch — claiming first would
                    # orphan a sig probe every time the plane then
                    # short-circuits.)
                    self.counters["plane_short_circuits"] += 1
                    return "host"
                gate = self._gate_locked(
                    self._plane, now, "plane_probes", "plane_short_circuits",
                    self.config.device_breaker_backoff)
                if gate is False:
                    return "host"
                if s is not None and s.state != CLOSED:
                    # Joint probe: claim the sig slot too, so the one
                    # dispatch resolves both breakers.
                    self._gate_locked(s, now, "sig_probes",
                                      "sig_short_circuits", sig_base)
                return "device"
            if s is not None:
                gate = self._gate_locked(s, now, "sig_probes",
                                         "sig_short_circuits", sig_base)
                if gate is False:
                    return "shard"
        return "device"

    def _due_locked(self, b: _Breaker, now: float, base: float) -> bool:
        """Side-effect-free twin of _gate_locked: True when a probe COULD
        be claimed for this breaker right now (must hold _mu). `base` is
        the breaker's OWN configured backoff (plane vs sig)."""
        if b.state == OPEN:
            return now - b.opened_at >= b.backoff
        if b.state == HALF_OPEN:
            return now - b.probe_at >= base
        return True

    def _gate_locked(self, b: _Breaker, now: float, probes_key: str,
                     short_key: str, base: float) -> Optional[bool]:
        """Breaker gate for one dispatch (must hold _mu). None = CLOSED
        (dispatch, no probe semantics); True = dispatch AS the half-open
        probe; False = short-circuit to the degraded route. `base` is the
        breaker's OWN configured backoff — the plane and sig breakers
        each double from (and re-claim at) their own knob, so a large
        device-sig-backoff is honored rather than collapsing to the
        plane's scale.

        An unresolved HALF_OPEN probe re-claims after one base backoff
        interval instead of wedging until probe_ttl: unlike the peer
        breaker, a claimed device probe can legitimately dispatch NOTHING
        — the probing query may be answered by the result memo — so a
        quiet probe usually means 'no evidence', not 'lost caller'.
        probe_ttl still bounds the truly-lost case as a failure."""
        if b.state == CLOSED:
            return None
        if b.state == HALF_OPEN:
            if now - b.probe_at > self.config.probe_ttl:
                self._reopen(b, now, base)
            elif now - b.probe_at >= base:
                b.probe_at = now
                self.counters[probes_key] += 1
                return True
        if b.state == OPEN and now - b.opened_at >= b.backoff:
            b.state = HALF_OPEN
            b.probe_at = now
            self.counters[probes_key] += 1
            return True
        self.counters[short_key] += 1
        return False

    # ---------------------------------------------------------- accounting

    def record_success(self, sig: Optional[Tuple] = None) -> None:
        """A device dispatch completed: reset failure streaks and close
        any probing breaker (plane and, when known, signature)."""
        with self._mu:
            p = self._plane
            p.consec_failures = 0
            if p.state != CLOSED:
                p.state = CLOSED
                p.backoff = 0.0
                self.counters["plane_closed"] += 1
            if sig is not None:
                s = self._sigs.get(sig)
                if s is not None:
                    s.consec_failures = 0
                    if s.state != CLOSED:
                        s.state = CLOSED
                        s.backoff = 0.0
                        self.counters["sig_restored"] += 1

    def record_failure(self, sig: Optional[Tuple], kind: str) -> None:
        """A device dispatch failed with classified `kind`: advance both
        breakers. A failed half-open probe re-opens with doubled backoff;
        `device_sig_failures` consecutive failures quarantine the
        signature, `device_breaker_failures` consecutive failures (any
        signature) open the plane."""
        now = self.clock()
        cfg = self.config
        with self._mu:
            self.counters["dispatch_failures"] += 1
            key = f"failures_{kind}"
            self.counters[key] = self.counters.get(key, 0) + 1
            p = self._plane
            p.consec_failures += 1
            if p.state == HALF_OPEN:
                self._reopen(p, now, cfg.device_breaker_backoff)
            elif (p.state == CLOSED
                  and p.consec_failures >= cfg.device_breaker_failures):
                p.state = OPEN
                p.opened_at = now
                p.backoff = cfg.device_breaker_backoff
                p.open_count += 1
                self.counters["plane_opened"] += 1
            if sig is None:
                return
            s = self._sigs.get(sig)
            if s is None:
                s = self._sigs[sig] = _Breaker()
                self._trim_sigs_locked()
            s.consec_failures += 1
            if s.state == HALF_OPEN:
                self._reopen(s, now, cfg.device_sig_backoff)
            elif (s.state == CLOSED
                  and s.consec_failures >= cfg.device_sig_failures):
                s.state = OPEN
                s.opened_at = now
                s.backoff = cfg.device_sig_backoff
                s.open_count += 1
                self.counters["sig_quarantined"] += 1

    def _reopen(self, b: _Breaker, now: float, base: float) -> None:
        # Must hold _mu. Failed (or expired) half-open probe: back off
        # harder, same doubling discipline as the peer breaker. `base`
        # is the breaker's own knob; the cap never sits below it, so a
        # sig backoff configured above the plane cap can't SHRINK on the
        # first failed probe.
        b.state = OPEN
        b.opened_at = now
        b.backoff = min(
            max(b.backoff, base) * 2,
            max(self.config.device_breaker_backoff_max, base))
        b.open_count += 1

    def _trim_sigs_locked(self) -> None:
        if len(self._sigs) <= _MAX_SIGS:
            return
        for key in [k for k, b in self._sigs.items() if b.state == CLOSED]:
            del self._sigs[key]
            if len(self._sigs) <= _MAX_SIGS:
                return
        # Every entry is open (pathological): drop oldest regardless.
        while len(self._sigs) > _MAX_SIGS:
            self._sigs.pop(next(iter(self._sigs)))

    # ---------------------------------------------------------- inspection

    def plane_state(self) -> str:
        with self._mu:
            return self._plane.state

    def sig_state(self, sig: Tuple) -> str:
        with self._mu:
            s = self._sigs.get(sig)
            return s.state if s is not None else CLOSED

    def snapshot(self) -> dict:
        """Counter + breaker-state export (the reference serves it as
        /debug/vars `device_plane`)."""
        with self._mu:
            # WHICH canonical shapes are quarantined, not just how many:
            # signatures are the canonical plan IR (docs/query-compiler.md),
            # so the repr is a readable op tree an operator can match to a
            # workload. Bounded — a pathological flood must not balloon a
            # stats scrape.
            # Bounded in BOTH dimensions (16 entries, 256 chars each),
            # with the repr work stopping AT the entry bound: a
            # pathological flood can hold _MAX_SIGS open breakers, and
            # building 1024 multi-KB IR reprs under the health lock
            # would block concurrent dispatch classification.
            quarantined = 0
            open_sigs = []
            for sig, b in self._sigs.items():
                if b.state == CLOSED:
                    continue
                quarantined += 1
                if len(open_sigs) < 16:
                    open_sigs.append(repr(sig)[:256])
            return {
                **dict(self.counters),
                "plane_state": self._plane.state,
                "plane_backoff": round(self._plane.backoff, 3),
                "plane_open_count": self._plane.open_count,
                "sigs_tracked": len(self._sigs),
                "sigs_open": quarantined,
                "open_signatures": open_sigs,
            }
