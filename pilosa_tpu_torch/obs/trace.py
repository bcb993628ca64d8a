"""Trace recorder core: spans, context propagation, ring, slow-query log.

Threading model: the ACTIVE trace rides a contextvar installed at handler
ingress, so serving-path stages (parse, admission, batching, fan-out,
gathers) record spans without any plumbing — obs.span("name") is a no-op
singleton when nothing is active, which is the whole disabled-path cost.
Code that hops threads (the executor's hedged remote legs) captures the
Trace object once and calls trace.span() directly; Trace state is
lock-protected so spans may complete on any thread.

Clock: spans and a trace's start (`Trace.start_mono`) are read on
`time.monotonic` unless the recorder is given another clock, so a
device trace mapped onto that clock lines up with the spans.

Garbage collection: while a `GcHook` is open (the server holds one),
one `gc.callbacks` callback times each collection, adds it to the
process's totals by generation, and notes the pause on the trace that
was active on the collecting thread. The collection may have
interrupted code that holds that trace's lock, so the note is a list
append without it; the pause lands as a `gc.pause` span at the trace's
next span exit (on whichever thread) or at its finish, both under the
lock. A pause noted while another thread finishes the trace can be lost.

Profiler ranges: while `profile_ranges(fn)` is set (the handler's
/debug/profile capture sets torch.profiler.record_function), every span
also opens `fn(name)` for its length, so the capture's Chrome trace
shows each host stage beside the kernels it launched. Unset, that costs
one global read per span, and this module never imports torch.

Cross-node: the coordinator stamps X-Pilosa-Trace on forwarded requests;
the peer adopts the id, records its own spans, and returns a size-bounded
JSON summary in X-Pilosa-Trace-Summary. The caller splices that summary
as CHILD spans of its remote:<peer> span. Child offsets stay relative to
the hop (the peer's own trace start), never converted through wall
clocks, so peer clock skew cannot corrupt the tree.
"""

from __future__ import annotations

import contextvars
import gc
import json
import random
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..stats import Histogram

_current: contextvars.ContextVar[Optional["Trace"]] = contextvars.ContextVar(
    "pilosa_tpu_trace", default=None
)

# Spans kept per trace; a runaway query (thousands of shards) truncates
# its own trace rather than growing without bound.
SPANS_MAX = 512
# Serialized peer-summary budget, both as sent (header built under it)
# and as accepted (a peer advertising a bigger one is truncated, not an
# error — the header must never be the thing that fails a query).
SUMMARY_MAX_BYTES = 4096


# Set while a profiler capture runs: called with a span's name, returns a
# context manager (torch.profiler.record_function) opened for the span.
_profile_range = None


def profile_ranges(fn) -> None:
    """Open `fn(span name)` around every span from now on (None: stop)."""
    global _profile_range
    _profile_range = fn


def current() -> Optional["Trace"]:
    """The trace active on this thread/context, or None."""
    return _current.get()


def activate(trace: Optional["Trace"]):
    """Install `trace` as the context's active trace; returns the reset
    token for deactivate()."""
    return _current.set(trace)


def deactivate(token) -> None:
    _current.reset(token)


class _NopSpan:
    """Shared do-nothing span: the disabled path allocates NOTHING —
    obs.span() returns this one module singleton when no trace is
    active, and every method is a constant-cost no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def tag(self, **kw) -> None:
        pass

    def splice(self, raw) -> None:
        pass

    def wire_id(self) -> str:
        return ""


NOP_SPAN = _NopSpan()


def span(name: str, **tags):
    """Context manager recording one stage span into the active trace.
    With no active trace this returns NOP_SPAN (no allocation)."""
    t = _current.get()
    if t is None:
        return NOP_SPAN
    return t.span(name, **tags)


def record(name: str, dur_ms: float, **tags) -> None:
    """Record a pre-measured span into the active trace (for stages whose
    duration is already computed, e.g. the scheduler's admission wait)."""
    t = _current.get()
    if t is not None:
        t.record(name, dur_ms, **tags)


class Span:
    """One named stage interval. Use as a context manager; completes into
    its trace on exit (from whichever thread ran it)."""

    __slots__ = ("_trace", "name", "start_ms", "dur_ms", "tags", "children",
                 "_t0", "_range")

    def __init__(self, trace: "Trace", name: str,
                 tags: Optional[Dict[str, Any]] = None):
        self._trace = trace
        self.name = name
        self.tags = tags or None
        self.children: Optional[List] = None
        self.start_ms = 0.0
        self.dur_ms = 0.0
        self._t0 = None
        self._range = None

    def __enter__(self) -> "Span":
        rf = _profile_range
        if rf is not None:
            self._range = rf(self.name)
            self._range.__enter__()
        self._t0 = self._trace._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t = self._trace
        now = t._clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        t0 = self._t0 if self._t0 is not None else now
        self.start_ms = (t0 - t._start) * 1000.0
        self.dur_ms = (now - t0) * 1000.0
        if exc_type is not None:
            self.tag(error=exc_type.__name__)
        t._append(self)
        return False

    def tag(self, **kw) -> None:
        if self.tags is None:
            self.tags = {}
        self.tags.update(kw)

    def wire_id(self) -> str:
        """The X-Pilosa-Trace header value for a hop made under this
        span: `<trace id>:1` (the :1 marks the sampling decision so the
        peer records without re-rolling its own sampler)."""
        return f"{self._trace.trace_id}:1"

    def splice(self, raw: str) -> None:
        """Attach a peer's X-Pilosa-Trace-Summary as child spans of this
        hop. Defensive by contract: an oversized or malformed summary is
        truncated/dropped with a tag, never an error — observability must
        not fail the query it observes. Child span offsets are kept
        relative to the hop (the peer's trace start), so peer clock skew
        never enters the tree."""
        if not raw:
            return
        if len(raw) > SUMMARY_MAX_BYTES:
            self.tag(summary_truncated=True)
            return
        try:
            data = json.loads(raw)
            spans = data.get("spans", [])
            if not isinstance(spans, list):
                raise TypeError("spans is not a list")
            children = []
            for s in spans[:SPANS_MAX]:
                name, start_ms, dur_ms = s[0], float(s[1]), float(s[2])
                tags = s[3] if len(s) > 3 and isinstance(s[3], dict) else None
                children.append((str(name), start_ms, dur_ms, tags))
        except (ValueError, TypeError, KeyError, IndexError) as e:
            self.tag(summary_error=type(e).__name__)
            return
        self.children = children
        if data.get("truncated"):
            self.tag(peer_truncated=int(data["truncated"]))

    def to_dict(self) -> dict:
        out: Dict[str, Any] = {
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "dur_ms": round(self.dur_ms, 3),
        }
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.children:
            out["children"] = [
                {"name": n, "start_ms": round(s, 3), "dur_ms": round(d, 3),
                 **({"tags": tg} if tg else {})}
                for n, s, d, tg in self.children
            ]
        return out


class Trace:
    """One query's span tree. Created by TraceRecorder; spans may be
    recorded from any thread (state is lock-protected)."""

    __slots__ = ("trace_id", "index", "pql", "adopted", "start_wall",
                 "_start", "_clock", "spans", "duration_ms", "status",
                 "finished", "spans_dropped", "tags", "_lock", "_gc")

    def __init__(self, trace_id: str, index: str = "", pql: str = "",
                 adopted: bool = False, clock=time.monotonic):
        self.trace_id = trace_id
        self.index = index
        self.pql = pql
        self.adopted = adopted
        self._clock = clock
        self._start = clock()
        self.start_wall = time.time()
        self.spans: List[Span] = []
        self.duration_ms = 0.0
        self.status = "ok"
        self.finished = False
        self.spans_dropped = 0
        self.tags: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        # Collections noted by _on_gc, (end on the trace's clock, seconds,
        # generation): appended without the lock, landed under it.
        self._gc: List[tuple] = []

    # ----------------------------------------------------------- recording

    def span(self, name: str, **tags) -> Span:
        return Span(self, name, tags or None)

    def tag(self, **kw) -> None:
        """Trace-level tags (e.g. the QoS tenant): request attributes
        that belong to the whole query, not one stage."""
        with self._lock:
            if self.finished:
                return
            if self.tags is None:
                self.tags = {}
            self.tags.update(kw)

    def record(self, name: str, dur_ms: float, **tags) -> None:
        """Append a pre-measured span ending now."""
        sp = Span(self, name, tags or None)
        now = self._clock()
        sp.dur_ms = float(dur_ms)
        sp.start_ms = max(0.0, (now - self._start) * 1000.0 - sp.dur_ms)
        self._append(sp)

    def _append(self, sp: Span) -> None:
        with self._lock:
            if self.finished or len(self.spans) >= SPANS_MAX:
                # finished: a straggler (an abandoned hedge leg completing
                # after the winning leg answered) must not mutate a trace
                # already published to the ring / histograms / summary
                # header — two scrapes of one trace id must agree.
                self.spans_dropped += 1
                return
            if self._gc:
                self._land_gc()
            self.spans.append(sp)

    def _land_gc(self) -> None:
        """The noted collections as `gc.pause` spans (lock held, trace
        not finished)."""
        while self._gc:
            end, secs, gen = self._gc.pop(0)
            if len(self.spans) >= SPANS_MAX:
                self.spans_dropped += 1
                continue
            sp = self.span("gc.pause", gen=gen)  # built here, never entered
            sp.start_ms = (end - secs - self._start) * 1000.0
            sp.dur_ms = secs * 1000.0
            self.spans.append(sp)

    def wire_id(self) -> str:
        return f"{self.trace_id}:1"

    @property
    def start_mono(self) -> float:
        """The trace's start on the recorder's clock (`time.monotonic`
        unless the recorder was given another): a span's absolute start
        is start_mono + start_ms / 1000."""
        return self._start

    # --------------------------------------------------------- serializing

    def to_dict(self) -> dict:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        out = {
            "id": self.trace_id,
            "index": self.index,
            "pql": self.pql,
            "start": self.start_wall,
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            "spans": spans,
        }
        with self._lock:
            if self.tags:
                out["tags"] = dict(self.tags)
        if self.spans_dropped:
            out["spans_dropped"] = self.spans_dropped
        return out

    def summary_header(self, max_bytes: int = SUMMARY_MAX_BYTES) -> str:
        """The X-Pilosa-Trace-Summary value: this node's spans as compact
        JSON, tail-truncated to fit `max_bytes` (the header must stay a
        bounded cost on every forwarded response)."""
        with self._lock:
            spans = list(self.spans)
        rows = []
        for s in spans:
            row: List[Any] = [s.name, round(s.start_ms, 3), round(s.dur_ms, 3)]
            if s.tags:
                row.append(s.tags)
            rows.append(row)
        # One-pass size cut: serialize each row once and keep a prefix
        # that fits the budget (envelope + truncated-field reserve),
        # then dump the payload once. Re-serializing the whole payload
        # per dropped row was O(n^2) — paid on every traced forwarded
        # response, worst exactly when a degraded path fattens traces.
        row_strs = [json.dumps(r, separators=(",", ":")) for r in rows]
        reserve = 64  # '{"id":...,"ms":...,"spans":[],"truncated":N}'
        budget = max_bytes - (len(self.trace_id) + reserve)
        keep, used = 0, 0
        for r in row_strs:
            if used + len(r) + 1 > budget:
                break
            used += len(r) + 1
            keep += 1
        while True:
            payload: Dict[str, Any] = {
                "id": self.trace_id,
                "ms": round(self.duration_ms, 3),
                "spans": rows[:keep],
            }
            if keep < len(rows):
                payload["truncated"] = len(rows) - keep
            out = json.dumps(payload, separators=(",", ":"))
            # The reserve makes overshoot all but impossible; the
            # fallback pop guarantees the bound regardless.
            if len(out) <= max_bytes or keep == 0:
                return out
            keep -= 1


class TraceRecorder:
    """Sampling recorder + bounded completed-trace ring + per-stage
    histograms + slow-query log. One per server process."""

    def __init__(self, config=None, stats=None, logger=None,
                 clock=time.monotonic, seed: Optional[int] = None):
        from . import ObsConfig

        self.config = config or ObsConfig()
        self.stats = stats
        self.logger = logger
        self.clock = clock
        self._lock = threading.Lock()
        # Seeded sampler: chaos/bench runs pin the seed so the sampled
        # set replays bit-identically.
        self._rng = random.Random(seed)
        self._ring: deque = deque(maxlen=max(1, self.config.ring_size))
        self._hists: Dict[str, Histogram] = {}
        self.counters: Dict[str, int] = {
            "traces_started": 0, "traces_adopted": 0, "traces_finished": 0,
            "slow_queries": 0, "spans_dropped": 0,
        }

    @property
    def enabled(self) -> bool:
        return self.config.sample_rate > 0.0

    # ----------------------------------------------------------- lifecycle

    def maybe_start(self, index: str = "", pql: str = "") -> Optional[Trace]:
        """Sample an ingress query: a Trace when this one is traced, else
        None (the common path: one float compare + one RNG draw)."""
        rate = self.config.sample_rate
        if rate <= 0.0:
            return None
        with self._lock:
            if rate < 1.0 and self._rng.random() >= rate:
                return None
            trace_id = f"{self._rng.getrandbits(64):016x}"
            self.counters["traces_started"] += 1
        return Trace(trace_id, index=index, pql=pql, clock=self.clock)

    def adopt(self, header: str, index: str = "", pql: str = "",
              ) -> Optional[Trace]:
        """Adopt a coordinator-stamped X-Pilosa-Trace header
        (`<id>[:sampled]`). The upstream sampler already decided, so the
        local rate is not re-rolled; a malformed header is ignored."""
        if not header:
            return None
        trace_id, _, flag = header.partition(":")
        trace_id = trace_id.strip()
        if (not trace_id or len(trace_id) > 64
                or not trace_id.replace("-", "").isalnum()):
            return None
        if flag and flag.strip() not in ("1", "true"):
            return None
        with self._lock:
            self.counters["traces_adopted"] += 1
        return Trace(trace_id, index=index, pql=pql, adopted=True,
                     clock=self.clock)

    def finish(self, trace: Optional[Trace], status: str = "ok") -> None:
        """Land a completed trace: ring, per-stage histograms, slow-query
        log. Idempotent — the handler's error paths and its summary-header
        path may both reach here."""
        if trace is None:
            return
        with trace._lock:
            # The finished flag flips under the trace lock so a straggler
            # span (abandoned hedge leg) racing this finish either lands
            # before the snapshot below or is dropped by _append — never
            # mutates the published trace.
            if trace.finished:
                return
            if trace._gc:
                trace._land_gc()
            trace.finished = True
            spans = list(trace.spans)
            dropped = trace.spans_dropped
        trace.status = status
        trace.duration_ms = (self.clock() - trace._start) * 1000.0
        with self._lock:
            self.counters["traces_finished"] += 1
            self.counters["spans_dropped"] += dropped
            if self.config.ring_size > 0:
                self._ring.append(trace)
            for s in spans:
                h = self._hists.get(s.name)
                if h is None:
                    h = self._hists[s.name] = Histogram()
                h.observe(s.dur_ms)
        slow_ms = self.config.slow_query_ms
        if slow_ms > 0 and trace.duration_ms >= slow_ms:
            with self._lock:
                self.counters["slow_queries"] += 1
            if self.stats is not None:
                self.stats.count("SlowQueries", 1)
            if self.logger is not None:
                breakdown = "; ".join(
                    f"{s.name}={s.dur_ms:.1f}ms" for s in spans)
                self.logger.info(
                    "[obs] slow query %.1fms > slow-query-ms %.1f "
                    "trace=%s index=%s pql=%s stages: %s",
                    trace.duration_ms, slow_ms, trace.trace_id, trace.index,
                    trace.pql, breakdown or "(no spans)")

    # ------------------------------------------------------------- reading

    def traces(self, min_ms: float = 0.0, index: Optional[str] = None,
               limit: int = 64) -> List[dict]:
        """Completed traces, newest first, filtered by minimum duration
        and/or index (the GET /debug/traces contract)."""
        with self._lock:
            candidates = list(self._ring)
        out = []
        for t in reversed(candidates):
            if t.duration_ms < min_ms:
                continue
            if index and t.index != index:
                continue
            out.append(t.to_dict())
            if len(out) >= max(1, limit):
                break
        return out

    def stage_histograms(self) -> Dict[str, dict]:
        """Per-stage log-bucketed latency snapshots (feeds /metrics)."""
        with self._lock:
            return {name: h.snapshot() for name, h in self._hists.items()}

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["ring"] = len(self._ring)
        out["sample_rate"] = self.config.sample_rate
        out["slow_query_ms"] = self.config.slow_query_ms
        return out


# ------------------------------------------------------------ gc pauses

# The process's collections while a GcHook is open, by generation.
_gc_collections = [0, 0, 0]
_gc_seconds = [0.0, 0.0, 0.0]
_gc_t0: Optional[float] = None  # start of the collection in progress


def _on_gc(phase: str, info: dict) -> None:
    """The `gc.callbacks` callback. It runs inside whatever code the
    collection interrupted, possibly holding a trace's lock, so it takes
    no lock and allocates little more than the noted tuple."""
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.monotonic()
        return
    t0, _gc_t0 = _gc_t0, None
    if t0 is None:
        return
    secs = time.monotonic() - t0
    g = info["generation"]
    _gc_collections[g] += 1
    _gc_seconds[g] += secs
    t = _current.get()
    if t is not None and not t.finished:
        t._gc.append((t._clock(), secs, g))


class GcHook:
    """Keeps `_on_gc` installed from `open` to `close` (installed while
    any hook is open), and reads the process's collections and pause
    milliseconds by generation since this hook opened (`snapshot()`).
    Every open hook counts every collection of the process: two servers
    in one process both count a pause."""

    _open_hooks = 0
    _install_lock = threading.Lock()

    def __init__(self):
        self._base: Optional[tuple] = None
        self._end: Optional[tuple] = None

    @staticmethod
    def _totals() -> tuple:
        return tuple(_gc_collections), tuple(_gc_seconds)

    def open(self) -> None:
        with GcHook._install_lock:
            if self._base is not None and self._end is None:
                return
            if GcHook._open_hooks == 0:
                gc.callbacks.append(_on_gc)
            GcHook._open_hooks += 1
            self._base, self._end = self._totals(), None

    def close(self) -> None:
        with GcHook._install_lock:
            if self._base is None or self._end is not None:
                return
            self._end = self._totals()
            GcHook._open_hooks -= 1
            if GcHook._open_hooks == 0:
                gc.callbacks.remove(_on_gc)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self._base is None:
            return out
        (n0, s0), (n1, s1) = self._base, self._end or self._totals()
        for g in range(3):
            out[f"gcCollectionsGen{g}"] = n1[g] - n0[g]
            out[f"gcPauseMsGen{g}"] = (s1[g] - s0[g]) * 1000.0
        out["gcPauseMs"] = sum(out[f"gcPauseMsGen{g}"] for g in range(3))
        return out
