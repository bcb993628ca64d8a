"""In-memory metrics client (jax-free copy of pilosa_tpu/stats.py's
InMemoryStatsClient, the expvar equivalent of reference stats.go).

The port's holder takes it as `stats`; the fragments count their writes
and the executor its device-ladder events (DeviceLadderFallback,
DeviceHostRouted, DeviceSigQuarantined) through it. The StatsD and Multi
clients come with the server slice.
"""

from __future__ import annotations

import json
import threading
from bisect import bisect_left
from collections import defaultdict
from typing import Dict, List, Optional


class Histogram:
    """Fixed log-bucketed histogram: count/sum/min/max plus counts per
    power-of-2 upper bound. Replaces the old per-key append-forever
    timing lists (a slow memory leak under sustained traffic, and
    /debug/vars copied + serialized the whole list per scrape): memory is
    O(buckets) however many observations land, snapshot() is what both
    /debug/vars and the /metrics Prometheus exposition need, and callers
    never pay more than one bisect per observation. Not self-locking —
    owners (InMemoryStatsClient, TraceRecorder) observe under their own
    lock, same as their counter dicts."""

    # 0.0625 .. 16384 in powers of two; values are usually milliseconds
    # (Timer) but the bounds work for any positive magnitude (batch
    # sizes, queue depths). Everything above the top bound lands in +Inf.
    BOUNDS = tuple(float(2.0 ** e) for e in range(-4, 15))

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # Per-bucket (non-cumulative) counts; index len(BOUNDS) is +Inf.
        self.buckets = [0] * (len(self.BOUNDS) + 1)

    def observe(self, value) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        self.buckets[bisect_left(self.BOUNDS, v)] += 1

    def snapshot(self) -> dict:
        """JSON-friendly view: nonzero buckets keyed by upper bound
        ("+Inf" for the overflow bucket). The /metrics renderer rebuilds
        the cumulative `le` series from BOUNDS."""
        buckets = {}
        for i, n in enumerate(self.buckets):
            if n:
                key = "+Inf" if i == len(self.BOUNDS) else repr(self.BOUNDS[i])
                buckets[key] = n
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": buckets,
        }


class InMemoryStatsClient:
    """Counter/gauge store, the expvar equivalent (stats.go:86-163)."""

    def __init__(self, tags: Optional[List[str]] = None, _root=None):
        self._tags = list(tags or [])
        self._root = _root or self
        if _root is None:
            self.counters: Dict[str, float] = defaultdict(float)
            self.gauges: Dict[str, float] = {}
            # Bounded log-bucketed histograms, NOT raw value lists: the
            # old per-key append grew without limit under traffic.
            self.timings: Dict[str, Histogram] = defaultdict(Histogram)
            self.sets: Dict[str, set] = defaultdict(set)
            self._lock = threading.Lock()

    def _key(self, name):
        return f"{name}|{','.join(sorted(self._tags))}" if self._tags else name

    def tags(self):
        return list(self._tags)

    def with_tags(self, *tags):
        return InMemoryStatsClient(sorted(set(self._tags) | set(tags)), _root=self._root)

    def count(self, name, value, rate=1.0):
        root = self._root
        with root._lock:
            root.counters[self._key(name)] += value

    def count_with_custom_tags(self, name, value, rate=1.0, tags=()):
        key = f"{name}|{','.join(sorted(set(self._tags) | set(tags)))}"
        root = self._root
        with root._lock:
            root.counters[key] += value

    def gauge(self, name, value, rate=1.0):
        root = self._root
        with root._lock:
            root.gauges[self._key(name)] = value

    def histogram(self, name, value, rate=1.0):
        root = self._root
        with root._lock:
            root.timings[self._key(name)].observe(value)

    def set(self, name, value, rate=1.0):
        root = self._root
        with root._lock:
            root.sets[self._key(name)].add(value)

    def timing(self, name, value, rate=1.0):
        self.histogram(name, value, rate)

    def snapshot(self) -> dict:
        root = self._root
        with root._lock:
            return {
                "counters": dict(root.counters),
                "gauges": dict(root.gauges),
                "timings": {k: v.snapshot() for k, v in root.timings.items()},
                "sets": {k: sorted(map(str, v)) for k, v in root.sets.items()},
            }

    def to_json(self) -> str:
        return json.dumps(self.snapshot())

    def open(self):
        pass

    def close(self):
        pass
