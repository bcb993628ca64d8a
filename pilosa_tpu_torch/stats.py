"""Metrics abstraction (port of reference stats.go).

StatsClient interface: count/gauge/histogram/set/timing with tag scoping.
Implementations: Nop, InMemory (expvar-equivalent, JSON-dumpable), Multi,
and StatsDClient (UDP fire-and-forget, datadog wire format — the
reference's statsd/statsd.go), selected by config via new_stats_client.
"""

from __future__ import annotations

import json
import threading
import time
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


class NopStatsClient:
    def tags(self):
        return []

    def with_tags(self, *tags):
        return self

    def count(self, name, value, rate=1.0):
        pass

    def count_with_custom_tags(self, name, value, rate=1.0, tags=()):
        pass

    def gauge(self, name, value, rate=1.0):
        pass

    def histogram(self, name, value, rate=1.0):
        pass

    def set(self, name, value, rate=1.0):
        pass

    def timing(self, name, value, rate=1.0):
        pass

    def open(self):
        pass

    def close(self):
        pass


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


class MultiStatsClient:
    def __init__(self, clients):
        self.clients = list(clients)

    def tags(self):
        return self.clients[0].tags() if self.clients else []

    def with_tags(self, *tags):
        return MultiStatsClient([c.with_tags(*tags) for c in self.clients])

    def count(self, name, value, rate=1.0):
        for c in self.clients:
            c.count(name, value, rate)

    def count_with_custom_tags(self, name, value, rate=1.0, tags=()):
        for c in self.clients:
            c.count_with_custom_tags(name, value, rate, tags)

    def gauge(self, name, value, rate=1.0):
        for c in self.clients:
            c.gauge(name, value, rate)

    def histogram(self, name, value, rate=1.0):
        for c in self.clients:
            c.histogram(name, value, rate)

    def set(self, name, value, rate=1.0):
        for c in self.clients:
            c.set(name, value, rate)

    def timing(self, name, value, rate=1.0):
        for c in self.clients:
            c.timing(name, value, rate)

    def snapshot(self) -> dict:
        """Delegate to the first snapshot-capable client (keeps /debug/vars
        working when statsd is layered on top of the in-memory store)."""
        for c in self.clients:
            if hasattr(c, "snapshot"):
                return c.snapshot()
        return {}

    def open(self):
        for c in self.clients:
            c.open()

    def close(self):
        for c in self.clients:
            c.close()


class StatsDClient:
    """UDP statsd emitter (reference statsd/statsd.go, datadog wire format:
    "name:value|type|#tag1,tag2"). Fire-and-forget; errors are dropped."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 tags: Optional[List[str]] = None, prefix: str = "pilosa_tpu."):
        import socket

        self.addr = (host, port)
        self.prefix = prefix
        self._tags = list(tags or [])
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _send(self, name, value, kind, rate=1.0, tags=None):
        all_tags = sorted(set(self._tags) | set(tags or ()))
        msg = f"{self.prefix}{name}:{value}|{kind}"
        if rate < 1.0:
            msg += f"|@{rate}"
        if all_tags:
            msg += "|#" + ",".join(all_tags)
        try:
            self._sock.sendto(msg.encode(), self.addr)
        except OSError:
            pass

    def tags(self):
        return list(self._tags)

    def with_tags(self, *tags):
        c = StatsDClient.__new__(StatsDClient)
        c.addr = self.addr
        c.prefix = self.prefix
        c._tags = sorted(set(self._tags) | set(tags))
        c._sock = self._sock
        return c

    def count(self, name, value, rate=1.0):
        self._send(name, value, "c", rate)

    def count_with_custom_tags(self, name, value, rate=1.0, tags=()):
        self._send(name, value, "c", rate, tags)

    def gauge(self, name, value, rate=1.0):
        self._send(name, value, "g", rate)

    def histogram(self, name, value, rate=1.0):
        self._send(name, value, "h", rate)

    def set(self, name, value, rate=1.0):
        self._send(name, value, "s", rate)

    def timing(self, name, value, rate=1.0):
        self._send(name, value, "ms", rate)

    def open(self):
        pass

    def close(self):
        self._sock.close()


def new_stats_client(service: str, host: str = "") -> object:
    """Factory matching the reference's config-driven choice
    (server/server.go:227): inmem (expvar), statsd/datadog, or nop."""
    if service in ("statsd", "datadog"):
        h, _, p = (host or "127.0.0.1:8125").partition(":")
        return MultiStatsClient(
            [InMemoryStatsClient(), StatsDClient(h or "127.0.0.1", int(p or 8125))]
        )
    if service in ("none", "nop"):
        return NopStatsClient()
    return InMemoryStatsClient()


class Timer:
    """Context manager feeding a stats histogram in milliseconds."""

    def __init__(self, stats, name):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self.stats:
            self.stats.timing(self.name, (time.monotonic() - self.start) * 1000.0)
