"""The device side of the traced window: torch.profiler's CUDA activity,
turned into busy intervals on the host's monotonic clock.

Two markers tie the clocks together: a short spin kernel on a stream of
its own, launched at a known host time at the start and at the end of
the window. Their device start less the host time is the profiler
clock's offset (off by the launch latency, some microseconds)."""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"

Interval = Tuple[str, float, float]  # name, start s, end s (host monotonic)


class DeviceWindow:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.marks: List[float] = []
        self.t0 = self.t1 = None
        self._stream = None

    def mark(self) -> float:
        """A marker at this host time, which it returns."""
        torch = self.torch
        with torch.cuda.stream(self._stream):
            t = time.monotonic()
            torch.cuda._sleep(20000)
        self.marks.append(t)
        return t

    def start(self) -> None:
        """Starts the profiler; its first start takes seconds, so this runs
        before the traffic, and the window is set by `open` and `close`."""
        from torch.profiler import ProfilerActivity, profile

        self._stream = self.torch.cuda.Stream()
        self.wall_less_mono = time.time() - time.monotonic()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def open(self) -> None:
        self.t0 = self.mark()

    def close(self) -> None:
        self.t1 = self.mark()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def intervals(self) -> Tuple[List[Interval], Optional[float]]:
        """Every device activity (kernel, copy, fill) of the profile on the
        host clock, the markers left out, and how the clocks were tied
        (without a marker the profiler's clock is taken for the wall
        clock)."""
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if str(ev.device_type()).rsplit(".", 1)[-1] != "CUDA":
                continue
            start = ev.start_ns() / 1e9
            raw.append((ev.name(), start, start + ev.duration_ns() / 1e9))
        marks = sorted(r for r in raw if MARKER in r[0])
        if len(marks) == len(self.marks) and marks:
            offset = sum(m[1] - h for m, h in zip(marks, self.marks)) / len(marks)
        elif raw:
            # No marker: take the profiler's clock for the wall clock.
            offset = self.wall_less_mono
            marks = []
        else:
            return [], None
        out = [(n, s - offset, e - offset) for n, s, e in raw if MARKER not in n]
        return out, {"offset_s": offset, "markers_found": len(marks), "events": len(raw)}


def union(intervals: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Busy spans: the intervals clipped to [lo, hi] and merged."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(intervals: List[Interval], lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Idle spans of [lo, hi] between the busy ones."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0][:80] or name[:80]


def top_ops(intervals: List[Interval], lo: float, hi: float, n: int = 10) -> List[list]:
    tot: Dict[str, float] = {}
    for name, s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            k = short_name(name)
            tot[k] = tot.get(k, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def kernel_s(intervals: List[Interval], pattern: str, lo: float, hi: float) -> float:
    """Seconds of the kernels whose name matches `pattern` (a regular
    expression searched in the name)."""
    rx = re.compile(pattern)
    return sum(min(e, hi) - max(s, lo) for name, s, e in intervals
               if rx.search(name) and e > lo and s < hi)


def label_gaps(idle: List[Tuple[float, float]], spans: List[tuple], n: int = 10,
               shortest: float = 50e-6) -> List[list]:
    """Idle seconds summed by what the host was doing at each gap's middle:
    the innermost recorder span open then (the latest to start), or
    "no span"; gaps shorter than `shortest` are summed as "gaps under 50
    us". `spans` are (name, start s, duration s)."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    import bisect

    tot: Dict[str, float] = {}
    longest = max((sp[2] for sp in spans), default=0.0)
    for s, e in idle:
        if e - s < shortest:
            tot["gaps under 50 us"] = tot.get("gaps under 50 us", 0.0) + (e - s)
            continue
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid)
        label = "no span"
        j = i - 1
        while j >= 0 and starts[j] >= mid - longest:
            name, st, dur = spans[j][:3]
            if st <= mid <= st + dur:
                label = name
                break
            j -= 1
        tot[label] = tot.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
