"""Judges every answer the run received against the reference.

A read that ran while writes were in flight may see any of them that had
been sent before its answer came back, and must see every one that had
been acknowledged before it was sent: new columns only ever add, so its
answer lies between the two, and is exact when no write was in flight.
The read-back after the window must see every acknowledged write."""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from .reference import expected, ride_matches


def _results(body: str):
    try:
        return json.loads(body)["results"]
    except (ValueError, KeyError, TypeError):
        return None


def _within(got, call: dict, lo: tuple, hi: tuple) -> bool:
    if call["agg"] == "Count":
        return isinstance(got, int) and lo[0] <= got <= hi[0]
    if not isinstance(got, dict):
        return False
    value, count = got.get("value"), got.get("count")
    return (isinstance(value, int) and isinstance(count, int)
            and lo[1] <= value <= hi[1] and lo[0] <= count <= hi[0])


class Judge:
    def __init__(self, ref, requests: List[dict], rides: List[dict], writes: List[list]):
        self.ref = ref
        self.requests = requests
        self.rides = rides
        n = len(rides)
        self.send_t = np.full(n, np.inf)
        self.ack_t = np.full(n, np.inf)
        self.failed_writes = []
        for tag, _due, t_send, t_recv, status, body in writes:
            self.send_t[tag] = t_send
            if status == 200 and _results(body) is not None:
                self.ack_t[tag] = t_recv
            else:
                self.failed_writes.append([tag, status, body[:300]])
        self._memo: Dict[int, tuple] = {}

    def _call_parts(self, tag: int, i: int):
        key = (tag, i)
        if key not in self._memo:
            call = self.requests[tag]["calls"][i]
            base = self.ref.answer(call)
            m, vals = ride_matches(call, self.rides) if self.rides else (None, None)
            self._memo[key] = (call, base, m, vals)
        return self._memo[key]

    def bounds(self, call, base, m, vals, t_send: float, t_recv: float):
        if m is None:
            return base, base
        acked = m & (self.ack_t < t_send)
        sent = m & (self.send_t < t_recv)
        lo = (base[0] + int(acked.sum()), base[1] + int(vals[acked].sum()))
        hi = (base[0] + int(sent.sum()), base[1] + int(vals[sent].sum()))
        return lo, hi

    def reads(self, records: List[list]) -> dict:
        """Marks each record ok or not (appends the number of correct calls)
        and returns the tallies, with a few wrong answers as examples."""
        wrong, failed, calls, examples = 0, 0, 0, []
        for rec in records:
            _reader, tag, t_send, t_recv, status, body = rec[:6]
            n_calls = len(self.requests[tag]["calls"])
            got = _results(body) if status == 200 else None
            good = 0
            if got is None or len(got) != n_calls:
                failed += 1
                if len(examples) < 3:
                    examples.append({"request": tag, "status": status, "body": body[:300]})
            else:
                for i in range(n_calls):
                    call, base, m, vals = self._call_parts(tag, i)
                    lo, hi = self.bounds(call, base, m, vals, t_send, t_recv)
                    if _within(got[i], call, lo, hi):
                        good += 1
                    else:
                        wrong += 1
                        if len(examples) < 3:
                            examples.append({"request": tag, "call": i, "got": got[i],
                                             "want": [expected(call, lo), expected(call, hi)]})
            calls += n_calls
            rec.append(good)
        return {"calls": calls, "wrong_calls": wrong, "failed_reads": failed,
                "examples": examples}

    def readback(self, calls: List[dict], answers: List) -> dict:
        """Exact: every acknowledged write counted, nothing else."""
        acked = np.isfinite(self.ack_t)
        wrong, examples = 0, []
        for call, got in zip(calls, answers):
            base = self.ref.answer(call)
            m, vals = ride_matches(call, self.rides)
            m = m & acked
            want = (base[0] + int(m.sum()), base[1] + int(vals[m].sum()))
            if not _within(got, call, want, want):
                wrong += 1
                if len(examples) < 3:
                    examples.append({"call": call, "got": got, "want": expected(call, want)})
        return {"readback_calls": len(calls), "readback_wrong": wrong, "examples": examples}
