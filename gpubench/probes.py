"""What the traced run reads from the program, without changing its files:
its kernel entry points wrapped as module attributes (each launch's
shape, so the bytes it moves can be counted), every trace its recorder
finishes, its counters, and once a second the CPU time of the server and
the clients, the collections' pauses and the engine's counters."""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from . import bounds

# The entry point wrapped by name; gather_expr_count routes through
# gather_expr_count_blocks, so it is counted there once. No cell's metric
# reads K2 (masked_plane_counts) or K3 (bsi_minmax), so they are not
# wrapped.
K1_ENTRY = "gather_expr_count_blocks"


class Launches:
    """Records each launch of the wrapped entry point while `active`:
    (family, bytes). A family whose entry point is gone is never recorded,
    so its roofline is absent and never 0."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.active = False
        self.records: List[tuple] = []
        self.wrapped: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _note(self, family: str, nbytes: int) -> None:
        if self.active and nbytes:
            with self._lock:
                self.records.append((family, nbytes))

    def install(self) -> None:
        k = self.kernels
        if hasattr(k, K1_ENTRY):
            orig1 = getattr(k, K1_ENTRY)

            def k1(blocks, idxs, tape, variant=None):
                out = orig1(blocks, idxs, tape, variant)
                if self.active:
                    distinct = int(idxs.unique().numel()) if idxs.numel() else 0
                    self._note("k1", sum(bounds.k1_bytes(distinct, b.shape[1], b.shape[2])
                                         for b in blocks if b.is_cuda))
                return out

            self.wrapped[K1_ENTRY] = orig1
            setattr(k, K1_ENTRY, k1)

    def uninstall(self) -> None:
        for name, fn in self.wrapped.items():
            setattr(self.kernels, name, fn)
        self.wrapped.clear()

    def bytes_by_family(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for fam, n in self.records:
                out[fam] = out.get(fam, 0) + n
        return out

    def count_by_family(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for fam, _ in self.records:
                out[fam] = out.get(fam, 0) + 1
        return out


class Traces:
    """Keeps every trace the server's recorder finishes while `active`, as
    (pql, [(name, start monotonic s, duration s, tags)])."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.active = False
        self.kept: List[tuple] = []
        self._orig = None
        self._lock = threading.Lock()

    def install(self) -> None:
        orig = self._orig = self.recorder.finish

        def finish(trace, status: str = "ok"):
            orig(trace, status)
            if self.active and trace is not None:
                t0 = trace._start
                spans = [(s.name, t0 + s.start_ms / 1e3, s.dur_ms / 1e3, dict(s.tags or {}))
                         for s in list(trace.spans)]
                with self._lock:
                    self.kept.append((trace.pql, t0, trace.duration_ms / 1e3, spans))

        self.recorder.finish = finish

    def uninstall(self) -> None:
        if self._orig is not None:
            self.recorder.finish = self._orig
            self._orig = None


def counters(srv, kernels) -> Dict[str, Dict[str, int]]:
    return {"engine": srv.executor.engine.snapshot(), "batcher": srv.batcher.snapshot(),
            "launches": dict(kernels.LAUNCHES)}


def delta(after: dict, before: dict) -> Dict[str, Dict[str, int]]:
    return {grp: {k: v - before[grp].get(k, 0) for k, v in vals.items()
                  if isinstance(v, (int, float))}
            for grp, vals in after.items()}


class GcPauses:
    """The interpreter's collections while it is open, and their
    milliseconds, by generation: every thread of the server stops for
    them."""

    def __init__(self):
        import gc

        self.n, self.ms, self._t0 = [0, 0, 0], [0.0, 0.0, 0.0], None
        gc.callbacks.append(self._note)

    def _note(self, phase, info):
        import time

        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info.get("generation", 2)
            self.n[g] += 1
            self.ms[g] += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    def close(self) -> None:
        import gc

        if self._note in gc.callbacks:
            gc.callbacks.remove(self._note)

    def snapshot(self) -> dict:
        return {f"gen{g}": {"collections": self.n[g], "ms": self.ms[g]} for g in range(3)}


def _proc_cpu_s(pid: int) -> Optional[float]:
    """User and system CPU seconds of a process (/proc/<pid>/stat)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class Sampler:
    """Once a second while running, what only the moment tells: the CPU
    seconds of the server's process and of the client process, the
    collections' pauses, and the engine's and batcher's counters.
    `by_second()` gives the changes from one sample to the next."""

    ENGINE = ("count_dispatches", "stack_misses", "leaf_delta_hits", "memo_hits")

    def __init__(self, srv, gc_pauses: GcPauses, client_pid: int, period_s: float = 1.0):
        self.srv, self.gc, self.client_pid, self.period_s = srv, gc_pauses, client_pid, period_s
        self.samples: List[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _sample(self) -> dict:
        eng = self.srv.executor.engine.snapshot()
        t = os.times()
        row = {"server_cpu_s": t.user + t.system,
               "clients_cpu_s": _proc_cpu_s(self.client_pid),
               "gc_ms": sum(self.gc.ms), "gc_gen2": self.gc.n[2],
               "launches": self.srv.batcher.snapshot().get("launches", 0)}
        row.update({k: eng.get(k, 0) for k in self.ENGINE})
        return row

    def _loop(self) -> None:
        while True:
            self.samples.append(self._sample())
            if self._stop.wait(self.period_s):
                self.samples.append(self._sample())
                return

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def by_second(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for a, b in zip(self.samples, self.samples[1:]):
            for k, v in b.items():
                d = None if v is None or a[k] is None else v - a[k]
                out.setdefault(k, []).append(round(d, 4) if isinstance(d, float) else d)
        return out


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
