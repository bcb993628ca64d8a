"""The deployment kind `one_node`: one server of the port in the run's own
process, on the run's device, holding the whole index. The default kind
of a configuration that names none.

A deployment kind is a module with a class `Deployment`, made with the
run's arguments, hooks, configuration, columns and device, which the
harness drives in this order: `start` (the servers and the index made
from the seed), `warm` (the cell's warm-up calls, answered), `arm` (the
traced run's probes installed), `open` and `close` (the measured window),
`disarm`, the read-back over `ports`, and `finish`, which closes the
servers and returns what the metrics read (see `finish`)."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from gpubench import devtrace, load, probes


def _answer(r):
    """An executor result as the HTTP answer's JSON has it."""
    return {"value": r.val, "count": r.count} if hasattr(r, "val") else r


class Deployment:
    def __init__(self, args, hooks, cfg, columns, torch, device, on_card, data_dir, log):
        self.args, self.hooks, self.cfg, self.columns = args, hooks, cfg, columns
        self.torch, self.device, self.on_card = torch, device, on_card
        self.data_dir, self.log = data_dir, log
        self.launches = self.traces = self.window = None

    def start(self, phases: Dict[str, float], t: float) -> None:
        from pilosa_tpu_torch.ops import kernels
        from pilosa_tpu_torch.server.server import Server

        self.kernels = kernels
        torch, device = self.torch, self.device
        srv = self.srv = Server(data_dir=self.data_dir, port=0, device=device)
        srv.open()
        columns = self.columns
        loader = self.loader = load.Loader(srv.holder, columns)
        loader.load()
        if self.on_card:
            torch.cuda.synchronize(device)
        phases["load"] = time.monotonic() - t
        self.log(f"loaded {columns.n_columns} columns, {columns.n_shards} shards: "
                 f"{loader.counts} containers in {phases['load']:.1f} s")
        self.ports = [srv.port]

    def warm(self, index: str, pqls: List[str], phases: Dict[str, float], t: float) -> List:
        """The set-up reads every row the cell's traffic reads into the leaf
        cache, as a serving node holds its index; the answers are checked."""
        torch, device, srv = self.torch, self.device, self.srv
        answers = [_answer(r) for pql in pqls for r in srv.executor.execute(index, pql)]
        if self.on_card:
            torch.cuda.synchronize(device)
        phases["resident"] = time.monotonic() - t
        if self.hooks.after_server:
            self.hooks.after_server(srv)
        return answers

    def arm(self, trace: int) -> None:
        if trace:
            self.launches = probes.Launches(self.kernels)
            self.launches.install()
            self.traces = probes.Traces(self.srv.trace_recorder)
            self.traces.install()
            if self.on_card:
                self.window = devtrace.DeviceWindow(self.torch)
                self.window.start()

    def open(self, client_pid: int) -> None:
        torch, device, srv = self.torch, self.device, self.srv
        self.before = probes.counters(srv, self.kernels)
        self.gc_pauses = probes.GcPauses()
        self.sampler = probes.Sampler(srv, self.gc_pauses, client_pid)
        self.sampler.start()
        self.peak_pre = 0
        if self.on_card:
            self.peak_pre = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        if self.launches is not None:
            if self.window is not None:
                self.window.open()
            self.launches.active = self.traces.active = True

    def close(self) -> None:
        torch, device = self.torch, self.device
        if self.launches is not None:
            self.launches.active = self.traces.active = False
            if self.window is not None:
                self.window.close()
                self.window.stop()
        self.after = probes.counters(self.srv, self.kernels)
        self.sampler.stop()
        self.gc_pauses.close()
        self.peak_window = torch.cuda.max_memory_allocated(device) if self.on_card else 0

    def disarm(self) -> None:
        if self.launches is not None:
            self.launches.uninstall()
            self.traces.uninstall()

    def finish(self) -> dict:
        """Closes the server and frees the device, and returns: `counters`
        (the window's changes), `peak_window` and `memory_peak` (bytes of
        the fullest card), `kind` and `count` (the device's name and the
        cards used), `containers`, `gc`, `by_second`, and in a traced run
        `traces` (every trace kept), `launch_bytes`, `device` (the
        intervals and busy seconds that the metrics read, over every card),
        `device_line` (busy and window seconds per card, for the result's
        `device`) and `breakdown`."""
        torch, device, srv = self.torch, self.device, self.srv
        out = {
            "counters": probes.delta(self.after, self.before),
            "peak_window": self.peak_window,
            "memory_peak": max(self.peak_pre, self.peak_window,
                               torch.cuda.max_memory_allocated(device) if self.on_card else 0),
            "kind": torch.cuda.get_device_name(device) if self.on_card else str(device),
            "count": 1, "containers": dict(self.loader.counts), "gc": self.gc_pauses.snapshot(),
            "by_second": self.sampler.by_second(), "traces": [], "launch_bytes": {},
            "device": None, "device_line": None, "breakdown": None, "run": {}}
        srv.close()
        del srv, self.srv, self.loader
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        if self.launches is None:
            return out
        out["traces"] = self.traces.kept
        out["launch_bytes"] = self.launches.bytes_by_family()
        window = self.window
        if window is not None:
            intervals, offset = window.intervals()
            lo, hi = window.t0, window.t1
            busy = devtrace.busy_s(intervals, lo, hi)
            out["device"] = {"intervals": intervals, "t0": lo, "t1": hi,
                             "busy_s": busy, "window_s": hi - lo}
            out["device_line"] = {"busy_s": busy, "window_s": hi - lo}
            spans = [(sp[0], sp[1], sp[2]) for tr in self.traces.kept for sp in tr[3]]
            out["breakdown"] = {"device_ops": devtrace.top_ops(intervals, lo, hi),
                                "idle_gaps": devtrace.label_gaps(
                                    devtrace.gaps(intervals, lo, hi), spans)}
            self.log(f"device window {hi - lo:.3f} s, busy {busy:.4f} s, clock {offset}, "
                     f"launches {self.launches.count_by_family()}")
        return out
