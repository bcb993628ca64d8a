"""One rank of the `collective` deployment kind (gpubench/deployments/
collective.py): a server of the port on the rank's device, rank r of the
job that the PILOSA_JAX_* variables describe, holding the shards that
its node owns.

    python3 gpubench/deployments/collective_rank.py <job.json> <rank>

It loads its shards, waits until the collective plane is active, then
answers the commands it reads from its standard input, one JSON line
each, with one JSON line ({"ok": ...} or {"error": ...}) on the standard
output it was started with; whatever else the process prints goes to its
standard error. `finish` writes the rank's report to the job's file for
it, after which the rank closes its server and exits; so does the end of
its input."""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

T_PROC = time.monotonic()
ACTIVE_TIMEOUT_S = 180.0
# A zero-length span in the trace of each request whose Count the
# collective plane answered (the executor's CollectiveCount counter, told
# apart by request): collective_served_pct reads it.
SERVED_SPAN = "gpubench.collective_count"


class ServedMarks:
    """Wraps the executor's counter of its requests' statistics: each
    CollectiveCount also lands as SERVED_SPAN in the request's trace."""

    def __init__(self, executor):
        from pilosa_tpu_torch.obs.trace import record

        self.executor = executor
        self.orig = executor._count_stat

        def count_stat(name):
            self.orig(name)
            if name == "CollectiveCount":
                record(SERVED_SPAN, 0.0)

        executor._count_stat = count_stat

    def uninstall(self) -> None:
        self.executor._count_stat = self.orig


class Rank:
    def __init__(self, job: dict, rank: int):
        import torch

        from pilosa_tpu_torch.ops import kernels
        from pilosa_tpu_torch.parallel import CollectiveConfig, distributed
        from pilosa_tpu_torch.server.server import Server

        from gpubench import datagen
        from gpubench.deployments.collective import OwnedLoader, owned_shards

        self.torch, self.kernels, self.distributed = torch, kernels, distributed
        self.job, self.rank = job, rank
        self.device = torch.device(job["devices"][rank])
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            torch.cuda.set_device(self.device)
        hosts = [f"localhost:{p}" for p in job["ports"]]
        self.srv = srv = Server(
            data_dir=job["data_dirs"][rank], port=job["ports"][rank], cluster_hosts=hosts,
            replica_n=job["replicas"], collective_config=CollectiveConfig(**job["collective"]),
            device=self.device)
        srv.open()  # joins the job: returns once every rank has
        cfg = job["cfg"]
        columns = datagen.Columns(cfg, job["seed"], self.device, job["shards_per_block"])
        self.owned = owned_shards(srv.cluster, cfg["index"], columns.n_shards, srv.node.id)
        self.loader = OwnedLoader(srv.holder, columns, self.owned)
        self.loader.load()
        srv.holder.index(cfg["index"]).set_remote_max_shard(columns.n_shards - 1)
        if self.on_card:
            torch.cuda.synchronize(self.device)
        deadline = time.monotonic() + ACTIVE_TIMEOUT_S
        while not srv.collective.active():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"the collective plane is not active after {ACTIVE_TIMEOUT_S} s: nodes "
                    f"{[(n.id, n.process_idx) for n in srv.cluster.nodes]}, broken "
                    f"{srv.collective.broken()}")
            time.sleep(0.05)
        self.setup_s = time.monotonic() - T_PROC
        self.launches = self.traces = self.window = None

    def counters(self) -> dict:
        from gpubench import probes

        out = probes.counters(self.srv, self.kernels)
        out["stats"] = dict(self.srv.stats.snapshot().get("counters", {}))
        out["collective"] = self.srv.collective.snapshot()
        return out

    # ------------------------------------------------------------ commands

    def ready(self, cmd) -> dict:
        return {"rank": self.rank, "node": self.srv.node.id, "owned": self.owned,
                "containers": self.loader.counts, "setup_s": self.setup_s,
                "reduce_backend": self.distributed.reduce_backend()}

    def fault(self, cmd) -> dict:
        from gpubench.tests import faults

        faults.ALL[cmd["name"]](self.srv)
        return {}

    def arm(self, cmd) -> dict:
        from gpubench import devtrace, probes

        if cmd["trace"]:
            self.marks = ServedMarks(self.srv.executor)
            self.launches = probes.Launches(self.kernels)
            self.launches.install()
            self.traces = probes.Traces(self.srv.trace_recorder)
            self.traces.install()
            if self.on_card:
                self.window = devtrace.DeviceWindow(self.torch)
                self.window.start()
        return {}

    def open(self, cmd) -> dict:
        from gpubench import probes

        torch = self.torch
        self.before = self.counters()
        self.gc_pauses = probes.GcPauses()
        self.peak_pre = 0
        if self.on_card:
            self.peak_pre = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.launches is not None:
            if self.window is not None:
                self.window.open()
            self.launches.active = self.traces.active = True
        return {}

    def close(self, cmd) -> dict:
        if self.launches is not None:
            self.launches.active = self.traces.active = False
            if self.window is not None:
                self.window.close()
                self.window.stop()
        self.after = self.counters()
        self.gc_pauses.close()
        self.peak_window = (self.torch.cuda.max_memory_allocated(self.device)
                            if self.on_card else 0)
        return {}

    def disarm(self, cmd) -> dict:
        if self.launches is not None:
            self.marks.uninstall()
            self.launches.uninstall()
            self.traces.uninstall()
        return {}

    def finish(self, cmd) -> dict:
        from gpubench import devtrace, probes
        from gpubench.harness import forbidden_modules

        bad = forbidden_modules()
        if bad:
            raise RuntimeError(f"rank {self.rank} refuses to report: modules of JAX or the "
                               f"JAX package are loaded: {bad}")
        torch, device = self.torch, self.device
        rep = {"rank": self.rank, "node": self.srv.node.id, "device": str(device),
               "kind": torch.cuda.get_device_name(device) if self.on_card else str(device),
               "reduce_backend": self.distributed.reduce_backend(),
               "counters": probes.delta(self.after, self.before),
               "collective": self.srv.collective.snapshot(),
               "peak_window": self.peak_window,
               "memory_peak": max(self.peak_pre, self.peak_window,
                                  torch.cuda.max_memory_allocated(device) if self.on_card
                                  else 0),
               "gc": self.gc_pauses.snapshot(), "traces": [], "launch_bytes": {},
               "launch_counts": {}, "window": None, "busy_s": None, "window_s": None}
        if self.launches is not None:
            rep["traces"] = self.traces.kept
            rep["launch_bytes"] = self.launches.bytes_by_family()
            rep["launch_counts"] = self.launches.count_by_family()
        if self.window is not None:
            intervals, clock = self.window.intervals()
            lo, hi = self.window.t0, self.window.t1
            mine = [(n, max(s, lo), min(e, hi)) for n, s, e in intervals if e > lo and s < hi]
            spans = [(sp[0], sp[1], sp[2]) for tr in self.traces.kept for sp in tr[3]]
            rep["busy_s"] = devtrace.busy_s(mine, lo, hi)
            rep["window_s"] = hi - lo
            rep["window"] = {"intervals": mine, "t0": lo, "t1": hi, "clock": clock,
                             "idle_gaps": devtrace.label_gaps(devtrace.gaps(mine, lo, hi),
                                                              spans, n=1 << 20)}
        tmp = self.job["reports"][self.rank] + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rep, f, default=str)
        os.replace(tmp, self.job["reports"][self.rank])
        return {}

    def shut(self) -> None:
        self.srv.close()
        self.distributed.shutdown()


def main() -> int:
    job_path, rank = sys.argv[1], int(sys.argv[2])
    replies = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    with open(job_path) as f:
        job = json.load(f)
    node = Rank(job, rank)
    ops = {"ready": node.ready, "fault": node.fault, "arm": node.arm, "open": node.open,
           "close": node.close, "disarm": node.disarm, "finish": node.finish}
    for line in sys.stdin:
        cmd = json.loads(line)
        try:
            reply = {"ok": ops[cmd["op"]](cmd)}
        except Exception:
            reply = {"error": traceback.format_exc()[-4000:]}
        replies.write(json.dumps(reply, default=str) + "\n")
        replies.flush()
        if cmd["op"] == "finish":
            break
    node.shut()
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
