"""The deployment kind `collective`: a static cluster of N server
processes of the port, each one rank of one torch.distributed job, rank r
on cuda:r (`nodes`, `replicas` and `collective` in the configuration).
Every node names all N under its cluster hosts, so shards are placed by
the port's jump hash, and whole-index queries are answered by the
collective plane: each rank runs the kernels over its own shards and the
ranks reduce over the job's group, which the job itself puts on NCCL when
every rank has a card of its own.

Each rank (gpubench/deployments/collective_rank.py) makes the columns on
its own device from the seed, block by block as a one-node run makes
them, and hands its holder only the shards that its placement gives its
node; the ranks load at once. A rank answers commands, one JSON line each
on its standard input, with one JSON line on the standard output it was
started with; its log goes to `rank<r>.log` in the run's directory. The
harness drives them all at once: `ready` (answered once the rank has
loaded and the collective plane is active), `fault`, `arm`, `open`,
`close`, `disarm` and `finish`, after which the rank writes its report,
closes its server and exits. The warm-up and the read-back are HTTP
queries to every node in turn."""

from __future__ import annotations

import atexit
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List

import torch

from gpubench import clients, devtrace, load, spec
from gpubench.datagen import SHARD_WIDTH

RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "collective_rank.py")
READY_TIMEOUT_S = 900.0
REPLY_TIMEOUT_S = 300.0
EXIT_TIMEOUT_S = 120.0


def owned_shards(cluster, index: str, n_shards: int, node_id: str) -> List[int]:
    """The shards that the cluster's placement gives the node."""
    return [s for s in range(n_shards)
            if any(n.id == node_id for n in cluster.shard_nodes(index, s))]


class OwnedLoader(load.Loader):
    """The Loader, handed only the shards that one node owns: each block
    that holds one of them is made as a one-node run makes it, and only
    the owned shards' columns reach the holder."""

    def __init__(self, holder, columns, owned: List[int]):
        super().__init__(holder, columns)
        self.owned = sorted(owned)
        self._ids: List[int] = []

    def _fragments(self, view, shard0: int, nb: int) -> list:
        return [view.create_fragment_if_not_exists(s, broadcast=False) for s in self._ids]

    def load(self) -> None:
        mine = set(self.owned)
        for shard0, nb in self.columns.blocks():
            ids = [s for s in range(shard0, shard0 + nb) if s in mine]
            if not ids:
                continue
            n, cols = self.columns.block(shard0, nb)
            padded = nb * SHARD_WIDTH
            pick = torch.tensor([s - shard0 for s in ids], device=self.columns.device)
            part = {}
            for name in self.columns.loaded:
                v = cols[name]
                if n < padded:
                    v = torch.cat([v, torch.full((padded - n,), -1, dtype=v.dtype,
                                                 device=v.device)])
                part[name] = v.view(nb, SHARD_WIDTH)[pick].reshape(-1)
            del cols
            self._ids = ids
            self.load_block(ids[0], len(ids), len(ids) * SHARD_WIDTH, part)


def free_ports(n: int) -> List[int]:
    """n consecutive free ports of five digits: the nodes' ids then sort
    as their ranks, so rank r is the placement's node r in every run."""
    import random

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("localhost", p))
            return list(range(base, base + n))
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _sum_into(acc: Dict, part: Dict) -> None:
    for k, v in part.items():
        if isinstance(v, dict):
            _sum_into(acc.setdefault(k, {}), v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            acc[k] = acc.get(k, 0) + v


class Deployment:
    def __init__(self, args, hooks, cfg, columns, torch_mod, device, on_card, data_dir, log):
        self.args, self.hooks, self.cfg, self.columns = args, hooks, cfg, columns
        self.on_card, self.data_dir, self.log = on_card, data_dir, log
        self.n = int(cfg["nodes"])
        if hooks.rank_devices:
            self.devices = list(hooks.rank_devices)
        elif on_card:
            self.devices = [f"cuda:{r}" for r in range(self.n)]
        else:
            self.devices = [str(device)] * self.n
        self.procs: List[subprocess.Popen] = []
        self.replies: List[queue.Queue] = []
        self.logs: List[str] = []

    # ------------------------------------------------------------ ranks

    def _spawn(self) -> None:
        ports = free_ports(self.n + 1)
        self.ports = ports[:self.n]
        job_path = os.path.join(self.data_dir, "job.json")
        self.reports = [os.path.join(self.data_dir, f"rank{r}.report.json")
                        for r in range(self.n)]
        job = {"cfg": self.cfg, "seed": self.args.seed,
               "shards_per_block": self.hooks.shards_per_block, "ports": self.ports,
               "devices": self.devices, "replicas": int(self.cfg["replicas"]),
               "collective": self.cfg["collective"],
               "data_dirs": [os.path.join(self.data_dir, f"rank{r}") for r in range(self.n)],
               "reports": self.reports}
        with open(job_path, "w") as f:
            json.dump(job, f)
        env = dict(os.environ, PILOSA_JAX_COORDINATOR=f"localhost:{ports[-1]}",
                   PILOSA_JAX_NUM_PROCESSES=str(self.n))
        atexit.register(self._kill)
        for r in range(self.n):
            self.logs.append(os.path.join(self.data_dir, f"rank{r}.log"))
            with open(self.logs[r], "w") as log_f:
                proc = subprocess.Popen(
                    [sys.executable, RANK, job_path, str(r)], stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=log_f, text=True, cwd=spec.ROOT,
                    env=dict(env, PILOSA_JAX_PROCESS_ID=str(r)))
            self.procs.append(proc)
            q: queue.Queue = queue.Queue()
            threading.Thread(target=self._read, args=(proc, q), daemon=True).start()
            self.replies.append(q)

    @staticmethod
    def _read(proc, q) -> None:
        for line in proc.stdout:
            q.put(json.loads(line))
        q.put(None)

    def _tail(self, r: int, n: int = 3000) -> str:
        with open(self.logs[r]) as f:
            return f.read()[-n:]

    def _all(self, op: str, timeout: float = REPLY_TIMEOUT_S, **kw) -> list:
        """`op` to every rank at once, then every reply in rank order."""
        line = json.dumps(dict(op=op, **kw)) + "\n"
        for proc in self.procs:
            proc.stdin.write(line)
            proc.stdin.flush()
        out = []
        for r, (proc, q) in enumerate(zip(self.procs, self.replies)):
            deadline = time.monotonic() + timeout
            while True:
                try:
                    reply = q.get(timeout=0.5)
                    break
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"rank {r} did not answer {op} within {timeout} s: "
                                           f"{self._tail(r)}")
            if reply is None:
                raise RuntimeError(f"rank {r} exited ({proc.wait()}) before answering {op}: "
                                   f"{self._tail(r)}")
            if "error" in reply:
                raise RuntimeError(f"rank {r} failed {op}: {reply['error']}")
            out.append(reply["ok"])
        return out

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # ---------------------------------------------------------- the run

    def start(self, phases: Dict[str, float], t: float) -> None:
        if self.on_card:
            from pilosa_tpu_torch.ops import kernels

            kernels.build()  # once, before the ranks: each finds it built
        self._spawn()
        self.ready = self._all("ready", timeout=READY_TIMEOUT_S)
        phases["load"] = time.monotonic() - t
        self.containers: Dict[str, int] = {}
        for rd in self.ready:
            _sum_into(self.containers, rd["containers"])
        self.log(f"{self.n} ranks ready on {self.devices}, reduce backend "
                 f"{[rd['reduce_backend'] for rd in self.ready]}, shards "
                 f"{[len(rd['owned']) for rd in self.ready]}: {self.containers} containers "
                 f"in {phases['load']:.1f} s")

    def warm(self, index: str, pqls: List[str], phases: Dict[str, float], t: float) -> List:
        """Every row the cell's traffic reads, counted through the nodes in
        turn: each entry of the collective plane makes every rank's block
        of its rows resident. The answers are checked."""
        answers = [r for res in clients.query_all(self.ports, index, pqls)
                   for r in (res if res is not None else [None])]
        phases["resident"] = time.monotonic() - t
        if self.hooks.rank_fault:
            self._all("fault", name=self.hooks.rank_fault)
        return answers

    def arm(self, trace: int) -> None:
        self._all("arm", trace=int(trace))

    def open(self, client_pid: int) -> None:
        self._all("open")

    def close(self) -> None:
        self._all("close")

    def disarm(self) -> None:
        self._all("disarm")

    def finish(self) -> dict:
        """As one_node's `finish`, over every rank: counters, traces and
        launch bytes summed or joined over the ranks; the peaks of the
        fullest card; `device` with every card's intervals and their busy
        and window seconds summed over the cards (so the idle share is the
        cards' mean), and `device_line` with the mean per card."""
        self._all("finish")
        for r, proc in enumerate(self.procs):
            rc = proc.wait(timeout=EXIT_TIMEOUT_S)
            if rc != 0:
                raise RuntimeError(f"rank {r} exited {rc}: {self._tail(r)}")
        reps = []
        for path in self.reports:
            with open(path) as f:
                reps.append(json.load(f))
        counters: Dict = {}
        launch_bytes: Dict = {}
        gc_ms: Dict = {}
        for rep in reps:
            _sum_into(counters, rep["counters"])
            _sum_into(launch_bytes, rep["launch_bytes"])
            _sum_into(gc_ms, rep["gc"])
        cards = len(set(self.devices))
        out = {"counters": counters, "peak_window": max(rep["peak_window"] for rep in reps),
               "memory_peak": max(rep["memory_peak"] for rep in reps), "kind": reps[0]["kind"],
               "count": cards, "containers": self.containers, "gc": gc_ms, "by_second": {},
               "traces": [tr for rep in reps for tr in rep["traces"]],
               "launch_bytes": launch_bytes, "device": None, "device_line": None,
               "breakdown": None,
               "run": {"ranks": [{k: rep[k] for k in ("rank", "node", "device", "kind",
                                                      "reduce_backend", "peak_window",
                                                      "memory_peak", "busy_s", "window_s")}
                                 | {"shards": len(self.ready[rep["rank"]]["owned"]),
                                    "setup_s": self.ready[rep["rank"]]["setup_s"],
                                    "collective": rep["collective"]} for rep in reps]}}
        if all(rep["window"] is not None for rep in reps):
            intervals = [tuple(iv) for rep in reps for iv in rep["window"]["intervals"]]
            lo = min(rep["window"]["t0"] for rep in reps)
            hi = max(rep["window"]["t1"] for rep in reps)
            busy = sum(rep["busy_s"] for rep in reps)
            window = sum(rep["window_s"] for rep in reps)
            out["device"] = {"intervals": intervals, "t0": lo, "t1": hi, "busy_s": busy,
                             "window_s": window}
            out["device_line"] = {"busy_s": busy / len(reps), "window_s": window / len(reps)}
            gaps: Dict[str, float] = {}
            for rep in reps:
                _sum_into(gaps, dict(rep["window"]["idle_gaps"]))
            out["breakdown"] = {
                "device_ops": devtrace.top_ops(intervals, lo, hi),
                "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
            self.log(f"device windows of {len(reps)} cards {window:.3f} s, busy {busy:.4f} s, "
                     f"launches {[rep['launch_counts'] for rep in reps]}")
        return out
