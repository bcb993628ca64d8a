"""A join and a leave under load, on both packages alike.

Three server processes of one package (data directories, replica_n = 2,
the jump hasher, live rebalance on) hold the first shards of a dense
field f, an int field v and a sparse field s, made from a numpy seed
and filled as the card smoke's path (j) fills its nodes. A fourth
process joins through `join_addr` while clients run
Count(Intersect(Row(f=a), Row(f=b))) and Sets/Clears round-robin over
the first three; `/cluster/resize/remove-node` then takes it out under
the same load. Every Count equals numpy, the only refusal a client sends
again is a write's cutover refusal ("shard migrated to a new owner"),
and after each move every node counts the written row as the
acknowledged writes left it. The port's nodes run on the CPU.

As a test it runs the port at a small size. As a script it
measures both packages on the same data and load and prints, for each,
the rebalance's wall time, the bytes and shards moved, the cutover
pauses (p50, max) and the clients' numbers during the move:

    JAX_PLATFORMS=cpu python tests/test_torch_join_ab.py --shards 64 --rows 32
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

W = 1 << 20  # SHARD_WIDTH
N_NODES = 3  # the cluster before the join
REPLICA_N = 2
V_MAX = 100000
V_DEPTH = 17

# One server process of package `lib`: nodes 0..N_NODES-1 reopen the
# data directories filled before the run; the last one joins on command.
WORKER = r"""
import json, os, sys

cfg = json.load(open(sys.argv[1]))
r = int(sys.argv[2])
sys.path.insert(0, cfg["here"])
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch

import chip_smoke as cs
from pilosa_tpu_torch.ops import kernels

ctl = cs.WorkerCommands(torch, kernels, cfg, r)
if cfg["lib"] == "pilosa_tpu":
    from pilosa_tpu.logger import Logger
    from pilosa_tpu.server.server import Server
    kw = {}
else:
    from pilosa_tpu_torch.logger import Logger
    from pilosa_tpu_torch.server.server import Server
    kw = {"device": "cpu"}
hosts = [f"localhost:{p}" for p in cfg["ports"]]


def make(**extra):
    return Server(data_dir=os.path.join(cfg["work"], f"n{r}"), port=cfg["ports"][r],
                  replica_n=cfg["replica_n"], cache_flush_interval=0,
                  anti_entropy_interval=0, member_monitor_interval=0,
                  logger=Logger(stream=sys.stderr), **kw, **extra)


srv = None
if r < len(hosts) - 1:
    srv = make(cluster_hosts=hosts[:-1], is_coordinator=r == 0)
    srv.open()
    # What a node filled in place knows of the shards the others hold.
    srv.holder.index("big").set_remote_max_shard(cfg["n_shards"] - 1)


def join(cmd):
    global srv
    srv = make(join_addr=hosts[0], is_coordinator=False)
    srv.open()  # returns once the coordinator admitted this node
    return {}


def status(cmd):
    return dict(nodes=[n.id for n in srv.cluster.nodes], state=srv.cluster.state,
                moving=srv.cluster.next_nodes is not None)


def report():
    return dict(node=hosts[r],
                rebalance=srv.rebalance_stats.snapshot() if srv is not None else None,
                pauses=list(srv.rebalance_stats._pauses) if srv is not None else [])


ctl.serve(report, lambda: srv is not None and srv.close(), ready=lambda cmd: {},
          join=join, status=status)
"""


def make_data(seed: int, n_shards: int, n_rows: int):
    """f's dense planes (about half the bits set), v's BSI planes and s's
    sparse bits over n_shards shards, from a numpy seed."""
    rng = np.random.default_rng(seed)
    H = rng.integers(0, 1 << 32, (n_rows, n_shards, W // 32), dtype=np.uint32)
    v = np.stack([cs.bsi_planes(rng.integers(0, V_MAX + 1, W).astype(np.uint32),
                                rng.random(W) < 0.5, V_DEPTH) for _ in range(n_shards)])
    srows = np.repeat(np.arange(cs.H_SPARSE_ROWS, dtype=np.uint64), 64)
    scols = rng.integers(0, n_shards * W, srows.size).astype(np.uint64)
    return rng, H, v, (srows, scols)


def fill_dirs(work: str, ports, H, v, sparse) -> None:
    """Data directories n0..n{N_NODES-1} holding each node's placement of
    f, v and s, written by the port's nodes and snapshotted, for either
    package's nodes to reopen."""
    from pilosa_tpu_torch.server.server import Server

    hosts = [f"localhost:{p}" for p in ports]
    servers = [Server(data_dir=os.path.join(work, f"n{r}"), port=ports[r],
                      cluster_hosts=hosts[:N_NODES], replica_n=REPLICA_N,
                      is_coordinator=r == 0, cache_flush_interval=0,
                      anti_entropy_interval=0, member_monitor_interval=0, device="cpu")
               for r in range(N_NODES)]
    try:
        for srv in servers:
            srv.open()
        for srv in servers:
            cs.fill_node(srv, H, v, sparse, H.shape[1])
            for field in srv.holder.index("big").fields.values():
                for view in field.views.values():
                    for frag in view.fragments.values():
                        frag.snapshot()
    finally:
        for srv in servers:
            srv.close()


def run_package(lib: str, base: str, ports, H, rng, n_clients: int, window_s: float,
                think_s: float, limit_s: float) -> dict:
    """One package's cluster over a copy of the filled directories: a join
    and a leave under `n_clients` clients. Returns each move's numbers."""
    work = tempfile.mkdtemp(prefix=f"join-ab-{lib}-", dir=base)
    for r in range(N_NODES):
        shutil.copytree(os.path.join(base, "fill", f"n{r}"), os.path.join(work, f"n{r}"))
    ctl = os.path.join(work, "ctl")
    os.makedirs(ctl)
    hosts = [f"localhost:{p}" for p in ports]
    joiner = N_NODES
    n_rows, n_shards = H.shape[:2]
    pairs = np.array([(a, b) for a in range(n_rows) for b in range(a + 1, n_rows)])
    want_pairs = [cs.np_count(np.bitwise_and(H[a], H[b])) for a, b in pairs]
    wr = n_rows  # the clients write a row that f does not hold
    cols = rng.permutation(n_shards * W)[:n_clients * 3000]
    writes = []
    for i in range(n_clients):
        mine = [int(c) for c in cols[i::n_clients]]
        writes.append([op for k, c in enumerate(mine) for op in
                       ([("Set", c)] + ([("Clear", mine[k - 1])] if k % 3 == 2 else []))])
    written, cursor = set(), [0] * n_clients
    cfg = dict(here=ROOT, work=work, ports=ports, replica_n=REPLICA_N, ctl=ctl,
               device="cpu", lib=lib, n_shards=n_shards)
    job = cs.RankJob(cfg, work, script=WORKER, n=N_NODES + 1)
    try:
        job.all("ready", timeout=300)

        def settled(n):
            st = job.ask(0, "status")
            return (len(st["nodes"]) == n and not st["moving"]
                    and all(job.ask(r, "status")["state"] == "NORMAL" for r in range(n)))

        def leave():
            status, got = cs.http(ports[0], "POST", "/cluster/resize/remove-node",
                                  {"id": hosts[joiner]})
            assert status == 200, got

        def check(nodes, label):
            for r in nodes:
                assert cs.query(ports[r], "big", f"Count(Row(f={wr}))") == [len(written)], (
                    lib, label, hosts[r])
                for k in range(0, len(pairs), max(1, len(pairs) // 4)):
                    a, b = (int(x) for x in pairs[k])
                    got = cs.query(ports[r], "big", f"Count(Intersect(Row(f={a}), Row(f={b})))")
                    assert got == [want_pairs[k]], (lib, label, hosts[r], a, b, got)

        out = {}
        for label, action, done, nodes in (
                ("join", lambda: job.ask(joiner, "join", timeout=limit_s),
                 lambda: settled(N_NODES + 1), range(N_NODES + 1)),
                ("leave", leave, lambda: settled(N_NODES), range(N_NODES))):
            before = job.all("report")
            got = cs.load_window(job, work, f"{lib} {label}", ports[:N_NODES], pairs, want_pairs, writes,
                                 cursor, written, wr, action, done, window_s=window_s,
                                 think_s=think_s, limit_s=limit_s)
            got["rebalance"] = cs.rebalance_numbers(job.all("report"), before)
            assert got["rebalance"]["jobs_completed"] == 1, (lib, label, got["rebalance"])
            check(nodes, label)
            out[label] = got
        job.stop()
        return out
    finally:
        job.close()
        shutil.rmtree(work, ignore_errors=True)


def measure(libs, n_shards: int, n_rows: int, n_clients: int, seed: int = 11,
            window_s: float = cs.J_WINDOW_S, think_s: float = cs.J_THINK_S,
            limit_s: float = cs.J_MOVE_LIMIT_S, base=None) -> dict:
    """Fill once, then run each package in `libs` over its own copy."""
    base = tempfile.mkdtemp(prefix="join-ab-", dir=base)
    try:
        rng, H, v, sparse = make_data(seed, n_shards, n_rows)
        # The joining node's id sorts last, as in the card smoke's path (j).
        ports = sorted(cs.free_ports(N_NODES + 1), key=lambda p: f"localhost:{p}")
        t0 = time.perf_counter()
        fill_dirs(os.path.join(base, "fill"), ports, H, v, sparse)
        out = {"fill_s": time.perf_counter() - t0}
        for lib in libs:
            out[lib] = run_package(lib, base, ports, H, np.random.default_rng([seed, 1]),
                                   n_clients, window_s, think_s, limit_s)
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_join_and_leave_under_load(tmp_path):
    """The port's cluster at a small size. The JAX package runs only in
    the measurement: a read of its fan-out can fail during a move (it
    re-routes a peer's 409 on the placement the peer refused), so a test
    of it under load would fail at random."""
    lib = "pilosa_tpu_torch"
    got = measure([lib], n_shards=8, n_rows=4, n_clients=2, window_s=0.5, think_s=0.01,
                  limit_s=60, base=str(tmp_path))[lib]
    for label in ("join", "leave"):
        rb = got[label]["rebalance"]
        assert rb["shards_cut_over"] > 0 and rb["fragments_moved"] > 0, (label, rb)
        assert rb["cutover_pause_ms_p50"] is not None, (label, rb)
        assert sum(w["n"] for w in got[label]["writes"].values()) > 0, got[label]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=64)
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--clients", type=int, default=cs.J_CLIENTS)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--libs", default="pilosa_tpu,pilosa_tpu_torch")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    got = measure(args.libs.split(","), args.shards, args.rows, args.clients, args.seed)
    for lib in args.libs.split(","):
        for label in ("join", "leave"):
            w = got[lib][label]
            print(json.dumps({"lib": lib, "move": label, "move_s": w["move_s"],
                              "rebalance": w["rebalance"], "counts": w["counts"],
                              "writes": w["writes"], "retried": w["retried"],
                              "refused": w["refused"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
