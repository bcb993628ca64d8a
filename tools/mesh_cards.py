#!/usr/bin/env python3
"""The engine over one partition per card beside one partition.

    python3 tools/mesh_cards.py [--shards 256] [--rows 128] [--batch 256]
                                [--reps 8] [--out PATH]

Run from the root of a checkout on a machine with two or more CUDA
cards. It builds chip_smoke.py's bench_big holder (random planes from
--seed), then three engines over it: one partition on cuda:0, one
partition per card (`engine_mesh(device_count)`), and as many partitions
all on cuda:0. For each it checks a count_batch of --batch distinct
Count(Intersect(Row, Row)) against numpy, counts K1's launches per batch
(one per partition), and times, alternating the engines: the batch
(host clock, warm stacks, count_batch_async then a synchronize of every
card), K1 alone over the resident stack's blocks (host clock around the
launches and a synchronize of every card: the partitions on different
cards run at once), and a single Count with the memos off. It prints
the cards' nvidia-smi lines and, last, one JSON object. Imports nothing
of JAX. `--device cpu` rehearses it on the CPU (the kernels' plain
twins, every partition on the CPU; no time it prints is a card's).

    python3 tools/mesh_cards.py --leg collective [--shards 256] [--rows 128]
                                [--counts 256] [--timeout-ms 3000] [--out PATH]

The collective leg, on a host of four or more cards: chip_smoke.py path
(i)'s four rank processes (`WORKER_I`), twice over the same seeded f and
v planes: (a) one card per rank (`[engine] mesh-devices 1`, rank r on
cuda:r), where the backend rule picks NCCL, and (b) all four on cuda:0,
where it picks gloo. Each checks distinct Counts at C = 1 and C = 8 over
HTTP, one collective count_batch of --batch Counts, TopN with and
without a filter and Sum/Min/Max with and without one against numpy, and
(a)'s answers against (b)'s; reports every rank's reduce backend, the
reduces, host copies and K1 launches per entry, Counts/s and p50/p99,
the leader's `collective.barrier` and `collective.reduce` p50s and the
reduce's mean time per entry on every rank (host clock); then stalls one
rank's reduce past the group's timeout and checks that the re-formed
group serves again within 10 s. `--device cpu` rehearses it (both legs
on the CPU, so both on gloo).
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import pilosa_tpu_torch as pt  # noqa: E402
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.parallel.engine import ShardedQueryEngine  # noqa: E402
from pilosa_tpu_torch.parallel.mesh import engine_mesh  # noqa: E402
from pilosa_tpu_torch.pql.parser import parse  # noqa: E402


def nvidia_smi_all():
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def leg_data(rng, shards: int, rows: int):
    """f's (rows, shards, W) random ~50%-density planes and v's values
    (0..V_MAX on about half the columns), from `rng`."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    H = rng.integers(0, 1 << 32, size=(rows, shards, SHARD_WIDTH // 32),
                     dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, cs.V_MAX + 1, size=(shards, SHARD_WIDTH)).astype(np.uint32)
    nn = rng.random((shards, SHARD_WIDTH)) < 0.5

    def want_vc(kind, mask):
        sel = vals[mask]
        if kind == "sum":
            return int(sel.sum(dtype=np.int64)), int(sel.size)
        best = int(sel.max() if kind == "max" else sel.min())
        return best, int(np.count_nonzero(sel == best))

    return H, dict(vals=vals, nn=nn, want_vc=want_vc)


def run_leg(label, device, H, bsi, planes, work, args, rng_seed):
    """One pass of the collective leg: four ranks with `device` (None:
    rank r on cuda:r), their answers and numbers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    n_rows, n_shards, _ = H.shape
    ctl = os.path.join(work, f"ctl-{label}")
    os.makedirs(ctl)
    ports = cs.free_ports(cs.I_RANKS + 1)
    cfg = dict(here=ROOT, coordinator=f"localhost:{ports[-1]}", ports=ports[:cs.I_RANKS],
               replica_n=cs.H_REPLICAS, engine_leaf=5 << 30, engine_stack=3 << 30,
               timeout_ms=args.timeout_ms, leaf_budget=cs.I_LEAF_BUDGET,
               client_timeout=cs.I_CLIENT_TIMEOUT, ctl=ctl, f_path=planes["f_path"],
               v_path=planes["v_path"], device=device, mesh_devices=1)
    rng = np.random.default_rng(rng_seed)  # the same draws in both legs
    t0 = time.perf_counter()
    os.makedirs(os.path.join(work, label))
    job = cs.RankJob(cfg, os.path.join(work, label))
    leg = {"device": device}
    answers = {}
    try:
        ready = job.all("ready", timeout=900)
        leg["start_s"] = time.perf_counter() - t0
        leg["mesh"] = [r["mesh"] for r in ready]
        reps = job.all("report")
        leg["reduce_backend"] = [r["collective"]["reduce_backend"] for r in reps]
        print(f"leg {label}: ranks up in {leg['start_s']:.1f} s, meshes {leg['mesh']}, "
              f"reduce backend per rank {leg['reduce_backend']}", flush=True)
        bufs = threading.local()

        def want_pair(a, b):
            x, y = H[a].reshape(-1).view(np.uint64), H[b].reshape(-1).view(np.uint64)
            if getattr(bufs, "w", None) is None:
                bufs.w, bufs.c = np.empty_like(x), np.empty(x.shape, np.uint8)
            np.bitwise_and(x, y, out=bufs.w)
            np.bitwise_count(bufs.w, out=bufs.c)
            return int(bufs.c.sum(dtype=np.int64))

        def window(name, fn):
            """Each rank's collective counters and K1/K2/K3 launches over fn()."""
            job.all("reset")
            r0 = job.all("report")
            got = fn()
            r1 = job.all("report")

            def d(rep, rep0, k):
                return rep["collective"][k] - rep0["collective"][k]

            per = []
            for rep, rep0 in zip(r1, r0):
                entries = d(rep, rep0, "entries")
                reduces = d(rep, rep0, "reduces")
                per.append(dict(
                    entries=entries, reduces=reduces,
                    reduces_per_entry=reduces / entries if entries else None,
                    host_copies_per_entry=(d(rep, rep0, "host_copies") / entries
                                           if entries else None),
                    reduce_ms_per_entry=(d(rep, rep0, "reduce_ms") / reduces
                                         if reduces else None),
                    # the plain twins' calls in a CPU rehearsal
                    launches=rep["launches"] if args.device == "cuda" else rep["plain"],
                    spans_p50_ms=rep["spans"],
                    fallbacks=rep["collective"]["fallbacks"]))
                assert not rep["collective"]["fallbacks"], (name, rep["collective"]["fallbacks"])
                if args.device == "cuda":
                    assert not any(rep["plain"].values()), (name, rep["plain"])
            leg.setdefault("windows", {})[name] = per
            return got, per

        # Counts over HTTP at C = 1 and C = 8, round-robin over the ranks
        every = cs.unordered_pairs(rng, n_rows)
        offset = 0
        for c in (1, 8):
            per_client = args.counts if c == 1 else max(1, args.counts // 4)
            n = c * per_client
            sel = every[(offset + np.arange(n)) % len(every)]
            offset += n
            work_q = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                       sel[j * per_client:(j + 1) * per_client]] for j in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                want = dict(zip(map(tuple, sel.tolist()),
                                pool.map(lambda p: want_pair(*p), sel.tolist())))
            (wall_s, clients), per = window(
                f"count_c{c}", lambda: cs.http_clients(ports[:cs.I_RANKS], "big", work_q))
            lat = []
            for j, res in enumerate(clients):
                for (a, b), (dt, results) in zip(sel[j * per_client:(j + 1) * per_client], res):
                    assert results == [want[(int(a), int(b))]], (label, a, b, results)
                    answers[f"Count({a},{b})"] = results[0]
                    lat.append(dt)
            for p in per:  # K1 once per partition (one) per entry
                assert p["launches"]["gather_expr_count"] == p["entries"], (label, c, p)
            leg[f"c{c}"] = dict(queries=n, qps=n / wall_s, p50_ms=cs.pct(lat, 50),
                                p99_ms=cs.pct(lat, 99),
                                barrier_p50_ms=per[0]["spans_p50_ms"]["collective.barrier"],
                                reduce_p50_ms=per[0]["spans_p50_ms"]["collective.reduce"],
                                reduces_per_entry=[p["reduces_per_entry"] for p in per],
                                host_copies_per_entry=[p["host_copies_per_entry"] for p in per],
                                reduce_ms_per_entry=[p["reduce_ms_per_entry"] for p in per])
            print(f"leg {label} C={c}: {n} Counts equal numpy; {leg[f'c{c}']}", flush=True)

        # one collective count_batch of --batch Counts, led by rank 0
        sel = cs.distinct_pairs(rng, n_rows, args.batch)
        qs = [f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in sel]
        with ThreadPoolExecutor(max_workers=8) as pool:
            want = list(pool.map(lambda p: want_pair(*p), sel.tolist()))
        got, per = window("count_batch", lambda: job.ask(0, "count_batch", queries=qs))
        assert got["counts"] == want, label
        answers["count_batch"] = got["counts"]
        for p in per:
            assert p["entries"] == 1 and p["launches"]["gather_expr_count"] == 1, (label, p)
        leg["count_batch"] = dict(q=args.batch, ms=got["ms"],
                                  host_copies_per_entry=[p["host_copies_per_entry"] for p in per],
                                  reduce_ms=[p["reduce_ms_per_entry"] for p in per])
        print(f"leg {label}: count_batch of {args.batch} equal numpy in {got['ms']:.1f} ms; "
              f"{leg['count_batch']}", flush=True)

        # TopN with and without a filter, Sum/Min/Max with and without one
        fa = int(rng.integers(n_rows))
        with ThreadPoolExecutor(max_workers=8) as pool:
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
            inter = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r] & H[fa]).sum(axis=1, dtype=np.int64),
                range(n_rows))))
        fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
        nn, want_vc = bsi["nn"], bsi["want_vc"]

        def others():
            port = ports[0]
            got = cs.query(port, "big", "TopN(f, n=10)")[0]
            assert [(p["id"], p["count"]) for p in got] == cs.replay_topn(cache, cache, 10)
            answers["topn"] = got
            got = cs.query(port, "big", f"TopN(f, Row(f={fa}), n=10)")[0]
            assert [(p["id"], p["count"]) for p in got] == cs.replay_topn(inter, cache, 10)
            answers["topn_filter"] = got
            for kind in ("sum", "min", "max"):
                for flt, mask in (("", nn), (f"Row(f={fa}), ", nn & fbits)):
                    got = cs.query(port, "big", f"{kind.title()}({flt}field=v)")[0]
                    assert (got["value"], got["count"]) == want_vc(kind, mask), (
                        label, kind, flt, got)
                    answers[kind + ("_filter" if flt else "")] = got

        _, per = window("others", others)
        leg["others"] = dict(host_copies_per_entry=[p["host_copies_per_entry"] for p in per],
                             reduces_per_entry=[p["reduces_per_entry"] for p in per],
                             launches=[p["launches"] for p in per])
        print(f"leg {label}: TopN, TopN with Row(f={fa}), Sum/Min/Max with and without it "
              f"equal numpy; {leg['others']}", flush=True)

        # one rank's reduce stalled past the group's timeout
        job.all("reset")
        reps0 = job.all("report")
        pairs = every[:32]
        stall_qs = [(f"Count(Intersect(Row(f={a}), Row(f={b})))", want_pair(int(a), int(b)))
                    for a, b in pairs]
        leg["stall"] = cs.reduce_stall(job, ports[0], 0, cs.I_RANKS - 1, stall_qs, reps0,
                                       args.timeout_ms)
        print(f"leg {label}: " + cs.stall_line(leg["stall"], args.timeout_ms), flush=True)
        job.stop()
    finally:
        job.close()
    return leg, answers


def collective_leg(args) -> int:
    import shutil
    import tempfile

    on_card = args.device == "cuda"
    if on_card and torch.cuda.device_count() < cs.I_RANKS:
        print(f"mesh_cards --leg collective: needs {cs.I_RANKS} CUDA cards", file=sys.stderr)
        return 2
    smi = nvidia_smi_all() if on_card else []
    for line in smi:
        print(line, flush=True)
    if on_card:
        kernels.load()
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    H, bsi = leg_data(rng, args.shards, args.rows)
    depth = 17  # V_MAX's bits
    work = tempfile.mkdtemp(prefix="pilosa-torch-leg-")
    out = {"cards": torch.cuda.device_count() if on_card else 0, "nvidia_smi": smi,
           "shards": args.shards, "rows": args.rows, "timeout_ms": args.timeout_ms,
           "legs": {}}
    try:
        planes = cs.write_planes(H, bsi, depth, work)
        out["data_s"] = time.perf_counter() - t0
        legs = {"a_card_per_rank": None if on_card else "cpu",
                "b_all_on_cuda0": "cuda:0" if on_card else "cpu"}
        answers = {}
        for label, device in legs.items():
            out["legs"][label], answers[label] = run_leg(label, device, H, bsi, planes, work,
                                                         args, args.seed + 1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, b = answers.values()
    assert a == b, [k for k in a if a[k] != b.get(k)]
    if on_card:
        assert out["legs"]["a_card_per_rank"]["reduce_backend"] == ["nccl"] * cs.I_RANKS, out
        assert out["legs"]["b_all_on_cuda0"]["reduce_backend"] == ["gloo"] * cs.I_RANKS, out
    print(f"legs (a) and (b): every answer equal ({len(a)} answers); "
          f"backends {[leg['reduce_backend'][0] for leg in out['legs'].values()]}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    print(json.dumps(out, default=float))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leg", choices=("engine", "collective"), default="engine")
    ap.add_argument("--counts", type=int, default=256,
                    help="collective leg: Counts at C = 1 (a quarter per client at C = 8)")
    ap.add_argument("--timeout-ms", type=int, default=3000,
                    help="collective leg: the barrier and reduce-group timeout (path (i)'s)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.leg == "collective":
        return collective_leg(args)
    on_card = args.device == "cuda"
    if on_card and torch.cuda.device_count() < 2:
        print("mesh_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count() if on_card else 4
    if on_card:
        for line in nvidia_smi_all():
            print(line)
        kernels.load()
    rng = np.random.default_rng(args.seed)
    holder = cs.build_index(pt, rng, args.shards, args.rows, device=args.device)
    H = cs.host_planes(holder, args.shards, args.rows)
    shards = list(range(args.shards))
    pairs = cs.distinct_pairs(rng, args.rows, args.batch)
    calls = [parse(f"Count(Intersect(Row(f={a}), Row(f={b})))").calls[0].children[0]
             for a, b in pairs]
    wants = [cs.np_count(H[a] & H[b]) for a, b in pairs]
    first = "cuda:0" if on_card else "cpu"
    meshes = {"1 on cuda:0": [first],
              f"{n_cards}, one per card": (engine_mesh(n_cards, "cuda") if on_card
                                           else ["cpu"] * n_cards),
              f"{n_cards} on cuda:0": [first] * n_cards}
    engines = {name: ShardedQueryEngine(holder, mesh=m) for name, m in meshes.items()}
    out = {"cards": n_cards, "device": args.device, "shards": args.shards,
           "rows": args.rows, "batch": args.batch, "engines": {}}
    plan0 = None
    for name, eng in engines.items():
        t0 = time.perf_counter()
        k0 = kernels.LAUNCHES["gather_expr_count"]
        got = eng.count_batch("big", calls, shards)
        sync(eng.mesh)
        assert got.tolist() == wants, name
        out["engines"][name] = dict(
            mesh=[str(d) for d in eng.mesh], cold_s=time.perf_counter() - t0,
            k1_launches_per_batch=kernels.LAUNCHES["gather_expr_count"] - k0,
            batch_ms=[], k1_ms=[], count_ms=[])
        if on_card:
            assert out["engines"][name]["k1_launches_per_batch"] == len(eng.mesh), name
        plan0 = plan0 or [eng.plan("big", c) for c in calls]
    slots, idxs, _, _ = ShardedQueryEngine._batch_slot_gather(plan0, len(plan0))
    idx_t = torch.from_numpy(np.stack(idxs))
    tape = plan0[0].expr.tape
    single = [calls[i] for i in range(min(64, len(calls)))]
    for _ in range(2):
        for name, eng in engines.items():
            r = out["engines"][name]
            stack = eng._stacked_leaf_tensor("big", list(slots), tuple(shards))
            sync(eng.mesh)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                eng.count_batch_async("big", calls, shards)
            sync(eng.mesh)
            r["batch_ms"].append((time.perf_counter() - t0) / args.reps * 1e3)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                ShardedQueryEngine._k1(stack, idx_t, tape)
            sync(eng.mesh)
            r["k1_ms"].append((time.perf_counter() - t0) / args.reps * 1e3)
            with eng.memos_off():
                for c in single:
                    t0 = time.perf_counter()
                    eng.count("big", c, shards)
                    r["count_ms"].append((time.perf_counter() - t0) * 1e3)
    for name, r in out["engines"].items():
        r["batch_ms"] = min(r["batch_ms"])
        r["k1_ms"] = min(r["k1_ms"])
        r["count_p50_ms"] = statistics.median(r.pop("count_ms"))
        print(f"{name}: count_batch Q={args.batch} equals numpy; K1 launches per batch "
              f"{r['k1_launches_per_batch']}; batch {r['batch_ms']:.3f} ms, K1 alone "
              f"{r['k1_ms']:.3f} ms (best of 2 x {args.reps}, host clock), single Count "
              f"p50 {r['count_p50_ms']:.3f} ms", flush=True)
    if on_card:  # all three engines' tensors together, per card
        out["peak_gib"] = {f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2**30
                           for i in range(n_cards)}
        print(f"peak memory per card (GiB): {out['peak_gib']}")
    for eng in engines.values():
        eng.close()
    holder.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
