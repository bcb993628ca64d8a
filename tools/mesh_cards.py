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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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
