#!/usr/bin/env python3
"""Time K1 at the BSI count_batch shape and at the serving shape.

    python3 tools/k1_bsi_batch.py [--root DIR] [--reps 20]

Run on a machine with one CUDA card. It builds the kernels of the
pilosa_tpu_torch package under DIR (default: this checkout; another
checkout, such as a parent commit unpacked beside it, builds into its own
_build directory), checks K1 against its plain twin, and prints one JSON
line with the profiler's device time per launch of

- the staged and the streaming variant at chip_smoke.py's BSI
  count_batch shape: 64 queries Count(Intersect(Row(f=r), Range(v >
  61234))), a depth-17 compare shared by all, S=256, W=32768, 82 distinct
  slots;
- the staged variant at the serving shape: 256 distinct 2-leaf Counts
  over 128 rows, S=256, W=32768;

with each shape's bytes bound and, where DIR's K1 hoists, the number of
hoist programs of the BSI launch. Compare two checkouts only within one
machine call, in turns (parent, change, change, parent). Imports nothing
of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

PEAK_HBM_BYTES_S = 3.35e12


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean profiler device time (ms) per launch of the kernels whose name
    contains `kernel`, over `reps` calls of fn() after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total", None) or ev.cuda_time_total
            count += ev.count
    if not count:
        raise RuntimeError(f"the profiler recorded no {kernel} launch")
    return total_us / count / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_bsi_batch: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel.engine import lower_tape

    assert kernels.__file__.startswith(root), kernels.__file__
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build_s = kernels.build(force=True)
    lib = kernels.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def planes(shape):
        return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    s, w, depth, q = 256, 32768, 17, 64
    plane_bytes = s * w * 4
    leaf = ("leaf", depth + 1)
    tape = lower_tape(("Intersect", (leaf, ("cmp", "gt", tuple(range(depth + 1)), depth, 61234))))
    batch = planes((depth + 1 + q, s, w))
    idxs = torch.cat([torch.arange(depth + 1, dtype=torch.int32)[:, None].expand(-1, q),
                      depth + 1 + torch.arange(q, dtype=torch.int32)[None]]).contiguous()
    want = kernels.gather_expr_count_plain(batch, idxs, tape)
    out = {"nvidia_smi": smi, "root": root, "build_s": build_s}
    staging = kernels._K1Staging(idxs, list(tape), "staged")
    out["bsi_hoist_programs"] = getattr(staging, "n_hoist", 0)
    out["bsi_ring_stages"] = staging.stages
    buf = torch.from_numpy(staging.host).to(dev)
    counts = torch.zeros(q, dtype=torch.int64, device=dev)

    def staged():
        counts.zero_()
        err = staging.launch(lib, batch, buf, counts)
        if err:
            raise RuntimeError(f"K1 staged launch failed: cudaError {err}")

    staged()
    torch.cuda.synchronize()
    assert torch.equal(counts, want), "staged"
    out["bsi_staged_ms"] = device_ms(staged, "k1_staged_kernel", args.reps)
    got = kernels.gather_expr_count(batch, idxs, tape, variant="streaming")
    torch.cuda.synchronize()
    assert torch.equal(got, want), "streaming"
    out["bsi_streaming_ms"] = device_ms(
        lambda: kernels.gather_expr_count(batch, idxs, tape, variant="streaming"),
        "k1_streaming_kernel", args.reps)
    bsi_bytes = batch.shape[0] * plane_bytes + idxs.numel() * 4 + q * 8
    out["bsi_bound_ms"] = bsi_bytes / PEAK_HBM_BYTES_S * 1e3
    del batch
    torch.cuda.empty_cache()

    u, qs = 128, 256
    stacked = planes((u, s, w))
    rng = np.random.default_rng(args.seed)
    a, b = np.divmod(rng.permutation(u * (u - 1))[:qs], u - 1)
    pairs = np.stack([a, (a + 1 + b) % u]).astype(np.int32)
    sidx = torch.from_numpy(pairs)
    stape = lower_tape(("Intersect", (("leaf", 0), ("leaf", 1))))
    got = kernels.gather_expr_count(stacked, sidx, stape, variant="staged")
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gather_expr_count_plain(stacked, sidx, stape))
    out["serving_staged_ms"] = device_ms(
        lambda: kernels.gather_expr_count(stacked, sidx, stape, variant="staged"),
        "k1_staged_kernel", args.reps)
    distinct = int(torch.unique(sidx).numel())
    out["serving_bound_ms"] = (distinct * plane_bytes + sidx.numel() * 4 + qs * 8) \
        / PEAK_HBM_BYTES_S * 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
