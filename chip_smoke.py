#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pilosa_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 11] [--shards 256] [--rows 128]

Run from the root of a checkout on a machine with one CUDA card (written
for an H100, sm_90a). It imports nothing of JAX and nothing of pilosa_tpu.
Phases, each of which fails the run if it fails:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds K1, K2 and K3 from pilosa_tpu_torch/csrc.
3. kernels — each kernel against its plain PyTorch twin on the same CUDA
             tensors, exact equality. K1: both variants (staged and
             streaming) and k1_plan's choice, at small shapes (2 leaves,
             3 leaves with Difference, a deep k-ary nest, ragged S, a
             ragged tail, Q=5000), on trees past the old tape limits
             (a 300-leaf Union, a chain 40 deep, a Difference with
             50 tails, a 40-row tree), on BSI compares (every kind,
             leading zeros, both strict last steps, depths 1, 17 and 40,
             alone at Q=1 and nested at Q=9), at engine.count's Q=1 over
             S=256, W=32768 (2 leaves, the nest, a 40-row Union, a
             depth-17 Count(Range(v > x))), at the serving shape
             (U=128, S=256, W=32768, L=2, Q=256) and at path (e)'s
             count_batch shape (64 Count(Intersect(Row, Range(v > x))),
             82 distinct slots, staged). K2 at R=128 and R=1,
             S=256, with and without a mask, and on an 18-plane BSI Sum
             stack. K3 (bsi_minmax): min and max, with and without a
             filter, at depth 17 over S=256, W=32768, on ragged tails,
             depths 0 and 40, and an empty filter. Kernel times from
             torch.profiler's device time (CUDA events where it shows
             none): K1 staged and streaming at the serving shape,
             streaming at Q=1 on 2 leaves and on the depth-17 compare,
             both at path (e)'s count_batch shape, K2
             at the TopN chunk and on the Sum stack, K3 (both launches).
             Bytes moved, and bounds (K1's counts the distinct slots a
             batch names, each read once).
4. main    — the bench_big serving shape through the port's entry
             points: index "big", field "f", 256 shards x 128 rows of
             random ~50%-density planes made from --seed and injected as
             dense containers (4 GiB on the host). (a) Executor.execute
             Count(Intersect) for several pairs plus a Union/Difference/
             Xor nest and a 40-row Union, (b) engine.count_batch over 256
             distinct pairs, then timed batches, (c) TopN(f, n=10) and
             TopN(f, Row(f=a), n=10), (d) a Set on one shard and a
             recount (the stale leaf and the batch's stack are refreshed
             by a delta scatter: full_refresh_bytes does not move), (e) on the same
             index an int field v (min 0, max 100000, 17 bits, values on
             about half the columns) and a YMD time field t (2 rows, 30
             day views of January 2018 plus month, year and standard
             views): Sum/Min/Max with and without Row(f=a), Count(Range(v
             > x)), Count(Intersect(Row(f=a), Range(v < x))), Count(Range(t
             = r, 10 day views)), a count_batch of 64 Range trees,
             Range(v >< [lo, hi]) and Range(v == x) as Rows, TopN(f,
             Range(v > x), n=10), then a SetValue and a timestamped Set,
             each followed by a recount, and warm repeats with one warm
             Max's host stages. (f) the engine layers around the kernels:
             (f1) the result and aux memos — (a)'s Counts, the 256-query
             count_batch, Sum/Max with and without Row(f=a) and a filtered
             TopN repeated launch no kernel, and one memo-hit Count is
             timed; (f2) delta refresh — a Set on one shard and a SetValue,
             the batch's stack refreshed by a scatter into a clone (device
             time, host time and peak memory beside a full regather of the
             same leaf set by a second engine, and torch.equal to it), then
             the Count, the batch, Sum and Max recounted; (f3) tiering — an
             Executor whose leaf cache holds 8 planes sweeps 32 rows,
             demoting 24 into a 48-plane host tier, a first Count over two
             demoted rows is answered on the host from the compressed bytes
             and its repeat promotes them and launches K1; (f4) the fault
             ladder on an Executor of its own — device-dispatch=1*error
             under a Count and under a filtered TopN (answered by the host
             rung, K1/K2 not launched), device-dispatch=1*oom under a
             count_batch (backpressure, one retry, K1 launched), a
             planted K1 launch error raising DeviceKernelFault out of
             Executor.execute (no host rung on the card), a real CUDA OOM
             classified `oom`, and a forced nvcc failure in a fresh
             process raising out of Executor.execute. Memo-hit times sit
             beside the kernel-path times: the warm loops of (a), (c) and
             (e) run inside engine.memos_off(). (g) one node over HTTP:
             (g1) an in-process Server on the card handed the same
             holder; (g2) 512 distinct Count(Intersect(Row, Row)) per
             client from C = 1, 8 and 32 keep-alive clients (a process
             of their own), memos off, at the scheduler's defaults:
             queries/s, p50/p99, the micro-batcher's groups, K1 launches
             by variant, stack misses, the device idle share (1 - the
             profiler's device time / wall time), the p50 of each stage
             in the server's trace recorder; at C >= 8 the batcher
             coalesces and K1 launches fewer times than there are
             queries; then 512 Counts at C = 8 under cProfile (the
             server's top functions by own host time); (g3) one client's 64 Counts over HTTP beside
             Executor.execute; (g4) TopN with and without a filter,
             Sum/Min/Max of v with a filter, and 8 concurrent keyed Rows
             coalesced into bitmap_batch (equal to per-call bitmaps);
             (g5) a keyed index of 64 row keys and 1,048,576 column keys
             imported over HTTP, a Count per row key, TopN with keys and
             one Row's column keys against a dict; (g6) `python -m
             pilosa_tpu_torch.cli server` in a subprocess on the card:
             the getting-started flow, /schema, /status, /debug/vars,
             SIGTERM, a relaunch on the same directory (counts and key
             ids kept) and a /debug/profile trace. Every answer is
             checked against numpy on the fragments' host planes (TopN
             against a numpy replay of the two-phase ranking).
5. kernel line — launch counters set to 0 just before each path of
             phase 4 and read just after it: K1 above 0 in (a), (b), (d)
             and the Range Counts of (e) — its streaming variant only in
             the single Counts, its staged variant in the batches — K2
             above 0 in the filtered TopNs and in Sum, K3 above 0 in
             Min/Max, none of the three in the memo hits of (f1), the
             plain twins at 0 in every path and the compile gate's
             refusals at 0 (in (g): K1 above 0 in every Count level and
             in (g5), K2 in (g4)'s TopNs, K3 in its Min/Max); outside
             (f4) the fault-ladder and host
             counters (host_counts, host_topn, device_dispatch_errors,
             oom_*, watchdog_timeouts, kernel_faults; host_cold_counts
             outside (f3)) are
             0 after every path. The line carries the launch sums.

It prints the nvidia-smi line and a {"kernels": [...]} JSON line before
the last line, and as its last line {"ok": true, "device": {...}}. With
--out PATH it also writes every measurement as JSON. With no CUDA device,
or without the
pilosa_tpu_torch package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet peaks.
PEAK_HBM_BYTES_S = 3.35e12
# 32-bit operations: the data sheet gives no int32 rate; its float32
# non-tensor rate is the closest peak for 32-bit ALU work.
PEAK_OPS_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(torch, fn, reps: int, warm: int = 1, inner: int = 1) -> float:
    """Median milliseconds per call of fn() on the current stream (CUDA
    events around `inner` back-to-back calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_total_ms(torch, fn):
    """(fn()'s value, host ms of the call, device ms, method): the self
    device time of every kernel and copy torch.profiler recorded during
    the call ("profiler"), or, where it recorded none, CUDA events around
    the call ("events", host gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        val = fn()
        b.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev_us = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages())
    if dev_us:
        return val, host_ms, dev_us / 1e3, "profiler"
    return val, host_ms, a.elapsed_time(b), "events"


# Counters of the device-fault ladder and the host rungs: 0 after every
# path that injects no fault.
LADDER = ("host_counts", "host_topn", "host_cold_counts", "device_dispatch_errors",
          "oom_backpressure", "oom_retries", "oom_batch_splits", "watchdog_timeouts",
          "kernel_faults")


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3


def device_ms(torch, fn, kernel: str, reps: int = 10, per_call: bool = False):
    """Mean device time (ms) per launch of the CUDA kernels whose name
    contains `kernel` (per call of fn() with per_call, for wrappers that
    launch more than one kernel), from torch.profiler over `reps` calls of
    fn(); None when the profiler recorded no such kernel."""
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
    return total_us / (reps if per_call else count) / 1e3 if count else None


def kernel_ms(torch, fn, kernel: str, reps: int = 10, per_call: bool = False):
    """(ms, method): the profiler's device time of the kernel, or, where
    the profiler shows none, CUDA events around bursts of 5 calls."""
    ms = device_ms(torch, fn, kernel, reps, per_call)
    if ms is not None:
        return ms, "profiler"
    return cuda_time_ms(torch, fn, reps, inner=5), "events"


def leaf(i):
    return ("leaf", i)


def chain(depth: int):
    """Every set-op kind, nested `depth` deep, one new leaf per level."""
    node = leaf(0)
    kinds = ("Intersect", "Union", "Xor", "Difference")
    for i in range(1, depth + 1):
        kind = kinds[i % 4]
        if kind == "Difference":
            node = (("Difference", node, (leaf(i),)) if i % 8 else
                    ("Difference", leaf(i), (node,)))
        else:
            node = (kind, (leaf(i), node) if i % 3 else (node, leaf(i)))
    return node


# Trees past the old tape limits (more than 64 tape ops, 8 deep, or 32
# distinct rows): (IR, leaf positions).
BIG_TREES = {
    "300-leaf Union": (("Union", tuple(leaf(i) for i in range(300))), 300),
    "chain 40 deep": (chain(40), 41),
    "Difference with 50 tails": (
        ("Difference", leaf(0), tuple(
            leaf(i) if i % 5 else ("Intersect", (leaf(i), leaf(i - 1)))
            for i in range(1, 51))), 51),
    "40-row Xor of Intersects and Unions": (
        ("Xor", tuple((("Intersect" if g % 2 else "Union"),
                       tuple(leaf(5 * g + k) for k in range(5))) for g in range(8))), 40),
}


def bsi_ir(op, depth, *pred):
    """A compare over BSI planes 0..depth (plane depth is not-null)."""
    idxs = tuple(range(depth + 1))
    if op == "between":
        return ("between", idxs, depth, *pred)
    return ("cmp", op, idxs, depth, pred[0])


# K1's BSI codes: (op, depth, predicate...). Leading zeros (lt 5, lt 4),
# a strict last step on a 1 bit and on a 0 bit (gt 65536, gt 6; lt 5,
# lt 4), every compare kind, depth 1, and a 40-bit field.
BSI_CASES = [
    ("lt", 17, 5), ("lt", 17, 4), ("lte", 17, 100000), ("gt", 17, 65536), ("gt", 17, 6),
    ("gte", 17, 0), ("eq", 17, 12345), ("neq", 17, 12345), ("between", 17, 1000, 90000),
    ("lt", 1, 1), ("gt", 1, 0), ("between", 1, 0, 1), ("eq", 1, 1),
    ("lt", 40, (1 << 39) + 3), ("gt", 40, 123456789), ("between", 40, 77, (1 << 38) - 1),
]


def check_kernels(torch, kernels, engine_mod, rng, brng, report, u, s, q,
                  dev="cuda"):
    """Each kernel against its twin on the card; returns per-kernel rows.
    (u, s, q) is the main path's batch shape: leaf rows, shards, queries.
    The BSI cases draw from brng, so rng's draws (the serving batch, then
    the main path's index) do not depend on them."""
    from pilosa_tpu_torch.constants import WORDS_PER_ROW

    dev = torch.device(dev)
    P = engine_mod.lower_tape
    maxerr = {"gather_expr_count": 0, "masked_plane_counts": 0, "bsi_minmax": 0}

    def rand_planes(shape, gen=rng):
        g = torch.Generator(device=dev)
        g.manual_seed(int(gen.integers(1 << 31)))
        return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def k1_hold(name, stacked, idxs, tape, want=None):
        """Both variants (the staged one where its ring holds the slots)
        and k1_plan's choice against the twin, exactly. Returns the
        variants that ran and k1_plan's."""
        if want is None:
            want = kernels.gather_expr_count_plain(stacked, idxs, tape)
        distinct = max(len(r) for r in kernels.k1_tiles(idxs.numpy())[0])
        ran = [v for v in kernels.K1_VARIANTS
               if v == "streaming" or kernels.k1_ring_stages(distinct) >= 2]
        before = dict(kernels.LAUNCHES)
        for variant in ran + [None]:
            got = kernels.gather_expr_count(stacked, idxs, tape, variant=variant)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            maxerr["gather_expr_count"] = max(maxerr["gather_expr_count"], err)
            if err:
                raise AssertionError(f"K1 {name} ({variant or 'k1_plan'}): kernel != twin "
                                     f"(max err {err})")
        chosen = kernels.k1_plan(distinct, idxs.shape[1])[0]
        for v in kernels.K1_VARIANTS:
            n = kernels.LAUNCHES[f"gather_expr_count_{v}"] - before[f"gather_expr_count_{v}"]
            assert n == (v in ran) + (v == chosen), (name, v, n)
        return ran, chosen

    def k1_case(name, u, s, w, ir, q, distinct=False):
        stacked = rand_planes((u, s, w))
        tape = P(ir)
        n_leaves = max(c >> 8 for c in tape if c & 0xFF == 0 or c & kernels.OP_ACC) + 1
        if distinct:  # one query over slots 0..L-1, as engine.count gives it
            idxs = torch.arange(n_leaves, dtype=torch.int32).reshape(n_leaves, 1)
        else:
            idxs = torch.from_numpy(
                rng.integers(0, u, size=(n_leaves, q)).astype(np.int32))
        ran, chosen = k1_hold(name, stacked, idxs, tape)
        log(f"K1 {name}: U={u} S={s} W={w} L={n_leaves} Q={q} tape={len(tape)} ops "
            f"depth {kernels.tape_depth(tape)}: exact ({', '.join(ran)}; k1_plan {chosen})")

    nest = ("Xor", (("Intersect", (("Union", (leaf(0), leaf(1))), leaf(2),
                                   ("Difference", leaf(3), (leaf(4), leaf(5))))),
                    ("Union", (leaf(6), ("Intersect", (leaf(7), leaf(8))))),
                    leaf(9)))
    k1_case("2 leaves", 8, 4, 256, ("Intersect", (leaf(0), leaf(1))), 16)
    k1_case("3 leaves Difference", 8, 4, 512,
            ("Difference", leaf(0), (leaf(1), leaf(2))), 16)
    k1_case("deep k-ary nest", 16, 3, 1024, nest, 12)
    k1_case("ragged S", 6, 5, 32768, ("Union", (leaf(0), leaf(1), leaf(2))), 7)
    k1_case("ragged tail", 7, 3, 1028, ("Difference", leaf(0), (leaf(1), leaf(2))), 9)
    k1_case("Q=5000", 64, 2, 1024, ("Intersect", (leaf(0), ("Union", (leaf(1), leaf(2))))),
            5000)
    for name, (ir, _) in BIG_TREES.items():
        k1_case(name, 48, 3, 512, ir, 4)
    # BSI compares, alone at Q=1 (engine.count's shape) and nested under
    # an Intersect in a batch of 9 queries (both variants).
    for case in BSI_CASES:
        op, depth, *pred = case
        n = depth + 1
        stacked = rand_planes((n + 6, 3, 1028), brng)
        tape = P(("Intersect", (leaf(n), bsi_ir(op, depth, *pred))))
        k1_hold(f"BSI {case} Q=1", stacked, torch.arange(n + 1, dtype=torch.int32)
                .reshape(-1, 1), tape)
        k1_hold(f"BSI {case}", stacked, torch.from_numpy(
            brng.integers(0, n + 6, (n + 1, 9)).astype(np.int32)), tape)
    log(f"K1 BSI codes: {len(BSI_CASES)} compares (every kind, leading zeros, strict last "
        f"steps, depths 1, 17, 40), alone at Q=1 and nested at Q=9: exact (staged and "
        f"streaming)")
    # engine.count's shapes on the main path: Q=1 over the full S, W.
    k1_case("single Count, 2 leaves", 2, s, WORDS_PER_ROW,
            ("Intersect", (leaf(0), leaf(1))), 1, distinct=True)
    k1_case("single Count, nest", 10, s, WORDS_PER_ROW, nest, 1, distinct=True)
    k1_case("single Count, 40-row Union", 40, s, WORDS_PER_ROW,
            ("Union", tuple(leaf(i) for i in range(40))), 1, distinct=True)

    # Serving shape (bench_big): U=128, S=256, W=32768, L=2, Q=256.
    w = WORDS_PER_ROW
    stacked = rand_planes((u, s, w))
    pairs = distinct_pairs(rng, u, q)
    idxs = torch.from_numpy(np.ascontiguousarray(pairs.T.astype(np.int32)))
    tape = P(("Intersect", (leaf(0), leaf(1))))
    want = kernels.gather_expr_count_plain(stacked, idxs, tape)
    ran, chosen = k1_hold("serving shape", stacked, idxs, tape, want)
    assert chosen == "staged" and "staged" in ran, (ran, chosen)
    k1_unique = int(torch.unique(idxs).numel())
    k1_stages = kernels.k1_ring_stages(k1_unique)
    timed = {}
    for variant in kernels.K1_VARIANTS:
        timed[variant] = kernel_ms(
            torch, lambda v=variant: kernels.gather_expr_count(stacked, idxs, tape, variant=v),
            f"k1_{variant}_kernel")
    k1_ms, k1_method = timed["staged"]
    # Also by CUDA events around one call, median of 10 (the wrapper's
    # host work before the launch included), the way earlier commits'
    # chip_smoke.py timed K1, for comparison with their runs.
    k1_events_ms = cuda_time_ms(torch, lambda: kernels.gather_expr_count(stacked, idxs, tape), 10)
    k1_plain_ms = cuda_time_ms(
        torch, lambda: kernels.gather_expr_count_plain(stacked, idxs, tape), 1, warm=0)
    # The least the function must move: each DISTINCT slot the batch names
    # read once, the slot ids read once, the (Q,) int64 sums written once.
    k1_bytes = k1_unique * s * w * 4 + idxs.numel() * 4 + q * 8
    k1_ops = q * s * w * 3  # AND, popc, add per word
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k1_operand_bytes = q * 2 * s * w * 4  # every query's two planes

    # engine.count's single Count (Q=1, 2 leaves) on the streaming variant.
    one = torch.tensor([[int(pairs[0, 0])], [int(pairs[0, 1])]], dtype=torch.int32)
    ran1, chosen1 = k1_hold("single Count at the serving planes", stacked, one, tape)
    assert chosen1 == "streaming", chosen1
    k1q1_ms, k1q1_method = kernel_ms(
        torch, lambda: kernels.gather_expr_count(stacked, one, tape), "k1_streaming_kernel", 50)
    k1q1_bytes = 2 * s * w * 4 + 2 * 4 + 8
    k1q1_bound, k1q1_by = bound(k1q1_bytes, s * w * 3)

    # Copy bandwidth of the same byte count, same script (the bound a
    # plain device copy reaches on this card).
    n_copy = min(k1_bytes // 2, 8 << 30) // 4
    src = torch.empty(n_copy, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_time_ms(torch, lambda: dst.copy_(src), 10)
    copy_bw = 2 * n_copy * 4 / (copy_ms * 1e-3)
    del src, dst
    log(f"K1 serving shape U={u} S={s} W={w} L=2 Q={q}: exact ({', '.join(ran)}; k1_plan "
        f"{chosen}, {k1_stages} ring stages); {k1_unique} distinct slots, "
        f"{k1_bytes / 1e9:.3f} GB needed, bound {k1_bound:.4f} ms at the 3.35 TB/s data "
        f"sheet, {k1_bytes / copy_bw * 1e3:.4f} ms at the measured copy rate "
        f"{copy_bw / 1e9:.1f} GB/s; twin {k1_plain_ms:.2f} ms; k1_plan's choice "
        f"{k1_events_ms:.4f} ms per call by CUDA events around one call")
    for variant, (ms, method) in timed.items():
        log(f"K1 {variant} at the serving shape: {ms:.4f} ms ({method}), "
            f"{k1_bound / ms:.3f} of the bound, {k1_bytes / (ms * 1e-3) / 1e9:.1f} GB/s of "
            f"distinct slots, {k1_operand_bytes / (ms * 1e-3) / 1e9:.1f} GB/s of operands")
    log(f"K1 streaming at Q=1 (engine.count, 2 leaves, S={s} W={w}): {k1q1_ms:.4f} ms "
        f"({k1q1_method}); bound {k1q1_bound:.4f} ms ({k1q1_bytes / 1e6:.1f} MB)")

    # K2 over the whole candidate stack (R=128, S=256 by default), with and
    # without a mask, and at the main path's TopN chunk (R=64 at 256
    # shards, executor._topn_chunk) with a mask.
    mask = rand_planes((s, w))
    k2 = {}
    r_chunk = min(u, max(1, (2 << 30) // (s * w * 4)))  # executor._topn_chunk
    for label, r_rows, m in (("mask", u, mask), ("no mask", u, None),
                             ("mask R=chunk", r_chunk, mask)):
        rows = stacked[:r_rows]
        u = r_rows
        got = kernels.masked_plane_counts(rows, m)
        want = kernels.masked_plane_counts_plain(rows, m)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        maxerr["masked_plane_counts"] = max(maxerr["masked_plane_counts"], err)
        if err:
            raise AssertionError(f"K2 {label}: kernel != twin (max err {err})")
        ms, method = kernel_ms(torch, lambda: kernels.masked_plane_counts(rows, m),
                               "masked_plane_counts_kernel")
        plain_ms = cuda_time_ms(
            torch, lambda: kernels.masked_plane_counts_plain(rows, m), 1, warm=0)
        nbytes = (u * s * w + (s * w if m is not None else 0)) * 4 + u * s * 4
        ops = u * s * w * (3 if m is not None else 2)
        b_ms, b_by = bound(nbytes, ops)
        k2[label] = dict(ms=ms, method=method, plain_ms=plain_ms, bytes=nbytes, bound_ms=b_ms,
                         bound_by=b_by, bound_copy_ms=nbytes / copy_bw * 1e3)
        log(f"K2 {label} R={u} S={s} W={w}: exact; kernel {ms:.4f} ms ({method}), twin "
            f"{plain_ms:.2f} ms, {nbytes / 1e9:.3f} GB -> {nbytes / (ms * 1e-3) / 1e9:.1f} "
            f"GB/s; bound {b_ms:.4f} ms (data sheet), {nbytes / copy_bw * 1e3:.4f} ms "
            f"(measured copy)")
    # Small and ragged K2 shapes too, and R=1 at the full S, W (the src
    # counts of a filtered TopN and Row.count).
    for r_, s_, w_ in ((1, s, w), (1, 1, 32768), (3, 5, 256), (33, 2, 1024)):
        st = rand_planes((r_, s_, w_))
        mk = rand_planes((s_, w_))
        for m in (mk, None):
            got = kernels.masked_plane_counts(st, m)
            want = kernels.masked_plane_counts_plain(st, m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 R={r_} S={s_} W={w_}: kernel != twin")
    log("K2 small/ragged shapes: exact")
    del stacked, rows
    torch.cuda.empty_cache()

    # The BSI path's shapes: a depth-17 field (min 0, max 100000) over the
    # full S, W: 18 planes, plane 17 the not-null row.
    depth = 17
    bsi = rand_planes((depth + 1, s, w), brng)
    plane_bytes = s * w * 4
    # K1: Count(Range(v > 50000)) at Q=1 (engine.count), 18 slots.
    gt_tape = P(bsi_ir("gt", depth, 50000))
    one18 = torch.arange(depth + 1, dtype=torch.int32).reshape(-1, 1)
    k1_hold("BSI Count(Range(v > 50000)) at full width", bsi, one18, gt_tape)
    k1b_ms, k1b_method = kernel_ms(
        torch, lambda: kernels.gather_expr_count(bsi, one18, gt_tape), "k1_streaming_kernel", 20)
    k1b_plain_ms = cuda_time_ms(
        torch, lambda: kernels.gather_expr_count_plain(bsi, one18, gt_tape), 1, warm=0)
    k1b_bytes = (depth + 1) * plane_bytes + (depth + 1) * 4 + 8
    k1b_bound, k1b_by = bound(k1b_bytes, s * w * (3 * depth + 2))
    log(f"K1 BSI Count(Range(v > 50000)), depth {depth}, Q=1, S={s} W={w}: exact; "
        f"{k1b_ms:.4f} ms ({k1b_method}), bound {k1b_bound:.4f} ms ({k1b_by}, "
        f"{k1b_bytes / 1e6:.1f} MB), {k1b_bound / k1b_ms:.3f} of it; twin {k1b_plain_ms:.2f} ms")
    # K1 at path (e)'s count_batch shape: 64 queries
    # Count(Intersect(Row(f=r), Range(v > x))), 19 leaf positions, 18 BSI
    # planes shared by all and one row each: 82 distinct slots, staged.
    n_bq = 64
    batch = rand_planes((depth + 1 + n_bq, s, w), brng)
    bq_tape = P(("Intersect", (leaf(depth + 1), bsi_ir("gt", depth, 61234))))
    bq_idxs = torch.cat([torch.arange(depth + 1, dtype=torch.int32)[:, None].expand(-1, n_bq),
                         depth + 1 + torch.arange(n_bq, dtype=torch.int32)[None]]).contiguous()
    ran, chosen = k1_hold("BSI count_batch shape at full width", batch, bq_idxs, bq_tape)
    assert chosen == "staged", chosen
    k1bq = {v: kernel_ms(torch, lambda v=v: kernels.gather_expr_count(
        batch, bq_idxs, bq_tape, variant=v), f"k1_{v}_kernel") for v in kernels.K1_VARIANTS}
    k1bq_ms, k1bq_method = k1bq["staged"]
    k1bq_plain_ms = cuda_time_ms(
        torch, lambda: kernels.gather_expr_count_plain(batch, bq_idxs, bq_tape), 1, warm=0)
    k1bq_bytes = batch.shape[0] * plane_bytes + bq_idxs.numel() * 4 + n_bq * 8
    k1bq_bound, k1bq_by = bound(k1bq_bytes, n_bq * s * w * (3 * depth + 5))
    log(f"K1 BSI count_batch shape (Q={n_bq}, L={depth + 2}, {batch.shape[0]} distinct slots, "
        f"S={s} W={w}): exact ({', '.join(ran)}; k1_plan {chosen}); staged {k1bq_ms:.4f} ms "
        f"({k1bq_method}), streaming {k1bq['streaming'][0]:.4f} ms; bound {k1bq_bound:.4f} ms "
        f"({k1bq_by}, {k1bq_bytes / 1e9:.3f} GB), staged at {k1bq_bound / k1bq_ms:.3f} of it; "
        f"twin {k1bq_plain_ms:.2f} ms")
    del batch
    # K2: Sum(Row(f=a), field=v) = per-plane counts of the stack, masked.
    k2s_ms, k2s_method = kernel_ms(
        torch, lambda: kernels.masked_plane_counts(bsi, mask), "masked_plane_counts_kernel", 20)
    got = kernels.masked_plane_counts(bsi, mask)
    want = kernels.masked_plane_counts_plain(bsi, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 BSI Sum stack: kernel != twin")
    k2s_bytes = (depth + 2) * plane_bytes + (depth + 1) * s * 4
    k2s_bound, k2s_by = bound(k2s_bytes, (depth + 1) * s * w * 3)
    log(f"K2 BSI Sum (R={depth + 1} planes, masked) S={s} W={w}: exact; {k2s_ms:.4f} ms "
        f"({k2s_method}), bound {k2s_bound:.4f} ms ({k2s_by}, {k2s_bytes / 1e6:.1f} MB), "
        f"{k2s_bound / k2s_ms:.3f} of it")
    # K3: Min and Max, with and without the filter, against the twin.
    for maximize in (True, False):
        for m in (mask, None):
            bits, cnt = kernels.bsi_minmax(bsi, m, maximize)
            wbits, wcnt = kernels.bsi_minmax_plain(bsi, m, maximize)
            torch.cuda.synchronize()
            err = max(int((bits - wbits).abs().max()), abs(int(cnt) - int(wcnt)))
            maxerr["bsi_minmax"] = max(maxerr["bsi_minmax"], err)
            if err:
                raise AssertionError(f"K3 max={maximize} mask={m is not None}: kernel != twin")
    k3_ms, k3_method = kernel_ms(
        torch, lambda: kernels.bsi_minmax(bsi, mask, True), "bsi_minmax", 20, per_call=True)
    k3_plain_ms = cuda_time_ms(
        torch, lambda: kernels.bsi_minmax_plain(bsi, mask, True), 1, warm=0)
    k3_bytes = (depth + 2) * plane_bytes + depth * 4 + 8
    k3_bound, k3_by = bound(k3_bytes, s * w * 3 * depth)
    log(f"K3 bsi_minmax at full width (depth {depth}, masked, S={s} W={w}): min and max, with "
        f"and without the mask, exact; {k3_ms:.4f} ms ({k3_method}, both launches), bound "
        f"{k3_bound:.4f} ms ({k3_by}, {k3_bytes / 1e6:.1f} MB), {k3_bound / k3_ms:.3f} of it; "
        f"twin {k3_plain_ms:.2f} ms")
    del bsi, mask
    torch.cuda.empty_cache()
    # Small and ragged K3 shapes (S*W not a multiple of a block's 4096
    # words), depth 0 and 40, and an empty filter.
    for shape, masked in (((18, 5, 1028), True), ((1, 2, 36), True), ((41, 3, 32768), True),
                          ((6, 1, 4), False), ((18, 256, 4096), False)):
        pl = rand_planes(shape, brng)
        mk = rand_planes(shape[1:], brng) if masked else None
        for maximize in (True, False):
            got = kernels.bsi_minmax(pl, mk, maximize)
            want = kernels.bsi_minmax_plain(pl, mk, maximize)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
                raise AssertionError(f"K3 {shape} mask={masked} max={maximize}: kernel != twin")
    full = torch.full((9, 4, 1024), -1, dtype=torch.int32, device=dev)
    for maximize in (True, False):
        bits, cnt = kernels.bsi_minmax(full, torch.zeros_like(full[0]), maximize)
        torch.cuda.synchronize()
        assert bits.tolist() == [int(not maximize)] * 8 and int(cnt) == 0, (maximize, bits, cnt)
    log("K3 small/ragged shapes and an empty filter: exact")
    log("library yardstick: no single PyTorch call computes any of the three functions "
        "(torch has no popcount), so library_ms is null")
    report["kernel_phase"] = {
        "k1_serving": dict(ms=k1_ms, method=k1_method, plain_ms=k1_plain_ms,
                           bytes=k1_bytes, distinct_slots=k1_unique, ring_stages=k1_stages,
                           operand_bytes=k1_operand_bytes, bound_ms=k1_bound,
                           bound_by=k1_by, bound_copy_ms=k1_bytes / copy_bw * 1e3,
                           streaming_ms=timed["streaming"][0], events_ms=k1_events_ms),
        "k1_single": dict(ms=k1q1_ms, method=k1q1_method, bytes=k1q1_bytes,
                          bound_ms=k1q1_bound, bound_by=k1q1_by),
        "k2": k2, "copy_gbs": copy_bw / 1e9, "max_abs_err": maxerr,
        "k1_bsi_single": dict(ms=k1b_ms, method=k1b_method, plain_ms=k1b_plain_ms,
                              bytes=k1b_bytes, bound_ms=k1b_bound, bound_by=k1b_by),
        "k1_bsi_batch": dict(ms=k1bq_ms, method=k1bq_method, plain_ms=k1bq_plain_ms,
                             streaming_ms=k1bq["streaming"][0],
                             bytes=k1bq_bytes, bound_ms=k1bq_bound, bound_by=k1bq_by),
        "k2_bsi_sum": dict(ms=k2s_ms, method=k2s_method, bytes=k2s_bytes,
                           bound_ms=k2s_bound, bound_by=k2s_by),
        "k3": dict(ms=k3_ms, method=k3_method, plain_ms=k3_plain_ms, bytes=k3_bytes,
                   bound_ms=k3_bound, bound_by=k3_by),
    }
    return {
        "gather_expr_count": dict(ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
                                  bound_by=k1_by, max_abs_err=maxerr["gather_expr_count"]),
        "masked_plane_counts": dict(ms=k2["mask R=chunk"]["ms"],
                                    plain_ms=k2["mask R=chunk"]["plain_ms"],
                                    bound_ms=k2["mask R=chunk"]["bound_ms"],
                                    bound_by=k2["mask R=chunk"]["bound_by"],
                                    max_abs_err=maxerr["masked_plane_counts"]),
        "bsi_minmax": dict(ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
                           bound_by=k3_by, max_abs_err=maxerr["bsi_minmax"]),
    }


def distinct_pairs(rng, n_rows: int, n: int) -> np.ndarray:
    """n distinct ordered (a, b) row pairs, a != b."""
    a, b = np.divmod(np.arange(n_rows * n_rows), n_rows)
    every = np.stack([a[a != b], b[a != b]], axis=1)
    if n > len(every):
        raise ValueError(f"{n} distinct pairs of {n_rows} rows do not exist")
    return every[rng.permutation(len(every))[:n]]


# ------------------------------------------------------------ phase 4


def build_index(pt, rng, n_shards: int, n_rows: int):
    """bench_big's holder: dense-container injection of random planes."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.storage.bitmap import Container

    n_containers = SHARD_WIDTH >> 16
    holder = pt.Holder(None)
    holder.open()
    fld = holder.create_index("big").create_field("f")
    view = fld.create_view_if_not_exists("standard")
    for shard in range(n_shards):
        frag = view.create_fragment_if_not_exists(shard, broadcast=False)
        words = rng.integers(0, 1 << 64, size=(n_rows, n_containers, 1024),
                             dtype=np.uint64)
        counts = np.bitwise_count(words).sum(axis=2)
        for row in range(n_rows):
            for ci in range(n_containers):
                frag.storage.containers[row * n_containers + ci] = Container(
                    bits=words[row, ci], n=int(counts[row, ci]))
            frag.cache.bulk_add(row, int(counts[row].sum()))
        frag.cache.invalidate(force=True)
    return holder


V_MAX = 100000  # bench.py:2221's int field: min 0, max 100000, 17 bits
T_DAYS = 30     # day views of January 2018 in the YMD time field
T_ROWS = 2


def build_bsi_time(holder, rng, n_shards: int):
    """Path (e)'s fields on the same index, injected as dense containers:
    an int field v (min 0, max V_MAX) holding a value on about half of
    every shard's columns, and a YMD time field t whose rows 0 and 1 hold
    ~25%-density day views for January 1-30 of 2018, plus the month, year
    and standard views a timestamped Set writes (their union). Returns
    (vals, nn): the (S, SHARD_WIDTH) values and the (S, W) not-null words."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.constants import (SHARD_WIDTH, VIEW_BSI_GROUP_PREFIX,
                                            WORDS_PER_ROW)
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.storage.bitmap import Container

    idx = holder.index("big")
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=V_MAX))
    depth = v.bsi_group("v").bit_depth()
    bview = v.create_view_if_not_exists(VIEW_BSI_GROUP_PREFIX + "v")
    t = idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    day_views = [t.create_view_if_not_exists(f"standard_201801{d:02d}")
                 for d in range(1, T_DAYS + 1)]
    union_views = [t.create_view_if_not_exists(n)
                   for n in ("standard_201801", "standard_2018", "standard")]
    seeds = rng.integers(1 << 62, size=n_shards)
    vals = np.empty((n_shards, SHARD_WIDTH), dtype=np.uint32)
    nn = np.empty((n_shards, WORDS_PER_ROW), dtype=np.uint32)

    def make(shard):
        g = np.random.default_rng(int(seeds[shard]))
        val = g.integers(0, V_MAX, SHARD_WIDTH, dtype=np.uint32, endpoint=True)
        nnw = g.integers(0, 1 << 32, WORDS_PER_ROW, dtype=np.uint32)
        bits = np.unpackbits(val.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
        planes = np.empty((depth + 1, WORDS_PER_ROW), dtype=np.uint32)
        planes[:depth] = np.packbits(np.ascontiguousarray(bits[:, :depth].T), axis=1,
                                     bitorder="little").view(np.uint32)
        planes[:depth] &= nnw
        planes[depth] = nnw
        days = (g.integers(0, 1 << 32, (T_ROWS, T_DAYS, WORDS_PER_ROW), dtype=np.uint32)
                & g.integers(0, 1 << 32, (T_ROWS, T_DAYS, WORDS_PER_ROW), dtype=np.uint32))
        vals[shard], nn[shard] = val, nnw
        return planes, days, np.bitwise_or.reduce(days, axis=1)

    def inject(view, shard, rows_planes):
        frag = view.create_fragment_if_not_exists(shard, broadcast=False)
        for row, plane in rows_planes:
            words = plane.view(np.uint64).reshape(-1, 1024)
            counts = np.bitwise_count(words).sum(axis=1)
            for ci in range(words.shape[0]):
                if counts[ci]:
                    frag.storage.containers[row * words.shape[0] + ci] = Container(
                        bits=words[ci], n=int(counts[ci]))

    with ThreadPoolExecutor(max_workers=8) as pool:
        for shard, (planes, days, union) in enumerate(pool.map(make, range(n_shards))):
            inject(bview, shard, enumerate(planes))
            for d, view in enumerate(day_views):
                inject(view, shard, ((r, days[r, d]) for r in range(T_ROWS)))
            for view in union_views:  # each view owns its words: a write
                inject(view, shard, enumerate(union.copy()))  # must not reach the others
    return vals, nn, depth


def host_planes(holder, n_shards: int, n_rows: int) -> np.ndarray:
    """(rows, shards, W) uint32 from every fragment's plane_np."""
    from pilosa_tpu_torch.constants import WORDS_PER_ROW

    H = np.empty((n_rows, n_shards, WORDS_PER_ROW), dtype=np.uint32)
    for s in range(n_shards):
        frag = holder.fragment("big", "f", "standard", s)
        for r in range(n_rows):
            H[r, s] = frag.plane_np(r)
    return H


def np_count(x: np.ndarray) -> int:
    return int(np.bitwise_count(x).sum(dtype=np.int64))


def replay_topn(counts, cache, n: int, thr: int = 1):
    """numpy replay of the two-phase TopN (executor.go:524-560 and
    fragment.go:899-990): counts (R, S) per-(row, shard) counts against
    the filter (or the row counts without one), cache (R, S) rank-cache
    counts. Returns [(row, total)] sorted by (-total, row), trimmed to n."""
    import heapq

    has_src = counts is not cache
    n_rows, n_shards = cache.shape
    union = set()
    for s in range(n_shards):
        cands = sorted(((int(cache[r, s]), r) for r in range(n_rows)
                        if cache[r, s] >= max(thr, 1)), key=lambda t: (-t[0], t[1]))
        results = []
        for cnt, r in cands:
            if len(results) < n:
                c = int(counts[r, s])
                if c == 0 or c < thr:
                    continue
                heapq.heappush(results, (c, r))
                if len(results) == n and not has_src:
                    break
                continue
            threshold = results[0][0]
            if threshold < thr or cnt < threshold:
                break
            c = int(counts[r, s])
            if c < threshold:
                continue
            heapq.heappush(results, (c, r))
        union.update(r for _, r in results)
    totals = []
    for r in union:
        t = sum(int(counts[r, s]) for s in range(n_shards)
                if counts[r, s] > 0 and counts[r, s] >= thr)
        if t:
            totals.append((r, t))
    totals.sort(key=lambda p: (-p[1], p[0]))
    return totals[:n]


def main_path(torch, pt, kernels, args, rng, report):
    from pilosa_tpu_torch.pql.parser import parse

    n_shards, n_rows = args.shards, args.rows
    t0 = time.perf_counter()
    holder = build_index(pt, rng, n_shards, n_rows)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    H = host_planes(holder, n_shards, n_rows)
    log(f"main: built {n_shards} shards x {n_rows} rows "
        f"({H.nbytes / 2**30:.2f} GiB of planes) in {build_s:.1f} s; host "
        f"reference planes in {time.perf_counter() - t0:.1f} s")
    ex = pt.Executor(holder)
    eng = ex.engine
    shards = list(range(n_shards))
    plane_bytes = n_shards * H.shape[2] * 4
    out = {"shards": n_shards, "rows": n_rows, "build_s": build_s}

    def want_pair(a, b):
        return np_count(np.bitwise_and(H[a], H[b]))

    # Each path is driven with the launch counters set to 0 just before it
    # and read just after, so one path's launches cannot hide another's.
    phases = {}

    def start(name):
        torch.cuda.synchronize()
        kernels.reset_counters()
        return name

    def end(name, *need, none=(), quiet=(eng,), allow=()):
        """Read the launch counters of the path just driven; `quiet`
        engines must show no ladder or host-rung counts but `allow`."""
        torch.cuda.synchronize()
        got = {"launches": dict(kernels.LAUNCHES), "plain_calls": dict(kernels.PLAIN_CALLS)}
        phases[name] = got
        log(f"counters {name}: launches {got['launches']}, plain twins {got['plain_calls']}")
        assert not any(got["plain_calls"].values()), (name, got)
        for k in need:
            assert got["launches"][k] > 0, (name, k, got)
        for k in none:
            assert got["launches"][k] == 0, (name, k, got)
        for e in quiet:
            snap = e.snapshot()
            bad = {k: snap[k] for k in LADDER if k not in allow and snap[k]}
            assert not bad, (name, bad)

    # ---- (a) Count through Executor.execute
    ph = start("a_execute_count")
    pairs_a = distinct_pairs(rng, n_rows, 8)
    t0 = time.perf_counter()
    a0, b0 = (int(x) for x in pairs_a[0])
    got = ex.execute("big", f"Count(Intersect(Row(f={a0}), Row(f={b0})))")[0]
    out["count_cold_s"] = time.perf_counter() - t0
    assert got == want_pair(a0, b0), (got, want_pair(a0, b0))
    for a, b in pairs_a[1:]:
        got = ex.execute("big", f"Count(Intersect(Row(f={a}), Row(f={b})))")[0]
        assert got == want_pair(int(a), int(b)), (a, b, got)
    nest_q = ("Count(Difference(Union(Row(f=1), Row(f=2), Row(f=3)), "
              "Xor(Row(f=4), Row(f=5)), Intersect(Row(f=6), Row(f=7))))")
    got = ex.execute("big", nest_q)[0]
    u = H[1] | H[2] | H[3]
    want = np_count(u & ~((H[4] ^ H[5]) | (H[6] & H[7])))
    del u
    assert got == want, (got, want)
    # 40 distinct rows in one tree: past the old 32-row tape limit.
    got = ex.execute("big", "Count(Union(" + ", ".join(
        f"Row(f={r})" for r in range(40)) + "))")[0]
    u = H[0].copy()
    for r in range(1, 40):
        u |= H[r]
    want = np_count(u)
    del u
    assert got == want, (got, want)
    log(f"main (a): Executor Count(Intersect) x{len(pairs_a)}, the "
        f"Union/Difference/Xor nest and a 40-row Union equal numpy (first, cold: "
        f"{out['count_cold_s']:.2f} s)")
    end(ph, "gather_expr_count", "gather_expr_count_streaming",
        none=("gather_expr_count_staged",))

    # ---- (b) count_batch over 256 distinct pairs
    ph = start("b_count_batch")
    pairs = distinct_pairs(rng, n_rows, args.batch)
    calls = [parse(f"Count(Intersect(Row(f={a}), Row(f={b})))").calls[0].children[0]
             for a, b in pairs]
    t0 = time.perf_counter()
    res = eng.count_batch("big", calls, shards)
    out["batch_cold_s"] = time.perf_counter() - t0
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as pool:
        wants = list(pool.map(lambda p: want_pair(int(p[0]), int(p[1])), pairs))
    assert [int(x) for x in res] == wants, "count_batch != numpy"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        eng.count_batch_async("big", calls, shards)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["batch_qps"] = args.reps * len(calls) / dt
    out["batch_ms"] = dt / args.reps * 1e3
    out["batch_gbs"] = args.reps * len(calls) * 2 * plane_bytes / dt / 1e9
    k1_ms = report["kernel_phase"]["k1_serving"]["ms"]
    out["batch_idle_share_est"] = max(0.0, 1.0 - k1_ms / out["batch_ms"])
    # Host-side stages of one warm batch (count_batch_async's own steps).
    stages = {}
    t0 = time.perf_counter()
    fcache = {}
    plans = [eng.plan("big", c, field_cache=fcache) for c in calls]
    stages["plans_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    slots, idxs_np, _, _ = eng._batch_slot_gather(plans, len(plans))
    slots = list(slots)  # the batch's stack: (index, slots, shards)
    stages["slot_gather_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng._stacked_leaf_tensor("big", slots, tuple(shards))
    stages["stack_probe_ms"] = (time.perf_counter() - t0) * 1e3
    stages["k1_ms"] = k1_ms
    out["batch_host_stages"] = stages
    log(f"main (b): count_batch Q={len(calls)} equals numpy (cold {out['batch_cold_s']:.2f} s "
        f"incl. leaf gathers); timed x{args.reps}: {out['batch_ms']:.3f} ms/batch, "
        f"{out['batch_qps']:.1f} queries/s, {out['batch_gbs']:.1f} GB/s; device idle "
        f"share ~{out['batch_idle_share_est']:.3f} (1 - K1 time / batch wall time); "
        f"host stages of one batch: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    end(ph, "gather_expr_count", "gather_expr_count_staged")

    # ---- (a) timed: single Counts on resident leaves (the batch above
    # gathered the leaf planes of nearly every row)
    ph = start("a_execute_count_timed")
    qpairs = distinct_pairs(rng, n_rows, args.single)
    qs = [f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in qpairs]
    with eng.memos_off():  # the kernel path, as before the memo
        ex.execute("big", qs[0])
        t0 = time.perf_counter()
        for q in qs:
            ex.execute("big", q)
        dt = time.perf_counter() - t0
    out["count_qps"] = len(qs) / dt
    out["count_ms"] = dt / len(qs) * 1e3
    log(f"main (a) timed: {len(qs)} Executor Counts, {out['count_ms']:.3f} ms each, "
        f"{out['count_qps']:.1f} queries/s")
    end(ph, "gather_expr_count", "gather_expr_count_streaming",
        none=("gather_expr_count_staged",))

    # ---- (c) TopN without a filter (rank caches only), then with one
    cache = np.stack([np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64)
                      for r in range(n_rows)])  # (R, S)
    ph = start("c_topn")
    t0 = time.perf_counter()
    got = ex.execute("big", "TopN(f, n=10)")[0]
    out["topn_ms"] = (time.perf_counter() - t0) * 1e3
    end(ph)
    want = replay_topn(cache, cache, 10)
    assert [(p.id, p.count) for p in got] == want, (got, want)
    fa = int(rng.integers(n_rows))
    with ThreadPoolExecutor(max_workers=8) as pool:
        inter = np.stack(list(pool.map(
            lambda r: np.bitwise_count(H[r] & H[fa]).sum(axis=1, dtype=np.int64),
            range(n_rows))))
    ph = start("c_topn_filter")
    t0 = time.perf_counter()
    got = ex.execute("big", f"TopN(f, Row(f={fa}), n=10)")[0]
    out["topn_filter_cold_ms"] = (time.perf_counter() - t0) * 1e3
    want = replay_topn(inter, cache, 10)
    assert [(p.id, p.count) for p in got] == want, (got, want)
    fb = (fa + 1) % n_rows
    with eng.memos_off():  # the kernel path, as before the memo
        ex.execute("big", f"TopN(f, Row(f={fb}), n=10)")
        t0 = time.perf_counter()
        ex.execute("big", f"TopN(f, Row(f={fa}), n=10)")
        out["topn_filter_ms"] = (time.perf_counter() - t0) * 1e3
    end(ph, "masked_plane_counts")
    log(f"main (c): TopN(f, n=10) and TopN(f, Row(f={fa}), n=10) equal the numpy "
        f"replay; {out['topn_ms']:.1f} ms and {out['topn_filter_ms']:.1f} ms warm "
        f"({out['topn_filter_cold_ms']:.1f} ms first)")

    # ---- (d) a write, then recounts: the stale leaf and the batch's
    # stack are refreshed by a delta scatter, nothing is re-gathered
    a, b = (int(x) for x in pairs[0])
    s = n_shards // 2
    cols = np.flatnonzero(np.unpackbits(
        (~H[a, s] & H[b, s]).view(np.uint8), bitorder="little"))
    col = s * (H.shape[2] * 32) + int(cols[0])
    # Other paths' stacks may have pushed the batch's stack out of the
    # LRU stack cache: make it resident (a hit or a restack of resident
    # leaves) so the write below has a cached stack to refresh.
    eng._stacked_leaf_tensor("big", slots, tuple(shards))
    base = eng.snapshot()
    ph = start("d_set_recount")
    assert ex.execute("big", f"Set({col}, f={a})") == [True]
    H[a, s, int(cols[0]) >> 5] |= np.uint32(1 << (int(cols[0]) & 31))
    got = ex.execute("big", f"Count(Intersect(Row(f={a}), Row(f={b})))")[0]
    assert got == want_pair(a, b) == wants[0] + 1, (got, wants[0])
    wants = [want_pair(int(p[0]), int(p[1])) if a in (int(p[0]), int(p[1])) else w
             for p, w in zip(pairs, wants)]
    # The whole batch, unmemoized, reads the batch's stack: one scatter.
    res = eng.count_batch_async("big", calls, shards).cpu().numpy()
    assert res.tolist() == wants, "count_batch_async != numpy"
    # Through the memo: the write moved the generation of a fragment every
    # leaf of f has a shard in, so every query but the Count above misses
    # and the misses ride one K1 launch over a stack of their own leaves.
    res = eng.count_batch("big", calls, shards)
    assert [int(x) for x in res] == wants and int(res[0]) == wants[0], "count_batch != numpy"
    now = eng.snapshot()
    dd = {k: now[k] - base[k] for k in ("leaf_delta_hits", "stack_delta_hits", "delta_bytes",
                                        "full_refresh_bytes", "memo_hits", "memo_misses")}
    assert dd["leaf_delta_hits"] >= 1 and dd["stack_delta_hits"] >= 1, dd
    assert dd["full_refresh_bytes"] == 0 and 0 < dd["delta_bytes"] <= 1024, dd
    out["d_counters"] = dd
    end(ph, "gather_expr_count", "gather_expr_count_streaming", "gather_expr_count_staged")
    log(f"main (d): Set then recount: Count, count_batch (memo) and the whole batch see "
        f"the write; refreshed by deltas, nothing re-gathered: {dd}")
    bsi = main_path_bsi(ex, eng, H, rng, n_shards, start, end, out)
    main_path_f(torch, pt, kernels, ex, eng, H, bsi, start, end, out, dict(
        pairs_a=pairs_a, nest_q=nest_q, calls=calls, pairs=pairs, wants=wants, fa=fa,
        slots=slots))
    out["engine"] = eng.snapshot()
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ex.close()  # (g)'s server serves the same holder and closes it
    main_path_g(torch, pt, kernels, holder, H, bsi, rng, start, end, out)
    launches = {k: sum(p["launches"][k] for p in phases.values())
                for k in kernels.LAUNCHES}
    out["phases"] = phases
    out["launches"] = launches
    report["main"] = out
    return launches


def main_path_bsi(ex, eng, H, rng, n_shards, start, end, out):
    """Path (e): BSI Sum/Min/Max and Range, time-quantum Range, a BSI TopN
    filter and their writes on the same 256-shard index, each answer
    against numpy on the fragments' host planes."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pilosa_tpu_torch.constants import SHARD_WIDTH, VIEW_BSI_GROUP_PREFIX
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.plan.signature import Leaf

    torch_sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    vals, nn_words, depth = build_bsi_time(ex.holder, rng, n_shards)
    e = {"build_s": time.perf_counter() - t0}
    # The reference reads the fragments' host planes: the BSI planes must
    # be the generated values bit for bit, and the time Range's reference
    # is the union of the day views' host planes.
    t0 = time.perf_counter()

    def check_shard(shard):
        frag = ex.holder.fragment("big", "v", VIEW_BSI_GROUP_PREFIX + "v", shard)
        nnw = frag.plane_np(depth)
        bits = np.unpackbits(vals[shard].view(np.uint8).reshape(-1, 4), axis=1,
                             bitorder="little")[:, :depth]
        want = np.packbits(np.ascontiguousarray(bits.T), axis=1,
                           bitorder="little").view(np.uint32) & nnw
        return bool(np.array_equal(nnw, nn_words[shard])) and all(
            np.array_equal(frag.plane_np(i), want[i]) for i in range(depth))

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(check_shard, range(n_shards))), "BSI host planes != values"
    nn = np.unpackbits(nn_words.view(np.uint8), axis=1, bitorder="little").view(bool)
    day_lo, day_hi = 5, 15  # Range(t=r, 2018-01-05T00:00, 2018-01-15T00:00): 10 day views
    t10 = np.zeros((T_ROWS, n_shards, H.shape[2]), dtype=np.uint32)
    for r in range(T_ROWS):
        for d in range(day_lo, day_hi):
            for shard in range(n_shards):
                t10[r, shard] |= ex.holder.fragment(
                    "big", "t", f"standard_201801{d:02d}", shard).plane_np(r)
    e["reference_s"] = time.perf_counter() - t0
    log(f"main (e): built v (depth {depth}, {int(nn.sum())} values) and t ({T_ROWS} rows x "
        f"{T_DAYS} day views + month/year/standard) in {e['build_s']:.1f} s; host reference "
        f"in {e['reference_s']:.1f} s")
    fa = int(rng.integers(H.shape[0]))
    fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
    with ThreadPoolExecutor(max_workers=8) as pool:  # rank counts after (d)'s Set
        cache = np.stack(list(pool.map(
            lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(H.shape[0]))))
    timed = {}

    def run(q):
        t0 = time.perf_counter()
        got = ex.execute("big", q)[0]
        timed[q] = (time.perf_counter() - t0) * 1e3
        return got

    def want_vc(kind, mask):
        sel = vals[mask]
        if kind == "sum":
            return int(sel.sum(dtype=np.int64)), int(sel.size)
        best = int(sel.max() if kind == "max" else sel.min())
        return best, int(np.count_nonzero(sel == best))

    # ---- Sum (K2), then Min/Max (K3), with and without Row(f=fa)
    ph = start("e_bsi_sum")
    for flt, mask in (("", nn), (f"Row(f={fa}), ", nn & fbits)):
        got = run(f"Sum({flt}field=v)")
        assert (got.val, got.count) == want_vc("sum", mask), (flt, got)
    end(ph, "masked_plane_counts", none=("bsi_minmax", "gather_expr_count"))
    ph = start("e_bsi_minmax")
    for kind in ("min", "max"):
        for flt, mask in (("", nn), (f"Row(f={fa}), ", nn & fbits)):
            got = run(f"{kind.title()}({flt}field=v)")
            assert (got.val, got.count) == want_vc(kind, mask), (kind, flt, got)
    end(ph, "bsi_minmax", none=("gather_expr_count",))
    log(f"main (e): Sum/Min/Max(field=v), with and without Row(f={fa}), equal numpy")

    # ---- Range Counts on K1: BSI, BSI under an Intersect, time
    x_gt, x_lt = 61234, 4321
    ph = start("e_range_count")
    got = run(f"Count(Range(v > {x_gt}))")
    assert got == int(np.count_nonzero(nn & (vals > x_gt))), got
    got = run(f"Count(Intersect(Row(f={fa}), Range(v < {x_lt})))")
    assert got == int(np.count_nonzero(nn & fbits & (vals < x_lt))), got
    tq = "Count(Range(t={}, 2018-01-05T00:00, 2018-01-15T00:00))"
    t_counts = [np_count(t10[r]) for r in range(T_ROWS)]
    for r in range(T_ROWS):
        assert run(tq.format(r)) == t_counts[r], r
    end(ph, "gather_expr_count", "gather_expr_count_streaming")
    log("main (e): Count(Range(v > x)), Count(Intersect(Row, Range(v < x))) and "
        "Count(Range(t=r, 10 day views)) equal numpy")

    # ---- count_batch of BSI trees: one predicate, 64 rows (staged K1)
    gt_plane = np.packbits(nn & (vals > x_gt), axis=1, bitorder="little").view(np.uint32)
    with ThreadPoolExecutor(max_workers=8) as pool:
        inter = np.stack(list(pool.map(
            lambda r: np.bitwise_count(H[r] & gt_plane).sum(axis=1, dtype=np.int64),
            range(H.shape[0]))))
    from pilosa_tpu_torch.pql.parser import parse

    bq = "Count(Intersect(Row(f={}), Range(v > %d)))" % x_gt
    n_b = min(64, H.shape[0])
    calls = [parse(bq.format(r)).calls[0].children[0] for r in range(n_b)]
    shards = list(range(n_shards))
    ph = start("e_range_count_batch")
    got = eng.count_batch("big", calls, shards)
    assert got.tolist() == inter[:n_b].sum(axis=1).tolist(), "BSI count_batch != numpy"
    torch_sync()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.count_batch_async("big", calls, shards)
    torch_sync()
    e["bsi_batch_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    end(ph, "gather_expr_count_staged", none=("gather_expr_count_streaming",))
    log(f"main (e): count_batch of {n_b} Count(Intersect(Row(f=r), Range(v > {x_gt}))) equals "
        f"numpy; {e['bsi_batch_ms']:.3f} ms per warm batch (host clock)")

    # ---- Ranges as Rows (elementwise torch on the device, no count kernel)
    ph = start("e_range_rows")
    lo, hi, eq = 50000, 50010, 77777
    flat_vals, flat_nn = vals.reshape(-1), nn.reshape(-1)
    got = run(f"Range(v >< [{lo}, {hi}])").columns()
    want = np.flatnonzero(flat_nn & (flat_vals >= lo) & (flat_vals <= hi))
    assert np.array_equal(got, want.astype(np.uint64)), (len(got), len(want))
    got = run(f"Range(v == {eq})").columns()
    want = np.flatnonzero(flat_nn & (flat_vals == eq))
    assert np.array_equal(got, want.astype(np.uint64)), (len(got), len(want))
    end(ph)
    log(f"main (e): Range(v >< [{lo}, {hi}]) and Range(v == {eq}) rows equal numpy")

    # ---- TopN over a BSI Range (K2 against the range's plane)
    ph = start("e_topn_range")
    got = run(f"TopN(f, Range(v > {x_gt}), n=10)")
    want = replay_topn(inter, cache, 10)
    assert [(p.id, p.count) for p in got] == want, (got, want)
    end(ph, "masked_plane_counts", none=("bsi_minmax",))
    log(f"main (e): TopN(f, Range(v > {x_gt}), n=10) equals the numpy replay")

    # ---- writes: a SetValue and a timestamped Set, then recounts
    shard = n_shards // 3
    col = int(np.flatnonzero(~nn[shard])[0])
    new_val = 54321
    before_eq = int(np.count_nonzero(nn & (vals == new_val)))
    ph = start("e_writes_recount")
    assert run(f"SetValue(col={shard * SHARD_WIDTH + col}, v={new_val})") is None
    vals[shard, col], nn[shard, col] = new_val, True
    got = run("Sum(field=v)")
    assert (got.val, got.count) == want_vc("sum", nn), got
    assert run(f"Count(Range(v == {new_val}))") == before_eq + 1
    tcol = int(np.flatnonzero(np.unpackbits(
        t10[1, shard].view(np.uint8), bitorder="little") == 0)[0])
    assert run(f"Set({shard * SHARD_WIDTH + tcol}, t=1, 2018-01-07T00:00)") is True
    assert run(tq.format(1)) == t_counts[1] + 1
    end(ph, "gather_expr_count", "masked_plane_counts")
    refusals = eng.snapshot()["compile_gate_refusals"]
    assert refusals == 0, refusals
    log("main (e): SetValue then Sum and Count(Range(v == x)), timestamped Set then the "
        "time Count: each sees its write; compile-gate refusals 0")
    # ---- warm repeats (resident stacks), and one warm Max's host stages
    ph = start("e_warm")
    warm = {}
    with eng.memos_off():  # the kernel path, as before the memo
        for q in (f"Sum(Row(f={fa}), field=v)", f"Max(Row(f={fa}), field=v)",
                  f"Count(Range(v > {x_gt}))", tq.format(1)):
            reps = []
            for _ in range(10):
                t0 = time.perf_counter()
                ex.execute("big", q)
                reps.append((time.perf_counter() - t0) * 1e3)
            warm[q] = statistics.median(reps)
    flt = parse(f"Row(f={fa})").calls[0]
    leaves = [Leaf("v", VIEW_BSI_GROUP_PREFIX + "v", i) for i in range(depth + 1)]
    stages = {}
    t0 = time.perf_counter()
    eng.supports(flt, "big")
    stages["gate_plan_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    planes = eng._stacked_leaf_tensor("big", leaves, tuple(shards))
    stages["stack_probe_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mask = eng._src_plane("big", flt, tuple(shards))
    torch_sync()
    stages["filter_plane_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bits, count = kernels.bsi_minmax(planes, mask, True)
    int(count)
    stages["k3_and_readback_ms"] = (time.perf_counter() - t0) * 1e3
    del planes, mask
    end(ph, "bsi_minmax", "masked_plane_counts", "gather_expr_count")
    e["warm_ms"], e["warm_max_stages"] = warm, stages
    log("main (e) warm, median of 10 (ms, host clock): " + "; ".join(
        f"{q} {ms:.3f}" for q, ms in warm.items()))
    log(f"main (e) host stages of one warm Max(Row(f={fa}), field=v) (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    e["query_ms"] = timed
    e["depth"] = depth
    out["bsi"] = e
    log("main (e) times (ms, host clock, one call each): " + "; ".join(
        f"{q} {ms:.1f}" for q, ms in timed.items()))
    return dict(vals=vals, nn=nn, fa=fa, fbits=fbits, want_vc=want_vc, x_gt=x_gt,
                warm_ms=warm)


# (f4): a fresh process whose kernel build cannot run (an empty build
# directory and a missing nvcc) drives one Count through Executor.execute.
BUILD_FAIL_SCRIPT = r"""
import json, os, shutil, sys, tempfile
sys.path.insert(0, sys.argv[1])
import pilosa_tpu_torch as pt
from pilosa_tpu_torch.ops import kernels

os.makedirs(kernels.BUILD_DIR, exist_ok=True)
empty = tempfile.mkdtemp(prefix="empty-", dir=kernels.BUILD_DIR)
try:
    kernels.BUILD_DIR = empty
    kernels.LIBRARY = os.path.join(empty, "libbitplane_kernels.so")
    kernels._nvcc = lambda: os.path.join(empty, "nvcc-missing")
    holder = pt.Holder(None)
    holder.open()
    holder.create_index("i").create_field("f").import_bits([0, 0, 1], [1, 70000, 1])
    ex = pt.Executor(holder)
    try:
        ex.execute("i", "Count(Intersect(Row(f=0), Row(f=1)))")
        out = {"raised": None}
    except Exception as e:
        out = {"raised": type(e).__name__, "message": str(e)[:300]}
    snap = ex.engine.snapshot()
    out.update({k: snap[k] for k in ("device_dispatch_errors", "host_counts", "host_topn",
                                     "count_dispatches")})
    out["plane"] = ex.engine.device_health.plane_state()
    out["dispatch_failures"] = ex.engine.device_health.snapshot()["dispatch_failures"]
    out["launches"] = sum(kernels.LAUNCHES.values())
    out["on_card"] = holder.device.type
    ex.close()
    holder.close()
finally:
    shutil.rmtree(empty, ignore_errors=True)
print(json.dumps(out))
"""


def main_path_f(torch, pt, kernels, ex, eng, H, bsi, start, end, out, ctx):
    """Path (f): the result and aux memos, delta refresh, tiering and the
    device-fault ladder on the same 256-shard index."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch import failpoints
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.parallel import EngineConfig
    from pilosa_tpu_torch.parallel.device_health import (DeviceKernelFault, ResilienceConfig,
                                                         classify_device_error)
    from pilosa_tpu_torch.parallel.engine import ShardedQueryEngine
    from pilosa_tpu_torch.tier import TierConfig

    n_rows, n_shards, n_words = H.shape
    shards = list(range(n_shards))
    plane_bytes = n_shards * n_words * 4
    vals, nn, bfa, fbits, want_vc = (bsi[k] for k in ("vals", "nn", "fa", "fbits", "want_vc"))
    calls, pairs = ctx["calls"], ctx["pairs"]
    f = {}

    def want_pair(a, b):
        return np_count(np.bitwise_and(H[a], H[b]))

    def ranked(src_row):
        with ThreadPoolExecutor(max_workers=8) as pool:
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
            inter = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r] & H[src_row]).sum(axis=1, dtype=np.int64),
                range(n_rows))))
        return replay_topn(inter, cache, 10)

    def median_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # ---- (f1) memos: (a)'s Counts, the batch, Sum/Max and a filtered TopN
    union_q = "Count(Union(" + ", ".join(f"Row(f={r})" for r in range(40)) + "))"
    u = H[1] | H[2] | H[3]
    nest_want = np_count(u & ~((H[4] ^ H[5]) | (H[6] & H[7])))
    u = H[0].copy()
    for r in range(1, 40):
        u |= H[r]
    union_want = np_count(u)
    del u
    counts = [(f"Count(Intersect(Row(f={a}), Row(f={b})))", want_pair(int(a), int(b)))
              for a, b in ctx["pairs_a"]] + [(ctx["nest_q"], nest_want), (union_q, union_want)]
    tfa = ctx["fa"]
    topn_q = f"TopN(f, Row(f={tfa}), n=10)"
    topn_want = ranked(tfa)
    aux = [("Sum(field=v)", want_vc("sum", nn)),
           (f"Sum(Row(f={bfa}), field=v)", want_vc("sum", nn & fbits)),
           ("Max(field=v)", want_vc("max", nn)),
           (f"Max(Row(f={bfa}), field=v)", want_vc("max", nn & fbits))]

    def setop_pass():
        for q, w in counts:
            assert ex.execute("big", q)[0] == w, q
        assert [int(x) for x in eng.count_batch("big", calls, shards)] == ctx["wants"]

    def aux_pass():
        for q, w in aux:
            got = ex.execute("big", q)[0]
            assert (got.val, got.count) == w, (q, got)
        got = ex.execute("big", topn_q)[0]
        assert [(p.id, p.count) for p in got] == topn_want, (got, topn_want)

    ph = start("f1_memo_prime")  # (d) and (e) wrote: re-validate once
    setop_pass()
    aux_pass()
    end(ph)
    ph = start("f1_memo")
    s0 = eng.snapshot()
    setop_pass()
    s1 = eng.snapshot()
    aux_pass()
    s2 = eng.snapshot()
    assert s1["memo_hits"] - s0["memo_hits"] == len(counts) + len(calls), (s0, s1)
    assert s2["memo_hits"] - s1["memo_hits"] >= len(aux) + 1, (s1, s2)
    assert s2["memo_misses"] == s0["memo_misses"], (s0, s2)
    memo_ms = {
        "count": median_ms(lambda: ex.execute("big", counts[0][0])),
        "count_batch_256": median_ms(lambda: eng.count_batch("big", calls, shards), 10),
        "sum_filtered": median_ms(lambda: ex.execute("big", aux[1][0])),
        "max_filtered": median_ms(lambda: ex.execute("big", aux[3][0])),
        "topn_filtered": median_ms(lambda: ex.execute("big", topn_q), 10),
    }
    end(ph, none=("gather_expr_count", "masked_plane_counts", "bsi_minmax"))
    f["memo"] = dict(set_op_hits=s1["memo_hits"] - s0["memo_hits"],
                     aux_hits=s2["memo_hits"] - s1["memo_hits"], hit_ms=memo_ms)
    log(f"main (f1): {len(counts)} Counts, a {len(calls)}-query count_batch, Sum/Max with and "
        f"without Row(f={bfa}) and TopN(f, Row(f={tfa}), n=10) repeated: equal numpy, "
        f"memo_hits +{f['memo']['set_op_hits']} and +{f['memo']['aux_hits']}, no kernel "
        f"launched; memo-hit medians (ms, host clock): " + ", ".join(
            f"{k} {v:.3f}" for k, v in memo_ms.items()))

    # ---- (f2) delta refresh of the batch's stack, beside a full regather
    slots = ctx["slots"]
    stack_shards = tuple(shards)
    eng._stacked_leaf_tensor("big", slots, stack_shards)  # resident before the write
    eng_nd = ShardedQueryEngine(
        ex.holder, config=EngineConfig(delta_max_fraction=0.0),
        tier_config=TierConfig(host_bytes=0, disk_bytes=0))
    rebuilt, cold_host_ms, cold_dev_ms, cold_how = device_total_ms(
        torch, lambda: eng_nd._stacked_leaf_tensor("big", slots, stack_shards))
    del rebuilt
    cold_bytes = eng_nd.snapshot()["full_refresh_bytes"]
    a2, b2 = (int(x) for x in pairs[1])
    s2_ = n_shards // 4
    c2 = int(np.flatnonzero(np.unpackbits((~H[a2, s2_] & H[b2, s2_]).view(np.uint8),
                                          bitorder="little"))[0])
    vshard = n_shards // 5
    vcol = int(np.flatnonzero(~nn[vshard])[0])
    new_val = 99999
    base = eng.snapshot()
    ph = start("f2_delta")
    assert ex.execute("big", f"Set({s2_ * SHARD_WIDTH + c2}, f={a2})") == [True]
    H[a2, s2_, c2 >> 5] |= np.uint32(1 << (c2 & 31))
    assert ex.execute("big", f"SetValue(col={vshard * SHARD_WIDTH + vcol}, v={new_val})") == [None]
    vals[vshard, vcol], nn[vshard, vcol] = new_val, True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    # The refresh's device work is one call of the engine's _scatter (the
    # index upload, the clone, the index_put): CUDA events around it.
    # torch.profiler records no device activity in a window this short on
    # the card (only the runtime calls), so it cannot time this call.
    scatter_ms = []
    real_scatter = eng._scatter

    def timed_scatter(*a):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        got = real_scatter(*a)
        ev1.record()
        torch.cuda.synchronize()
        scatter_ms.append(ev0.elapsed_time(ev1))
        return got

    eng._scatter = timed_scatter
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refreshed = eng._stacked_leaf_tensor("big", slots, stack_shards)
        torch.cuda.synchronize()
        delta_host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del eng._scatter
    assert len(scatter_ms) == 1, scatter_ms
    delta_dev_ms = scatter_ms[0]
    delta_peak = torch.cuda.max_memory_allocated()
    # The clone alone, the allocator's block already free (no cudaMalloc).
    clone_ms = cuda_time_ms(torch, lambda: refreshed.clone(), 3)
    mid = eng.snapshot()
    assert mid["stack_delta_hits"] == base["stack_delta_hits"] + 1, (base, mid)
    assert mid["full_refresh_bytes"] == base["full_refresh_bytes"], (base, mid)
    # The same refresh without the delta path (the port before it): the
    # write moved the generation of a fragment every leaf has a shard in,
    # so every leaf is re-gathered from the host planes and restacked.
    torch.cuda.reset_peak_memory_stats()
    mem1 = torch.cuda.memory_allocated()
    rebuilt, full_host_ms, full_dev_ms, full_how = device_total_ms(
        torch, lambda: eng_nd._stacked_leaf_tensor("big", slots, stack_shards))
    full_peak = torch.cuda.max_memory_allocated()
    regathered = eng_nd.snapshot()["full_refresh_bytes"] - cold_bytes
    assert regathered == len(slots) * plane_bytes, (regathered, len(slots))
    assert torch.equal(refreshed, rebuilt), "delta-refreshed stack != stack from host planes"
    del refreshed, rebuilt
    eng_nd.close()
    torch.cuda.empty_cache()
    # The host container walk of a cold gather, per plane: serial (the
    # default), and on the auto-sized gather pool (gather_workers=0).
    gather_ms = {}
    for gw in (1, 0):
        e2 = ShardedQueryEngine(ex.holder, config=EngineConfig(gather_workers=gw),
                                tier_config=TierConfig(host_bytes=0, disk_bytes=0))
        t0 = time.perf_counter()
        for leaf in slots[:8]:
            e2._host_gather([ex.holder.fragment("big", leaf.field, leaf.view, sh)
                             for sh in shards], leaf.row)
        gather_ms[e2._gather_workers] = (time.perf_counter() - t0) / 8 * 1e3
        e2.close()
    # The recounts see both writes.
    assert ex.execute("big", f"Count(Intersect(Row(f={a2}), Row(f={b2})))")[0] == \
        want_pair(a2, b2)
    wants = [want_pair(int(p[0]), int(p[1])) if a2 in (int(p[0]), int(p[1])) else w
             for p, w in zip(pairs, ctx["wants"])]
    ctx["wants"] = wants
    assert [int(x) for x in eng.count_batch("big", calls, shards)] == wants
    assert eng.count_batch_async("big", calls, shards).cpu().numpy().tolist() == wants
    for q, kind in (("Sum(field=v)", "sum"), ("Max(field=v)", "max")):
        got = ex.execute("big", q)[0]
        assert (got.val, got.count) == want_vc(kind, nn), (q, got)
    now = eng.snapshot()
    dd = {k: now[k] - base[k] for k in ("leaf_delta_hits", "stack_delta_hits", "delta_bytes",
                                        "full_refresh_bytes")}
    # The BSI stack may have left the LRU stack cache since (e): then its
    # planes are refreshed one by one (leaf deltas) and restacked.
    assert dd["leaf_delta_hits"] >= 1 and dd["stack_delta_hits"] >= 1, dd
    assert dd["full_refresh_bytes"] == 0 and 0 < dd["delta_bytes"] <= 2048, dd
    end(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
    gib = 2 ** 30
    f["delta"] = dict(
        counters=dd, stack_leaves=len(slots), stack_gb=len(slots) * plane_bytes / 1e9,
        delta_host_ms=delta_host_ms, delta_device_ms=delta_dev_ms,
        device_ms_by=dict(delta="events around the scatter", full_refresh=full_how,
                          cold_gather=cold_how), clone_alone_ms=clone_ms,
        delta_peak_gib=delta_peak / gib, delta_peak_over_gib=(delta_peak - mem0) / gib,
        full_refresh_host_ms=full_host_ms, full_refresh_device_ms=full_dev_ms,
        full_refresh_bytes=regathered,
        full_refresh_peak_gib=full_peak / gib, full_refresh_peak_over_gib=(full_peak - mem1) / gib,
        cold_gather_host_ms=cold_host_ms, cold_gather_device_ms=cold_dev_ms,
        host_gather_ms_per_plane_by_workers=gather_ms)
    log(f"main (f2): Set on shard {s2_} and SetValue: Count, count_batch, Sum and Max equal "
        f"numpy; {dd}. The {len(slots)}-leaf stack ({len(slots) * plane_bytes / 1e9:.2f} GB) "
        f"refreshed by a delta in {delta_host_ms:.3f} ms host, {delta_dev_ms:.3f} ms device "
        f"(events around the scatter; the clone alone {clone_ms:.3f} ms), peak "
        f"{delta_peak / gib:.2f} GiB (+{(delta_peak - mem0) / gib:.2f}); without the delta path "
        f"(every leaf re-gathered, {regathered / 1e9:.2f} GB, and restacked) {full_host_ms:.3f} ms host, "
        f"{full_dev_ms:.3f} ms device ({full_how}), peak +{(full_peak - mem1) / gib:.2f} GiB; "
        f"the whole leaf set gathered from the host {cold_host_ms:.1f} ms host, "
        f"{cold_dev_ms:.3f} ms device ({cold_how}); host walk per plane by gather threads "
        f"{ {k: round(v, 3) for k, v in gather_ms.items()} } ms; "
        f"torch.equal to the rebuilt stack")

    # ---- (f3) tiering: a leaf cache of 8 planes, a 48-plane host tier
    keep, tier_planes, n_sweep = 8, 48, 32
    tcfg = TierConfig(host_bytes=tier_planes * plane_bytes, disk_bytes=0, prefetch_interval=0)
    ex_t = pt.Executor(ex.holder, engine_config=EngineConfig(
        leaf_cache_bytes=keep * plane_bytes, stack_cache_bytes=keep * plane_bytes),
        tier_config=tcfg)
    et = ex_t.engine
    # Memo off: the second touch below must reach the tier.
    with et.memos_off():
        ph = start("f3_sweep")
        t0 = time.perf_counter()
        for r in range(n_sweep):
            assert ex_t.execute("big", f"Count(Row(f={r}))")[0] == np_count(H[r]), r
        sweep_s = time.perf_counter() - t0
        assert et.tier.drain(timeout=300)
        tsnap = et.tier.snapshot()
        assert tsnap["demotions_host"] >= 16, tsnap
        end(ph, "gather_expr_count", quiet=(eng, et))
        q = "Count(Intersect(Row(f=0), Row(f=1)))"
        ph = start("f3_cold_host")
        t0 = time.perf_counter()
        got = ex_t.execute("big", q)[0]
        cold_ms = (time.perf_counter() - t0) * 1e3
        assert got == want_pair(0, 1), got
        assert et.snapshot()["host_cold_counts"] == 1
        end(ph, none=("gather_expr_count",), quiet=(eng, et), allow=("host_cold_counts",))
        ph = start("f3_promote")
        tb = et.snapshot()
        t0 = time.perf_counter()
        got = ex_t.execute("big", q)[0]
        promote_ms = (time.perf_counter() - t0) * 1e3
        assert got == want_pair(0, 1), got
        ta = et.snapshot()
        assert ta["leaf_tier_hits"] - tb["leaf_tier_hits"] == 2, (tb, ta)
        assert ta["host_cold_counts"] == 1 and ta["leaf_misses"] == tb["leaf_misses"]
        end(ph, "gather_expr_count", quiet=(eng, et), allow=("host_cold_counts",))
        f["tier"] = dict(leaf_cache_planes=keep, host_tier_bytes=tcfg.host_bytes,
                         swept=n_sweep, sweep_s=sweep_s, tier=et.tier.snapshot(),
                         cold_host_count_ms=cold_ms, promote_count_ms=promote_ms,
                         tier_promote_bytes=ta["tier_promote_bytes"] - tb["tier_promote_bytes"])
        log(f"main (f3): {n_sweep} rows swept through a {keep}-plane leaf cache in "
            f"{sweep_s:.1f} s, {tsnap['demotions_host']} planes demoted into a "
            f"{tcfg.host_bytes} B host tier ({tsnap['host_bytes']} B held); {q} first "
            f"answered on the host from the compressed bytes in {cold_ms:.1f} ms, then "
            f"promoted (leaf_tier_hits +2) and counted by K1 in {promote_ms:.1f} ms; both "
            f"equal numpy")
    ex_t.close()

    # ---- (f4) the fault ladder, on an Executor of its own (OOM
    # backpressure halves its budgets for its lifetime)
    ex_l = pt.Executor(ex.holder,
                       resilience_config=ResilienceConfig(device_breaker_failures=100))
    el = ex_l.engine
    try:
        ph = start("f4_error_count")
        failpoints.configure("device-dispatch", "error", count=1)
        got = ex_l.execute("big", "Count(Intersect(Row(f=2), Row(f=3)))")[0]
        failpoints.reset()
        assert got == want_pair(2, 3), got
        s = el.snapshot()
        assert s["host_counts"] == 1 and s["device_dispatch_errors"] == 1, s
        end(ph, none=("gather_expr_count",))
        ph = start("f4_error_topn")
        failpoints.configure("device-dispatch", "error")
        got = ex_l.execute("big", topn_q)[0]
        failpoints.reset()
        assert [(p.id, p.count) for p in got] == ranked(tfa), got
        s = el.snapshot()
        assert s["host_topn"] >= 1 and s["host_topn"] == s["device_dispatch_errors"] - 1, s
        end(ph, none=("masked_plane_counts",))
        ph = start("f4_oom_batch")
        failpoints.configure("device-dispatch", "oom", count=1)
        res = el.count_batch("big", calls, shards)
        failpoints.reset()
        assert [int(x) for x in res] == wants, "count_batch after an OOM != numpy"
        s = el.snapshot()
        assert s["oom_backpressure"] == 1 and s["oom_retries"] == 1, s
        end(ph, "gather_expr_count", "gather_expr_count_staged")
        # A real fault of a kernel on the card (a planted launch error) is
        # classified and recorded, then raised out of execute: no host rung.
        ph = start("f4_kernel_fault")
        real_check = kernels._check_launch

        def planted(name, err):
            raise RuntimeError(f"{name} kernel launch failed: cudaError 700")

        kernels._check_launch = planted
        fault = None
        try:
            ex_l.execute("big", "Count(Intersect(Row(f=4), Row(f=5)))")
        except DeviceKernelFault as e:
            fault = e.kind
        finally:
            kernels._check_launch = real_check
        s2 = el.snapshot()
        assert fault == "runtime" and s2["kernel_faults"] == 1, (fault, s2)
        assert s2["host_counts"] == s["host_counts"] and s2["host_topn"] == s["host_topn"], s2
        assert el.device_health.snapshot()["failures_runtime"] >= 1
        end(ph, none=("gather_expr_count",))
        s = s2
        ladder = {k: s[k] for k in LADDER}
    finally:
        failpoints.reset()
        ex_l.close()
    total = torch.cuda.mem_get_info()[1]
    try:  # more than the card holds: no cached block can serve it
        torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")
        raise AssertionError("allocating past the card's memory did not fail")
    except torch.cuda.OutOfMemoryError as e:
        oom_kind = classify_device_error(e)
        oom_text = str(e).splitlines()[0][:120]
    assert oom_kind == "oom", (oom_kind, oom_text)
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", BUILD_FAIL_SCRIPT, HERE],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    build_fail = json.loads(proc.stdout.strip().splitlines()[-1])
    assert build_fail["raised"] == "KernelBuildError", build_fail
    assert build_fail["on_card"] == "cuda" and build_fail["plane"] == "closed", build_fail
    assert not any(build_fail[k] for k in ("device_dispatch_errors", "host_counts", "host_topn",
                                           "dispatch_failures", "launches")), build_fail
    f["ladder"] = dict(counters=ladder, cuda_oom=oom_text, build_failure=build_fail)
    log(f"main (f4): device-dispatch=1*error under a Count and =error under a filtered TopN "
        f"answered by the host rung (equal numpy, K1/K2 not launched); =1*oom under a "
        f"count_batch: backpressure, one retry, K1 launched; a planted K1 launch error "
        f"raises DeviceKernelFault out of Executor.execute; ladder counters {ladder}; a "
        f"real CUDA OOM ({oom_text!r}) classifies {oom_kind}; a forced nvcc failure raises "
        f"{build_fail['raised']} out of Executor.execute with no dispatch error, no host "
        f"answer and the plane breaker closed")
    out["f"] = f


# ------------------------------------------------------------ path (g)

# Path (g)'s HTTP clients run in a process of their own (stdlib only), so
# their JSON and socket work does not share the server's GIL. stdin: {"port",
# "index", "work": [[pql, ...] per client]}; each client holds one
# keep-alive connection and sends its queries in order; all start at one
# barrier. stdout: {"wall_s", "clients": [[[latency_s, status, body], ...]]}.
HTTP_CLIENTS_SCRIPT = r"""
import http.client, json, sys, threading, time
cfg = json.load(sys.stdin)
work = cfg["work"]
t = {}
barrier = threading.Barrier(len(work), action=lambda: t.setdefault("start", time.perf_counter()))
out = [None] * len(work)

def run(i):
    conn = http.client.HTTPConnection("localhost", cfg["port"], timeout=600)
    res = []
    barrier.wait()
    for q in work[i]:
        t0 = time.perf_counter()
        conn.request("POST", "/index/%s/query" % cfg["index"], body=q.encode())
        r = conn.getresponse()
        body = r.read().decode()
        res.append([time.perf_counter() - t0, r.status, body])
    conn.close()
    out[i] = res

threads = [threading.Thread(target=run, args=(i,)) for i in range(len(work))]
for th in threads:
    th.start()
for th in threads:
    th.join()
print(json.dumps({"wall_s": time.perf_counter() - t["start"], "clients": out}))
"""


def http_clients(port: int, index: str, work):
    """Drive `work` (one list of PQL strings per client) from the client
    process; returns (wall_s, [[(latency_s, results)]]), failing on any
    answer that is not a 200."""
    proc = subprocess.run([sys.executable, "-c", HTTP_CLIENTS_SCRIPT],
                          input=json.dumps({"port": port, "index": index, "work": work}),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    clients = []
    for res in got["clients"]:
        for lat, status, body in res:
            assert status == 200, (status, body[:500])
        clients.append([(lat, json.loads(body)["results"]) for lat, _, body in res])
    return got["wall_s"], clients


def http(port: int, method: str, path: str, body=None):
    """One request on a fresh connection; (status, parsed JSON or text)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=300)
    try:
        data = body if body is None or isinstance(body, bytes) else (
            body.encode() if isinstance(body, str) else json.dumps(body).encode())
        conn.request(method, path, body=data)
        r = conn.getresponse()
        raw = r.read().decode()
    finally:
        conn.close()
    try:
        return r.status, json.loads(raw)
    except ValueError:
        return r.status, raw


def query(port: int, index: str, pql: str):
    status, got = http(port, "POST", f"/index/{index}/query", pql)
    assert status == 200, (pql, status, got)
    return got["results"]


def profiled_wall(torch, fn):
    """(fn()'s value, device ms of every kernel and copy torch.profiler
    recorded while fn ran, or None where it recorded none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        val = fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages())
    return val, (dev_us / 1e3 if dev_us else None)


def host_profile(fn, top: int = 15):
    """(fn()'s value, the `top` functions by own host time while fn ran,
    over every thread of this process: cProfile sees the server's
    threads too on Python 3.12)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    try:
        val = fn()
    finally:
        prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    return val, [dict(fn=f"{os.path.basename(f)}:{line}({name})", calls=nc,
                      own_ms=tt * 1e3, cum_ms=ct * 1e3)
                 for (f, line, name), (_, nc, tt, ct, _) in rows]


class GcPauses:
    """Python's gen-2 collections while a block runs, and their host ms
    (the server's threads stop for them)."""

    def __enter__(self):
        import gc

        self.n, self.ms, self._t0 = 0, 0.0, None
        self._cb = self._note
        gc.callbacks.append(self._cb)
        return self

    def _note(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)


def pct(xs, p):
    return float(np.percentile(np.asarray(xs) * 1e3, p))


def trace_stages(srv, index: str, n: int) -> dict:
    """p50 over the server's newest n traces of `index` (the recorder
    samples every query by default, its ring holds 256): the handler's
    whole span (`server`) and each stage's time per query, the durations
    of a stage's spans in one trace summed."""
    traces = srv.trace_recorder.traces(index=index, limit=n)
    per = {"server": [t["duration_ms"] for t in traces]}
    for t in traces:
        stage = {}
        for s in t["spans"]:
            stage[s["name"]] = stage.get(s["name"], 0.0) + s["dur_ms"]
        for name, ms in stage.items():
            per.setdefault(name, []).append(ms)
    out = {name: float(np.median(v)) for name, v in per.items()}
    out["traces"] = len(traces)
    return out


def unordered_pairs(rng, n_rows: int) -> np.ndarray:
    """Every unordered pair (a < b) of n_rows rows, shuffled: Intersect
    is commutative, so (a, b) and (b, a) share one canonical plan."""
    a, b = np.triu_indices(n_rows, k=1)
    every = np.stack([a, b], axis=1)
    return every[rng.permutation(len(every))]


def main_path_g(torch, pt, kernels, holder, H, bsi, rng, start, end, out,
                per_client=512, n_keys=1 << 20, device=None):
    """Path (g): one pilosa node over HTTP on the card. (g1) an in-process
    Server handed the 256-shard holder of (a)-(f); (g2) concurrent distinct
    Counts from C = 1, 8, 32 keep-alive clients through the scheduler and
    the micro-batcher; (g3) one client's HTTP overhead beside
    Executor.execute; (g4) TopN, Sum/Min/Max and coalesced Rows over HTTP;
    (g5) a keyed index of 1,048,576 column keys imported over HTTP; (g6)
    `python -m pilosa_tpu_torch.cli server` in a subprocess, restarted on
    its data directory, and a /debug/profile capture."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.server.server import Server

    n_rows, n_shards, n_words = H.shape
    g = {}
    # ---- (g1) the server, handed (a)-(f)'s holder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = Server(data_dir=None, port=0, cache_flush_interval=0, device=device)
    own_holder = srv.holder
    srv.open()
    own_holder.close()
    srv.holder = srv.executor.holder = holder
    port = srv.port
    eng = srv.executor.engine
    sched = srv.scheduler.config
    g["scheduler"] = dict(interactive_concurrency=sched.interactive_concurrency,
                          batch_window=sched.batch_window,
                          batch_window_max=sched.batch_window_max, batch_max=sched.batch_max)
    # A serving node holds its index in HBM: make every row of f resident
    # before the traffic, so (g2)-(g3) time serving, not cold gathers.
    from pilosa_tpu_torch.plan.signature import Leaf

    t0 = time.perf_counter()
    eng._leaf_tensor("big", [Leaf("f", "standard", r) for r in range(n_rows)],
                     tuple(range(n_shards)))
    torch.cuda.synchronize()
    g["resident_s"] = time.perf_counter() - t0
    log(f"main (g1): Server on {torch.cuda.get_device_name(0)} at localhost:{port}, "
        f"holder of (a)-(f) ({n_shards} shards x {n_rows} rows, made resident in "
        f"{g['resident_s']:.1f} s); scheduler {g['scheduler']}")

    bufs = threading.local()

    def want_pair(a, b):
        # popcount(H[a] & H[b]) into this thread's reused buffers: a fresh
        # 33.5 MB temporary per pair costs more than the AND itself.
        x, y = H[a].reshape(-1).view(np.uint64), H[b].reshape(-1).view(np.uint64)
        if getattr(bufs, "w", None) is None:
            bufs.w, bufs.c = np.empty_like(x), np.empty(x.shape, np.uint8)
        np.bitwise_and(x, y, out=bufs.w)
        np.bitwise_count(bufs.w, out=bufs.c)
        return int(bufs.c.sum(dtype=np.int64))

    def batcher_delta(b0):
        b1 = srv.batcher.snapshot()
        return {k: b1[k] - b0[k] for k in b1}

    try:
        # ---- (g2) concurrent distinct Counts over HTTP
        every = unordered_pairs(rng, n_rows)
        levels = {}
        want = {}  # numpy's count per pair, shared by the levels
        for c in (1, 8, 32):
            per = per_client
            n = c * per
            # Pairs cycle through every unordered pair; within a client
            # they are distinct, and the level runs with the memos off, so
            # no answer comes from the memo.
            sel = every[np.arange(n) % len(every)]
            work = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                     sel[i * per:(i + 1) * per]] for i in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                new = sorted({(int(a), int(b)) for a, b in sel} - want.keys())
                want.update(zip(new, pool.map(lambda p: want_pair(*p), new)))
            b0, e0 = srv.batcher.snapshot(), eng.snapshot()
            ph = start(f"g2_http_count_c{c}")
            with eng.memos_off(), GcPauses() as gcp:
                (wall_s, clients), dev_ms = profiled_wall(
                    torch, lambda: http_clients(port, "big", work))
            lat = []
            for i, res in enumerate(clients):
                for (a, b), (dt, results) in zip(sel[i * per:(i + 1) * per], res):
                    assert results == [want[(int(a), int(b))]], (a, b, results)
                    lat.append(dt)
            bd = batcher_delta(b0)
            e1 = eng.snapshot()
            k1 = {k: kernels.LAUNCHES[k] for k in ("gather_expr_count", "gather_expr_count_staged",
                                                    "gather_expr_count_streaming")}
            lv = dict(clients=c, queries=n, wall_s=wall_s, qps=n / wall_s,
                      p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), max_ms=max(lat) * 1e3,
                      first_ms=clients[0][0][0] * 1e3, batcher=bd,
                      mean_group=(bd["enqueued"] / bd["launches"]) if bd["launches"] else None,
                      k1_launches=k1,
                      stack_misses=e1["stack_misses"] - e0["stack_misses"],
                      stack_hits=e1["stack_hits"] - e0["stack_hits"],
                      memo_hits=e1["memo_hits"] - e0["memo_hits"],
                      gc_gen2=gcp.n, gc_gen2_ms=gcp.ms, device_ms=dev_ms,
                      idle_share=(1.0 - dev_ms / (wall_s * 1e3)) if dev_ms else None,
                      stages_p50_ms=trace_stages(srv, "big", min(n, 256)))
            assert lv["memo_hits"] == 0, lv
            if c >= 8:
                assert bd["coalesced"] > 0, lv
                assert k1["gather_expr_count"] < n, lv
            end(ph, "gather_expr_count", quiet=(eng,))
            levels[c] = lv
            log(f"main (g2) C={c}: {n} distinct Counts over HTTP equal numpy; "
                f"{lv['qps']:.1f} queries/s, p50 {lv['p50_ms']:.3f} ms, p99 "
                f"{lv['p99_ms']:.3f} ms, max {lv['max_ms']:.3f} ms (first "
                f"{lv['first_ms']:.3f} ms); gen-2 GCs {gcp.n} ({gcp.ms:.1f} ms); "
                f"batcher {bd} (mean group "
                f"{lv['mean_group']}); K1 {k1}; stack misses {lv['stack_misses']}; "
                f"device {dev_ms} ms of {wall_s * 1e3:.1f} ms wall, idle share "
                f"{lv['idle_share']}; p50 per stage of the last traces (ms) "
                f"{lv['stages_p50_ms']}")
        g["g2"] = levels
        # The same traffic at C = 8 under cProfile (slower, so not a level
        # of its own): where the server's host time goes.
        sel = every[np.arange(8 * 64) % len(every)][::-1]
        work = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in sel[i::8]]
                for i in range(8)]
        ph = start("g2_host_profile")
        with eng.memos_off():
            (wall_s, clients), top = host_profile(lambda: http_clients(port, "big", work))
        for i, res in enumerate(clients):
            for (a, b), (_, results) in zip(sel[i::8], res):
                assert results == [want[(int(a), int(b))]], (a, b, results)
        end(ph, "gather_expr_count", quiet=(eng,))
        g["g2_host_profile"] = dict(queries=len(sel), wall_s=wall_s, top=top)
        log(f"main (g2) host profile, C=8, {len(sel)} Counts in {wall_s:.2f} s under "
            f"cProfile, top functions by own time (ms): " + "; ".join(
                f"{t['fn']} {t['own_ms']:.0f} ({t['calls']} calls)" for t in top))

        # ---- (g3) one client: HTTP + admission beside Executor.execute
        sel = every[-min(64, len(every)):]
        qs = [f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in sel]
        ph = start("g3_http_overhead")
        with eng.memos_off():
            _, (res,) = http_clients(port, "big", [qs])
            direct = []
            for q in qs:
                t0 = time.perf_counter()
                srv.executor.execute("big", q)
                direct.append(time.perf_counter() - t0)
        for (a, b), (_, results) in zip(sel, res):
            assert results == [want_pair(int(a), int(b))], (a, b, results)
        end(ph, "gather_expr_count", quiet=(eng,))
        g["g3"] = dict(http_p50_ms=pct([r[0] for r in res], 50),
                       execute_p50_ms=pct(direct, 50),
                       stages_p50_ms=trace_stages(srv, "big", len(qs)))
        g["g3"]["http_share_ms"] = g["g3"]["http_p50_ms"] - g["g3"]["execute_p50_ms"]
        log(f"main (g3): 64 Counts, one client: HTTP p50 {g['g3']['http_p50_ms']:.3f} ms, "
            f"Executor.execute p50 {g['g3']['execute_p50_ms']:.3f} ms (memos off); HTTP, "
            f"JSON and admission {g['g3']['http_share_ms']:.3f} ms; p50 per stage of the "
            f"HTTP queries' traces (ms) {g['g3']['stages_p50_ms']}")

        # ---- (g4) the other query families over HTTP
        with ThreadPoolExecutor(max_workers=8) as pool:
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
        fa = int(rng.integers(n_rows))
        with ThreadPoolExecutor(max_workers=8) as pool:
            inter = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r] & H[fa]).sum(axis=1, dtype=np.int64),
                range(n_rows))))
        ph = start("g4_topn")
        t0 = time.perf_counter()
        got = query(port, "big", "TopN(f, n=10)")[0]
        g["topn_ms"] = (time.perf_counter() - t0) * 1e3
        assert [(p["id"], p["count"]) for p in got] == replay_topn(cache, cache, 10), got
        t0 = time.perf_counter()
        got = query(port, "big", f"TopN(f, Row(f={fa}), n=10)")[0]
        g["topn_filter_ms"] = (time.perf_counter() - t0) * 1e3
        assert [(p["id"], p["count"]) for p in got] == replay_topn(inter, cache, 10), got
        end(ph, "masked_plane_counts", quiet=(eng,))
        vals, nn, want_vc = bsi["vals"], bsi["nn"], bsi["want_vc"]
        fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
        ph = start("g4_bsi")
        for kind in ("sum", "min", "max"):
            got = query(port, "big", f"{kind.title()}(Row(f={fa}), field=v)")[0]
            assert (got["value"], got["count"]) == want_vc(kind, nn & fbits), (kind, got)
        end(ph, "masked_plane_counts", "bsi_minmax", quiet=(eng,))
        log(f"main (g4): TopN(f, n=10) {g['topn_ms']:.1f} ms and TopN(f, Row(f={fa}), n=10) "
            f"{g['topn_filter_ms']:.1f} ms over HTTP equal the numpy replay; Sum/Min/Max of v "
            f"with Row(f={fa}) equal numpy")

        # ---- (g5) key translation at scale: a keyed index over HTTP
        n_row_keys, chunk = 64, 1 << 16
        assert http(port, "POST", "/index/k", {"options": {"keys": True}})[0] == 200
        assert http(port, "POST", "/index/k/field/seg",
                    {"options": {"type": "set", "keys": True}})[0] == 200
        row_of = rng.integers(0, n_row_keys, n_keys)
        col_keys = [f"u{i}" for i in range(n_keys)]
        row_keys = [f"k{r}" for r in range(n_row_keys)]
        ph = start("g5_keys")
        t0 = time.perf_counter()
        for i in range(0, n_keys, chunk):
            status, body = http(port, "POST", "/index/k/field/seg/import", {
                "rowKeys": [row_keys[r] for r in row_of[i:i + chunk]],
                "columnKeys": col_keys[i:i + chunk]})
            assert status == 200, (status, body)
        import_s = time.perf_counter() - t0
        members = {k: [] for k in row_keys}
        for i, r in enumerate(row_of):
            members[row_keys[r]].append(col_keys[i])
        lat = []
        for k in row_keys:
            t0 = time.perf_counter()
            got = query(port, "k", f'Count(Row(seg="{k}"))')
            lat.append(time.perf_counter() - t0)
            assert got == [len(members[k])], (k, got)
        top = query(port, "k", "TopN(seg, n=5)")[0]
        want_top = sorted(((k, len(v)) for k, v in members.items()), key=lambda t: (-t[1], t[0]))
        assert [p["count"] for p in top] == [c for _, c in want_top[:5]], top
        assert all(len(members[p["key"]]) == p["count"] for p in top), top
        k0 = row_keys[int(rng.integers(n_row_keys))]
        row = query(port, "k", f'Row(seg="{k0}")')[0]
        assert sorted(row["keys"]) == sorted(members[k0]), k0
        end(ph, "gather_expr_count", quiet=(eng,))
        g["g5"] = dict(keys=n_keys, import_s=import_s, import_keys_per_s=n_keys / import_s,
                       count_p50_ms=pct(lat, 50), count_p99_ms=pct(lat, 99))
        log(f"main (g5): {n_keys} column keys over {n_row_keys} row keys imported over HTTP "
            f"in {import_s:.2f} s ({g['g5']['import_keys_per_s']:.0f} keys/s); Count per row "
            f"key p50 {g['g5']['count_p50_ms']:.3f} ms, p99 {g['g5']['count_p99_ms']:.3f} ms; "
            f"TopN(seg, n=5) keys and Row(seg=\"{k0}\")'s column keys equal the script's dict")

        # ---- (g4, last part) 8 concurrent Rows on the keyed index: the
        # micro-batcher coalesces them into bitmap_batch
        ph = start("g4_bitmap_batch")
        ks = row_keys[:8]
        coalesced = 0
        rounds = 0
        while not coalesced and rounds < 20:
            rounds += 1
            b0, d0 = srv.batcher.snapshot(), eng.snapshot()["bitmap_dispatches"]
            _, clients = http_clients(port, "k", [[f'Row(seg="{k}")'] for k in ks])
            for k, ((_, results),) in zip(ks, clients):
                assert sorted(results[0]["keys"]) == sorted(members[k]), k
            dispatches = eng.snapshot()["bitmap_dispatches"] - d0
            coalesced = batcher_delta(b0)["coalesced"] if dispatches < len(ks) else 0
        assert coalesced, f"no bitmap_batch in {rounds} rounds of 8 concurrent Rows"
        from pilosa_tpu_torch.pql.parser import parse

        ids = srv.translate_store.translate_rows_to_uint64("k", "seg", ks)
        calls = [parse(f"Row(seg={i})").calls[0] for i in ids]
        kshards = list(range(holder.index("k").max_shard() + 1))
        batch = eng.bitmap_batch("k", calls, kshards)
        for c_, r in zip(calls, batch):
            assert np.array_equal(r.columns(), eng.bitmap("k", c_, kshards).columns())
        end(ph, quiet=(eng,))
        g["g4_bitmap_batch"] = dict(rounds=rounds, coalesced=coalesced)
        log(f"main (g4): 8 concurrent Row(seg=k) over HTTP coalesced ({coalesced} joined a "
            f"group, round {rounds}); their keys equal the dict; bitmap_batch planes equal "
            f"per-call engine.bitmap")
        g["engine"] = eng.snapshot()
        g["batcher"] = srv.batcher.snapshot()
        g["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"main (g1): peak device memory over (g1)-(g5) "
            f"{g['max_memory_allocated_gib']:.2f} GiB")
    finally:
        srv.close()
    g["g6"] = cli_server_flow(device)
    out["g"] = g


def cli_server_flow(device=None):
    """(g6): `python -m pilosa_tpu_torch.cli server` on the card in a
    subprocess: the README's getting-started flow, a keyed Set, SIGTERM,
    a relaunch on the same data directory, the re-query, and a
    /debug/profile capture."""
    import shutil
    import signal
    import socket
    import tempfile

    data = tempfile.mkdtemp(prefix="pilosa-torch-cli-")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    res = {}

    def launch():
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir", data,
             "--bind", f"localhost:{port}"] + (["--device", device] if device else []),
            cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                return proc, line.strip(), time.perf_counter() - t0
        proc.wait(timeout=60)
        raise AssertionError("cli server did not start: " + "".join(lines)[-3000:])

    def stop(proc):
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        return proc.returncode

    proc = None
    try:
        proc, banner, res["start_s"] = launch()
        assert banner.startswith("pilosa-tpu server listening on"), banner
        assert http(port, "POST", "/index/repository", {})[0] == 200
        assert http(port, "POST", "/index/repository/field/stargazer", {})[0] == 200
        for col in (1, 2, 3, 1 << 20):
            assert query(port, "repository", f"Set({col}, stargazer=10)") == [True]
        assert query(port, "repository", "Count(Row(stargazer=10))") == [4]
        assert query(port, "repository", "TopN(stargazer, n=5)") == [[{"id": 10, "count": 4}]]
        assert http(port, "POST", "/index/users", {"options": {"keys": True}})[0] == 200
        assert http(port, "POST", "/index/users/field/seg",
                    {"options": {"type": "set", "keys": True}})[0] == 200
        for u in ("alice", "bob", "carol"):
            assert query(port, "users", f'Set("{u}", seg="fans")') == [True]
        before = query(port, "users", 'Row(seg="fans")')[0]
        status, schema = http(port, "GET", "/schema")
        assert status == 200 and {i["name"] for i in schema["indexes"]} == {"repository", "users"}
        status, st = http(port, "GET", "/status")
        assert status == 200 and st["state"] == "NORMAL", st
        status, dv = http(port, "GET", "/debug/vars")
        assert status == 200 and dv["engine_cache"]["count_dispatches"] > 0, dv.get("engine_cache")
        res["exit_first"] = stop(proc)
        proc, _, res["restart_s"] = launch()
        assert query(port, "repository", "Count(Row(stargazer=10))") == [4]
        after = query(port, "users", 'Row(seg="fans")')[0]
        assert after == before and sorted(after["keys"]) == ["alice", "bob", "carol"], after
        status, prof = http(port, "POST", "/debug/profile?seconds=1")
        assert status == 200 and os.path.exists(os.path.join(prof["path"], "trace.json")), prof
        res["exit_second"] = stop(proc)
        proc = None
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(data, ignore_errors=True)
    log(f"main (g6): `python -m pilosa_tpu_torch.cli server` on the card: getting-started "
        f"flow, /schema, /status, /debug/vars count_dispatches > 0; SIGTERM (exit "
        f"{res['exit_first']}), relaunch on the same directory: counts and key ids kept; "
        f"/debug/profile wrote a trace; start {res['start_s']:.1f} s, restart "
        f"{res['restart_s']:.1f} s")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--single", type=int, default=64)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pilosa_tpu_torch")):
        print("chip_smoke: pilosa_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import pilosa_tpu_torch as pt
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import engine as engine_mod

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvidia-smi: {smi}")
    report = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
              "seed": args.seed}

    t0 = time.perf_counter()
    build_s = kernels.build(force=True)
    kernels.load()
    log(f"build: nvcc sm_90a in {build_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    report["build_s"] = build_s

    rng = np.random.default_rng(args.seed)
    rows = check_kernels(torch, kernels, engine_mod, rng, np.random.default_rng([args.seed, 3]),
                         report, args.rows, args.shards, args.batch)
    launches = main_path(torch, pt, kernels, args, rng, report)

    source = "pilosa_tpu_torch/csrc/bitplane_kernels.cu"
    replaces = {"gather_expr_count": "pilosa_tpu/ops/pallas_kernels.py:145",
                "masked_plane_counts": "pilosa_tpu/parallel/engine.py:1922",
                "bsi_minmax": "pilosa_tpu/parallel/engine.py:2099"}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in rows.items()]}
    report["kernels"] = line["kernels"]
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=float)
    log(f"total {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
