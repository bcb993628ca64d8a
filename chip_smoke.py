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
             82 distinct slots, staged, the shared compare run once per
             chunk as a hoist program). K2 at R=128 and R=1,
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
             distinct pairs, then timed batches, (c) TopN(f, n=10) (also
             timed on an Executor of 8 workers beside one of 1, and one
             call under cProfile) and
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
             holder; (g2) distinct Count(Intersect(Row, Row)), 512, 128
             and 32 per client from C = 1, 8 and 32 keep-alive clients (a process
             of their own), memos off, at the scheduler's defaults:
             queries/s, p50/p99, the micro-batcher's groups, K1 launches
             by variant, stack misses, the device idle share (1 - the
             profiler's device time / wall time), the p50 of each stage
             in the server's trace recorder; at C >= 8 the batcher
             coalesces and K1 launches fewer times than there are
             queries; then 256 Counts at C = 8 under cProfile (the
             server's top functions by own host time); (g3) one client's 64 Counts over HTTP beside
             Executor.execute; (g4) TopN with and without a filter,
             Sum/Min/Max of v with a filter, and 8 concurrent keyed Rows
             coalesced into bitmap_batch (equal to per-call bitmaps);
             (g5) a keyed index of 64 row keys and 524,288 column keys
             imported over HTTP, a Count per row key, TopN with keys and
             one Row's column keys against a dict; (g6) `python -m
             pilosa_tpu_torch.cli server` in a subprocess on the card:
             the getting-started flow, /schema, /status, /debug/vars,
             SIGTERM, a relaunch on the same directory (counts and key
             ids kept) and a /debug/profile trace; (g4) also times TopN(f,
             n=10) over HTTP with the server executor's 8-worker pool and
             with none. (h) a static cluster on the card: (a)-(g)'s engine
             and holder closed, four in-process Servers, each with
             cluster_hosts naming all four, replica_n = 2 and the jump
             hasher, each holding exactly the shards its placement gives
             it of f (the same 256 x 128 planes), v (path (e)'s values)
             and a sparse field s (8 rows of 4096 bits over all shards),
             with a quarter of the default leaf and stack budgets each;
             (h1) distinct Count(Intersect(Row, Row)), 256 per client
             from C = 1 client and 32 per client from C = 8 (cut from
             512 since paths (i) and (j), from 64 since (i0)), round-robin
             over the nodes,
             memos off:
             queries/s, p50/p99, K1 launches by variant, the p50 of the
             coordinators' executor.fanout, remote:<peer> and reduce
             spans, the device idle share; (h2) from every node a nested
             set-op Count, Row(s=r) and Intersect(Row(s=r), Row(f=a)) as
             Rows, TopN(f, n=10), TopN(f, Row(f=a), n=10) (K2, two phases
             across nodes) and Sum/Min/Max of v with Row(f=a) (K2, K3,
             composed per node); (h3) a query node's link to one owner
             dropped by the client-send failpoint: 64 Counts answered
             from the replicas, the breaker open, then healed and
             re-closed; one node closed, the other three answering; (h4)
             a Set on one replica of a shard of s only, the replicas'
             Counts differing, the syncer's merge of that fragment, and
             the repaired replica's K1 Count equal to numpy through a
             delta refresh (full_refresh_bytes unmoved); one dense f
             fragment's block checksums timed. (i0) the collective
             plane's NCCL reduce: a subprocess builds the port's
             ReduceGroup on NCCL, world 1, on cuda:0 with a TCPStore of
             its own, reduces and gathers a payload with the status slot
             on the card, times one all_reduce of 256 int64 beside a
             one-rank gloo group, fails one reduce by an injected
             timeout and re-forms the group at generation 1, which
             reduces again. (i) the collective plane:
             (h)'s servers closed, the same planes of f and v written once
             to .npy files, four server processes on the card, each rank
             r of 4 in one job whose reduce backend is gloo (the four
             share the card; PILOSA_JAX_COORDINATOR /
             NUM_PROCESSES / PROCESS_ID), cluster_hosts naming all four,
             replica_n = 2, [collective] enabled with a 3000 ms barrier
             and group timeout and a 2 GiB leaf budget per rank; each
             fills its holder with its placement's shards from the
             memory-mapped planes and holds its collective block of every
             row of f resident; the script waits until every rank's
             collective.active() is true and drives each through a
             control directory (reset / report counters, a profiler
             window); (i1) distinct Count(Intersect(Row, Row)), 256 per
             client at C = 1 and 64 at C = 8, round-robin over the
             ranks, every one
             served by the collective plane (CollectiveCount equals the
             query count, no fallback): queries/s, p50/p99, collective
             entries and mean group, K1 launches per rank by variant, the
             leaders' collective.barrier and collective.entry span p50s,
             each rank's device time and peak memory, the device idle
             share; (i2) from every rank a nested set-op Count, TopN(f,
             n=10) and TopN(f, Row(f=a), n=10) (phase 2 collective),
             Sum/Min/Max of v with and without Row(f=a) (Min/Max counted
             over every rank: numpy's global answer, not (h)'s
             first-node fold), and one POST /internal/collective/count;
             (i3) one rank stopped with SIGSTOP for 32 Counts on another:
             every answer right through the fan-out's replicas, the
             barrier timed out, the plane's breaker open and the later
             queries past it without a barrier; SIGCONT, the half-open
             probe closes the plane and CollectiveCount climbs; the
             resumed rank read `abort` at the aborted barriers and every
             rank entered the same number of reduces; (i3b) rank 3's
             next reduce sleeps past the group's timeout: the Count is
             answered through the fan-out, every rank counts one group
             failure and one re-formation, and the plane serves a Count
             again (equal numpy) within 10 s; then SIGTERM to
             every rank, each exits 0 with its last counters. (i4) the
             four ranks again, each with `[engine] mesh-devices` 2 (8
             partitions on the card): (i1)'s first 64 Counts, (i2)'s
             queries from one rank, and v = V_MAX written to a null
             column of two shards one rank holds in its two partitions,
             then Max with and without the filter; every answer equal
             to (i)'s one-partition answer and numpy, K1/K2/K3 launched
             exactly 2 times per rank per collective entry, K1 staged
             once per rank per entry. (j) a
             cluster that changes shape, and the change stream: (j1)
             three server processes on the card with data directories
             (replica_n = 2, the jump hasher, live rebalance), each
             filled with its placement's shards of the first 64 shards
             of f, v and s (the planes (i) wrote); a fourth server
             process joins through join_addr while 8 clients (a process
             of their own, 50 ms between requests) run
             Count(Intersect(Row, Row)) over rows 0..31 and, every 4th
             request, a Set or a Clear of their own columns of row 128
             of f, round-robin over the first three nodes (a request
             refused at a cutover is sent again and counted):
             the rebalance's wall time, bytes and shards moved, cutover
             pauses, Counts/s and p50/p99 before, during and after the
             move, write p50/p99 and retries, K1 launches per node, the
             device idle share; (j2) every node's Counts, Count(Row(f=
             128)) against the acknowledged writes, Rows of s, TopN(f,
             n=10) and Sum/Min/Max of v with Row(f=a), and the joined
             node's own K1 Count over the shards it received; then
             /cluster/resize/remove-node takes the fourth node out under
             the same load, its shards move back, and (j2) holds again;
             (j3) one Server with index ev (f over 64 shards x 128 rows,
             written to its files, 256 Sets timed), reopened with [cdc]
             enabled (base images cut): 2048 single-bit Sets and Clears
             at positions 1..2048 (Set p50 with capture on and off),
             /cdc/stream from 0 gives every op in order,
             Count(Intersect(Row(f=a), Row(f=b))) with
             X-Pilosa-At-Position at J_PIT_POSITIONS positions equals a numpy replay
             (planes on the card, K2, K1 not launched, the live engine's
             counters unmoved) beside a live Count, and a standing
             Count(Row(f=a)) re-evaluates without a push after a write to
             row b and re-pushes after a write to row a. (k) geo
             replication, the mux transport and the autoscaler: (k1) a
             leader process over the first 32 shards of (j3)'s index ev
             (32 shards x 128 rows, a cut of its 64 for the time limit),
             `[cdc] enabled` with retention-ops 8192, `[geo] role =
             leader`; 8193 Sets of a row the reads never name fold its
             log once) and a follower process that bootstraps the whole
             index (a 410, then the base images); 4 writers send 2048
             Sets/Clears to the leader while 4 readers send
             Count(Intersect(Row(f=a), Row(f=b))) to the follower with
             X-Pilosa-Max-Staleness: 1, each answer a typed 409 or
             numpy's count after a prefix of the leader's change log
             (read back from its stream), then, at the head, the final
             count; a write to the follower answers the typed 409, POST
             /geo/promote, the old leader is fenced and re-tails the new
             one, both equal numpy; bootstrap seconds and bytes, lag,
             follower Count p50, promotion seconds, the follower's K1
             launches after its bootstrap; (k2) (h)'s four Servers with
             `[transport] enabled` (listening from the start; (h1)-(h4)
             hand their clients no mux): (h1)'s Counts at C = 1 and 8
             over the mux beside (h1)'s HTTP numbers, the transport
             counters (mux requests, no HTTP request, no handshake
             fallback), then one node's mux listener closed and 64
             Counts from the other three over the HTTP fallback; (k3)
             after (j2)'s leave, the fourth process starts a fresh
             standby Server and the coordinator's autoscaler (interval
             1 s, window 3, cooldown 0, scale-out-qps half its own
             reading of (j1)'s load before the join, scale-in-qps 0.5)
             joins it under (j)'s 8 clients and, its scale-in held
             until every node's answers after the join are read,
             removes it once they stop: the seconds from the first
             sample over (under) the mark to the action, each move's
             rebalance seconds, every node's answers after each
             move. (l) one node over 4 shard partitions, run after (f)
             on the same holder: an in-process Server with
             `[engine] mesh-devices` 4 (one
             partition per card where there are 4, else 4 on the
             first card) handed the holder; (l1) (a)'s Counts and
             nest, (b)'s count_batch, TopN with and without
             Row(f=a), Sum/Min/Max of v with and without it,
             Count(Range(v > x)), Row(f=a), and a Set and a SetValue
             each followed by recounts, every answer equal to the
             one-partition engine and numpy; K1, K2 and K3 launch
             once per partition per device call; the write refreshes
             the batch's stack on the written shard's block only
             (full_refresh_bytes unmoved); (b)'s batch timed over 4
             partitions beside 1; (l2) K1 staged, K2 on a 64-row chunk
             and K3 at one partition's block shape (S = 64) against
             their twins and bounds; peak memory per device; (l3)
             distinct Counts over HTTP, 256 at C = 1 and 64 per client
             at C = 8, equal numpy. (a) also checks
             engine.count_async's int64 device scalar against count.
             Every answer is checked against numpy on the fragments'
             host planes (TopN against a numpy replay of the two-phase
             ranking).
5. kernel line — launch counters set to 0 just before each path of
             phase 4 and read just after it: K1 above 0 in (a), (b), (d)
             and the Range Counts of (e) — its streaming variant only in
             the single Counts, its staged variant in the batches — K2
             above 0 in the filtered TopNs and in Sum, K3 above 0 in
             Min/Max, none of the three in the memo hits of (f1), the
             plain twins at 0 in every path and the compile gate's
             refusals at 0 (in (g): K1 above 0 in every Count level and
             in (g5), K2 in (g4)'s TopNs, K3 in its Min/Max; in (h): K1
             in every path, K2 and K3 in (h2); in (i): K1 on every rank
             in (i1), K1, K2 and K3 on every rank in (i2), the plain
             twins at 0 on every rank, each rank resetting and reporting
             its own counters, and in (i4) each kernel I4_MESH times per
             rank per entry; in (j): K1 in the join, the leave, the
             joined node's Count and the standing query, K1, K2 and K3
             in each (j2), K2 and not K1 on the point-in-time path; in
             (l): K1 in its Counts, batches and HTTP levels, K2 in its
             TopNs and Sum, K3 in its Min/Max, each a multiple of the
             4 partitions; in
             (k): K1 in the follower's reads after its bootstrap and
             after the promotion, in (k2)'s Counts and fallback, in
             (k3)'s autoscaled join, K1, K2 and K3 after each move);
             outside (f4) and (i3) the fault-ladder
             and host
             counters (host_counts, host_topn, device_dispatch_errors,
             oom_*, watchdog_timeouts, kernel_faults; host_cold_counts
             outside (f3)) are
             0 after every path, on every node's engine in (h), failover
             included, on every rank's in (i) and every node's in (j).
             The line carries the launch sums, (i)'s ranks included. The
             log lines of (h), (i), (j) and (k) carry the nvidia-smi name
             and power limit.

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
    # Every query shares the compare: the staged launch runs it as one
    # hoist program per chunk, each query `hoisted & row`.
    bq_plan = kernels._K1Staging(bq_idxs, list(bq_tape), None)
    bq_hoisted = bq_plan.n_hoist
    assert bq_hoisted == 1 and not bq_plan.bsi, bq_hoisted
    k1bq = {v: kernel_ms(torch, lambda v=v: kernels.gather_expr_count(
        batch, bq_idxs, bq_tape, variant=v), f"k1_{v}_kernel") for v in kernels.K1_VARIANTS}
    k1bq_ms, k1bq_method = k1bq["staged"]
    k1bq_plain_ms = cuda_time_ms(
        torch, lambda: kernels.gather_expr_count_plain(batch, bq_idxs, bq_tape), 1, warm=0)
    k1bq_bytes = batch.shape[0] * plane_bytes + bq_idxs.numel() * 4 + n_bq * 8
    k1bq_bound, k1bq_by = bound(k1bq_bytes, n_bq * s * w * (3 * depth + 5))
    log(f"K1 BSI count_batch shape (Q={n_bq}, L={depth + 2}, {batch.shape[0]} distinct slots, "
        f"S={s} W={w}): exact, max_abs_err 0 ({', '.join(ran)}; k1_plan {chosen}); "
        f"{bq_hoisted} hoisted span ({bq_plan.stages} ring stages of "
        f"{bq_hoisted + bq_plan.max_distinct} rows); staged {k1bq_ms:.4f} ms ({k1bq_method}), "
        f"streaming {k1bq['streaming'][0]:.4f} ms; bound {k1bq_bound:.4f} ms ({k1bq_by}, "
        f"{k1bq_bytes / 1e9:.3f} GB), staged at {k1bq_bound / k1bq_ms:.3f} of it; the serving "
        f"shape's staged {k1_ms:.4f} ms in this run; twin {k1bq_plain_ms:.2f} ms")
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
    # Path (i)'s shapes: each rank's (k, W) blocks, k = 67 shards. K1 on a
    # two-leaf Count at Q = 1 (streaming), K2 on a 64-row TopN chunk and
    # the 18-plane Sum stack, K3 on the depth-17 scan, all masked but K1.
    k = 67
    k67 = {}
    pair = rand_planes((2, k, w))
    pair_idx = torch.arange(2, dtype=torch.int32).reshape(-1, 1)
    pair_tape = P(("Intersect", (leaf(0), leaf(1))))
    k1_hold("path (i)'s Count at k = 67", pair, pair_idx, pair_tape)
    chunk = rand_planes((64, k, w))
    bsi_k = bsi[:, :k].contiguous()
    mask_k = mask[:k].contiguous()
    for name, st, m in (("topn_chunk", chunk, mask_k), ("sum_stack", bsi_k, mask_k)):
        if not torch.equal(kernels.masked_plane_counts(st, m),
                           kernels.masked_plane_counts_plain(st, m)):
            raise AssertionError(f"K2 {name} at k = {k}: kernel != twin")
    for maximize in (True, False):
        got = kernels.bsi_minmax(bsi_k, mask_k, maximize)
        want = kernels.bsi_minmax_plain(bsi_k, mask_k, maximize)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
            raise AssertionError(f"K3 at k = {k} max={maximize}: kernel != twin")
    for name, run, plain, kname, nbytes, ops, per_call in (
            ("k1_count", lambda: kernels.gather_expr_count(pair, pair_idx, pair_tape),
             lambda: kernels.gather_expr_count_plain(pair, pair_idx, pair_tape),
             "k1_streaming_kernel", 2 * k * w * 4 + 8 + 8, 2 * k * w, False),
            ("k2_topn_chunk", lambda: kernels.masked_plane_counts(chunk, mask_k),
             lambda: kernels.masked_plane_counts_plain(chunk, mask_k),
             "masked_plane_counts_kernel", (65 * k * w + 64 * k) * 4, 64 * k * w * 3, False),
            ("k2_sum_stack", lambda: kernels.masked_plane_counts(bsi_k, mask_k),
             lambda: kernels.masked_plane_counts_plain(bsi_k, mask_k),
             "masked_plane_counts_kernel", ((depth + 2) * k * w + (depth + 1) * k) * 4,
             (depth + 1) * k * w * 3, False),
            ("k3_minmax", lambda: kernels.bsi_minmax(bsi_k, mask_k, True),
             lambda: kernels.bsi_minmax_plain(bsi_k, mask_k, True),
             "bsi_minmax", (depth + 2) * k * w * 4 + depth * 4 + 8, k * w * 3 * depth, True)):
        ms, method = kernel_ms(torch, run, kname, 20, per_call=per_call)
        plain_ms = cuda_time_ms(torch, plain, 3, warm=1)
        b_ms, b_by = bound(nbytes, ops)
        k67[name] = dict(ms=ms, method=method, plain_ms=plain_ms, bytes=nbytes,
                         bound_ms=b_ms, bound_by=b_by)
    report["kernel_phase_k67"] = k67
    log(f"path (i)'s shapes, k = {k} shards per rank, exact against the twins: " + "; ".join(
        f"{name} {r['ms']:.4f} ms ({r['method']}), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), twin {r['plain_ms']:.3f} ms" for name, r in k67.items()))
    del pair, chunk, bsi_k, mask_k
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
                             streaming_ms=k1bq["streaming"][0], hoisted_spans=bq_hoisted,
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


def build_index(pt, rng, n_shards: int, n_rows: int, device=None):
    """bench_big's holder: dense-container injection of random planes."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.storage.bitmap import Container

    n_containers = SHARD_WIDTH >> 16
    holder = pt.Holder(None, device=device)
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


PATH_S = {}  # wall seconds of each timed path, for PERF.md's cuts


def timed_path(name, fn, *a, **kw):
    t0 = time.perf_counter()
    try:
        return fn(*a, **kw)
    finally:
        PATH_S[name] = round(time.perf_counter() - t0, 1)


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
    # engine.count_async: one K1 launch left on the card, read back
    # through numpy and int(), equal to count.
    a1, b1 = (int(x) for x in pairs_a[1])
    call = parse(f"Count(Intersect(Row(f={a1}), Row(f={b1})))").calls[0].children[0]
    pending = eng.count_async("big", call, shards)
    assert pending.tensor.is_cuda and pending.tensor.dtype == torch.int64, pending
    with eng.memos_off():
        assert int(np.asarray(pending)) == int(pending) == eng.count("big", call, shards) \
            == want_pair(a1, b1)
    log(f"main (a): Executor Count(Intersect) x{len(pairs_a)}, the "
        f"Union/Difference/Xor nest and a 40-row Union equal numpy (first, cold: "
        f"{out['count_cold_s']:.2f} s); engine.count_async's int64 device scalar equals "
        f"count")
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
    # 256 distinct pairs share no leaf position: nothing to hoist.
    end(ph, "gather_expr_count", "gather_expr_count_staged", none=("gather_expr_count_hoisted",))

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
    with GcPauses() as gcp:
        t0 = time.perf_counter()
        got = ex.execute("big", "TopN(f, n=10)")[0]
        out["topn_ms"] = (time.perf_counter() - t0) * 1e3
    out["topn_first_gc"] = (gcp.n, gcp.ms)
    want = replay_topn(cache, cache, 10)
    assert [(p.id, p.count) for p in got] == want, (got, want)
    # The unfiltered TopN is a per-shard walk of the rank caches on the
    # executor's pool: one Executor with no pool (workers 1, as `ex`) and
    # one with 8 workers (the server's), timed in turn.
    ex8 = pt.Executor(holder, workers=8)
    ex8._engine = eng
    reps = {1: [], 8: []}
    for _ in range(3):
        for w, e in ((1, ex), (8, ex8)):
            with GcPauses() as gcp:
                t0 = time.perf_counter()
                got = e.execute("big", "TopN(f, n=10)")[0]
                reps[w].append(((time.perf_counter() - t0) * 1e3, gcp.n, gcp.ms))
            assert [(p.id, p.count) for p in got] == want, (w, got)
    ex8._engine = None
    ex8.close()
    out["topn_workers_ms"] = reps
    got, top = host_profile(lambda: ex.execute("big", "TopN(f, n=10)")[0], top=8)
    out["topn_profile"] = top
    end(ph)
    log(f"main (c): TopN(f, n=10) (ms, gen-2 GCs, their ms) workers 1 {reps[1]}, "
        f"workers 8 {reps[8]}; one "
        f"call's top functions by own time (ms): " + "; ".join(
            f"{t['fn']} {t['own_ms']:.0f} ({t['calls']} calls)" for t in top))
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
        f"replay; {out['topn_ms']:.1f} ms (gen-2 GCs in it, their ms: "
        f"{out['topn_first_gc']}) and {out['topn_filter_ms']:.1f} ms warm "
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
    ctx = dict(pairs_a=pairs_a, nest_q=nest_q, calls=calls, pairs=pairs, wants=wants, fa=fa,
               slots=slots)
    timed_path("f", main_path_f, torch, pt, kernels, ex, eng, H, bsi, start, end, out, ctx)
    out["engine"] = eng.snapshot()
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # (l) draws from a generator of its own: the later paths' draws stay
    # as they were before it.
    timed_path("l", main_path_l, torch, pt, kernels, holder, ex, H, bsi, ctx,
               np.random.default_rng([args.seed, 12]), start, end, out, report["nvidia_smi"])
    ex.close()  # (g)'s server serves the same holder and closes it
    timed_path("g", main_path_g, torch, pt, kernels, holder, H, bsi, rng, start, end, out)
    # (g)'s server closed the holder and its engine; drop its fragments so
    # that (h)'s nodes do not share the host (and the collector) with them.
    holder.indexes.clear()
    del holder, ex, eng
    timed_path("h", main_path_h, torch, kernels, H, bsi, out["bsi"]["depth"], rng, start,
               end, out, report["nvidia_smi"])
    timed_path("i0", main_path_i0, out, report["nvidia_smi"])
    # (i)'s ranks are processes of their own: each resets and reports its
    # own counters around each of (i)'s paths, and the sums join phases.
    import shutil
    import tempfile

    planes_dir = tempfile.mkdtemp(prefix="pilosa-torch-planes-")
    try:
        planes = write_planes(H, bsi, out["bsi"]["depth"], planes_dir)
        prev = timed_path("i", main_path_i, torch, kernels, H, bsi, out["bsi"]["depth"], rng,
                          out, report["nvidia_smi"], phases, planes)
        timed_path("i4", main_path_i4, torch, kernels, H, bsi, out["bsi"]["depth"], out,
                   report["nvidia_smi"], phases, planes, prev)
        timed_path("j", main_path_j, torch, kernels, H, bsi, out["bsi"]["depth"], rng, start,
                   end, out, report["nvidia_smi"], phases, planes)
        timed_path("k1", main_path_k1, torch, kernels, H, rng, out, report["nvidia_smi"],
                   phases, planes)
    finally:
        shutil.rmtree(planes_dir, ignore_errors=True)
    log(f"main: seconds per path {PATH_S}")
    out["path_s"] = dict(PATH_S)
    launches = {k: sum(p["launches"][k] for p in phases.values())
                for k in kernels.LAUNCHES}
    out["phases"] = phases
    out["launches"] = launches
    report["main"] = out
    return launches


L_PARTITIONS = 4  # (l): the engine's shard partitions ([engine] mesh-devices)


def main_path_l(torch, pt, kernels, holder, ex, H, bsi, ctx, rng, start, end, out, smi,
                per_client=256, per_client_c8=64, device=None):
    """Path (l): one node over L_PARTITIONS shard partitions, on (a)-(f)'s
    holder. An in-process Server with `[engine] mesh-devices` 4 (one
    partition per card where there are 4, else 4 on the first card) is
    handed the holder; its engine holds every plane as 4 blocks of 64
    shards and launches K1, K2 and K3 once per partition per device call.
    (l1) (a)'s Counts and nest, (b)'s count_batch, TopN with and without a
    filter, Sum/Min/Max of v with and without one, Count(Range(v > x)), a
    Row, a Set and a SetValue each followed by recounts (a delta on the
    written shard's block only) against the one-partition engine `ex`
    and numpy; (l2) K1, K2 and K3 at one partition's block shape against
    their twins and bounds, and (b)'s batch over 4 partitions beside 1;
    (l3) distinct Counts over HTTP at C = 1 and 8."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.constants import SHARD_WIDTH, VIEW_BSI_GROUP_PREFIX
    from pilosa_tpu_torch.parallel import EngineConfig
    from pilosa_tpu_torch.plan.signature import Leaf
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.server.server import Server

    n_rows, n_shards, n_words = H.shape
    shards = list(range(n_shards))
    P = L_PARTITIONS
    eng = ex.engine
    vals, nn, fa, fbits, want_vc = (bsi[k] for k in ("vals", "nn", "fa", "fbits", "want_vc"))
    depth = out["bsi"]["depth"]
    lo = {"partitions": P, "smi": smi}
    bufs = threading.local()

    def want_pair(a, b):
        x, y = H[a].reshape(-1).view(np.uint64), H[b].reshape(-1).view(np.uint64)
        if getattr(bufs, "w", None) is None:
            bufs.w, bufs.c = np.empty_like(x), np.empty(x.shape, np.uint8)
        np.bitwise_and(x, y, out=bufs.w)
        np.bitwise_count(bufs.w, out=bufs.c)
        return int(bufs.c.sum(dtype=np.int64))

    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)
    srv = Server(data_dir=None, port=0, cache_flush_interval=0,
                 engine_config=EngineConfig(mesh_devices=P), device=device)
    own_holder = srv.holder
    srv.open()
    own_holder.close()
    srv.holder = srv.executor.holder = holder
    ex4 = srv.executor
    eng4 = ex4.engine
    lo["mesh"] = [str(d) for d in eng4.mesh]
    assert eng4.n_devices == P and eng.n_devices == 1, (eng4.mesh, eng.mesh)
    where = ("one partition per card" if len(set(eng4.mesh)) == P
             else f"{P} partitions on {eng4.mesh[0]}")
    log(f"main (l) [{smi}]: an engine of {P} partitions ({where}: {lo['mesh']}) beside the "
        f"one-partition engine on {eng.mesh}; {torch.cuda.device_count()} card(s) visible")

    def launched(fn):
        """(fn()'s value, the kernel launches it made)."""
        torch.cuda.synchronize()
        k0 = dict(kernels.LAUNCHES)
        val = fn()
        torch.cuda.synchronize()
        return val, {k: kernels.LAUNCHES[k] - k0[k] for k in k0}

    def both(q):
        """ex4's answer, which must equal the one-partition engine's."""
        got, ref = ex4.execute("big", q)[0], ex.execute("big", q)[0]
        if hasattr(got, "segments"):  # a Row: its planes, shard by shard
            assert sorted(got.segments) == sorted(ref.segments), q
            assert all(torch.equal(got.segments[s], ref.segments[s]) for s in got.segments), q
        elif hasattr(got, "val"):
            assert (got.val, got.count) == (ref.val, ref.count), (q, got, ref)
        else:
            norm = (lambda r: [(p.id, p.count) for p in r]) if isinstance(got, list) else (
                lambda r: r)
            assert norm(got) == norm(ref), (q, got, ref)
        return got

    try:
        t0 = time.perf_counter()
        # ---- (l1) Counts: (a)'s pairs and nest; one K1 launch per partition
        ph = start("l1_count")
        pairs_a = ctx["pairs_a"]
        for a, b in pairs_a:
            got = both(f"Count(Intersect(Row(f={a}), Row(f={b})))")
            assert got == want_pair(int(a), int(b)), (a, b, got)
        nest = both(ctx["nest_q"])
        a0, b0 = (int(x) for x in pairs_a[0])
        call = parse(f"Count(Intersect(Row(f={a0}), Row(f={b0})))").calls[0].children[0]
        with eng4.memos_off():
            got, n1 = launched(lambda: eng4.count("big", call, shards))
            pending, n2 = launched(lambda: int(eng4.count_async("big", call, shards)))
        assert got == pending == want_pair(a0, b0), (got, pending)
        k1_per_call = n1["gather_expr_count"]
        assert n1["gather_expr_count"] == n2["gather_expr_count"] == P, (n1, n2)
        end(ph, "gather_expr_count", "gather_expr_count_streaming", quiet=(eng, eng4))
        log(f"main (l1): {len(pairs_a)} Count(Intersect) and the nest ({nest}) over {P} "
            f"partitions equal the one-partition engine and numpy; count and count_async "
            f"launch K1 {k1_per_call:.0f} times each (once per partition)")

        # ---- (b)'s 256-query count_batch: one K1 launch per partition
        calls, wants = ctx["calls"], ctx["wants"]
        ph = start("l1_count_batch")
        t1 = time.perf_counter()
        res, n1 = launched(lambda: eng4.count_batch("big", calls, shards))
        lo["batch_cold_s"] = time.perf_counter() - t1
        assert [int(x) for x in res] == wants, "count_batch over partitions != numpy"
        assert n1["gather_expr_count_staged"] == n1["gather_expr_count"] == P, n1
        ref = eng.count_batch("big", calls, shards)
        with eng4.memos_off():
            got, n2 = launched(lambda: eng4.count_batch("big", calls, shards))
        assert got.tolist() == ref.tolist() == wants
        assert n2["gather_expr_count"] == P, n2
        end(ph, "gather_expr_count", "gather_expr_count_staged", quiet=(eng, eng4))
        plans = [eng4.plan("big", c) for c in calls]
        slots = list(eng4._batch_slot_gather(plans, len(plans))[0])
        stack = eng4._stacked_leaf_tensor("big", slots, tuple(shards))
        assert len(stack) == P and all(
            b.shape == (len(slots), n_shards // P, n_words) and b.device == d
            for b, d in zip(stack, eng4.mesh)), [(b.shape, b.device) for b in stack]
        # The batch's wall time over P partitions beside one, in one run.
        walls = {1: [], P: []}
        for _ in range(2):
            for e_, n_ in ((eng, 1), (eng4, P)):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(4):
                    e_.count_batch_async("big", calls, shards)
                torch.cuda.synchronize()
                walls[n_].append((time.perf_counter() - t1) / 4 * 1e3)
        lo["batch_ms"] = {str(k): min(v) for k, v in walls.items()}
        log(f"main (l1): count_batch Q={len(calls)} over {P} partitions equals numpy and the "
            f"one-partition engine (cold {lo['batch_cold_s']:.2f} s incl. gathers); K1 staged "
            f"launched {P} times per batch; stack of {len(slots)} slots in {P} blocks of "
            f"{n_shards // P} shards; ms per batch (best of 2 x 4, host clock): 1 partition "
            f"{lo['batch_ms']['1']:.3f}, {P} partitions {lo['batch_ms'][str(P)]:.3f}")

        # ---- TopN with and without Row(f=fa); K2 once per partition
        ph = start("l1_topn")
        top = both("TopN(f, n=10)")
        top_f = both(f"TopN(f, Row(f={fa}), n=10)")
        # The TopNs above stacked the candidates in chunks of 64 rows.
        rows_req = list(range(min(64, n_rows)))
        src = parse(f"Row(f={fa})").calls[0]
        for flt in (None, src):
            ref = eng.topn_counts("big", "f", rows_req, shards, src_call=flt)
            with eng4.memos_off():
                got, n1 = launched(lambda: eng4.topn_counts("big", "f", rows_req, shards,
                                                            src_call=flt))
            assert n1["masked_plane_counts"] == P, n1
            assert got.tolist() == ref.tolist(), flt
        end(ph, "masked_plane_counts", quiet=(eng, eng4))
        log(f"main (l1): TopN(f, n=10) {[(p.id, p.count) for p in top[:3]]}... and "
            f"TopN(f, Row(f={fa}), n=10) equal the one-partition engine; topn_counts with and "
            f"without the filter launch K2 {P} times each")

        # ---- Sum/Min/Max of v, with and without Row(f=fa); K2 and K3 per partition
        ph = start("l1_bsi")
        for kind in ("sum", "min", "max"):
            for flt, mask in (("", nn), (f"Row(f={fa}), ", nn & fbits)):
                got = both(f"{kind.title()}({flt}field=v)")
                assert (got.val, got.count) == want_vc(kind, mask), (kind, flt, got)
        for kind, kname in (("sum", "masked_plane_counts"), ("max", "bsi_minmax"),
                            ("min", "bsi_minmax")):
            ref = eng.bsi_val_count("big", "v", kind, depth, shards, filter_call=src)
            with eng4.memos_off():
                got, n1 = launched(lambda: eng4.bsi_val_count(
                    "big", "v", kind, depth, shards, filter_call=src))
            assert n1[kname] == P, (kind, n1)
            if kind == "sum":
                assert got.tolist() == ref.tolist()
            else:
                assert got[0].tolist() == ref[0].tolist() and got[1] == ref[1], (kind, got, ref)
        end(ph, "masked_plane_counts", "bsi_minmax", quiet=(eng, eng4))
        log(f"main (l1): Sum/Min/Max(field=v) with and without Row(f={fa}) equal numpy and the "
            f"one-partition engine; Sum launches K2 and Min/Max K3 {P} times each")

        # ---- Count(Range(v > x)) and a Row
        ph = start("l1_range_row")
        x_gt = bsi["x_gt"]
        got = both(f"Count(Range(v > {x_gt}))")
        assert got == int(np.count_nonzero(nn & (vals > x_gt))), got
        row = both(f"Row(f={fa})")
        assert row.count() == np_count(H[fa]), row.count()
        end(ph, "gather_expr_count", quiet=(eng, eng4))
        log(f"main (l1): Count(Range(v > {x_gt})) and Row(f={fa}) ({row.count()} columns, "
            f"blocks joined in shard order) equal numpy and the one-partition engine")

        # ---- a Set and a SetValue, each followed by recounts: the stale
        # stacks refresh by a delta on the written shard's block alone.
        ph = start("l1_writes")
        shard = n_shards * 5 // 8
        part = shard // (n_shards // P)
        col = int(np.flatnonzero(np.unpackbits(H[a0, shard].view(np.uint8),
                                               bitorder="little") == 0)[0])
        base = eng4.snapshot()
        before = eng4._stacked_leaf_tensor("big", slots, tuple(shards))
        assert ex4.execute("big", f"Set({shard * SHARD_WIDTH + col}, f={a0})") == [True]
        H[a0, shard, col >> 5] |= np.uint32(1 << (col & 31))
        assert both(f"Count(Intersect(Row(f={a0}), Row(f={b0})))") == want_pair(a0, b0)
        wants = [want_pair(int(p[0]), int(p[1])) if a0 in (int(p[0]), int(p[1])) else w
                 for p, w in zip(ctx["pairs"], wants)]
        ctx["wants"] = wants
        assert [int(x) for x in eng4.count_batch("big", calls, shards)] == wants
        after = eng4._stacked_leaf_tensor("big", slots, tuple(shards))
        moved = [p for p in range(P) if after[p] is not before[p]]
        assert moved == [part], (moved, part)
        vcol = int(np.flatnonzero(~nn[shard])[0])
        new_val = 65432
        eq_before = int(np.count_nonzero(nn & (vals == new_val)))
        assert ex4.execute("big", f"SetValue(col={shard * SHARD_WIDTH + vcol}, "
                                  f"v={new_val})") == [None]
        vals[shard, vcol], nn[shard, vcol] = new_val, True
        assert both(f"Count(Range(v == {new_val}))") == eq_before + 1
        got = both("Sum(field=v)")
        assert (got.val, got.count) == want_vc("sum", nn), got
        now = eng4.snapshot()
        dd = {k: now[k] - base[k] for k in ("leaf_delta_hits", "stack_delta_hits",
                                            "delta_bytes", "full_refresh_bytes")}
        assert dd["full_refresh_bytes"] == 0 and dd["stack_delta_hits"] >= 2, dd
        end(ph, "gather_expr_count", "masked_plane_counts", quiet=(eng, eng4))
        lo["writes"] = dict(counters=dd, shard=shard, partition=part)
        log(f"main (l1): a Set on shard {shard} (partition {part}) and a SetValue, then "
            f"recounts: equal numpy; the batch's stack refreshed on block {moved} only, "
            f"the others kept; {dd}")
        lo["l1_s"] = time.perf_counter() - t0

        # ---- (l2) K1, K2 and K3 at one partition's block shape
        t0 = time.perf_counter()
        blk = after[0]  # (U, S/P, W) on partition 0's device
        idx_np = np.stack(eng4._batch_slot_gather(plans, len(plans))[1])
        idx_t = torch.from_numpy(idx_np.astype(np.int32))
        tape = plans[0].expr.tape
        got = kernels.gather_expr_count(blk, idx_t, tape, variant="staged")
        want = kernels.gather_expr_count_plain(blk, idx_t, tape)
        k1_err = int((got - want).abs().max())
        assert k1_err == 0, "K1 at a partition's block != twin"
        distinct = len(np.unique(idx_np))
        s_b = blk.shape[1]
        k1_ms, k1_how = kernel_ms(torch, lambda: kernels.gather_expr_count(
            blk, idx_t, tape, variant="staged"), "k1_staged_kernel")
        k1_plain = cuda_time_ms(torch, lambda: kernels.gather_expr_count_plain(
            blk, idx_t, tape), 1, warm=0)
        k1_bytes = distinct * s_b * n_words * 4 + idx_np.size * 4 + len(calls) * 8
        k1_bound, k1_by = bound(k1_bytes, len(calls) * s_b * n_words * 2)
        chunk = blk[:64]  # a TopN chunk of 64 candidate rows
        r_c = chunk.shape[0]
        mask = eng4._src_plane("big", src, tuple(shards))[0]
        vstack = eng4._stacked_leaf_tensor("big", [
            Leaf("v", VIEW_BSI_GROUP_PREFIX + "v", i) for i in range(depth + 1)],
            tuple(shards))[0]
        k2_err = int((kernels.masked_plane_counts(chunk, mask)
                      - kernels.masked_plane_counts_plain(chunk, mask)).abs().max())
        kb, kc = kernels.bsi_minmax(vstack, mask, True)
        pb, pc = kernels.bsi_minmax_plain(vstack, mask, True)
        k3_err = max(int((kb - pb).abs().max()), abs(int(kc) - int(pc)))
        assert k2_err == 0 and k3_err == 0, (k2_err, k3_err)
        k2_ms, k2_how = kernel_ms(torch, lambda: kernels.masked_plane_counts(chunk, mask),
                                  "masked_plane_counts_kernel", 20)
        k2_plain = cuda_time_ms(torch, lambda: kernels.masked_plane_counts_plain(chunk, mask),
                                3, warm=1)
        k2_bytes = ((r_c + 1) * s_b * n_words + r_c * s_b) * 4
        k2_bound, k2_by = bound(k2_bytes, r_c * s_b * n_words * 3)
        k3_ms, k3_how = kernel_ms(torch, lambda: kernels.bsi_minmax(vstack, mask, True),
                                  "bsi_minmax", 20, per_call=True)
        k3_plain = cuda_time_ms(torch, lambda: kernels.bsi_minmax_plain(vstack, mask, True),
                                3, warm=1)
        k3_bytes = (depth + 2) * s_b * n_words * 4 + depth * 4 + 8
        k3_bound, k3_by = bound(k3_bytes, s_b * n_words * 3 * depth)
        lo["block_kernels"] = {
            "k1_staged": dict(shape=[len(slots), s_b, n_words, int(idx_np.shape[0]),
                                     len(calls)], distinct_slots=distinct, ms=k1_ms,
                              method=k1_how, plain_ms=k1_plain, bytes=k1_bytes,
                              bound_ms=k1_bound, bound_by=k1_by),
            "k2_topn_chunk": dict(shape=[r_c, s_b, n_words], ms=k2_ms, method=k2_how,
                                  plain_ms=k2_plain, bytes=k2_bytes, bound_ms=k2_bound,
                                  bound_by=k2_by),
            "k3_minmax": dict(shape=[depth + 1, s_b, n_words], ms=k3_ms, method=k3_how,
                              plain_ms=k3_plain, bytes=k3_bytes, bound_ms=k3_bound,
                              bound_by=k3_by)}
        log(f"main (l2) [{smi}]: at one partition's block (S={s_b}), exact against the "
            "twins: " + "; ".join(
                f"{k} {r['shape']} {r['ms']:.4f} ms ({r['method']}), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of "
                f"it, twin {r['plain_ms']:.2f} ms" for k, r in lo["block_kernels"].items()))
        del blk, chunk, mask, vstack, before, after, stack
        lo["peak_gib"] = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                          for d in sorted({d for d in eng4.mesh}, key=str)}
        log(f"main (l2): peak memory per device (GiB): {lo['peak_gib']}")
        lo["l2_s"] = time.perf_counter() - t0

        # ---- (l3) distinct Counts over HTTP, memos off
        t0 = time.perf_counter()
        every = unordered_pairs(rng, n_rows)
        levels = {}
        for c in (1, 8):
            per = {1: per_client, 8: per_client_c8}[c]
            n = c * per
            off = 0 if c == 1 else per_client
            sel = every[(off + np.arange(n)) % len(every)]
            work = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                     sel[i * per:(i + 1) * per]] for i in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                want = list(pool.map(lambda p: want_pair(int(p[0]), int(p[1])), sel))
            ph = start(f"l3_http_count_c{c}")
            with eng4.memos_off():
                wall_s, clients = http_clients(srv.port, "big", work)
            lat = []
            for i, res in enumerate(clients):
                for j, (dt, results) in enumerate(res):
                    assert results == [want[i * per + j]], (c, i, j, results)
                    lat.append(dt)
            k1 = kernels.LAUNCHES["gather_expr_count"]
            assert k1 > 0 and k1 % P == 0, k1
            # K1's host work and staging once per device call: one copy per
            # distinct device among the partitions, not one per launch.
            staged = kernels.STAGED["gather_expr_count"]
            assert staged == k1 // P * len(set(eng4.mesh)), (staged, k1)
            end(ph, "gather_expr_count", quiet=(eng, eng4))
            levels[c] = dict(queries=n, wall_s=wall_s, qps=n / wall_s, p50_ms=pct(lat, 50),
                             p99_ms=pct(lat, 99), k1_launches=k1, staging_copies=staged,
                             staging_per_count=staged / n)
            log(f"main (l3) C={c}: {n} distinct Counts over HTTP from a Server with "
                f"mesh-devices {P} equal numpy; {levels[c]['qps']:.1f} queries/s, p50 "
                f"{levels[c]['p50_ms']:.3f} ms, p99 {levels[c]['p99_ms']:.3f} ms; K1 "
                f"launched {k1} times ({k1 // P} device calls x {P} partitions); staging "
                f"copies {staged} ({staged / n:.3f} per Count)")
        lo["http"] = levels
        lo["l3_s"] = time.perf_counter() - t0
        lo["engine"] = eng4.snapshot()
    finally:
        # The holder stays open for (g): the server closes its own.
        srv.holder = srv.executor.holder = own_holder
        srv.close()
    out["l"] = lo


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
    # The shared compare ran as a hoist program of the staged launch.
    end(ph, "gather_expr_count_staged", "gather_expr_count_hoisted",
        none=("gather_expr_count_streaming",))
    log(f"main (e): count_batch of {n_b} Count(Intersect(Row(f=r), Range(v > {x_gt}))) equals "
        f"numpy, staged with its compare hoisted; {e['bsi_batch_ms']:.3f} ms per warm batch "
        f"(host clock)")

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
    bits, count = kernels.bsi_minmax(planes.joined(), mask.joined(), True)
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
    clone_ms = cuda_time_ms(torch, lambda: refreshed.joined().clone(), 3)
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
    assert torch.equal(refreshed.joined(), rebuilt.joined()), \
        "delta-refreshed stack != stack from host planes"
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

# Path (g)'s and (h)'s HTTP clients run in a process of their own (stdlib
# only), so their JSON and socket work does not share the servers' GIL.
# stdin: {"ports", "index", "work": [[pql, ...] per client]}; client i
# sends its j-th query to ports[(i + j) % len(ports)] over one keep-alive
# connection per port, in order; all start at one barrier. stdout:
# {"wall_s", "clients": [[[latency_s, status, body], ...]]}.
HTTP_CLIENTS_SCRIPT = r"""
import http.client, json, sys, threading, time
cfg = json.load(sys.stdin)
work, ports = cfg["work"], cfg["ports"]
t = {}
barrier = threading.Barrier(len(work), action=lambda: t.setdefault("start", time.perf_counter()))
out = [None] * len(work)

def run(i):
    conns = [http.client.HTTPConnection("localhost", p, timeout=600) for p in ports]
    res = []
    barrier.wait()
    for j, q in enumerate(work[i]):
        conn = conns[(i + j) % len(ports)]
        t0 = time.perf_counter()
        conn.request("POST", "/index/%s/query" % cfg["index"], body=q.encode())
        r = conn.getresponse()
        body = r.read().decode()
        res.append([time.perf_counter() - t0, r.status, body])
    for conn in conns:
        conn.close()
    out[i] = res

threads = [threading.Thread(target=run, args=(i,)) for i in range(len(work))]
for th in threads:
    th.start()
for th in threads:
    th.join()
print(json.dumps({"wall_s": time.perf_counter() - t["start"], "clients": out}))
"""


def http_clients(port, index: str, work):
    """Drive `work` (one list of PQL strings per client) from the client
    process against one port, or round-robin over a list of ports;
    returns (wall_s, [[(latency_s, results)]]), failing on any answer
    that is not a 200."""
    ports = list(port) if isinstance(port, (list, tuple)) else [port]
    proc = subprocess.run([sys.executable, "-c", HTTP_CLIENTS_SCRIPT],
                          input=json.dumps({"ports": ports, "index": index, "work": work}),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    clients = []
    for res in got["clients"]:
        for lat, status, body in res:
            assert status == 200, (status, body[:500])
        clients.append([(lat, json.loads(body)["results"]) for lat, _, body in res])
    return got["wall_s"], clients


def http(port: int, method: str, path: str, body=None, headers=None):
    """One request on a fresh connection; (status, parsed JSON or text)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=300)
    try:
        data = body if body is None or isinstance(body, bytes) else (
            body.encode() if isinstance(body, str) else json.dumps(body).encode())
        conn.request(method, path, body=data, headers=headers or {})
        r = conn.getresponse()
        raw = r.read().decode()
    finally:
        conn.close()
    try:
        return r.status, json.loads(raw)
    except ValueError:
        return r.status, raw


def http_raw(port: int, path: str):
    """One GET on a fresh connection; (status, the body's bytes)."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=300)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


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
                per_client=512, per_client_c8=128, per_client_c32=32, n_keys=1 << 19,
                device=None):
    """Path (g): one pilosa node over HTTP on the card. (g1) an in-process
    Server handed the 256-shard holder of (a)-(f); (g2) concurrent distinct
    Counts from C = 1, 8, 32 keep-alive clients through the scheduler and
    the micro-batcher; (g3) one client's HTTP overhead beside
    Executor.execute; (g4) TopN, Sum/Min/Max and coalesced Rows over HTTP;
    (g5) a keyed index of 524,288 column keys imported over HTTP; (g6)
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
            # C = 8 runs 256 queries per client and C = 32 64, not 512:
            # the script's time limit also holds paths (h)-(j).
            per = {1: per_client, 8: per_client_c8, 32: per_client_c32}[c]
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
            # One host-to-device staging copy per K1 device call.
            staged = kernels.STAGED["gather_expr_count"]
            assert staged == k1["gather_expr_count"], (staged, k1)
            lv = dict(clients=c, queries=n, wall_s=wall_s, qps=n / wall_s,
                      staging_copies=staged, staging_per_count=staged / n,
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
                f"{lv['mean_group']}); K1 {k1}; staging copies {staged} "
                f"({lv['staging_per_count']:.3f} per Count); stack misses {lv['stack_misses']}; "
                f"device {dev_ms} ms of {wall_s * 1e3:.1f} ms wall, idle share "
                f"{lv['idle_share']}; p50 per stage of the last traces (ms) "
                f"{lv['stages_p50_ms']}")
        g["g2"] = levels
        # The same traffic at C = 8 under cProfile (slower, so not a level
        # of its own): where the server's host time goes.
        sel = every[np.arange(8 * 32) % len(every)][::-1]
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
        # The same over HTTP with the server's 8-worker pool and with none.
        pool8 = srv.executor._pool
        reps = {1: [], 8: []}
        try:
            for _ in range(3):
                for w in (1, 8):
                    srv.executor._pool = pool8 if w == 8 else None
                    with GcPauses() as gcp:
                        t0 = time.perf_counter()
                        got = query(port, "big", "TopN(f, n=10)")[0]
                        reps[w].append(((time.perf_counter() - t0) * 1e3, gcp.n, gcp.ms))
                    assert [(p["id"], p["count"]) for p in got] == replay_topn(
                        cache, cache, 10), got
        finally:
            srv.executor._pool = pool8
        g["topn_workers_ms"] = reps
        log(f"main (g4): TopN(f, n=10) over HTTP (ms, gen-2 GCs, their ms), executor "
            f"workers 1 {reps[1]}, workers 8 {reps[8]}")
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
        # Drawn as for 2^20 keys (the count before the time limit cut it),
        # so that the later paths' draws stay as they were.
        row_of = rng.integers(0, n_row_keys, 1 << 20)[:n_keys]
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


# ------------------------------------------------------------ path (h)

H_NODES = 4
H_REPLICAS = 2
H_SPARSE_ROWS = 8
H_SPARSE_BITS = 4096  # bits per row of the sparse field s, over every shard


def free_ports(n: int):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("localhost", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


def free_port_pairs(n: int, offset: int):
    """n free ports whose twins (port + offset, a mux listener's) are free
    too."""
    import socket

    out = []
    while len(out) < n:
        (p,) = free_ports(1)
        if p + offset > 65000 or p in out:
            continue
        probe = socket.socket()
        try:
            probe.bind(("localhost", p + offset))
        except OSError:
            continue
        finally:
            probe.close()
        out.append(p)
    return out


def bsi_planes(vals, nn, depth: int) -> np.ndarray:
    """One shard's (depth + 1, W) BSI planes from its values and not-null
    bits: planes 0..depth-1 the value bits under not-null, plane depth
    the not-null bits."""
    bits = np.unpackbits(vals.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
    planes = np.packbits(np.ascontiguousarray(bits[:, :depth].T), axis=1,
                         bitorder="little").view(np.uint32)
    nnw = np.packbits(nn, bitorder="little").view(np.uint32)
    return np.concatenate([planes & nnw, nnw[None]], axis=0)


def fill_node(srv, H, v_planes, sparse, n_shards: int) -> list:
    """Give one node exactly the shards its placement assigns it: f's
    dense planes from H and v's BSI planes (each a copy per node), and
    s's sparse bits. Returns the node's shards."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH, VIEW_BSI_GROUP_PREFIX
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.storage.bitmap import Container

    idx = srv.holder.create_index("big")
    f_view = idx.create_field("f").create_view_if_not_exists("standard")
    v = idx.create_field("v", FieldOptions(type="int", min=0, max=V_MAX))
    v_view = v.create_view_if_not_exists(VIEW_BSI_GROUP_PREFIX + "v")
    s_view = idx.create_field("s").create_view_if_not_exists("standard")
    idx.set_remote_max_shard(n_shards - 1)
    owned = [s for s in range(n_shards) if any(
        n.id == srv.node.id for n in srv.cluster.shard_nodes("big", s))]
    srows, scols = sparse
    n_rows, n_containers = H.shape[0], SHARD_WIDTH >> 16
    for shard in owned:
        frag = f_view.create_fragment_if_not_exists(shard, broadcast=False)
        words = H[:, shard].view(np.uint64).reshape(n_rows, n_containers, 1024).copy()
        counts = np.bitwise_count(words).sum(axis=2)
        for row in range(n_rows):
            for ci in range(n_containers):
                frag.storage.containers[row * n_containers + ci] = Container(
                    bits=words[row, ci], n=int(counts[row, ci]))
            frag.cache.bulk_add(row, int(counts[row].sum()))
        frag.cache.invalidate(force=True)
        vfrag = v_view.create_fragment_if_not_exists(shard, broadcast=False)
        for row, plane in enumerate(v_planes[shard]):
            pw = plane.view(np.uint64).reshape(-1, 1024)
            pc = np.bitwise_count(pw).sum(axis=1)
            for ci in range(pw.shape[0]):
                if pc[ci]:
                    vfrag.storage.containers[row * pw.shape[0] + ci] = Container(
                        bits=pw[ci].copy(), n=int(pc[ci]))
        sel = (scols // SHARD_WIDTH) == shard
        if sel.any():
            s_view.create_fragment_if_not_exists(shard, broadcast=False).bulk_import(
                srows[sel], scols[sel])
    return owned


def cluster_stages(servers, n: int) -> dict:
    """p50 over the coordinators' newest n traces of each node (traces
    holding an `executor.fanout` span; a forwarded leg records none) of
    the fan-out, the remote legs (every `remote:<peer>` span, each leg
    its own sample) and the reduce, plus the handler's whole span."""
    per = {"server": [], "executor.fanout": [], "remote": [], "reduce": []}
    for srv in servers:
        for t in srv.trace_recorder.traces(index="big", limit=n):
            names = [sp["name"] for sp in t["spans"]]
            if "executor.fanout" not in names:
                continue
            per["server"].append(t["duration_ms"])
            for sp in t["spans"]:
                if sp["name"].startswith("remote:"):
                    per["remote"].append(sp["dur_ms"])
                elif sp["name"] in per:
                    per[sp["name"]].append(sp["dur_ms"])
    out = {name: (float(np.median(v)) if v else None) for name, v in per.items()}
    out["traces"] = len(per["server"])
    return out


def fold_val_count(srv, kind: str, vals, mask, n_shards: int):
    """numpy's Min or Max as a cluster answers it: each node's (value,
    count) over the shards the fan-out gives it (this node's own, then
    each peer's, in the executor's order), folded with the reference's
    ValCount.smaller/larger, which keep the first node's count on a tie
    (executor.go's ValCount; pilosa_tpu/executor.py:150-167)."""
    local = [s for s in range(n_shards) if any(
        n.id == srv.node.id for n in srv.cluster.shard_nodes("big", s))]
    remote = {}
    for s in range(n_shards):
        if s not in local:
            remote.setdefault(srv.cluster.shard_nodes("big", s)[0].id, []).append(s)
    acc = (0, 0)
    for group in [local] + list(remote.values()):
        sel = vals[group][mask[group]]
        if not sel.size:
            continue
        best = int(sel.min() if kind == "min" else sel.max())
        vc = (best, int(np.count_nonzero(sel == best)))
        better = vc[0] < acc[0] if kind == "min" else vc[0] > acc[0]
        if acc[1] == 0 or better:
            acc = vc
    return acc


def main_path_h(torch, kernels, H, bsi, depth, rng, start, end, out, smi,
                per_client=256, per_client_c8=32, device=None):
    """Path (h): a static cluster of four nodes on one card. Four
    in-process Servers, every one with cluster_hosts naming all four,
    replica_n = 2 and the default jump hasher; each holds exactly the
    shards its placement gives it of f (256 shards x 128 rows, (a)-(g)'s
    planes), v (path (e)'s values) and a sparse field s. (h1) distinct
    HTTP Counts at C = 1 and 8, round-robin over the nodes; (h2) nested
    set-ops, Rows that cross nodes, TopN with and without a filter,
    Sum/Min/Max; (h3) failover: a dropped link, the breaker, then a node
    closed; (h4) anti-entropy repairs a replica written alone."""
    import contextlib
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch import failpoints
    from pilosa_tpu_torch.cluster.health import CLOSED
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.parallel import EngineConfig
    from pilosa_tpu_torch.plan.signature import Leaf
    from pilosa_tpu_torch.server.mux import TransportConfig
    from pilosa_tpu_torch.server.server import Server

    n_rows, n_shards, n_words = H.shape
    h = {"nodes": H_NODES, "replica_n": H_REPLICAS, "smi": smi}
    # Four engines share the card: each gets a quarter of the default
    # 16 GiB leaf + 16 GiB stack budgets, 8 GiB, split 5 + 3 (a setting of
    # this script): a node caches its leaves once for its own shards and
    # once more for the shards each peer sends it (a leaf is cached per
    # shard set), ~4.6 GiB of f and v.
    leaf_budget, stack_budget = 5 << 30, 3 << 30
    ports = free_port_pairs(H_NODES, K_MUX_OFF)
    hosts = [f"localhost:{p}" for p in ports]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    servers = [Server(
        data_dir=None, port=p, cluster_hosts=hosts, replica_n=H_REPLICAS,
        cache_flush_interval=0, anti_entropy_interval=0, member_monitor_interval=0,
        engine_config=EngineConfig(leaf_cache_bytes=leaf_budget,
                                   stack_cache_bytes=stack_budget),
        transport_config=TransportConfig(enabled=True, port_offset=K_MUX_OFF),
        device=device) for p in ports]
    for srv in servers:
        srv.open()
        # (h1)-(h4) fan out over HTTP; (k2) hands the client its mux.
        srv.client.mux = None
    # The sparse field s: H_SPARSE_BITS random columns per row over every
    # shard, so that a Row answer crossing nodes stays small on the wire.
    srows = np.repeat(np.arange(H_SPARSE_ROWS, dtype=np.uint64), H_SPARSE_BITS)
    scols = np.concatenate([np.sort(rng.choice(n_shards * SHARD_WIDTH, H_SPARSE_BITS,
                                               replace=False)).astype(np.uint64)
                            for _ in range(H_SPARSE_ROWS)])
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            v_planes = list(pool.map(lambda sh: bsi_planes(
                bsi["vals"][sh], bsi["nn"][sh], depth), range(n_shards)))
        owned = {}
        for srv in servers:
            owned[srv.node.id] = fill_node(srv, H, v_planes, (srows, scols), n_shards)
        del v_planes
        h["build_s"] = time.perf_counter() - t0
        by_node = {srv.node.id: len(owned[srv.node.id]) for srv in servers}
        assert sum(by_node.values()) == H_REPLICAS * n_shards, by_node
        engines = [srv.executor.engine for srv in servers]
        # Serving nodes hold their shards in HBM, as in (g1): every row of
        # f resident on each node over each shard set it serves — its own
        # shards (a query it coordinates) and, for each peer, the shards
        # that peer's fan-out sends it (the executor's own assignment).
        sets = {srv.node.id: {tuple(owned[srv.node.id])} for srv in servers}
        for srv in servers:
            _, remote = srv.executor._assign_shards("big", list(range(n_shards)))
            for nid, shards in remote.items():
                sets[nid].add(tuple(shards))
        t0 = time.perf_counter()
        for srv, eng in zip(servers, engines):
            for shards in sorted(sets[srv.node.id]):
                eng._leaf_tensor("big", [Leaf("f", "standard", r) for r in range(n_rows)],
                                 shards)
        torch.cuda.synchronize()
        h["resident_s"] = time.perf_counter() - t0
        h["shards_per_node"] = by_node
        h["shard_sets_per_node"] = {k: sorted(len(t) for t in v) for k, v in sets.items()}
        h["resident_gib"] = {srv.node.id: eng._leaf_bytes / 2**30
                             for srv, eng in zip(servers, engines)}
        log(f"main (h) [{smi}]: {H_NODES} Servers on {torch.cuda.get_device_name(0)} "
            f"(replica_n {H_REPLICAS}, jump hash), shards per node {by_node}; filled in "
            f"{h['build_s']:.1f} s; f resident on every node over each shard set it serves "
            f"(sizes {h['shard_sets_per_node']}) in {h['resident_s']:.1f} s, leaf GiB per node "
            f"{h['resident_gib']}; leaf + stack budgets {leaf_budget >> 30} + "
            f"{stack_budget >> 30} GiB per node")

        bufs = threading.local()

        def want_pair(a, b):
            x, y = H[a].reshape(-1).view(np.uint64), H[b].reshape(-1).view(np.uint64)
            if getattr(bufs, "w", None) is None:
                bufs.w, bufs.c = np.empty_like(x), np.empty(x.shape, np.uint8)
            np.bitwise_and(x, y, out=bufs.w)
            np.bitwise_count(bufs.w, out=bufs.c)
            return int(bufs.c.sum(dtype=np.int64))

        def memos_off():
            stack = contextlib.ExitStack()
            for eng in engines:
                stack.enter_context(eng.memos_off())
            return stack

        def peers_snapshot():
            return [srv.cluster.health.snapshot() for srv in servers]

        # ---- (h1) distinct Counts over HTTP, round-robin over the nodes
        every = unordered_pairs(rng, n_rows)
        want = {}
        levels = {}
        offset = 0
        for c in (1, 8):
            # C = 1 runs 256 queries per client and C = 8 32: the
            # script's time limit also holds paths (i0)-(k).
            per = per_client if c == 1 else per_client_c8
            n = c * per
            sel = every[(offset + np.arange(n)) % len(every)]
            offset += n
            work = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                     sel[i * per:(i + 1) * per]] for i in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                new = sorted({(int(a), int(b)) for a, b in sel} - want.keys())
                want.update(zip(new, pool.map(lambda p: want_pair(*p), new)))
            ph = start(f"h1_http_count_c{c}")
            with memos_off(), GcPauses() as gcp:
                (wall_s, clients), dev_ms = profiled_wall(
                    torch, lambda: http_clients(ports, "big", work))
            lat = []
            for i, res in enumerate(clients):
                for (a, b), (dt, results) in zip(sel[i * per:(i + 1) * per], res):
                    assert results == [want[(int(a), int(b))]], (a, b, results)
                    lat.append(dt)
            k1 = {k: kernels.LAUNCHES[k] for k in ("gather_expr_count", "gather_expr_count_staged",
                                                    "gather_expr_count_streaming")}
            lv = dict(clients=c, queries=n, wall_s=wall_s, qps=n / wall_s,
                      p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), max_ms=max(lat) * 1e3,
                      k1_launches=k1, gc_gen2=gcp.n, gc_gen2_ms=gcp.ms, device_ms=dev_ms,
                      idle_share=(1.0 - dev_ms / (wall_s * 1e3)) if dev_ms else None,
                      stages_p50_ms=cluster_stages(servers, min(n // H_NODES, 256)))
            end(ph, "gather_expr_count", quiet=engines)
            levels[c] = lv
            log(f"main (h1) [{smi}] C={c}: {n} distinct Counts over HTTP, round-robin over "
                f"{H_NODES} nodes, equal numpy; {lv['qps']:.1f} queries/s, p50 "
                f"{lv['p50_ms']:.3f} ms, p99 {lv['p99_ms']:.3f} ms, max {lv['max_ms']:.3f} ms; "
                f"K1 {k1}; gen-2 GCs {gcp.n} ({gcp.ms:.1f} ms); device {dev_ms} ms of "
                f"{wall_s * 1e3:.1f} ms wall, idle share {lv['idle_share']}; p50 of the "
                f"coordinators' spans (ms) {lv['stages_p50_ms']}")
        h["h1"] = levels
        h["h1_breakers"] = [p["breaker_opened"] for p in peers_snapshot()]
        assert not any(h["h1_breakers"]), h["h1_breakers"]

        # ---- (h2) answers that cross nodes
        fa, fb, fc, fd, fe = (int(x) for x in rng.choice(n_rows, 5, replace=False))
        sr = int(rng.integers(H_SPARSE_ROWS))
        with ThreadPoolExecutor(max_workers=8) as pool:
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
            inter = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r] & H[fa]).sum(axis=1, dtype=np.int64),
                range(n_rows))))
        nest = (f"Count(Union(Difference(Row(f={fa}), Row(f={fb})), "
                f"Xor(Row(f={fc}), Intersect(Row(f={fd}), Row(f={fe})))))")
        want_nest = np_count((H[fa] & ~H[fb]) | (H[fc] ^ (H[fd] & H[fe])))
        s_cols = scols[srows == sr].astype(np.int64)
        fbits_flat = np.unpackbits(H[fa].view(np.uint8), axis=1,
                                   bitorder="little").reshape(-1).view(bool)
        want_s_and_f = s_cols[fbits_flat[s_cols]]
        fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
        vals, nn, want_vc = bsi["vals"], bsi["nn"], bsi["want_vc"]
        ph = start("h2_cross_node")
        timed = {}
        e0 = [eng.snapshot() for eng in engines]
        with memos_off(), GcPauses() as gcp:
            # Each node twice: the first call gathers the leaves of the
            # shard sets it has not served yet (v's planes, TopN's
            # candidates), the repeat finds them resident.
            for rep in ("", "_warm"):
                for srv in servers:
                    def run(name, pql):
                        t0 = time.perf_counter()
                        got = query(srv.port, "big", pql)
                        timed.setdefault(name + rep, []).append(
                            (time.perf_counter() - t0) * 1e3)
                        return got

                    assert run("nest", nest) == [want_nest], srv.node.id
                    got = run("row", f"Row(s={sr})")[0]
                    assert got["columns"] == s_cols.tolist(), srv.node.id
                    got = run("row_and", f"Intersect(Row(s={sr}), Row(f={fa}))")[0]
                    assert got["columns"] == want_s_and_f.tolist(), srv.node.id
                    got = run("topn", "TopN(f, n=10)")[0]
                    assert [(p["id"], p["count"]) for p in got] == replay_topn(
                        cache, cache, 10), got
                    got = run("topn_filter", f"TopN(f, Row(f={fa}), n=10)")[0]
                    assert [(p["id"], p["count"]) for p in got] == replay_topn(
                        inter, cache, 10), got
                    for kind in ("sum", "min", "max"):
                        got = run(kind, f"{kind.title()}(Row(f={fa}), field=v)")[0]
                        want_k = (want_vc(kind, nn & fbits) if kind == "sum" else
                                  fold_val_count(srv, kind, vals, nn & fbits, n_shards))
                        assert (got["value"], got["count"]) == want_k, (kind, got, want_k)
        # The executor's own reduce: peers' Rows merged onto the card.
        row = servers[0].executor.execute("big", f"Row(s={sr})")[0]
        assert row.columns().astype(np.int64).tolist() == s_cols.tolist()
        assert all(seg.device.type == servers[0].holder.device.type
                   for seg in row.segments.values())
        end(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax", quiet=engines)
        h["h2_ms"] = timed
        h["h2_engines"] = {k: sum(e[k] - b[k] for e, b in zip(
            (eng.snapshot() for eng in engines), e0)) for k in (
            "leaf_misses", "leaf_hits", "stack_misses", "full_refresh_bytes",
            "leaf_evictions", "stack_evictions", "leaf_tier_hits")}
        h["h2_gc"] = (gcp.n, gcp.ms)
        log(f"main (h2) [{smi}]: from every node a Union/Difference/Xor nest, Row(s={sr}) "
            f"({len(s_cols)} columns over {n_shards} shards) and its Intersect with Row(f={fa}), "
            f"TopN(f, n=10), TopN(f, Row(f={fa}), n=10) and Sum/Min/Max of v with Row(f={fa}) "
            f"equal numpy (TopN the two-phase replay); a peer's Row merged on the card; ms per "
            f"node: " + "; ".join(f"{k} {', '.join(f'{x:.1f}' for x in v)}"
                                   for k, v in timed.items())
            + f"; gen-2 GCs {gcp.n} ({gcp.ms:.1f} ms); engines {h['h2_engines']}")

        # ---- (k2) (h1)'s Counts over the mux transport, then one node's
        # mux listener closed: its peers fall back to HTTP
        assert all(srv.mux_server.port == srv.port + K_MUX_OFF for srv in servers)
        for srv in servers:
            srv.client.mux = srv.mux_transport
        tr0 = [srv.transport_stats.snapshot() for srv in servers]
        k2 = {}
        for c in (1, 8):
            per = per_client if c == 1 else per_client_c8
            n = c * per
            sel = every[(offset + np.arange(n)) % len(every)]
            offset += n
            work = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                     sel[i * per:(i + 1) * per]] for i in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                new = sorted({(int(a), int(b)) for a, b in sel} - want.keys())
                want.update(zip(new, pool.map(lambda p: want_pair(*p), new)))
            ph = start(f"k2_mux_count_c{c}")
            with memos_off(), GcPauses() as gcp:
                (wall_s, clients), dev_ms = profiled_wall(
                    torch, lambda: http_clients(ports, "big", work))
            lat = []
            for i, res in enumerate(clients):
                for (a, b), (dt, results) in zip(sel[i * per:(i + 1) * per], res):
                    assert results == [want[(int(a), int(b))]], (a, b, results)
                    lat.append(dt)
            end(ph, "gather_expr_count", quiet=engines)
            k2[c] = dict(clients=c, queries=n, wall_s=wall_s, qps=n / wall_s,
                         p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), device_ms=dev_ms,
                         gc_gen2=gcp.n, http_qps=levels[c]["qps"],
                         http_p50_ms=levels[c]["p50_ms"])
            log(f"main (k2) [{smi}] C={c}: {n} distinct Counts, round-robin over {H_NODES} "
                f"nodes whose peer requests ride the mux, equal numpy; "
                f"{k2[c]['qps']:.1f} queries/s, p50 {k2[c]['p50_ms']:.3f} ms, p99 "
                f"{k2[c]['p99_ms']:.3f} ms (over HTTP in (h1): {levels[c]['qps']:.1f} "
                f"queries/s, p50 {levels[c]['p50_ms']:.3f} ms)")
        tr1 = [srv.transport_stats.snapshot() for srv in servers]
        mux_diff = {key: sum(b[key] - a[key] for a, b in zip(tr0, tr1))
                    for key in tr1[0] if key != "inflight_hwm"}
        assert mux_diff["requests_mux"] > 0, mux_diff
        assert mux_diff["requests_http"] == 0 and mux_diff["handshake_fallbacks"] == 0, mux_diff
        # One node's mux listener closes and drops its connections. Once
        # each peer's reader has seen its connection end, the peer's next
        # request to that node redials, is refused, demotes the node to
        # HTTP and goes over HTTP (a request racing the close would fail
        # as a transport error and take the other replica instead).
        shut = servers[-1]
        shut.mux_server.close()
        t0 = time.perf_counter()
        while any(not c.closed for c in (srv.mux_transport._conns.get(shut.node.uri)
                                         for srv in servers[:-1]) if c is not None):
            assert time.perf_counter() - t0 < 30, "a peer never saw its mux connection end"
            time.sleep(0.01)
        sel = every[:64]
        for a, b in sel:
            if (int(a), int(b)) not in want:
                want[(int(a), int(b))] = want_pair(int(a), int(b))
        ph = start("k2_mux_fallback")
        with memos_off():
            for i, (a, b) in enumerate(sel):
                got = query(ports[i % (H_NODES - 1)], "big",
                            f"Count(Intersect(Row(f={a}), Row(f={b})))")
                assert got == [want[(int(a), int(b))]], (a, b, got)
        end(ph, "gather_expr_count", quiet=engines)
        tr2 = [srv.transport_stats.snapshot() for srv in servers]
        fall_diff = {key: sum(b[key] - a[key] for a, b in zip(tr1, tr2))
                     for key in tr2[0] if key != "inflight_hwm"}
        assert fall_diff["requests_http"] > 0 and fall_diff["handshake_fallbacks"] > 0, \
            fall_diff
        for srv in servers:
            srv.client.mux = None
        # A request that met the closing connection failed as a transport
        # error and may have opened its breaker: the member probes close
        # every breaker before (h3) drops a link on purpose.
        opened = sum(srv.cluster.health.snapshot()["breaker_opened"] for srv in servers)
        t0 = time.perf_counter()
        while not all(p["state"] == CLOSED for srv in servers
                      for p in srv.cluster.health.snapshot()["peers"].values()):
            assert time.perf_counter() - t0 < 30, "the breakers did not close after (k2)"
            for srv in servers:
                srv._monitor_members()
        h["k2"] = dict(levels=k2, transport=mux_diff, fallback=fall_diff,
                       closed_listener=shut.node.id, breakers_opened=opened)
        log(f"main (k2) [{smi}]: transport over (k2)'s Counts {mux_diff}; {shut.node.id}'s "
            f"mux listener closed: 64 Counts from the other three equal numpy, their "
            f"requests to it over HTTP: {fall_diff}; breakers opened over (h) so far: "
            f"{opened}")

        # ---- (h3) failover: a dropped link, then a closed node
        q_srv = target = None
        for srv in servers:
            for shard in range(n_shards):
                owners = srv.cluster.shard_nodes("big", shard)
                if all(n.id != srv.node.id for n in owners):
                    q_srv, target = srv, owners[0]
                    break
            if q_srv is not None:
                break
        assert q_srv is not None, "every node holds every shard"
        sel = every[:64]
        for a, b in sel:
            if (int(a), int(b)) not in want:
                want[(int(a), int(b))] = want_pair(int(a), int(b))
        qs = [(f"Count(Intersect(Row(f={a}), Row(f={b})))", want[(int(a), int(b))])
              for a, b in sel]
        ph = start("h3_failover")
        b0 = q_srv.cluster.health.snapshot()
        failpoints.configure(f"client-send@{target.uri}", "drop")
        try:
            t0 = time.perf_counter()
            with memos_off():
                for pql, w in qs:
                    assert query(q_srv.port, "big", pql) == [w], pql
            drop_s = time.perf_counter() - t0
            b1 = q_srv.cluster.health.snapshot()
        finally:
            failpoints.reset()
        assert b1["peers"][target.id]["state"] != CLOSED, b1["peers"]
        assert b1["breaker_opened"] > b0["breaker_opened"], b1
        t0 = time.perf_counter()
        closed = False
        while time.perf_counter() - t0 < 30 and not closed:
            for srv in servers:
                srv._monitor_members()
            assert query(q_srv.port, "big", qs[0][0]) == [qs[0][1]]
            closed = all(p["state"] == CLOSED
                         for p in q_srv.cluster.health.snapshot()["peers"].values())
        recover_s = time.perf_counter() - t0
        assert closed, q_srv.cluster.health.snapshot()["peers"]
        # Close one node; the other three answer every query from the
        # replicas of its shards.
        victim = next(srv for srv in servers if srv is not q_srv)
        victim_ladder = {k: victim.executor.engine.snapshot()[k] for k in LADDER}
        assert not any(victim_ladder.values()), victim_ladder
        victim.close()
        alive = [srv for srv in servers if srv is not victim]
        t0 = time.perf_counter()
        with memos_off():
            for srv in alive:
                for pql, w in qs[:16]:
                    assert query(srv.port, "big", pql) == [w], (srv.node.id, pql)
        dead_s = time.perf_counter() - t0
        end(ph, "gather_expr_count", quiet=[srv.executor.engine for srv in alive])
        b2 = q_srv.cluster.health.snapshot()
        h["h3"] = dict(query_node=q_srv.node.id, dropped=target.id, drop_queries=len(qs),
                       drop_s=drop_s, recover_s=recover_s, closed_node=victim.node.id,
                       dead_queries=16 * len(alive), dead_s=dead_s,
                       breaker={k: b2[k] - b0[k] for k in (
                           "breaker_opened", "breaker_closed", "breaker_short_circuits",
                           "half_open_probes", "retries_spent", "retries_denied",
                           "hedges_fired", "hedges_won")})
        log(f"main (h3) [{smi}]: {q_srv.node.id}'s link to {target.id} dropped: {len(qs)} "
            f"Counts equal numpy from the replicas in {drop_s:.2f} s, breaker "
            f"{b1['peers'][target.id]['state']}; healed, breakers closed in {recover_s:.2f} s; "
            f"{victim.node.id} closed: {16 * len(alive)} Counts from the other three equal "
            f"numpy in {dead_s:.2f} s; breaker counters {h['h3']['breaker']}")

        # ---- (h4) anti-entropy: a Set on one replica only, then the
        # syncer. The divergence is in the sparse field s: the block merge
        # ships every bit of a differing 100-row block, and a dense block
        # of f holds ~52M bits. The sweep's step for that fragment runs
        # as sync_holder runs it; one dense f fragment's block checksums
        # (every set position hashed, 8 bytes per bit) are timed beside it.
        live = {srv.node.id: srv for srv in alive}
        shard = next(s for s in range(n_shards)
                     if all(n.id in live for n in alive[0].cluster.shard_nodes("big", s)))
        rep_a, rep_b = (live[n.id] for n in alive[0].cluster.shard_nodes("big", shard))
        s_set = set(s_cols.tolist())
        col = next(shard * SHARD_WIDTH + int(c) for c in np.flatnonzero(np.unpackbits(
            H[fa, shard].view(np.uint8), bitorder="little"))
            if shard * SHARD_WIDTH + int(c) not in s_set)
        b_shards = [s for s in range(n_shards) if any(
            n.id == rep_b.node.id for n in rep_b.cluster.shard_nodes("big", s))]
        pair_q = f"Count(Intersect(Row(s={sr}), Row(f={fa})))"
        row_q = f"Count(Row(s={sr}))"

        def local_count(srv, pql, shards):
            """A node's own answer over `shards` (a forwarded request:
            ?remote=true answers typed values, {"type", "value"})."""
            status, got = http(srv.port, "POST", "/index/big/query?remote=true",
                               {"query": pql, "shards": shards})
            assert status == 200, got
            return got["results"][0]["value"]

        def want_local(cols, shards):
            cols = np.asarray(sorted(cols), dtype=np.int64)
            return int(np.count_nonzero(np.isin(cols // SHARD_WIDTH, shards)
                                        & fbits_flat[cols]))

        ph = start("h4_anti_entropy")
        with memos_off():
            # Both replicas' leaves resident before the divergence.
            assert local_count(rep_b, pair_q, b_shards) == want_local(s_set, b_shards)
            before = [local_count(r, row_q, [shard]) for r in (rep_a, rep_b)]
            assert before[0] == before[1], before
            status, got = http(rep_a.port, "POST", "/index/big/query?remote=true",
                               f"Set({col}, s={sr})")
            assert status == 200 and got["results"] == [{"type": "bool", "value": True}], got
            counts = [local_count(r, row_q, [shard]) for r in (rep_a, rep_b)]
            assert counts == [before[0] + 1, before[1]], counts
            e0 = rep_b.executor.engine.snapshot()
            syncer = HolderSyncer(rep_a)
            t0 = time.perf_counter()
            syncer._sync_fragment("big", "s", "standard", shard,
                                  syncer._remote_replicas("big", shard))
            sync_s = time.perf_counter() - t0
            s_set.add(col)
            assert [local_count(r, row_q, [shard]) for r in (rep_a, rep_b)] == [counts[0]] * 2
            assert local_count(rep_b, pair_q, b_shards) == want_local(s_set, b_shards)
            e1 = rep_b.executor.engine.snapshot()
        dd = {k: e1[k] - e0[k] for k in ("leaf_delta_hits", "stack_delta_hits", "delta_bytes",
                                         "full_refresh_bytes")}
        assert dd["full_refresh_bytes"] == 0, dd
        assert dd["leaf_delta_hits"] + dd["stack_delta_hits"] >= 1, dd
        end(ph, "gather_expr_count", quiet=[srv.executor.engine for srv in alive])
        for srv in alive:
            assert query(srv.port, "big", pair_q) == [want_local(s_set, range(n_shards))]
        frag = rep_a.holder.fragment("big", "f", "standard", shard)
        frag.invalidate_checksums()
        t0 = time.perf_counter()
        n_blocks = len(frag.blocks())
        dense_blocks_s = time.perf_counter() - t0
        h["h4"] = dict(shard=shard, replicas=[rep_a.node.id, rep_b.node.id], sync_s=sync_s,
                       delta=dd, dense_fragment_blocks_s=dense_blocks_s,
                       dense_fragment_blocks=n_blocks)
        log(f"main (h4) [{smi}]: Set({col}, s={sr}) on {rep_a.node.id} alone: shard {shard}'s "
            f"{row_q} {counts[0]} there, {counts[1]} on {rep_b.node.id}; the syncer repaired "
            f"the fragment in {sync_s:.3f} s, and {rep_b.node.id}'s K1 {pair_q} over its "
            f"{len(b_shards)} shards equals numpy, refreshed by a delta {dd}; one dense f "
            f"fragment's {n_blocks} block checksums took {dense_blocks_s:.2f} s")
        h["engines"] = {srv.node.id: srv.executor.engine.snapshot() for srv in alive}
        h["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"main (h) [{smi}]: peak device memory over (h) "
            f"{h['max_memory_allocated_gib']:.2f} GiB")
    finally:
        failpoints.reset()
        for srv in servers:
            if srv.opened:
                srv.close()
    out["h"] = h


# ------------------------------------------------------------ path (i)

I0_TIMEOUT_MS = 1000  # (i0): the one-rank groups' reduce timeout
I0_VALUES = 256       # (i0): int64 values of the timed reduce
I0_REPS = 200         # (i0): timed reduces of each backend

# Path (i0): the port's own ReduceGroup on NCCL, world 1, on cuda:0, with
# a TCPStore of its own, in a process of its own (NCCL's state stays out
# of the script's). Prints one line, "I0 <json>".
I0_SCRIPT = r"""
import json, socket, sys, time

sys.path.insert(0, sys.argv[1])
timeout_ms, n, reps = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
import torch
import torch.distributed as tdist

from pilosa_tpu_torch.parallel import distributed as dist

s = socket.socket()
s.bind(("localhost", 0))
port = s.getsockname()[1]
s.close()
dev = torch.device("cuda", 0)
store = tdist.TCPStore("localhost", port, 1, True)
out = {"device": torch.cuda.get_device_name(0), "timeout_ms": timeout_ms}
t0 = time.perf_counter()
group = dist.ReduceGroup(store, "nccl", 0, 1, dev, timeout_ms)
out["form_ms"] = (time.perf_counter() - t0) * 1e3
# The plane's payload: the status slot in front of the values, on the card.
payload = torch.empty(n + 1, dtype=torch.int64, device=dev)
payload[0] = 0
payload[1:] = torch.arange(1, n + 1, device=dev)
got = group.all_reduce_sum(payload.clone())
assert got.device == dev and torch.equal(got, payload)
rows = group.all_gather(payload)
assert rows.device == dev and tuple(rows.shape) == (1, n + 1) and torch.equal(rows[0], payload)
out["reduce"] = out["gather"] = "equal, on the card"
gloo = dist.ReduceGroup(tdist.PrefixStore("i0-gloo", store), "gloo", 0, 1, "cpu", timeout_ms)
x_dev = torch.arange(n, dtype=torch.int64, device=dev)
x_host = x_dev.cpu()


def timed(fn):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3


# One all_reduce of n int64 values on each backend, then each as the
# plane runs it: NCCL reduces on the card and copies the result to the
# host; gloo copies the rank's result to the host and reduces there.
out["nccl_ms"] = timed(lambda: group.all_reduce_sum(x_dev))
out["gloo_ms"] = timed(lambda: gloo.all_reduce_sum(x_host))
out["nccl_plane_ms"] = timed(lambda: group.all_reduce_sum(x_dev).cpu())
out["gloo_plane_ms"] = timed(lambda: gloo.all_reduce_sum(x_dev.cpu()))


class NeverDone:
    # The work of a reduce a peer never comes to.
    def __init__(self, work):
        self.work = work

    def is_completed(self):
        return False


real = group._complete
group._complete = lambda work, timeout_ms=None: real(NeverDone(work), timeout_ms)
t0 = time.perf_counter()
try:
    group.all_reduce_sum(payload.clone())
    raise AssertionError("the injected timeout did not fail the reduce")
except dist.ReduceFailed as e:
    out["failure"] = str(e)
out["failed_after_ms"] = (time.perf_counter() - t0) * 1e3
assert group.failed is not None
t0 = time.perf_counter()
again = group.reform(1)
out["reform_ms"] = (time.perf_counter() - t0) * 1e3
assert again.generation == 1 and torch.equal(again.all_reduce_sum(payload.clone()), payload)
out["generation"] = again.generation
again.abort()
gloo.abort()
print("I0 " + json.dumps(out), flush=True)
"""


def main_path_i0(out, smi):
    """Path (i0): the collective plane's NCCL reduce on the one card. A
    subprocess builds the port's ReduceGroup with NCCL, world 1, on
    cuda:0: it reduces and gathers a payload with the status slot on the
    card, times one all_reduce of I0_VALUES int64 values beside the same
    reduce on a one-rank gloo group, fails one reduce by an injected
    timeout (a work that never completes) and re-forms the group at
    generation 1, which reduces again."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", I0_SCRIPT, HERE, str(I0_TIMEOUT_MS),
                           str(I0_VALUES), str(I0_REPS)],
                          capture_output=True, text=True, timeout=300, cwd=HERE)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("I0 ")), None)
    assert proc.returncode == 0 and line, (proc.returncode, proc.stdout[-2000:],
                                           proc.stderr[-4000:])
    i0 = json.loads(line[3:])
    i0["wall_s"] = time.perf_counter() - t0
    out["i0"] = i0
    log(f"main (i0) [{smi}]: NCCL ReduceGroup, world 1, on {i0['device']}: formed in "
        f"{i0['form_ms']:.1f} ms; reduce and gather of {I0_VALUES} + 1 int64 (the status "
        f"slot) {i0['reduce']}; one all_reduce of {I0_VALUES} int64 NCCL "
        f"{i0['nccl_ms']:.4f} ms, gloo {i0['gloo_ms']:.4f} ms (mean of {I0_REPS}, host "
        f"clock); as the plane reduces (NCCL then one copy to the host; a copy then gloo) "
        f"{i0['nccl_plane_ms']:.4f} ms against {i0['gloo_plane_ms']:.4f} ms; an injected "
        f"timeout failed a reduce after {i0['failed_after_ms']:.1f} ms ({i0['failure']}); "
        f"re-formed at generation {i0['generation']} in {i0['reform_ms']:.1f} ms and "
        f"reduced again, equal; {i0['wall_s']:.1f} s with the process")


I_RANKS = 4
I_TIMEOUT_MS = 3000      # barrier and process-group timeout of path (i)'s job
I_CLIENT_TIMEOUT = 5.0   # s: a server's peer requests (30 s by default)
I_LEAF_BUDGET = 2 << 30  # [collective] leaf-budget-bytes per rank (default 256 MiB)
I_STOP_COUNTS = 32

class WorkerCommands:
    """The main thread of a server process of (i) or (j). It answers the
    script's commands (files `<r>.<n>.cmd` in the control directory,
    answered as `<r>.<n>.json`) until SIGTERM, then writes a last report
    as `<r>.final.json`. Every process answers `reset` (the kernels'
    launch counters and the peak device memory), `report`,
    `profile_start` and `profile_stop` (the device time of a
    torch.profiler window; None in a CPU rehearsal); a path adds its
    own commands. Made first thing in the process, so that a SIGTERM
    during start-up ends it too."""

    def __init__(self, torch, kernels, cfg: dict, r: int):
        import signal

        self.torch, self.kernels, self.ctl, self.r = torch, kernels, cfg["ctl"], r
        self.cuda = cfg["device"] != "cpu"  # None: the card
        self.stop = []
        self.prof = None
        signal.signal(signal.SIGTERM, lambda *a: self.stop.append(1))

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def max_mem_gib(self):
        return self.torch.cuda.max_memory_allocated() / 2**30 if self.cuda else None

    def reset(self, cmd):
        self.sync()
        self.kernels.reset_counters()
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()
        return {}

    def profile_start(self, cmd):
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile

            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return {}

    def profile_stop(self, cmd):
        if not self.cuda:
            return {"device_ms": None}
        self.sync()
        self.prof.__exit__(None, None, None)
        us = sum(getattr(ev, "self_device_time_total", 0)
                 for ev in self.prof.key_averages())
        self.prof = None
        return {"device_ms": us / 1e3}

    def _write(self, name: str, obj) -> None:
        tmp = os.path.join(self.ctl, f"{self.r}.{name}.tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f, default=float)
        os.replace(tmp, os.path.join(self.ctl, f"{self.r}.{name}.json"))

    def serve(self, report, close, **ops) -> None:
        """Answer commands with `ops` (name -> function of the command)
        and the shared ones until SIGTERM; then `report()`, `close()`,
        and the report written for `RankJob.stop`."""
        ops = dict(reset=self.reset, profile_start=self.profile_start,
                   profile_stop=self.profile_stop, report=lambda cmd: report(), **ops)
        n = 0
        while not self.stop:
            path = os.path.join(self.ctl, f"{self.r}.{n}.cmd")
            if os.path.exists(path):
                with open(path) as f:
                    cmd = json.load(f)
                try:
                    reply = {"ok": ops[cmd["op"]](cmd)}
                except Exception as e:  # the script reads it and fails the path
                    reply = {"error": f"{type(e).__name__}: {e}"}
                self._write(str(n), reply)
                n += 1
            time.sleep(0.005)
        final = report()
        close()
        self._write("final", final)


# One rank of path (i)'s job: a port Server on the card, rank `rank` of
# I_RANKS in one gloo group (the reference's three variables), holding the
# shards its placement gives it of f and v from the memory-mapped planes
# the script wrote. Besides WorkerCommands' own, it answers `ready` and
# reports the engine, collective and batcher counters and the leader's
# span p50s.
WORKER_I = r"""
import json, os, sys, time

cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, cfg["here"])
os.environ["PILOSA_JAX_COORDINATOR"] = cfg["coordinator"]
os.environ["PILOSA_JAX_NUM_PROCESSES"] = str(len(cfg["ports"]))
os.environ["PILOSA_JAX_PROCESS_ID"] = str(rank)

import numpy as np
import torch

import chip_smoke as cs
from pilosa_tpu_torch.logger import Logger
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import CollectiveConfig, EngineConfig
from pilosa_tpu_torch.plan.signature import Leaf
from pilosa_tpu_torch.server.server import Server

ctl = cs.WorkerCommands(torch, kernels, cfg, rank)
device = cfg["device"]  # None: the card; "cpu" rehearses the path without one
if device is None and cfg.get("mesh_devices"):
    # (i4): each rank on a card of its own where there are several (its
    # partitions stay there), all on cuda:0 on a one-card machine.
    device = f"cuda:{rank % torch.cuda.device_count()}"
hosts = [f"localhost:{p}" for p in cfg["ports"]]
srv = Server(
    data_dir=None, port=cfg["ports"][rank], cluster_hosts=hosts,
    replica_n=cfg["replica_n"], cache_flush_interval=0, anti_entropy_interval=0,
    member_monitor_interval=1.0, logger=Logger(stream=sys.stderr),
    engine_config=EngineConfig(leaf_cache_bytes=cfg["engine_leaf"],
                               stack_cache_bytes=cfg["engine_stack"],
                               mesh_devices=cfg.get("mesh_devices", 0)),
    collective_config=CollectiveConfig(timeout_ms=cfg["timeout_ms"],
                                       leaf_budget_bytes=cfg["leaf_budget"]),
    device=device)
srv.client.timeout = cfg["client_timeout"]
srv.open()  # joins the job: returns once every rank has
t0 = time.perf_counter()
H = np.load(cfg["f_path"], mmap_mode="r")
V = np.load(cfg["v_path"], mmap_mode="r")
empty = np.zeros(0, dtype=np.uint64)
owned = cs.fill_node(srv, H, V, (empty, empty), H.shape[1])
fill_s = time.perf_counter() - t0
deadline = time.time() + 120
while not srv.collective.active():
    assert time.time() < deadline, [(n.id, n.process_idx) for n in srv.cluster.nodes]
    time.sleep(0.1)
# A serving rank holds its block of every row of f resident, as (g1) and
# (h) hold theirs: the placement a descriptor gives this rank.
t0 = time.perf_counter()
desc = srv.collective._descriptor("count", "big", queries=[])
mine = desc["slots"][rank]
mesh = srv.collective.partitions()
for r in range(H.shape[0]):
    srv.collective._global_leaf("big", Leaf("f", "standard", r), mine, desc["k"], mesh)
ctl.sync()
ready = dict(rank=rank, node=srv.node.id, owned=len(owned), slots=len(mine),
             mine=mine, k=desc["k"], d_local=desc["dLocal"], mesh=[str(d) for d in mesh],
             fill_s=fill_s, resident_s=time.perf_counter() - t0,
             leaf_gib=srv.collective._leaf_bytes / 2**30)
del H, V


def stall_reduce(cmd):
    # The next reduce of this rank sleeps `seconds` first, once: the
    # peers' reduces time out, and the group re-forms at the next entry.
    from pilosa_tpu_torch.parallel import distributed

    real = distributed.all_reduce_sum

    def stalled(values):
        distributed.all_reduce_sum = real
        time.sleep(cmd["seconds"])
        return real(values)

    distributed.all_reduce_sum = stalled
    return {}


def spans(limit):
    per = {"collective.barrier": [], "collective.entry": [], "collective.reduce": []}
    for t in srv.trace_recorder.traces(index="big", limit=limit):
        for sp in t["spans"]:
            if sp["name"] in per:
                per[sp["name"]].append(sp["dur_ms"])
    return {k: (float(np.median(v)) if v else None) for k, v in per.items()}


def report():
    eng = srv.executor._engine
    ctl.sync()
    return dict(
        launches=dict(kernels.LAUNCHES), plain=dict(kernels.PLAIN_CALLS),
        staged=dict(kernels.STAGED),
        engine=eng.snapshot() if eng is not None else None,
        collective=srv.collective.snapshot(), batcher=srv.batcher.snapshot(),
        counters=dict(srv.stats.snapshot().get("counters", {})),
        spans=spans(256), max_mem_gib=ctl.max_mem_gib())


def count_batch(cmd):
    # One collective entry of every Count in `queries`, led by this rank.
    from pilosa_tpu_torch.pql.parser import parse

    calls = [parse(q).calls[0].children[0] for q in cmd["queries"]]
    t0 = time.perf_counter()
    counts = srv.collective.count_batch("big", calls)
    return dict(counts=[int(c) for c in counts], ms=(time.perf_counter() - t0) * 1e3)


ctl.serve(report, srv.close, ready=lambda cmd: ready, stall_reduce=stall_reduce,
          count_batch=count_batch)
"""


def reduce_stall(job, port: int, q_rank: int, x_rank: int, qs, reps0, timeout_ms: int) -> dict:
    """Rank x_rank's next reduce sleeps past the group's timeout: the
    Count asked of rank q_rank is answered through the fan-out (equal to
    its want), every rank's reduce fails, and Counts of `qs` are asked
    again until one goes through the plane, which must happen within
    10 s of the failure, every answer equal. Returns the numbers; fails
    unless every rank but the stalled one counted one group failure,
    every rank one re-formation, and none holds a `broken` reason. The
    stalled rank's own late reduce may fail, or complete: its peers'
    parts can have reached it before they gave up (NCCL's small-message
    protocols write into the receiver's buffers), and it then re-forms
    at the next barrier all the same."""
    n = len(reps0)
    job.ask(x_rank, "stall_reduce", seconds=timeout_ms / 1000.0 + 1.0)
    pql, w = qs[0]
    t0 = time.perf_counter()
    assert query(port, "big", pql) == [w], pql  # through the fan-out
    failed = time.perf_counter()
    q1 = job.ask(q_rank, "report")
    assert q1["collective"]["group_failures"] == reps0[q_rank]["collective"][
        "group_failures"] + 1, q1["collective"]
    recovered, n_after = None, 0
    while time.perf_counter() - failed < 10.0:
        pql, w = qs[n_after % len(qs)]
        n_after += 1
        assert query(port, "big", pql) == [w], pql
        q2 = job.ask(q_rank, "report")
        if q2["counters"].get("CollectiveCount", 0) > q1["counters"].get("CollectiveCount", 0):
            recovered = time.perf_counter() - failed
            break
        time.sleep(0.1)
    assert recovered is not None, q2["collective"]
    reps = job.all("report")

    def delta(key):
        return [rep["collective"][key] - rep0["collective"][key]
                for rep, rep0 in zip(reps, reps0)]

    stall = dict(stalled_rank=x_rank, query_rank=q_rank, stall_s=timeout_ms / 1000.0 + 1.0,
                 failed_query_s=failed - t0, recovered_s=recovered, counts_after=n_after,
                 group_failures=delta("group_failures"), group_reforms=delta("group_reforms"),
                 generation=[rep["collective"]["group_generation"] for rep in reps],
                 backend=[rep["collective"]["reduce_backend"] for rep in reps],
                 broken=[rep["collective"]["broken"] for rep in reps])
    peers = [f for r, f in enumerate(stall["group_failures"]) if r != x_rank]
    assert peers == [1] * (n - 1), stall
    assert stall["group_failures"][x_rank] in (0, 1), stall
    assert stall["group_reforms"] == [1] * n, stall
    assert stall["broken"] == [None] * n, stall
    assert len(set(stall["generation"])) == 1, stall
    return stall


def stall_line(stall: dict, timeout_ms: int) -> str:
    return (f"rank {stall['stalled_rank']}'s reduce stalled {stall['stall_s']:.1f} s (past "
            f"the {timeout_ms} ms group timeout): the Count on rank {stall['query_rank']} "
            f"equal numpy through the fan-out in {stall['failed_query_s']:.2f} s; every "
            f"rank counted group_failures {stall['group_failures']} and group_reforms "
            f"{stall['group_reforms']}, now at generation {stall['generation'][0]}, reduce "
            f"backend {stall['backend'][0]}, broken {stall['broken'][0]}; the plane served "
            f"a Count again (equal numpy) {stall['recovered_s']:.2f} s after the failure, "
            f"{stall['counts_after']} Count(s) later")


class RankJob:
    """Server processes of one path ((i)'s four ranks, (j)'s nodes):
    started together from `script`, driven through the control directory,
    stopped with SIGTERM (or killed) on close."""

    def __init__(self, cfg: dict, workdir: str, script: str = WORKER_I, n: int = I_RANKS):
        self.cfg = cfg
        self.ctl = cfg["ctl"]
        self.n = [0] * n
        path = os.path.join(workdir, "rank_worker.py")
        with open(path, "w") as f:
            f.write(script)
        cfg_path = os.path.join(workdir, "job.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
        self.logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(n)]
        self.procs = [subprocess.Popen([sys.executable, path, cfg_path, str(r)],
                                       stdout=self.logs[r], stderr=subprocess.STDOUT,
                                       env=env, cwd=HERE)
                      for r in range(n)]

    def tail(self, r: int, n: int = 3000) -> str:
        self.logs[r].flush()
        with open(self.logs[r].name) as f:
            return f.read()[-n:]

    def _send(self, r: int, op: str, **kw) -> int:
        n = self.n[r]
        self.n[r] += 1
        tmp = os.path.join(self.ctl, f"{r}.{n}.w")
        with open(tmp, "w") as f:
            json.dump(dict(op=op, **kw), f)
        os.replace(tmp, os.path.join(self.ctl, f"{r}.{n}.cmd"))
        return n

    def _reply(self, r: int, n: int, op: str, timeout: float):
        path = os.path.join(self.ctl, f"{r}.{n}.json")
        deadline = time.time() + timeout
        while not os.path.exists(path):
            rc = self.procs[r].poll()
            assert rc is None, f"rank {r} exited {rc}: {self.tail(r)}"
            assert time.time() < deadline, f"rank {r} did not answer {op}: {self.tail(r)}"
            time.sleep(0.01)
        with open(path) as f:
            reply = json.load(f)
        assert "error" not in reply, (r, op, reply["error"], self.tail(r))
        return reply["ok"]

    def ask(self, r: int, op: str, timeout: float = 600.0, **kw):
        return self._reply(r, self._send(r, op, **kw), op, timeout)

    def all(self, op: str, timeout: float = 600.0, **kw):
        """`op` to every process at once (a profiler start or a report
        takes each process seconds), then every reply in order."""
        sent = [self._send(r, op, **kw) for r in range(len(self.procs))]
        return [self._reply(r, n, op, timeout) for r, n in enumerate(sent)]

    def stop(self, timeout: float = 120.0):
        """SIGTERM every rank, wait for each to exit 0; the last reports."""
        import signal

        for p in self.procs:
            p.send_signal(signal.SIGTERM)
        finals = []
        for r, p in enumerate(self.procs):
            rc = p.wait(timeout=timeout)
            assert rc == 0, f"rank {r} exited {rc}: {self.tail(r)}"
            with open(os.path.join(self.ctl, f"{r}.final.json")) as f:
                finals.append(json.load(f))
        return finals

    def close(self):
        import signal

        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
                p.wait(timeout=60)
        for f in self.logs:
            f.close()


def sum_launches(reports) -> dict:
    return {k: sum(rep["launches"][k] for rep in reports) for k in reports[0]["launches"]}


def write_planes(H, bsi, depth: int, work: str) -> dict:
    """f's planes and v's BSI planes as .npy files in `work`, written once
    for the server processes of (i) and (j) to memory-map."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    vals, nn = bsi["vals"], bsi["nn"]
    with ThreadPoolExecutor(max_workers=8) as pool:
        v_planes = np.stack(list(pool.map(lambda sh: bsi_planes(
            vals[sh], nn[sh], depth), range(H.shape[1]))))
    out = dict(f_path=os.path.join(work, "f.npy"), v_path=os.path.join(work, "v.npy"))
    np.save(out["f_path"], H)
    np.save(out["v_path"], v_planes)
    out["write_s"] = time.perf_counter() - t0
    return out


def main_path_i(torch, kernels, H, bsi, depth, rng, out, smi, phases, planes,
                per_client=256, per_client_c8=64, device=None):
    """Path (i): the collective plane on the card. Four server processes,
    each rank r of 4 in one gloo job (PILOSA_JAX_* variables), each with
    cluster_hosts naming all four, replica_n = 2 and the jump hasher,
    each holding its placement's shards of f (the same 256 x 128 planes)
    and v; whole-index queries go through the collective plane: every
    rank runs K1/K2/K3 over its own block and the ranks reduce once over
    gloo (the job's rule: they share the card). (i1) distinct Counts at
    C = 1 and 8, round-robin over the nodes;
    (i2) a nest, TopN with and without a filter, Sum/Min/Max with and
    without a filter from every node, and /internal/collective/count;
    (i3) one rank stopped (SIGSTOP) for 32 Counts, then resumed; (i3b)
    one rank's reduce stalled past the group's timeout (reduce_stall)."""
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.cluster.node import Cluster, Node

    n_rows, n_shards, n_words = H.shape
    i = {"ranks": I_RANKS, "replica_n": H_REPLICAS, "smi": smi,
         "timeout_ms": I_TIMEOUT_MS, "leaf_budget_bytes": I_LEAF_BUDGET}
    work = tempfile.mkdtemp(prefix="pilosa-torch-ranks-")
    ctl = os.path.join(work, "ctl")
    os.makedirs(ctl)
    job = None
    try:
        vals, nn = bsi["vals"], bsi["nn"]
        i["write_s"] = planes["write_s"]
        ports = free_ports(I_RANKS + 1)
        cfg = dict(here=HERE, coordinator=f"localhost:{ports[-1]}", ports=ports[:I_RANKS],
                   replica_n=H_REPLICAS, engine_leaf=5 << 30, engine_stack=3 << 30,
                   timeout_ms=I_TIMEOUT_MS, leaf_budget=I_LEAF_BUDGET,
                   client_timeout=I_CLIENT_TIMEOUT, ctl=ctl,
                   f_path=planes["f_path"], v_path=planes["v_path"], device=device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        job = RankJob(cfg, work)
        ready = job.all("ready", timeout=900)
        i["start_s"] = time.perf_counter() - t0
        i["ready"] = ready
        log(f"main (i) [{smi}]: {I_RANKS} rank processes on {torch.cuda.get_device_name(0)}, "
            f"one gloo job (replica_n {H_REPLICAS}, jump hash, barrier and group timeout "
            f"{I_TIMEOUT_MS} ms); planes written in {i['write_s']:.1f} s, ranks up in "
            f"{i['start_s']:.1f} s: " + "; ".join(
                f"rank {r['rank']} {r['node']} owns {r['owned']} shards, counts {r['slots']} "
                f"(k {r['k']}), filled {r['fill_s']:.1f} s, f resident {r['leaf_gib']:.2f} GiB "
                f"in {r['resident_s']:.1f} s" for r in ready))
        assert sum(r["slots"] for r in ready) == n_shards, ready
        port_of = {r["rank"]: ports[r["rank"]] for r in ready}

        def begin(name):
            job.all("reset")
            return name, job.all("report")

        def finish(name, before, *need, quiet=True):
            """Each rank's launches over the path; `need` kernels launched
            on every rank, no plain twin anywhere, and (with `quiet`) no
            ladder or host rung on any rank's engine."""
            reps = job.all("report")
            for r, rep in enumerate(reps):
                # A CPU rehearsal (device="cpu") runs the plain twins.
                ran = rep["plain"] if device == "cpu" else rep["launches"]
                assert device == "cpu" or not any(rep["plain"].values()), (
                    name, r, rep["plain"])
                for k in need:
                    assert ran[k] > 0, (name, r, k, ran)
                if quiet and rep["engine"] is not None:
                    bad = {k: rep["engine"][k] for k in LADDER if rep["engine"][k]}
                    assert not bad, (name, r, bad)
                assert not rep["collective"]["fallbacks"] or not quiet, (
                    name, r, rep["collective"]["fallbacks"])
            got = {"launches": sum_launches(reps),
                   "plain_calls": {k: sum(rep["plain"][k] for rep in reps)
                                   for k in reps[0]["plain"]},
                   "per_rank": [rep["launches"] for rep in reps]}
            phases[name] = got
            log(f"counters {name}: launches per rank {got['per_rank']}, plain twins "
                f"{got['plain_calls']}")
            return reps

        def delta(reps, reps0, key, sub):
            return [rep[key][sub] - rep0[key][sub] if isinstance(rep[key][sub], (int, float))
                    else None for rep, rep0 in zip(reps, reps0)]

        bufs = threading.local()

        def want_pair(a, b):
            x, y = H[a].reshape(-1).view(np.uint64), H[b].reshape(-1).view(np.uint64)
            if getattr(bufs, "w", None) is None:
                bufs.w, bufs.c = np.empty_like(x), np.empty(x.shape, np.uint8)
            np.bitwise_and(x, y, out=bufs.w)
            np.bitwise_count(bufs.w, out=bufs.c)
            return int(bufs.c.sum(dtype=np.int64))

        # ---- (i1) distinct Counts over HTTP, round-robin over the ranks
        every = unordered_pairs(rng, n_rows)
        want, levels, offset = {}, {}, 0
        for c in (1, 8):
            per = per_client if c == 1 else per_client_c8
            n = c * per
            sel = every[(offset + np.arange(n)) % len(every)]
            offset += n
            work_q = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
                       sel[j * per:(j + 1) * per]] for j in range(c)]
            with ThreadPoolExecutor(max_workers=8) as pool:
                new = sorted({(int(a), int(b)) for a, b in sel} - want.keys())
                want.update(zip(new, pool.map(lambda p: want_pair(*p), new)))
            name, reps0 = begin(f"i1_collective_count_c{c}")
            job.all("profile_start")
            with GcPauses() as gcp:
                wall_s, clients = http_clients(ports[:I_RANKS], "big", work_q)
            dev = [r["device_ms"] for r in job.all("profile_stop")]
            lat = []
            for j, res in enumerate(clients):
                for (a, b), (dt, results) in zip(sel[j * per:(j + 1) * per], res):
                    assert results == [want[(int(a), int(b))]], (a, b, results)
                    lat.append(dt)
            reps = finish(name, reps0, "gather_expr_count")
            served = sum(rep["counters"].get("CollectiveCount", 0)
                         - rep0["counters"].get("CollectiveCount", 0)
                         for rep, rep0 in zip(reps, reps0))
            assert served == n, (served, n)
            groups = [rep["batcher"]["launches"] - rep0["batcher"]["launches"]
                      for rep, rep0 in zip(reps, reps0)]
            coalesced = [rep["batcher"]["coalesced"] - rep0["batcher"]["coalesced"]
                         for rep, rep0 in zip(reps, reps0)]
            k1 = [{k: rep["launches"][k] for k in ("gather_expr_count_staged",
                                                   "gather_expr_count_streaming")}
                  for rep in reps]
            dev_total = sum(d for d in dev if d)
            entries = delta(reps, reps0, "collective", "entries")
            assert len(set(entries)) == 1, entries  # every rank enters every entry
            lv = dict(clients=c, queries=n, wall_s=wall_s, qps=n / wall_s,
                      p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), max_ms=max(lat) * 1e3,
                      batcher_groups=groups, coalesced=coalesced,
                      mean_group=n / entries[0],
                      k1_per_rank=k1, device_ms_per_rank=dev,
                      idle_share=1.0 - dev_total / (wall_s * 1e3),
                      spans_p50_ms=[rep["spans"] for rep in reps],
                      peak_gib_per_rank=[rep["max_mem_gib"] for rep in reps],
                      entries=entries[0], gc_gen2=gcp.n)
            levels[c] = lv
            log(f"main (i1) [{smi}] C={c}: {n} distinct Counts over HTTP, round-robin over "
                f"{I_RANKS} ranks, equal numpy, all through the collective plane "
                f"(CollectiveCount {served}); {lv['qps']:.1f} queries/s, p50 "
                f"{lv['p50_ms']:.3f} ms, p99 {lv['p99_ms']:.3f} ms, max {lv['max_ms']:.3f} ms; "
                f"{lv['entries']} collective entries (mean group {lv['mean_group']:.2f} "
                f"queries; batcher groups per rank {groups}); K1 per rank {k1}; leader span "
                f"p50s (ms) "
                f"{lv['spans_p50_ms']}; device ms per rank {dev} of {wall_s * 1e3:.1f} ms "
                f"wall, idle share {lv['idle_share']:.4f}; peak GiB per rank "
                f"{lv['peak_gib_per_rank']}")
        i["i1"] = levels

        # ---- (i2) other queries, from every node
        fa, fb, fc, fd, fe = (int(x) for x in rng.choice(n_rows, 5, replace=False))
        with ThreadPoolExecutor(max_workers=8) as pool:
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
            inter = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r] & H[fa]).sum(axis=1, dtype=np.int64),
                range(n_rows))))
        nest = (f"Count(Union(Difference(Row(f={fa}), Row(f={fb})), "
                f"Xor(Row(f={fc}), Intersect(Row(f={fd}), Row(f={fe})))))")
        want_nest = np_count((H[fa] & ~H[fb]) | (H[fc] ^ (H[fd] & H[fe])))
        fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
        want_vc = bsi["want_vc"]
        name, reps0 = begin("i2_collective_other")
        timed, answers = {}, {}
        for srv_rank in range(I_RANKS):
            port = port_of[srv_rank]

            def run(label, pql):
                t0 = time.perf_counter()
                got = query(port, "big", pql)
                timed.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
                answers.setdefault(label, (pql, got))
                return got

            assert run("nest", nest) == [want_nest], srv_rank
            got = run("topn", "TopN(f, n=10)")[0]
            assert [(p["id"], p["count"]) for p in got] == replay_topn(cache, cache, 10), got
            got = run("topn_filter", f"TopN(f, Row(f={fa}), n=10)")[0]
            assert [(p["id"], p["count"]) for p in got] == replay_topn(inter, cache, 10), got
            for kind in ("sum", "min", "max"):
                for flt, mask in (("", nn), (f"Row(f={fa}), ", nn & fbits)):
                    got = run(kind + ("_filter" if flt else ""),
                              f"{kind.title()}({flt}field=v)")[0]
                    # The collective rung counts every column holding the
                    # extreme value, on every rank: numpy's global answer
                    # (not the fan-out's first-node fold of path (h)).
                    assert (got["value"], got["count"]) == want_vc(kind, mask), (
                        srv_rank, kind, flt, got, want_vc(kind, mask),
                        job.ask(srv_rank, "report")["collective"]["fallbacks"])
        status, got = http(port_of[0], "POST", "/internal/collective/count",
                           {"index": "big", "field": "f", "rows": [fa, fb]})
        assert status == 200 and got == {"count": want_pair(fa, fb)}, (status, got)
        reps = finish(name, reps0, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
        served = {k: sum(rep["counters"].get(k, 0) - rep0["counters"].get(k, 0)
                         for rep, rep0 in zip(reps, reps0))
                  for k in ("CollectiveCount", "CollectiveTopN", "CollectiveValCount",
                            "CollectiveFallback")}
        assert served["CollectiveTopN"] > 0 and served["CollectiveValCount"] > 0, served
        assert served["CollectiveFallback"] == 0, served
        i["i2_ms"] = timed
        i["i2_served"] = served
        log(f"main (i2) [{smi}]: from every rank a Union/Difference/Xor nest, TopN(f, n=10), "
            f"TopN(f, Row(f={fa}), n=10) (phase 2 collective) and Sum/Min/Max of v with and "
            f"without Row(f={fa}), and one /internal/collective/count, equal numpy (TopN the "
            f"two-phase replay, Min/Max counted over every rank); served {served}; ms per "
            f"rank: " + "; ".join(f"{k} {', '.join(f'{x:.1f}' for x in v)}"
                                  for k, v in timed.items()))

        # ---- (i3) one rank stopped, then resumed
        q_rank, x_rank = 0, I_RANKS - 1
        sel = every[:I_STOP_COUNTS]
        for a, b in sel:
            if (int(a), int(b)) not in want:
                want[(int(a), int(b))] = want_pair(int(a), int(b))
        qs = [(f"Count(Intersect(Row(f={a}), Row(f={b})))", want[(int(a), int(b))])
              for a, b in sel]
        name, reps0 = begin("i3_rank_stopped")
        q0 = reps0[q_rank]
        os.kill(job.procs[x_rank].pid, signal.SIGSTOP)
        try:
            t0 = time.perf_counter()
            stop_lat = []
            for pql, w in qs:
                t1 = time.perf_counter()
                assert query(port_of[q_rank], "big", pql) == [w], pql
                stop_lat.append((time.perf_counter() - t1) * 1e3)
            stop_s = time.perf_counter() - t0
            q1 = job.ask(q_rank, "report")
        finally:
            os.kill(job.procs[x_rank].pid, signal.SIGCONT)
        h0, h1 = q0["collective"]["health"], q1["collective"]["health"]
        stopped = dict(
            barrier_timeouts=q1["collective"]["barrier_timeouts"]
            - q0["collective"]["barrier_timeouts"],
            entries=q1["collective"]["entries"] - q0["collective"]["entries"],
            plane_opened=h1["plane_opened"] - h0["plane_opened"],
            slice_quarantined=h1["slice_quarantined"] - h0["slice_quarantined"],
            fallbacks=q1["collective"]["fallbacks"],
            collective_count=q1["counters"].get("CollectiveCount", 0)
            - q0["counters"].get("CollectiveCount", 0))
        assert stopped["barrier_timeouts"] >= 1, stopped
        assert stopped["plane_opened"] + stopped["slice_quarantined"] >= 1, stopped
        assert stopped["entries"] < len(qs) // 4, stopped  # later queries skip the barrier
        t0 = time.perf_counter()
        resumed = None
        while time.perf_counter() - t0 < 120:
            pql, w = qs[len(stop_lat) % len(qs)]
            assert query(port_of[q_rank], "big", pql) == [w], pql
            q2 = job.ask(q_rank, "report")
            if q2["counters"].get("CollectiveCount", 0) > q1["counters"].get(
                    "CollectiveCount", 0):
                resumed = time.perf_counter() - t0
                break
            time.sleep(0.2)
        assert resumed is not None, q2["collective"]
        assert q2["collective"]["health"]["plane_state"] == "closed", q2["collective"]["health"]
        deadline = time.time() + 60
        while True:
            reps = job.all("report")
            if reps[x_rank]["collective"]["barrier_aborts"] > reps0[x_rank]["collective"][
                    "barrier_aborts"] or time.time() > deadline:
                break
            time.sleep(0.5)
        finish(name, reps0, "gather_expr_count", quiet=False)
        aborts = delta(reps, reps0, "collective", "barrier_aborts")
        reduces = [rep["collective"]["reduces"] for rep in reps]
        assert aborts[x_rank] >= 1, aborts  # the resumed rank read `abort`
        assert len(set(reduces)) == 1, reduces  # ... and entered no reduce alone
        i["i3"] = dict(query_rank=q_rank, stopped_rank=x_rank, counts=len(qs), stop_s=stop_s,
                       stop_lat_ms=stop_lat, stopped=stopped, resumed_s=resumed,
                       barrier_aborts=aborts, reduces=reduces,
                       health=q2["collective"]["health"])
        log(f"main (i3) [{smi}]: rank {x_rank} stopped (SIGSTOP): {len(qs)} Counts on rank "
            f"{q_rank} equal numpy in {stop_s:.2f} s (first {stop_lat[0]:.1f} ms, then p50 "
            f"{float(np.median(stop_lat[1:])):.1f} ms) through the fan-out's replicas; "
            f"{stopped}; resumed (SIGCONT): the plane closed and CollectiveCount climbed "
            f"{resumed:.2f} s later; the resumed rank read `abort` at {aborts[x_rank]} "
            f"barrier(s) and every rank entered {reduces[0]} reduces")

        # ---- (i3b) one rank's reduce stalled past the group's timeout
        name, reps0 = begin("i3b_reduce_stalled")
        stall = reduce_stall(job, port_of[q_rank], q_rank, x_rank, qs, reps0, I_TIMEOUT_MS)
        finish(name, reps0, "gather_expr_count", quiet=False)
        assert stall["backend"] == ["gloo"] * I_RANKS, stall
        # On gloo the stalled rank's reduce fails too: its peers' aborted
        # groups closed their connections.
        assert stall["group_failures"] == [1] * I_RANKS, stall
        i["i3b"] = stall
        log(f"main (i3b) [{smi}]: " + stall_line(stall, I_TIMEOUT_MS))

        # ---- shutdown: SIGTERM, each rank's last report
        finals = job.stop()
        for r, fin in enumerate(finals):
            assert device == "cpu" or not any(fin["plain"].values()), (r, fin["plain"])
        i["final"] = [dict(launches=f["launches"], plain=f["plain"],
                           collective={k: v for k, v in f["collective"].items()
                                       if k != "health"}) for f in finals]
        log(f"main (i) [{smi}]: SIGTERM, every rank exited 0; launches per rank since the "
            f"last reset {[f['launches'] for f in finals]}, plain twins "
            f"{[sum(f['plain'].values()) for f in finals]}")
    finally:
        if job is not None:
            job.close()
        shutil.rmtree(work, ignore_errors=True)
    out["i"] = i
    # What (i4) holds its answers against: (i)'s one-partition answers,
    # each equal to numpy's.
    first = every[:per_client]
    return dict(counts=[(int(a), int(b), want[(int(a), int(b))]) for a, b in first],
                answers=answers, fa=fa)


I4_MESH = 2         # (i4): [engine] mesh-devices of every rank
I4_COUNTS = 64      # (i4): distinct Counts at C = 1 (a cut: PERF.md §4)


def main_path_i4(torch, kernels, H, bsi, depth, out, smi, phases, planes, prev,
                 n_counts=I4_COUNTS, device=None):
    """Path (i4): (i)'s four rank processes again, each with `[engine]
    mesh-devices` I4_MESH (8 partitions on cuda:0 on a one-card machine;
    a rank per card where there are four): every rank holds its k slots
    as I4_MESH blocks and launches K1/K2/K3 once per partition per
    collective entry, exactly, read from each rank's launch counters.
    (i4a) (i1)'s first `n_counts` distinct Counts at C = 1; (i4b) (i2)'s
    nest, TopN with and without a filter and Sum/Min/Max with and without
    a filter; every answer equal to (i)'s one-partition answer, which
    (i) held equal to numpy; (i4c) V_MAX written to a null column of two
    shards that one rank holds in two different partitions: Max with and
    without the filter against numpy, the maximum tied across them."""
    import shutil
    import tempfile

    n_rows, n_shards, n_words = H.shape
    i4 = {"ranks": I_RANKS, "mesh_devices": I4_MESH, "smi": smi}
    work = tempfile.mkdtemp(prefix="pilosa-torch-ranks-i4-")
    ctl = os.path.join(work, "ctl")
    os.makedirs(ctl)
    job = None
    t_path = time.perf_counter()
    try:
        ports = free_ports(I_RANKS + 1)
        cfg = dict(here=HERE, coordinator=f"localhost:{ports[-1]}", ports=ports[:I_RANKS],
                   replica_n=H_REPLICAS, engine_leaf=5 << 30, engine_stack=3 << 30,
                   timeout_ms=I_TIMEOUT_MS, leaf_budget=I_LEAF_BUDGET,
                   client_timeout=I_CLIENT_TIMEOUT, ctl=ctl, mesh_devices=I4_MESH,
                   f_path=planes["f_path"], v_path=planes["v_path"], device=device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        job = RankJob(cfg, work)
        ready = job.all("ready", timeout=900)
        i4["start_s"] = time.perf_counter() - t0
        for r in ready:
            assert r["d_local"] == I4_MESH == len(r["mesh"]) and r["k"] % I4_MESH == 0, r
        assert sum(r["slots"] for r in ready) == n_shards, ready
        i4["ready"] = [{k: v for k, v in r.items() if k != "mine"} for r in ready]
        log(f"main (i4) [{smi}]: {I_RANKS} rank processes of {I4_MESH} partitions each, up "
            f"in {i4['start_s']:.1f} s: " + "; ".join(
                f"rank {r['rank']} on {', '.join(r['mesh'])} counts {r['slots']} shards "
                f"(k {r['k']}, {r['k'] // I4_MESH} per partition), f resident "
                f"{r['leaf_gib']:.2f} GiB" for r in ready))

        def entries_phase(name, fn, kernel, exact=True):
            """fn() with every rank's counters reset around it; on every
            rank `kernel` ran I4_MESH times per collective entry (at least
            that, with `exact` False: the engine's own launches join)."""
            job.all("reset")
            reps0 = job.all("report")
            result = fn()
            reps = job.all("report")
            per_rank = []
            for r, (rep, rep0) in enumerate(zip(reps, reps0)):
                ran = rep["plain"] if device == "cpu" else rep["launches"]
                assert device == "cpu" or not any(rep["plain"].values()), (name, r, rep["plain"])
                assert not rep["collective"]["fallbacks"], (name, r, rep["collective"])
                entries = rep["collective"]["entries"] - rep0["collective"]["entries"]
                assert entries > 0, (name, r)
                n = ran[kernel]
                assert (n == I4_MESH * entries) if exact else (
                    n >= I4_MESH * entries and n % I4_MESH == 0), (name, r, kernel, n, entries)
                per_rank.append(dict(entries=entries, launches=n,
                                     staged=rep["staged"]["gather_expr_count"]))
            phases[name] = {"launches": sum_launches(reps),
                            "plain_calls": {k: sum(rep["plain"][k] for rep in reps)
                                            for k in reps[0]["plain"]}}
            log(f"counters {name}: {kernel} per rank (entries, launches, K1 staging copies) "
                f"{[(p['entries'], p['launches'], p['staged']) for p in per_rank]}")
            return result, per_rank

        # ---- (i4a) (i1)'s Counts at C = 1 over the partitioned ranks
        counts = prev["counts"][:n_counts]
        work_q = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b, _ in counts]]
        (wall_s, clients), per_rank = entries_phase(
            "i4a_collective_count_c1",
            lambda: http_clients(ports[:I_RANKS], "big", work_q), "gather_expr_count")
        lat = []
        for (a, b, w), (dt, results) in zip(counts, clients[0]):
            assert results == [w], (a, b, results, w)
            lat.append(dt)
        staged = [p["staged"] for p in per_rank]
        assert device == "cpu" or all(st == p["entries"] for st, p in zip(staged, per_rank)), \
            per_rank
        i4["i4a"] = dict(queries=len(counts), wall_s=wall_s, qps=len(counts) / wall_s,
                         p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), per_rank=per_rank)
        log(f"main (i4a) [{smi}] C=1: {len(counts)} distinct Counts over HTTP round-robin "
            f"over {I_RANKS} ranks of {I4_MESH} partitions equal (i)'s one-partition answers "
            f"(= numpy); {i4['i4a']['qps']:.1f} queries/s, p50 {i4['i4a']['p50_ms']:.3f} ms, "
            f"p99 {i4['i4a']['p99_ms']:.3f} ms; K1 {I4_MESH} per rank per entry, one staging "
            f"copy per rank per entry")

        # ---- (i4b) (i2)'s other queries from rank 0
        kernel_of = {"nest": "gather_expr_count", "topn": "masked_plane_counts",
                     "topn_filter": "masked_plane_counts", "sum": "masked_plane_counts",
                     "sum_filter": "masked_plane_counts", "min": "bsi_minmax",
                     "min_filter": "bsi_minmax", "max": "bsi_minmax",
                     "max_filter": "bsi_minmax"}
        b = {}
        for label, (pql, want) in prev["answers"].items():
            got, per_rank = entries_phase(
                f"i4b_{label}", lambda: query(ports[0], "big", pql), kernel_of[label],
                exact=label != "topn_filter")  # its phase 1 runs on each engine too
            assert got == want, (label, pql, got, want)
            b[label] = per_rank
        i4["i4b"] = b
        log(f"main (i4b) [{smi}]: from rank 0 {', '.join(b)} equal (i)'s one-partition "
            f"answers (= numpy); K1/K2/K3 {I4_MESH} per rank per entry (TopN with a filter: "
            f"phase 1 on the engines, per partition too)")

        # ---- (i4c) a maximum tied across two partitions of one rank
        fa = prev["fa"]
        held = max(ready, key=lambda r: r["slots"])
        mine, per = held["mine"], held["k"] // I4_MESH
        assert len(mine) > per, (len(mine), per)
        planted = []
        for shard in (mine[0], mine[per]):  # partitions 0 and 1 of one rank
            col = int(np.flatnonzero(~bsi["nn"][shard])[0])
            f_bit = (int(H[fa, shard, col >> 5]) >> (col & 31)) & 1
            planted.append((shard, col, f_bit))
            assert query(ports[0], "big", f"SetValue(col={shard * n_words * 32 + col}, "
                                          f"v={V_MAX})") == [None]
        fbits = np.unpackbits(H[fa].view(np.uint8), axis=1, bitorder="little").view(bool)
        want_vc = bsi["want_vc"]
        c = {}
        for flt, mask, extra in (("", bsi["nn"], 2),
                                 (f"Row(f={fa}), ", bsi["nn"] & fbits,
                                  sum(f for _, _, f in planted))):
            v0, c0 = want_vc("max", mask)
            want = (v0, c0) if not extra else ((V_MAX, c0 + extra) if v0 == V_MAX
                                               else (V_MAX, extra))
            got, per_rank = entries_phase(
                f"i4c_max{'_filter' if flt else ''}",
                lambda: query(ports[0], "big", f"Max({flt}field=v)")[0], "bsi_minmax")
            assert (got["value"], got["count"]) == want, (flt, got, want)
            c["max_filter" if flt else "max"] = dict(answer=want, per_rank=per_rank)
        i4["i4c"] = dict(rank=held["rank"], planted=planted, **c)
        log(f"main (i4c) [{smi}]: v={V_MAX} written to a null column of shards "
            f"{planted[0][0]} and {planted[1][0]}, partitions 0 and 1 of rank {held['rank']}: "
            f"Max(field=v) "
            f"{c['max']['answer']}, Max(Row(f={fa}), field=v) {c['max_filter']['answer']}, "
            f"equal numpy, every holder counted")

        finals = job.stop()
        for r, fin in enumerate(finals):
            assert device == "cpu" or not any(fin["plain"].values()), (r, fin["plain"])
        i4["seconds"] = time.perf_counter() - t_path
        log(f"main (i4) [{smi}]: SIGTERM, every rank exited 0; path (i4) took "
            f"{i4['seconds']:.1f} s")
    finally:
        if job is not None:
            job.close()
        shutil.rmtree(work, ignore_errors=True)
    out["i4"] = i4


# ------------------------------------------------------------ path (j)

J_NODES = 3          # the cluster before the join; a fourth node joins it
J_SHARDS = 64        # (j1)-(j2) hold config 5's first 64 shards (a cut: PERF.md §4)
J_CLIENTS = 8
J_COUNT_ROWS = 32    # the clients' Counts read rows 0..31 of f
J_WRITE_EVERY = 4    # every 4th request of a client is a Set or a Clear
J_WINDOW_S = 2.0     # client load before a move starts and after it ends
J_MOVE_LIMIT_S = 300  # a join or a leave that takes longer fails the run
J_THINK_S = 0.05     # each client's pause between requests
J_EV_SHARDS = 64     # (j3): index ev, 64 shards x 128 rows of f (1 GiB)
J_EV_OPS = 2048      # (j3): single-bit Sets and Clears recorded by the log
J_PIT_POSITIONS = 2  # (j3): positions read point-in-time (a cut of 4 for the time limit)
J_EV_OFF_SETS = 256  # (j3): Sets timed before change capture is enabled

# Path (j)'s clients, one thread each, until the stop file appears: every
# J_WRITE_EVERY-th request a Set or Clear of the client's own, else a
# Count, round-robin over the ports. The result file holds, per client,
# [[t0, latency_s, status, body, kind, k, sends again], ...] and the
# (status, body) of every refusal it sent again.
J_CLIENTS_SCRIPT = r"""
import http.client, json, os, sys, threading, time
cfg = json.load(open(sys.argv[1]))
ports, stop, every = cfg["ports"], cfg["stop"], cfg["write_every"]
out = [None] * len(cfg["counts"])

def run(i):
    conns = [http.client.HTTPConnection("localhost", p, timeout=600) for p in ports]
    used = [time.monotonic()] * len(conns)
    counts, writes = cfg["counts"][i], cfg["writes"][i]
    res, j, w, refused = [], 0, 0, []
    while not os.path.exists(stop) and time.time() < cfg["deadline"]:
        if j % every == every - 1 and w < len(writes):
            kind, k, q = "w", w, writes[w]
            w += 1
        else:
            kind, k, q = "c", j % len(counts), counts[j % len(counts)]
        c = (i + j) % len(ports)
        conn = conns[c]
        # A server ends a keep-alive connection idle for 60 s (a write
        # retried through a long cutover keeps the others idle that
        # long): reuse one only well inside that, as the port's own
        # client does (InternalClient.IDLE_REUSE_S).
        if time.monotonic() - used[c] > 20:
            conn.close()
        t0, p0 = time.time(), time.perf_counter()
        tries = 0
        while True:
            try:
                conn.request("POST", "/index/%s/query" % cfg["index"], body=q.encode())
                r = conn.getresponse()
                status, body = r.status, r.read().decode()
            except (OSError, http.client.HTTPException) as e:
                conn.close()  # reconnects on the next request
                status, body = 0, repr(e)
            used[c] = time.monotonic()
            # The one refusal a client sends again is the reference's
            # retryable one: a write that met a cutover past the server's
            # cutover wait ("shard migrated to a new owner"); Set and
            # Clear are idempotent. Any other answer but 200, to a read
            # or a write, is kept as it is and fails the run.
            if (status == 200 or kind != "w" or "shard migrated to a new owner" not in body
                    or tries >= 100):
                break
            tries += 1
            refused.append([status, body[:300]])
            time.sleep(0.05)
        res.append([t0, time.perf_counter() - p0, status, body, kind, k, tries])
        j += 1
        time.sleep(cfg["think_s"])
    for conn in conns:
        conn.close()
    out[i] = [res, refused]

threads = [threading.Thread(target=run, args=(i,)) for i in range(len(out))]
for th in threads:
    th.start()
for th in threads:
    th.join()
json.dump(out, open(cfg["result"], "w"))
"""


# One node of path (j): processes 0..J_NODES-1 open a data directory and
# fill it with their placement of f, v and s, as (h)'s nodes do; the last
# process joins through `join_addr` on the `join` command. Besides
# WorkerCommands' own, each answers `ready`, `status` (membership, state,
# a move in progress) and `holds` (which of the given shards of f it
# holds) and reports its engine and rebalance counters and pauses. For
# (k3) the coordinator runs the autoscaler every second (window 3,
# cooldown 0) and logs its samples from the start, inert until
# `autoscale` sets its high mark and standby and logs its actions
# (`autoscale_report`); on `standby` the
# last process replaces its removed server with a fresh standby, a
# one-node cluster of itself on the same port, as the reference's tests
# make one.
WORKER_J = r"""
import json, os, sys, time

cfg = json.load(open(sys.argv[1]))
r = int(sys.argv[2])
sys.path.insert(0, cfg["here"])

import numpy as np
import torch

import chip_smoke as cs
from pilosa_tpu_torch.cluster.autoscale import AutoscaleConfig
from pilosa_tpu_torch.logger import Logger
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import EngineConfig
from pilosa_tpu_torch.server.server import Server

ctl = cs.WorkerCommands(torch, kernels, cfg, r)
device = cfg["device"]  # None: the card; "cpu" rehearses the path without one
hosts = [f"localhost:{p}" for p in cfg["ports"]]
n_base = len(hosts) - 1  # the last process joins later
auto = {"samples": [], "actions": []}


def make(name=None, **kw):
    return Server(
        data_dir=os.path.join(cfg["work"], name or f"n{r}"), port=cfg["ports"][r],
        replica_n=cfg["replica_n"], cache_flush_interval=0, anti_entropy_interval=0,
        member_monitor_interval=0, logger=Logger(stream=sys.stderr),
        engine_config=EngineConfig(leaf_cache_bytes=cfg["engine_leaf"],
                                   stack_cache_bytes=cfg["engine_stack"]),
        device=device, **kw)


srv = None
ready = {"node": hosts[r]}
if r < n_base:
    scale = {}
    if r == 0:
        scale["autoscale_config"] = AutoscaleConfig(
            interval=1.0, window=3, scale_out_qps=1e9, scale_in_qps=cfg["scale_in_qps"],
            cooldown=0.0)
    srv = make(cluster_hosts=hosts[:n_base], is_coordinator=r == 0, **scale)
    srv.open()
    if r == 0:
        # Log every sample of the controller (time, queries/s), and when
        # it acts, for (k3).
        sample = srv.autoscaler._sample

        def logged(now):
            got = sample(now)
            if got is not None:
                auto["samples"].append([time.time(), got["qps"]])
            return got

        srv.autoscaler._sample = logged
    t0 = time.perf_counter()
    S = np.load(cfg["s_path"])
    n_shards = cfg["n_shards"]
    owned = cs.fill_node(srv, np.load(cfg["f_path"], mmap_mode="r")[:, :n_shards],
                         np.load(cfg["v_path"], mmap_mode="r")[:n_shards], (S[0], S[1]),
                         n_shards)
    ready.update(owned=len(owned), fill_s=time.perf_counter() - t0)


def status(cmd):
    return dict(nodes=[n.id for n in srv.cluster.nodes], state=srv.cluster.state,
                moving=srv.cluster.next_nodes is not None)


def report():
    eng = srv.executor._engine if srv is not None else None
    ctl.sync()
    return dict(
        node=hosts[r], launches=dict(kernels.LAUNCHES), plain=dict(kernels.PLAIN_CALLS),
        engine=eng.snapshot() if eng is not None else None,
        rebalance=srv.rebalance_stats.snapshot() if srv is not None else None,
        pauses=list(srv.rebalance_stats._pauses) if srv is not None else [],
        max_mem_gib=ctl.max_mem_gib())


def join(cmd):
    global srv
    srv = make(join_addr=hosts[0], is_coordinator=False)
    srv.open()  # returns once the coordinator admitted this node
    return {}


def holds(cmd):
    return [s for s in cmd["shards"]
            if srv.holder.fragment("big", "f", "standard", s) is not None]


def autoscale(cmd):
    c = srv.autoscaler
    c.config.scale_out_qps = cmd["scale_out_qps"]
    c.config.standby = cmd["standby"]
    with c._lock:
        c.config.scale_in_qps = cmd["scale_in_qps"]
        c._samples.clear()
    for name in ("_scale_out", "_scale_in"):
        def timed(act=getattr(c, name), name=name):
            auto["actions"].append([name, time.time()])
            return act()

        setattr(c, name, timed)
    return {}


def scale_in(cmd):
    # Sets scale-in-qps and starts the controller's window afresh; returns
    # the time of the change, on this process's clock.
    c = srv.autoscaler
    with c._lock:
        c.config.scale_in_qps = cmd["qps"]
        c._samples.clear()
    return {"t": time.time()}


def standby(cmd):
    global srv
    srv.close()
    srv = make(name=f"n{r}-standby", cluster_hosts=[hosts[r]], is_coordinator=True)
    srv.open()
    return {}


ctl.serve(report, lambda: srv is not None and srv.close(), ready=lambda cmd: ready,
          join=join, status=status, holds=holds, standby=standby, autoscale=autoscale,
          scale_in=scale_in,
          autoscale_report=lambda cmd: dict(auto, snapshot=srv.autoscaler.snapshot()))
"""


def j_fill_ev(srv, H, n_shards: int) -> None:
    """(j3)'s index ev: field f holding the first n_shards shards of H
    (every row), each fragment written to its file once. Serial: the
    snapshot is Python work under the GIL, which a thread pool only
    contends for."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.storage.bitmap import Container

    view = srv.holder.create_index("ev").create_field("f") \
        .create_view_if_not_exists("standard")
    n_rows, n_containers = H.shape[0], SHARD_WIDTH >> 16

    def one(shard):
        frag = view.create_fragment_if_not_exists(shard, broadcast=False)
        words = H[:, shard].view(np.uint64).reshape(n_rows, n_containers, 1024).copy()
        counts = np.bitwise_count(words).sum(axis=2)
        for row in range(n_rows):
            for ci in range(n_containers):
                frag.storage.containers[row * n_containers + ci] = Container(
                    bits=words[row, ci], n=int(counts[row, ci]))
            frag.cache.bulk_add(row, int(counts[row].sum()))
        frag.cache.invalidate(force=True)
        frag.snapshot()

    for shard in range(n_shards):
        one(shard)


def load_window(job, work: str, label: str, ports, pairs, want_pairs, writes, cursor,
                written: set, wr: int, action, done, window_s: float = J_WINDOW_S,
                think_s: float = J_THINK_S, limit_s: float = J_MOVE_LIMIT_S) -> dict:
    """Path (j)'s load around a move of the server processes of `job`:
    clients (J_CLIENTS_SCRIPT, a process of their own, one client per
    entry of `writes`) run Count(Intersect) over `pairs` and client i's
    Sets and Clears of row `wr` from writes[i][cursor[i]:], round-robin
    over `ports`, for window_s; then `action()`, until `done()`, then
    window_s more. Every Count must equal `want_pairs` and every answer
    be 200; a write refused at a cutover is sent again and counted. The
    acknowledged writes are applied to `written` and advance `cursor`.
    Returns the window's numbers."""
    n_clients = len(writes)
    cfg_path = os.path.join(work, f"clients-{label}.json")
    res_path = os.path.join(work, f"result-{label}.json")
    stop = os.path.join(work, f"stop-{label}")
    counts = [[f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in
               np.roll(pairs, -37 * i, axis=0)] for i in range(n_clients)]
    wq = [[f"{op}({c}, f={wr})" for op, c in writes[i][cursor[i]:]]
          for i in range(n_clients)]
    with open(cfg_path, "w") as f:
        json.dump({"ports": ports, "index": "big", "stop": stop,
                   "write_every": J_WRITE_EVERY, "think_s": think_s,
                   "counts": counts,
                   "writes": wq, "result": res_path,
                   "deadline": time.time() + 600}, f)
    proc = subprocess.Popen([sys.executable, "-c", J_CLIENTS_SCRIPT, cfg_path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    marks = {}
    try:
        with GcPauses() as gcp:
            job.all("profile_start")
            time.sleep(window_s)
            marks["begin"] = time.time()
            action()
            t_end, t_log = time.time() + limit_s, time.time() + 10
            while not done():
                assert time.time() < t_end, f"{label}: the move did not end"
                if time.time() > t_log:
                    t_log += 10
                    rb = job.ask(0, "report")["rebalance"]
                    log(f"(j1) {label}: {time.time() - marks['begin']:.0f} s, "
                        f"coordinator {rb}")
                time.sleep(0.2)
            marks["end"] = time.time()
            time.sleep(window_s)
            open(stop, "w").close()
            dev = [r["device_ms"] for r in job.all("profile_stop")]
    finally:
        open(stop, "w").close()
        _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(res_path) as f:
        clients, refused = zip(*json.load(f))
    # What the retried writes were refused with: each distinct
    # (status, body) and how often.
    why = {}
    for st, body in (x for r in refused for x in r):
        why[f"{st} {body}"] = why.get(f"{st} {body}", 0) + 1

    def win_of(t_req):
        return ("before" if t_req < marks["begin"] else
                "during" if t_req < marks["end"] else "after")

    lat = {"before": [], "during": [], "after": []}
    wlat = {"before": [], "during": [], "after": []}
    retried = {w: 0 for w in lat}  # writes sent again, by window
    n_win = {k: 0 for k in lat}
    for i, res in enumerate(clients):
        for t_req, dt, status_, body, kind, k, tries in res:
            assert status_ == 200, (label, kind, status_, body[:500])
            win = win_of(t_req)
            retried[win] += tries
            got = json.loads(body)["results"]
            if kind == "c":
                assert got == [want_pairs[(k + 37 * i) % len(pairs)]], (
                    label, win, k, got)
                lat[win].append(dt)
                n_win[win] += 1
            else:
                op, c = writes[i][cursor[i] + k]
                (written.add if op == "Set" else written.discard)(c)
                wlat[win].append(dt)
        cursor[i] += sum(1 for r in res if r[4] == "w")
    first = min(r[0] for res in clients for r in res)
    last = max(r[0] + r[1] for res in clients for r in res)
    span = {"before": marks["begin"] - first,
            "during": marks["end"] - marks["begin"], "after": last - marks["end"]}
    wall = last - first
    dev_ms = sum(d for d in dev if d) or None
    return dict(
        move_s=marks["end"] - marks["begin"], first_t=first, begin_t=marks["begin"],
        end_t=marks["end"], wall_s=wall,
        counts={w: dict(n=n_win[w], qps=n_win[w] / span[w],
                        p50_ms=pct(lat[w], 50) if lat[w] else None,
                        p99_ms=pct(lat[w], 99) if lat[w] else None)
                for w in lat},
        writes={w: dict(n=len(wlat[w]), p50_ms=pct(wlat[w], 50) if wlat[w] else None,
                        p99_ms=pct(wlat[w], 99) if wlat[w] else None)
                for w in wlat},
        retried=retried, refused=why, device_ms=dev_ms, gc_gen2=gcp.n, gc_gen2_ms=gcp.ms,
        idle_share=(1.0 - dev_ms / (wall * 1e3)) if dev_ms else None)


def rebalance_numbers(reps, before) -> dict:
    """The rebalance counters that the processes' reports `reps` gained
    since `before`, and the cutover pauses recorded since (p50, max)."""
    tot = {k: sum((r["rebalance"] or {}).get(k, 0) for r in reps)
           - sum((b["rebalance"] or {}).get(k, 0) for b in before)
           for k in ("bytes_streamed", "fragments_moved", "shards_cut_over",
                     "jobs_completed", "jobs_aborted", "catchup_rounds",
                     "cutover_pause_overruns", "stale_epoch_reroutes")}
    pauses = sorted(p for r, b in zip(reps, before) for p in r["pauses"][len(b["pauses"]):])
    tot["cutover_pause_ms_p50"] = pct(pauses, 50) if pauses else None
    tot["cutover_pause_ms_max"] = max(pauses) * 1e3 if pauses else None
    return tot


def main_path_k3(job, j, work, hosts, ports, joiner, pairs, want_pairs, writes, cursor,
                 written, wr, begin, finish, check_every, joined, left, smi):
    """Path (k3): the autoscaler drives a join and a leave of (j)'s
    cluster. The removed fourth process starts a fresh standby; the
    coordinator's autoscaler (interval 1 s, window 3) gets scale-out-qps
    at half the queries/s it read itself while (j1)'s clients ran before
    the join, and that standby. Under (j)'s 8 clients it joins the standby; with the
    clients stopped, and every node read after the join (the scale-in is
    held until then), it removes that node again. Every answer equals
    numpy; the seconds from the first sample over the mark to the job's
    start, and each move's rebalance seconds."""
    k3 = {}
    job.ask(joiner, "standby")
    # The mark: half the queries/s that (j1)'s 8 clients drove before its
    # join, as the controller itself read them (its samples of the
    # coordinator's traffic, direct and forwarded) in that window.
    jw = j["join"]
    read = [q for t, q in job.ask(0, "autoscale_report")["samples"]
            if jw["first_t"] + 1.0 <= t <= jw["begin_t"]]
    assert read, jw
    mark = 0.5 * float(np.median(read))
    # No scale-in until every node has been read after the join: a leave
    # that began under that check would move shards while it reads (no
    # queries/s is at or under -1).
    job.ask(0, "autoscale", scale_out_qps=mark, scale_in_qps=-1.0, standby=hosts[joiner])
    k3.update(scale_out_qps=mark, scale_in_qps=K_SCALE_IN_QPS, j1_samples_before=read,
              j1_client_qps_before=jw["counts"]["before"]["qps"])

    def decided(action, over, since=0.0):
        """(seconds from the first sample of the run that ended at the
        action to the action, the action's time), counting samples from
        `since` on. The first call acted; later ones found no standby
        left, or no node it added, and held (counted as skipped_bounds)."""
        rep = job.ask(0, "autoscale_report")
        acts = [t for name, t in rep["actions"] if name == action]
        assert acts, rep
        first = None
        for t, qps in rep["samples"]:
            if t < since:
                continue
            if t > acts[0]:
                break
            first = (first or t) if over(qps) else None
        assert first is not None, rep
        return acts[0] - first, acts[0], rep["snapshot"]

    ph = begin("k3_scale_out")
    before = job.all("report")
    ow = load_window(job, work, "k3-out", ports[:J_NODES], pairs, want_pairs, writes,
                     cursor, written, wr, lambda: None, joined)
    reps = finish(ph, "gather_expr_count")
    ow["rebalance"] = rebalance_numbers(reps, before)
    assert ow["rebalance"]["jobs_completed"] == 1, ow["rebalance"]
    k3["out_decide_s"], t_out, snap = decided("_scale_out", lambda q: q >= mark)
    k3["out_rebalance_s"] = ow["end_t"] - t_out
    k3["scale_out"] = ow
    ph = begin("k3_after_scale_out")
    check_every(range(J_NODES + 1), "after the autoscaled join")
    finish(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
    t_release = job.ask(0, "scale_in", qps=K_SCALE_IN_QPS)["t"]
    log(f"main (k3) [{smi}]: the coordinator's autoscaler (interval 1 s, window 3, "
        f"scale-out-qps {mark:.1f}, half its own reading {read} of (j1)'s load before "
        f"its join, whose clients sent {jw['counts']['before']['qps']:.1f} Counts/s) admitted the "
        f"standby {hosts[joiner]} under {J_CLIENTS} clients: {k3['out_decide_s']:.2f} s from "
        f"the first sample over the mark to the job's start, rebalance "
        f"{k3['out_rebalance_s']:.2f} s, {ow['rebalance']}; Counts before/during/after "
        f"{ow['counts']}; every answer equal numpy, and from all {J_NODES + 1} nodes after it")

    ph = begin("k3_scale_in")
    before = job.all("report")
    t0 = time.time()
    while not left():
        assert time.time() - t0 < J_MOVE_LIMIT_S + 30, "the autoscaler did not scale in"
        time.sleep(0.2)
    t_left = time.time()
    reps = finish(ph)
    rb = rebalance_numbers(reps, before)
    assert rb["jobs_completed"] == 1, rb
    k3["in_decide_s"], t_in, snap = decided("_scale_in", lambda q: q <= K_SCALE_IN_QPS,
                                            since=t_release)
    k3["in_rebalance_s"] = t_left - t_in
    k3["scale_in"] = dict(rebalance=rb)
    k3["autoscaler"] = snap
    assert snap["scale_out"] == 1 and snap["scale_in"] == 1 and not snap["errors"], snap
    ph = begin("k3_after_scale_in")
    check_every(range(J_NODES), "after the autoscaled leave")
    finish(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
    log(f"main (k3) [{smi}]: clients stopped: the autoscaler (scale-in-qps "
        f"{K_SCALE_IN_QPS}) removed {hosts[joiner]} {k3['in_decide_s']:.2f} s after the "
        f"first sample under the mark, rebalance {k3['in_rebalance_s']:.2f} s, {rb}; every "
        f"node's answers equal numpy after it; autoscaler {snap}")
    j["k3"] = k3


def main_path_j(torch, kernels, H, bsi, depth, rng, start, end, out, smi, phases, planes,
                device=None):
    """Path (j): a cluster that changes shape, and the change stream, on
    one card. (j1) three server processes (data directories, replica_n =
    2, the jump hasher, live rebalance) hold the first J_SHARDS shards of
    f, v and s as (h)'s nodes hold all of them; a fourth server process
    joins through `join_addr` while 8 clients
    run Counts and Sets/Clears round-robin over the first three, and the
    coordinator's live rebalance moves its shards; (j2) every node's
    Counts, Rows, TopN and Sum/Min/Max equal numpy on the state the
    writes produced, and the joined node counts with K1 over the shards
    it received; /cluster/resize/remove-node then takes it out under the
    same load, its shards move back, and (j2) holds again. (j3) one
    Server with change capture over index ev (64 shards of f, filled
    before capture): recorded Sets and Clears, point-in-time Counts
    against a numpy replay (planes on the card, K2), the change stream
    from the start, and a standing Count that re-pushes only on a real
    change."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from pilosa_tpu_torch.cdc import CdcConfig
    from pilosa_tpu_torch.cdc.log import decode_cdc_records
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import FSYNC_NEVER, StorageConfig

    H_ev = H[:, :J_EV_SHARDS]  # (j3)'s index ev
    H = H[:, :J_SHARDS]
    vals, nn = bsi["vals"][:J_SHARDS], bsi["nn"][:J_SHARDS]
    n_rows, n_shards, n_words = H.shape
    wr = n_rows  # the clients write row n_rows of f: absent from H, so
    # TopN(f) and the Counts over rows 0..J_COUNT_ROWS-1 keep H's answers
    j = {"nodes": J_NODES, "replica_n": H_REPLICAS, "smi": smi}
    work = tempfile.mkdtemp(prefix="pilosa-torch-j-")
    ctl = os.path.join(work, "ctl")
    os.makedirs(ctl)
    # The joining node's id (host:port) sorts after the others': jump hash
    # then gives it a quarter of the placements, 36 of 128 here, whatever
    # ports the run gets (an id sorting first re-keys every replica pair).
    ports = sorted(free_ports(J_NODES + 1), key=lambda p: f"localhost:{p}")
    hosts = [f"localhost:{p}" for p in ports]
    joiner = J_NODES  # the process index of the joining node
    srows = np.repeat(np.arange(H_SPARSE_ROWS, dtype=np.uint64), H_SPARSE_BITS)
    scols = np.concatenate([np.sort(rng.choice(n_shards * SHARD_WIDTH, H_SPARSE_BITS,
                                               replace=False)).astype(np.uint64)
                            for _ in range(H_SPARSE_ROWS)])
    job = None
    try:
        np.save(os.path.join(work, "s.npy"), np.stack([srows, scols]))
        cfg = dict(here=HERE, work=work, ports=ports, replica_n=H_REPLICAS,
                   engine_leaf=5 << 30, engine_stack=3 << 30, ctl=ctl,
                   scale_in_qps=K_SCALE_IN_QPS,
                   f_path=planes["f_path"], v_path=planes["v_path"],
                   s_path=os.path.join(work, "s.npy"), n_shards=n_shards, device=device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        job = RankJob(cfg, work, script=WORKER_J, n=J_NODES + 1)
        ready = job.all("ready", timeout=900)
        j["start_s"] = time.perf_counter() - t0
        j["shards_per_node_before"] = {r["node"]: r.get("owned") for r in ready[:J_NODES]}
        log(f"main (j) [{smi}]: {J_NODES} server processes on {torch.cuda.get_device_name(0)} "
            f"with data directories (replica_n {H_REPLICAS}, jump hash) and one to join, "
            f"config 5's first {n_shards} shards; up and filled in {j['start_s']:.1f} s, "
            f"shards per node {j['shards_per_node_before']}")

        # ---- what numpy says
        pairs = unordered_pairs(rng, J_COUNT_ROWS)
        with ThreadPoolExecutor(max_workers=8) as pool:
            want_pairs = list(pool.map(
                lambda p: np_count(np.bitwise_and(H[p[0]], H[p[1]])), pairs))
            cache = np.stack(list(pool.map(
                lambda r: np.bitwise_count(H[r]).sum(axis=1, dtype=np.int64), range(n_rows))))
        want_topn = replay_topn(cache, cache, 10)
        fa = int(rng.integers(J_COUNT_ROWS, n_rows))
        sr = int(rng.integers(H_SPARSE_ROWS))
        fbits_flat = np.unpackbits(H[fa].view(np.uint8), axis=1,
                                   bitorder="little").reshape(-1).view(bool)
        fbits = fbits_flat.reshape(n_shards, -1)
        s_cols = scols[srows == sr].astype(np.int64)
        want_s_and_f = s_cols[fbits_flat[s_cols]]
        sel = vals[nn & fbits]
        want_sum = (int(sel.sum(dtype=np.int64)), int(sel.size))
        del sel
        # Each client writes its own columns of row wr over every shard:
        # Sets, and every third op a Clear of the column set before.
        wcols = rng.permutation(np.unique(rng.integers(
            0, n_shards * SHARD_WIDTH, J_CLIENTS * 4000)))[:J_CLIENTS * 3000]
        writes = []
        for i in range(J_CLIENTS):
            mine = [int(c) for c in wcols[i::J_CLIENTS]]
            ops = []
            for k, c in enumerate(mine):
                ops.append(("Set", c))
                if k % 3 == 2:
                    ops.append(("Clear", mine[k - 1]))
            writes.append(ops)
        written = set()  # row wr's columns after the acknowledged writes
        cursor = [0] * J_CLIENTS  # each client's next write across windows

        def begin(name):
            job.all("reset")
            return name

        def finish(name, *need, none=()):
            """Every process's launches over the path, summed into
            `phases`; `need` kernels launched, `none` not, no plain twin
            on the card, and no ladder or host rung on any engine."""
            reps = job.all("report")
            got = {"launches": {k: sum(r["launches"][k] for r in reps)
                                for k in kernels.LAUNCHES},
                   "plain_calls": {k: sum(r["plain"][k] for r in reps)
                                   for k in kernels.PLAIN_CALLS}}
            phases[name] = got
            log(f"counters {name}: launches {got['launches']}, plain twins "
                f"{got['plain_calls']}")
            ran = got["plain_calls"] if device == "cpu" else got["launches"]
            assert device == "cpu" or not any(got["plain_calls"].values()), (name, got)
            for k in need:
                assert ran[k] > 0, (name, k, got)
            for k in none:
                assert ran[k] == 0, (name, k, got)
            for r, rep in enumerate(reps):
                snap = rep["engine"] or {}
                bad = {k: snap[k] for k in LADDER if snap.get(k)}
                assert not bad, (name, r, bad)
            return reps

        def status(r):
            return job.ask(r, "status")

        def members():
            """The coordinator's membership as a Cluster of this process
            (the jump hasher, replica_n), for placement-dependent wants."""
            ids = status(0)["nodes"]
            nodes = [Node(id=h, uri=h) for h in sorted(ids)]
            return nodes, {n.id: SimpleNamespace(node=n, cluster=Cluster(
                node=n, nodes=nodes, replica_n=H_REPLICAS)) for n in nodes}

        def k1_per_node(reps, before):
            return {r["node"]: (r["engine"] or {}).get("count_dispatches", 0)
                    - (b["engine"] or {}).get("count_dispatches", 0)
                    for r, b in zip(reps, before)}

        def check_every(node_idx, label):
            """(j2): every node's answers against numpy, with no move
            under way from before the first answer to after the last."""
            assert not status(0)["moving"], label
            nodes, view = members()
            assert sorted(n.id for n in nodes) == sorted(hosts[r] for r in node_idx), nodes
            want_w = len(written)
            want_w_and_f = sum(1 for c in written if fbits_flat[c])
            for r in node_idx:
                port = ports[r]
                for k in range(0, len(pairs), len(pairs) // 4):
                    a, b = (int(x) for x in pairs[k])
                    got = query(port, "big", f"Count(Intersect(Row(f={a}), Row(f={b})))")
                    assert got == [want_pairs[k]], (label, hosts[r], a, b, got)
                assert query(port, "big", f"Count(Row(f={wr}))") == [want_w], label
                assert query(port, "big", f"Count(Intersect(Row(f={wr}), Row(f={fa})))") \
                    == [want_w_and_f], label
                got = query(port, "big", f"Row(s={sr})")[0]
                assert got["columns"] == s_cols.tolist(), (label, hosts[r])
                got = query(port, "big", f"Intersect(Row(s={sr}), Row(f={fa}))")[0]
                assert got["columns"] == want_s_and_f.tolist(), (label, hosts[r])
                got = query(port, "big", "TopN(f, n=10)")[0]
                assert [(p["id"], p["count"]) for p in got] == want_topn, (label, got)
                got = query(port, "big", f"Sum(Row(f={fa}), field=v)")[0]
                assert (got["value"], got["count"]) == want_sum, (label, got)
                for kind in ("min", "max"):
                    got = query(port, "big", f"{kind.title()}(Row(f={fa}), field=v)")[0]
                    want_k = fold_val_count(view[hosts[r]], kind, vals, nn & fbits, n_shards)
                    assert (got["value"], got["count"]) == want_k, (
                        label, hosts[r], kind, got, want_k)
            st = status(0)
            assert not st["moving"] and sorted(st["nodes"]) == sorted(n.id for n in nodes), (
                label, st)

        # ---- (j1) join under load
        for r in range(J_NODES):  # each node's Count leaves resident before the clock
            for a, b in pairs[:J_COUNT_ROWS]:
                query(ports[r], "big", f"Count(Intersect(Row(f={a}), Row(f={b})))")

        def join():
            job.ask(joiner, "join", timeout=J_MOVE_LIMIT_S)

        def joined():
            st = status(0)
            return (len(st["nodes"]) == J_NODES + 1 and not st["moving"]
                    and all(status(r)["state"] == "NORMAL" for r in range(J_NODES + 1)))

        ph = begin("j1_join")
        before = job.all("report")
        jw = load_window(job, work, "join", ports[:J_NODES], pairs, want_pairs, writes,
                         cursor, written, wr, join, joined)
        reps = finish(ph, "gather_expr_count")
        jw["rebalance"] = rebalance_numbers(reps, before)
        jw["k1_per_node"] = k1_per_node(reps, before)
        assert jw["rebalance"]["jobs_completed"] == 1, jw["rebalance"]
        got_j = reps[joiner]["engine"]
        assert got_j["count_dispatches"] > 0 and got_j["leaf_misses"] > 0, got_j
        j["join"] = jw
        nodes, view = members()
        mine = [s for s in range(n_shards) if any(
            n.id == hosts[joiner] for n in view[hosts[0]].cluster.shard_nodes("big", s))]
        assert mine and job.ask(joiner, "holds", shards=mine) == mine
        j["joiner_shards"] = len(mine)
        log(f"main (j1) [{smi}]: {hosts[joiner]} joined {J_NODES} nodes on "
            f"{torch.cuda.get_device_name(0)} under {J_CLIENTS} clients: rebalance "
            f"{jw['move_s']:.2f} s, {jw['rebalance']}; Counts before/during/after "
            f"{jw['counts']}; writes {jw['writes']}, sent again {jw['retried']} after "
            f"{jw['refused']}; K1 launches "
            f"per node {jw['k1_per_node']}; device {jw['device_ms']} ms, idle share "
            f"{jw['idle_share']}; gen-2 GCs in this process {jw['gc_gen2']} "
            f"({jw['gc_gen2_ms']:.1f} ms); every answer equal numpy")

        # ---- (j2) after the join: the joiner's own Count, then every node
        ph = begin("j2_joined_count")
        a, b = (int(x) for x in pairs[1])
        status_, got = http(ports[joiner], "POST", "/index/big/query?remote=true",
                            {"query": f"Count(Intersect(Row(f={a}), Row(f={b})))",
                             "shards": mine})
        assert status_ == 200, got
        want_mine = np_count(np.bitwise_and(H[a][mine], H[b][mine]))
        assert got["results"][0]["value"] == want_mine, (got, want_mine)
        reps = finish(ph, "gather_expr_count")
        assert reps[joiner]["launches"]["gather_expr_count"] > 0 or device == "cpu", reps[joiner]
        ph = begin("j2_after_join")
        t0 = time.perf_counter()
        check_every(range(J_NODES + 1), "after the join")
        j["check_join_s"] = time.perf_counter() - t0
        finish(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
        log(f"main (j2) [{smi}]: after the join, {hosts[joiner]} counted its {len(mine)} "
            f"received shards with K1 (equal numpy); from all {J_NODES + 1} nodes Counts, "
            f"Count(Row(f={wr})) = {len(written)} written bits, Rows, TopN(f, n=10) and "
            f"Sum/Min/Max equal numpy in {j['check_join_s']:.1f} s")

        # ---- (j1) leave under load: remove-node, shards move back
        def leave():
            status_, got = http(ports[0], "POST", "/cluster/resize/remove-node",
                                {"id": hosts[joiner]})
            assert status_ == 200, got

        def left():
            st = status(0)
            return (len(st["nodes"]) == J_NODES and not st["moving"]
                    and all(status(r)["state"] == "NORMAL" for r in range(J_NODES)))

        ph = begin("j1_leave")
        before = job.all("report")
        lw = load_window(job, work, "leave", ports[:J_NODES], pairs, want_pairs, writes,
                         cursor, written, wr, leave, left)
        reps = finish(ph, "gather_expr_count")
        lw["rebalance"] = rebalance_numbers(reps, before)
        lw["k1_per_node"] = k1_per_node(reps, before)
        assert lw["rebalance"]["jobs_completed"] == 1, lw["rebalance"]
        j["leave"] = lw
        log(f"main (j1) [{smi}]: {hosts[joiner]} removed under {J_CLIENTS} clients: "
            f"rebalance {lw['move_s']:.2f} s, {lw['rebalance']}; Counts before/during/after "
            f"{lw['counts']}; writes {lw['writes']}, sent again {lw['retried']} after "
            f"{lw['refused']}; K1 launches "
            f"per node {lw['k1_per_node']}; device {lw['device_ms']} ms, idle share "
            f"{lw['idle_share']}; every answer equal numpy")
        ph = begin("j2_after_leave")
        t0 = time.perf_counter()
        check_every(range(J_NODES), "after the leave")
        j["check_leave_s"] = time.perf_counter() - t0
        reps = finish(ph, "gather_expr_count", "masked_plane_counts", "bsi_minmax")
        j["engines"] = {r["node"]: r["engine"] for r in reps}
        j["max_memory_allocated_gib"] = [r["max_mem_gib"] for r in reps]
        log(f"main (j2) [{smi}]: after the leave, from all {J_NODES} nodes the same answers "
            f"equal numpy ({len(written)} written bits) in {j['check_leave_s']:.1f} s; peak "
            f"device memory per process over (j1)-(j2) "
            f"{j['max_memory_allocated_gib']} GiB")
        main_path_k3(job, j, work, hosts, ports, joiner, pairs, want_pairs, writes, cursor,
                     written, wr, begin, finish, check_every, joined, left, smi)
        finals = job.stop()
        j["final_launches"] = [f["launches"] for f in finals]
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    finally:
        if job is not None:
            job.close()

    # ---- (j3) change capture on one node
    ev_dir = os.path.join(work, "ev")
    ev_port = free_ports(1)[0]
    a_ev, b_ev, c_ev = (int(x) for x in rng.choice(n_rows, 3, replace=False))
    kw = dict(data_dir=ev_dir, port=ev_port, cache_flush_interval=0,
              anti_entropy_interval=0, member_monitor_interval=0, device=device)
    # The fill is set-up: its files are written without fsync (the reopens
    # below read them back through the page cache).
    srv = Server(storage_config=StorageConfig(fsync=FSYNC_NEVER), **kw).open()
    try:
        t0 = time.perf_counter()
        j_fill_ev(srv, H_ev, J_EV_SHARDS)
        j["ev_fill_s"] = time.perf_counter() - t0
    finally:
        srv.close()
    srv = Server(**kw).open()
    try:
        # Sets timed without capture, on row c_ev (never read below).
        off_cols = rng.choice(J_EV_SHARDS * SHARD_WIDTH, J_EV_OFF_SETS, replace=False)
        off_lat = []
        for col in off_cols:
            t0 = time.perf_counter()
            query(ev_port, "ev", f"Set({int(col)}, f={c_ev})")
            off_lat.append(time.perf_counter() - t0)
    finally:
        srv.close()
    t0 = time.perf_counter()
    srv = Server(cdc_config=CdcConfig(enabled=True, standing_interval=0,
                                      pit_cache=J_EV_SHARDS + 8), **kw).open()
    try:
        j["ev_capture_open_s"] = time.perf_counter() - t0
        assert srv.cdc.log("ev").last_pos == 0
        live = f"Count(Intersect(Row(f={a_ev}), Row(f={b_ev})))"
        bits = {r: np.unpackbits(H_ev[r].view(np.uint8), axis=1,
                                 bitorder="little").reshape(-1).astype(bool)
                for r in (a_ev, b_ev)}
        status, reg = http(ev_port, "POST", "/cdc/standing",
                           {"index": "ev", "query": f"Count(Row(f={a_ev}))"})
        assert status == 200 and reg["created"], reg
        sid = reg["id"]
        srv.cdc.standing.evaluate_once()
        status, st = http(ev_port, "GET", f"/cdc/standing/{sid}/poll?version=0&timeout=5")
        assert st["version"] == 1 and st["result"] == int(bits[a_ev].sum()), st

        # 2048 single-bit writes that each change a bit (so each takes one
        # position): Sets of clear bits and Clears of set bits in rows a, b.
        ph = start("j3_cdc_writes")
        ops, on_lat, positions, checkpoints = [], [], [], {}
        for k in range(J_EV_OPS):
            r = (a_ev, b_ev)[k % 2]
            col = int(rng.integers(J_EV_SHARDS * SHARD_WIDTH))
            op = "Clear" if bits[r][col] else "Set"
            t0 = time.perf_counter()
            assert query(ev_port, "ev", f"{op}({col}, f={r})") == [True], (op, col, r)
            on_lat.append(time.perf_counter() - t0)
            bits[r][col] = op == "Set"
            positions.append(srv.cdc.log("ev").last_pos)
            ops.append((op, r, col))
            if (k + 1) % (J_EV_OPS // J_PIT_POSITIONS) == 0:
                checkpoints[positions[-1]] = int(np.count_nonzero(bits[a_ev] & bits[b_ev]))
        assert positions == list(range(1, J_EV_OPS + 1)), positions[:8]
        end(ph, quiet=[])
        status, data = http_raw(ev_port, f"/cdc/stream?index=ev&from=0&timeout=0"
                                         f"&max-bytes={64 << 20}")
        assert status == 200
        recs = [rec for rec, _ in decode_cdc_records(data)]
        assert [rec.position for rec in recs] == positions, len(recs)
        assert [rec.shard for rec in recs] == [col // SHARD_WIDTH for _, _, col in ops]

        # Point-in-time Counts at J_PIT_POSITIONS positions against the
        # numpy replay.
        live_eng = srv.executor.engine
        with live_eng.memos_off():
            live_lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                assert query(ev_port, "ev", live) == [checkpoints[J_EV_OPS]]
                live_lat.append(time.perf_counter() - t0)
        ph = start("j3_point_in_time")
        e0 = live_eng.snapshot()
        pit_lat, pit_first = [], []
        for pos, want in checkpoints.items():
            for rep in range(3):
                t0 = time.perf_counter()
                status, got = http(ev_port, "POST", "/index/ev/query", live,
                                   headers={"X-Pilosa-At-Position": str(pos)})
                (pit_lat if rep else pit_first).append(time.perf_counter() - t0)
                assert status == 200 and got["results"] == [want], (pos, got, want)
        hist = srv.cdc.historical_fragment("ev", "f", "standard", 0, min(checkpoints))
        assert hist.plane(a_ev).is_cuda == (srv.holder.device.type == "cuda")
        pit_k2 = kernels.LAUNCHES["masked_plane_counts"]
        end(ph, "masked_plane_counts", none=("gather_expr_count", "bsi_minmax"),
            quiet=[live_eng])
        assert live_eng.snapshot() == e0, "a point-in-time read touched the live engine"

        # The standing Count(Row(f=a)): a write to row b re-evaluates
        # without a push, a write to row a re-pushes.
        ph = start("j3_standing")
        sq = srv.cdc.standing.get(sid)
        srv.cdc.standing.evaluate_once()  # the 2048 writes changed row a
        version, pushes = sq.version, sq.pushes
        assert sq.to_dict()["result"] == int(bits[a_ev].sum()), sq.to_dict()
        col = int(np.flatnonzero(~bits[b_ev])[0])
        query(ev_port, "ev", f"Set({col}, f={b_ev})")
        assert srv.cdc.standing.evaluate_once() == 1  # re-evaluated ...
        assert (sq.version, sq.pushes) == (version, pushes), sq.to_dict()  # ... no push
        col = int(np.flatnonzero(~bits[a_ev])[0])
        query(ev_port, "ev", f"Set({col}, f={a_ev})")
        srv.cdc.standing.evaluate_once()
        status, st = http(ev_port, "GET",
                          f"/cdc/standing/{sid}/poll?version={version}&timeout=5")
        assert st["version"] == version + 1 and st["result"] == int(bits[a_ev].sum()) + 1, st
        end(ph, "gather_expr_count", quiet=[live_eng])
        j["cdc"] = dict(
            set_p50_ms_capture_off=pct(off_lat, 50), set_p50_ms_capture_on=pct(on_lat, 50),
            set_p99_ms_capture_on=pct(on_lat, 99), ops=J_EV_OPS, stream_bytes=len(data),
            pit_first_ms=[x * 1e3 for x in pit_first], pit_p50_ms=pct(pit_lat, 50),
            live_p50_ms=pct(live_lat, 50), pit_k2_launches=pit_k2,
            positions=sorted(checkpoints))
        log(f"main (j3) [{smi}]: index ev ({J_EV_SHARDS} shards x {n_rows} rows of f) filled "
            f"in {j['ev_fill_s']:.1f} s, reopened with change capture in "
            f"{j['ev_capture_open_s']:.1f} s (base images cut); {J_EV_OPS} Sets/Clears at "
            f"positions 1..{J_EV_OPS}, Set p50 {j['cdc']['set_p50_ms_capture_on']:.3f} ms with "
            f"capture, {j['cdc']['set_p50_ms_capture_off']:.3f} ms without; /cdc/stream from 0 "
            f"gave every op ({len(data)} bytes); point-in-time Counts at positions "
            f"{sorted(checkpoints)} equal the numpy replay (planes on "
            f"{hist.plane(a_ev).device}, K2 {pit_k2} launches, K1 none, the live engine "
            f"untouched): first {['%.1f' % (x * 1e3) for x in pit_first]} ms, then p50 "
            f"{j['cdc']['pit_p50_ms']:.3f} ms against a live Count's "
            f"{j['cdc']['live_p50_ms']:.3f} ms; the standing Count re-pushed only on row "
            f"{a_ev}'s write")
    finally:
        srv.close()
        shutil.rmtree(work, ignore_errors=True)
    out["j"] = j


# ------------------------------------------------------------ path (k)

K_SHARDS = 32  # (k1): the leader's index ev, its first 32 shards x 128 rows (512 MiB; a cut)
K_WRITERS = 4           # (k1): clients writing to the leader
K_READERS = 4           # (k1): clients reading from the follower
K_WRITES = 512          # (k1): single-bit Sets and Clears per writer
K_RETENTION = 8192      # (k1): the leader's [cdc] retention-ops
K_STALENESS = "1"       # (k1): X-Pilosa-Max-Staleness of the follower's reads, s
K_PROMOTED_WRITES = 16  # (k1): writes the promoted follower accepts
K_MUX_OFF = 2000        # (k2): [transport] port-offset of (h)'s nodes
K_SCALE_IN_QPS = 0.5    # (k3): [autoscale] scale-in-qps

# Path (k1)'s clients: writer i sends writes[i] to the leader one request
# each, then exits; a reader sends `read` to the follower with the
# staleness header, 5 ms apart, until the stop file appears. The file
# `writers_done` appears when every writer has finished. The result file
# holds, per client, [[t0, latency_s, status, body], ...].
K_CLIENTS_SCRIPT = r"""
import http.client, json, os, sys, threading, time
cfg = json.load(open(sys.argv[1]))
n_w = len(cfg["writes"])
out = [None] * (n_w + cfg["readers"])

def send(conn, q, headers):
    t0, p0 = time.time(), time.perf_counter()
    try:
        conn.request("POST", "/index/%s/query" % cfg["index"], body=q.encode(), headers=headers)
        r = conn.getresponse()
        status, body = r.status, r.read().decode()
    except (OSError, http.client.HTTPException) as e:
        conn.close()
        status, body = 0, repr(e)
    return [t0, time.perf_counter() - p0, status, body]

def writer(i):
    conn = http.client.HTTPConnection("localhost", cfg["leader"], timeout=600)
    out[i] = [send(conn, q, {}) for q in cfg["writes"][i]]
    conn.close()

def reader(i):
    conn = http.client.HTTPConnection("localhost", cfg["follower"], timeout=600)
    res = []
    while not os.path.exists(cfg["stop"]) and time.time() < cfg["deadline"]:
        res.append(send(conn, cfg["read"], {"X-Pilosa-Max-Staleness": cfg["staleness"]}))
        time.sleep(0.005)
    conn.close()
    out[n_w + i] = res

ws = [threading.Thread(target=writer, args=(i,)) for i in range(n_w)]
rs = [threading.Thread(target=reader, args=(i,)) for i in range(cfg["readers"])]
for th in rs + ws:
    th.start()
for th in ws:
    th.join()
open(cfg["writers_done"], "w").close()
for th in rs:
    th.join()
json.dump(out, open(cfg["result"], "w"))
"""


# One node of path (k1): process 0 is the geo leader of index ev (filled
# as (j3) fills it, then reopened with change capture and `[geo] role =
# leader`, then K_RETENTION + 1 Sets of row `wr` in shard 0 so that its
# change log folds once); process 1 becomes the follower on `follow`.
# Besides WorkerCommands' own, each answers `ready` and `status` (geo
# status and tail counters, the follower's cursor and bootstrap, the
# change log's positions) and reports its engine counters.
WORKER_K = r"""
import json, os, sys, time

cfg = json.load(open(sys.argv[1]))
r = int(sys.argv[2])
sys.path.insert(0, cfg["here"])

import numpy as np
import torch

import chip_smoke as cs
from pilosa_tpu_torch.cdc import CdcConfig
from pilosa_tpu_torch.geo import GeoConfig
from pilosa_tpu_torch.logger import Logger
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server.server import Server
from pilosa_tpu_torch.storage import FSYNC_NEVER, StorageConfig

ctl = cs.WorkerCommands(torch, kernels, cfg, r)
device = cfg["device"]  # None: the card; "cpu" rehearses the path without one
hosts = [f"localhost:{p}" for p in cfg["ports"]]
boot = {}


def make(**kw):
    return Server(
        data_dir=os.path.join(cfg["work"], f"k{r}"), port=cfg["ports"][r],
        cache_flush_interval=0, anti_entropy_interval=0, member_monitor_interval=0,
        logger=Logger(stream=sys.stderr), device=device, **kw)


def capture():
    return CdcConfig(enabled=True, standing_interval=0, retention_ops=cfg["retention"])


srv = None
ready = {"node": hosts[r]}
if r == 0:
    t0 = time.perf_counter()
    # The fill is set-up: its files are written without fsync, as (j3)'s.
    srv = Server(
        data_dir=os.path.join(cfg["work"], "k0"), port=cfg["ports"][0],
        cache_flush_interval=0, anti_entropy_interval=0, member_monitor_interval=0,
        storage_config=StorageConfig(fsync=FSYNC_NEVER), device=device).open()
    cs.j_fill_ev(srv, np.load(cfg["f_path"], mmap_mode="r")[:, :cfg["n_shards"]],
                 cfg["n_shards"])
    srv.close()
    ready["fill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = make(cdc_config=capture(), geo_config=GeoConfig(role="leader")).open()
    ready["capture_open_s"] = time.perf_counter() - t0
    cols = list(range(cfg["retention"] + 1))
    t0 = time.perf_counter()
    for k in range(0, len(cols), 512):
        srv.api.query("ev", " ".join(f"Set({c}, f={cfg['wr']})" for c in cols[k:k + 512]))
    log = srv.cdc.log("ev")
    ready.update(prefix_s=time.perf_counter() - t0, base_pos=log.base_pos,
                 last_pos=log.last_pos)


def follow(cmd):
    global srv
    srv = make(cdc_config=capture(), geo_config=GeoConfig(
        role="follower", leader=hosts[0], backoff=0.05, backoff_max=1.0))
    # One bootstrap answer carries the whole index: the leader compresses
    # every image before the first byte, past the client's 30 s default.
    srv.geo.client.timeout = 600
    fetch = srv.geo.client.cdc_bootstrap

    def timed(host, index):
        t0 = time.time()
        resp = fetch(host, index)
        boot.update(t_asked=t0, fetch_s=time.time() - t0, fragments=len(resp["fragments"]),
                    wire_bytes=sum(len(f["data"]) for f in resp["fragments"]))
        return resp

    srv.geo.client.cdc_bootstrap = timed
    srv.open()
    return {}


def status(cmd):
    out = dict(geo=srv.geo.debug_vars(), boot=dict(boot))
    if srv.cdc is not None and srv.cdc.log("ev") is not None:
        log = srv.cdc.log("ev")
        out.update(last_pos=log.last_pos, base_pos=log.base_pos)
    out["links"] = {n: l.pos for n, l in srv.geo.tailer._links.items()}
    return out


def report():
    eng = srv.executor._engine if srv is not None else None
    ctl.sync()
    return dict(node=hosts[r], launches=dict(kernels.LAUNCHES),
                plain=dict(kernels.PLAIN_CALLS),
                engine=eng.snapshot() if eng is not None else None,
                max_mem_gib=ctl.max_mem_gib())


ctl.serve(report, lambda: srv is not None and srv.close(), ready=lambda cmd: ready,
          follow=follow, status=status)
"""


def main_path_k1(torch, kernels, H, rng, out, smi, phases, planes, device=None):
    """Path (k1): a geo follower of (j3)'s index on one card. A leader
    process (index ev: f over K_SHARDS shards x 128 rows, filled before
    capture, then `[cdc] enabled` with retention-ops K_RETENTION and `[geo]
    role = leader`; K_RETENTION + 1 Sets of a row absent from the reads
    fold its log once) and a follower process (`role = follower`) that
    bootstraps the whole index (its cursor 0 is behind retention: a 410,
    then the base images). Then K_WRITERS writers send K_WRITES Sets or
    Clears each to the leader while K_READERS readers send
    Count(Intersect(Row(f=a), Row(f=b))) to the follower with
    X-Pilosa-Max-Staleness: every answer is a typed 409 or equals numpy's
    count after a prefix of the leader's change log; once the lag is 0
    every answer equals the final count. A write to the follower gets the
    typed 409; POST /geo/promote; the new leader accepts writes, the old
    one is fenced (409) and re-tails; both end equal numpy."""
    import shutil
    import tempfile

    from pilosa_tpu_torch.cdc.log import decode_cdc_records
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.storage.bitmap import decode_op_records

    H = H[:, :K_SHARDS]
    n_rows = H.shape[0]
    wr = n_rows  # the prefix row: absent from H and from every read below
    k = {"shards": K_SHARDS, "smi": smi}
    work = tempfile.mkdtemp(prefix="pilosa-torch-k-")
    ctl = os.path.join(work, "ctl")
    os.makedirs(ctl)
    ports = free_ports(2)
    lp, fp = ports
    job = None

    def finish(name, reps, *need):
        got = {"launches": {x: sum(r["launches"][x] for r in reps) for x in kernels.LAUNCHES},
               "plain_calls": {x: sum(r["plain"][x] for r in reps)
                               for x in kernels.PLAIN_CALLS}}
        phases[name] = got
        log(f"counters {name}: launches {got['launches']}, plain twins "
            f"{got['plain_calls']}")
        ran = got["plain_calls"] if device == "cpu" else got["launches"]
        assert device == "cpu" or not any(got["plain_calls"].values()), (name, got)
        for x in need:
            assert ran[x] > 0, (name, x, got)
        for i, rep in enumerate(reps):
            snap = rep["engine"] or {}
            bad = {x: snap[x] for x in LADDER if snap.get(x)}
            assert not bad, (name, i, bad)

    try:
        cfg = dict(here=HERE, work=work, ports=ports, ctl=ctl, f_path=planes["f_path"],
                   n_shards=K_SHARDS, retention=K_RETENTION, wr=wr, device=device)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        job = RankJob(cfg, work, script=WORKER_K, n=2)
        lead = job.ask(0, "ready", timeout=900)
        k["leader_start_s"] = time.perf_counter() - t0
        assert lead["base_pos"] > 0, lead
        k.update(fill_s=lead["fill_s"], capture_open_s=lead["capture_open_s"],
                 prefix_s=lead["prefix_s"], base_pos=lead["base_pos"],
                 prefix_last_pos=lead["last_pos"])
        log(f"main (k1) [{smi}]: geo leader process on {torch.cuda.get_device_name(0)}: "
            f"index ev ({K_SHARDS} shards x {n_rows} rows of f) filled in "
            f"{lead['fill_s']:.1f} s, reopened with change capture and [geo] role leader in "
            f"{lead['capture_open_s']:.1f} s; {K_RETENTION + 1} Sets of row {wr} in "
            f"{lead['prefix_s']:.1f} s folded the log to base position {lead['base_pos']}")

        # ---- the follower bootstraps
        job.ask(1, "ready")
        t0 = time.perf_counter()
        job.ask(1, "follow", timeout=300)
        deadline = time.perf_counter() + 600
        while True:
            st = job.ask(1, "status")
            tail = st["geo"]["tail"]
            if tail["bootstraps"] >= 1 and st["links"].get("ev", 0) >= lead["last_pos"]:
                break
            assert time.perf_counter() < deadline, st
            time.sleep(0.2)
        k["bootstrap_s"] = time.perf_counter() - t0
        k["bootstrap"] = st["boot"]
        assert tail["bootstraps"] == 1 and tail["apply_errors"] == 0, tail
        assert st["boot"]["fragments"] >= K_SHARDS, st["boot"]
        job.ask(1, "reset")
        log(f"main (k1) [{smi}]: the follower process bootstrapped from the leader in "
            f"{k['bootstrap_s']:.1f} s (the bootstrap answer took "
            f"{st['boot']['fetch_s']:.1f} s: {st['boot']['fragments']} fragment images, "
            f"{st['boot']['wire_bytes']} bytes of base64 zlib); cursor {st['links']['ev']}")

        # ---- writers to the leader, readers on the follower
        a, b = (int(x) for x in rng.choice(n_rows, 2, replace=False))
        bits = {x: np.unpackbits(H[x].view(np.uint8), axis=1,
                                 bitorder="little").reshape(-1).astype(bool) for x in (a, b)}
        base = int(np.count_nonzero(bits[a] & bits[b]))
        read = f"Count(Intersect(Row(f={a}), Row(f={b})))"
        cols = rng.permutation(K_SHARDS * SHARD_WIDTH)[:K_WRITERS * K_WRITES]
        writes = []
        for i in range(K_WRITERS):
            ops = []
            for j, col in enumerate(cols[i::K_WRITERS]):
                row = (a, b)[j % 2]
                op = "Clear" if bits[row][col] else "Set"
                ops.append(f"{op}({int(col)}, f={row})")
            writes.append(ops)
        lead_pos0 = job.ask(0, "status")["last_pos"]
        cfg_path = os.path.join(work, "k1-clients.json")
        res_path = os.path.join(work, "k1-result.json")
        stop, wdone = os.path.join(work, "k1-stop"), os.path.join(work, "k1-writers")
        with open(cfg_path, "w") as f:
            json.dump(dict(leader=lp, follower=fp, index="ev", writes=writes,
                           readers=K_READERS, read=read, staleness=K_STALENESS,
                           stop=stop, writers_done=wdone, result=res_path,
                           deadline=time.time() + 600), f)
        lags = []
        proc = subprocess.Popen([sys.executable, "-c", K_CLIENTS_SCRIPT, cfg_path],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            while not os.path.exists(wdone):
                assert proc.poll() is None, proc.communicate()[1][-3000:]
                assert time.perf_counter() - t0 < 300, "the writers did not finish"
                _, gs = http(fp, "GET", "/geo/status")
                lags.append(gs.get("lag"))
                time.sleep(0.1)
            k["write_s"] = time.perf_counter() - t0
            lead_pos1 = job.ask(0, "status")["last_pos"]
            while True:
                st = job.ask(1, "status")
                _, gs = http(fp, "GET", "/geo/status")
                lags.append(gs.get("lag"))
                # Lag 0 in positions: the follower's cursor is at the
                # leader's head (its lag in seconds keeps the time since
                # the last poll returned, up to the 0.25 s long-poll).
                if st["links"]["ev"] >= lead_pos1:
                    break
                assert time.perf_counter() - t0 < 300, (st, gs)
                time.sleep(0.05)
            k["catch_up_s"] = time.perf_counter() - t0 - k["write_s"]
            time.sleep(0.5)  # the readers read at lag 0 too
        finally:
            open(stop, "w").close()
            _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        with open(res_path) as f:
            clients = json.load(f)

        # The count after every prefix of the leader's change log, from its
        # own stream: the follower applies records in that order.
        status_, data = http_raw(lp, f"/cdc/stream?index=ev&from={lead_pos0}&timeout=0"
                                     f"&max-bytes={64 << 20}")
        assert status_ == 200
        recs = [rec for rec, _ in decode_cdc_records(data)]
        assert [rec.position for rec in recs] == list(range(lead_pos0 + 1, lead_pos1 + 1))
        count, prefix = base, [base]
        for rec in recs:
            for adds, rems in decode_op_records(rec.ops):
                for pos, on in [(p, True) for p in adds] + [(p, False) for p in rems]:
                    row, col = int(pos) // SHARD_WIDTH, rec.shard * SHARD_WIDTH + int(pos) % SHARD_WIDTH
                    if row not in bits:
                        continue
                    before = bits[a][col] and bits[b][col]
                    bits[row][col] = on
                    count += int(bits[a][col] and bits[b][col]) - int(before)
            prefix.append(count)
        final = count
        assert final == int(np.count_nonzero(bits[a] & bits[b]))
        valid = set(prefix)
        acked = 0
        for res in clients[:K_WRITERS]:
            for _, _, status_, body in res:
                assert status_ == 200, (status_, body[:300])
                acked += 1
        assert acked == K_WRITERS * K_WRITES and len(recs) == acked, (acked, len(recs))
        lat, stale, n_reads, at_zero = [], 0, 0, 0
        t_zero = None
        for res in clients[K_WRITERS:]:
            for t_req, dt, status_, body in res:
                n_reads += 1
                if status_ == 409:
                    assert "staleness" in body, body[:300]
                    stale += 1
                    continue
                assert status_ == 200, (status_, body[:300])
                got = json.loads(body)["results"][0]
                assert got in valid, (got, base, final)
                lat.append(dt)
        # Lag 0 reached: every answer now is the final count.
        for _ in range(16):
            st_, got = http(fp, "POST", "/index/ev/query", read,
                            headers={"X-Pilosa-Max-Staleness": K_STALENESS})
            assert st_ == 200 and got["results"] == [final], (st_, got, final)
            at_zero += 1
        lag_vals = [x for x in lags if x is not None]
        k["load"] = dict(writes=acked, reads=n_reads, reads_409=stale, reads_at_lag_0=at_zero,
                         follower_count_p50_ms=pct(lat, 50) if lat else None,
                         follower_count_p99_ms=pct(lat, 99) if lat else None,
                         lag_p50_ms=pct(lag_vals, 50) if lag_vals else None,
                         lag_max_s=max(lag_vals) if lag_vals else None,
                         lag_unknown_samples=len(lags) - len(lag_vals),
                         prefix_counts=len(valid), base=base, final=final)
        reps = job.all("report")
        finish("k1_follower_reads", reps[1:], "gather_expr_count")
        k["follower_k1_after_bootstrap"] = reps[1]["launches"]["gather_expr_count"]
        assert k["follower_k1_after_bootstrap"] > 0 or device == "cpu", reps[1]["launches"]
        log(f"main (k1) [{smi}]: {K_WRITERS} writers x {K_WRITES} Sets/Clears to the leader "
            f"in {k['write_s']:.1f} s while {K_READERS} readers sent {read} to the follower "
            f"(max staleness {K_STALENESS} s): {n_reads} answers, {stale} typed 409s, every "
            f"other one equal numpy's count after a prefix of the leader's log ({len(valid)} "
            f"distinct prefix counts, {base} -> {final}); follower Count p50 "
            f"{k['load']['follower_count_p50_ms']} ms; lag p50 {k['load']['lag_p50_ms']} ms, "
            f"max {k['load']['lag_max_s']} s; caught up {k['catch_up_s']:.2f} s after the "
            f"last write, then {at_zero} answers equal the final count; the follower's K1 "
            f"launches after its bootstrap {k['follower_k1_after_bootstrap']}")

        # ---- a write to the follower, then promotion and fencing
        st_, got = http(fp, "POST", "/index/ev/query", f"Set(3, f={a})")
        assert st_ == 409 and "epoch" in got["error"], (st_, got)
        job.all("reset")
        t0 = time.perf_counter()
        st_, got = http(fp, "POST", "/geo/promote", "")
        assert st_ == 200 and got["role"] == "leader" and got["epoch"] == 1, got
        while http(lp, "GET", "/geo/status")[1]["role"] != "follower":
            assert time.perf_counter() - t0 < 120, "the old leader was not fenced"
            time.sleep(0.05)
        k["promotion_s"] = time.perf_counter() - t0
        st_, got = http(lp, "POST", "/index/ev/query", f"Set(3, f={a})")
        assert st_ == 409 and got.get("current") == 1, (st_, got)
        free = np.flatnonzero(~bits[a] & bits[b])[:K_PROMOTED_WRITES]
        for col in free:
            assert query(fp, "ev", f"Set({int(col)}, f={a})") == [True]
            bits[a][col] = True
        final = int(np.count_nonzero(bits[a] & bits[b]))
        want_a = int(np.count_nonzero(bits[a]))
        t1 = time.perf_counter()
        while query(lp, "ev", read) != [final]:
            assert time.perf_counter() - t1 < 300, "the old leader did not re-tail"
            time.sleep(0.1)
        k["retail_s"] = time.perf_counter() - t1
        for port in (lp, fp):
            assert query(port, "ev", read) == [final], port
            assert query(port, "ev", f"Count(Row(f={a}))") == [want_a], port
        reps = job.all("report")
        finish("k1_promotion", reps, "gather_expr_count")
        k["final"] = dict(count=final, row_a=want_a)
        log(f"main (k1) [{smi}]: a write to the follower got the typed 409; POST /geo/promote: "
            f"the old leader fenced (role follower, writes 409 at epoch 1) in "
            f"{k['promotion_s']:.2f} s; the new leader took {K_PROMOTED_WRITES} Sets and the "
            f"old one re-tailed them in {k['retail_s']:.2f} s; both answer {read} = {final} "
            f"and Count(Row(f={a})) = {want_a}, equal numpy")
        finals = job.stop()
        k["final_launches"] = [f_["launches"] for f_ in finals]
    finally:
        if job is not None:
            job.close()
        shutil.rmtree(work, ignore_errors=True)
    out["k1"] = k


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
