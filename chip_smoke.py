#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pilosa_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 11] [--shards 256] [--rows 128]

Run from the root of a checkout on a machine with one CUDA card (written
for an H100, sm_90a). It imports nothing of JAX and nothing of pilosa_tpu.
Phases, each of which fails the run if it fails:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — nvcc builds K1 and K2 from pilosa_tpu_torch/csrc.
3. kernels — each kernel against its plain PyTorch twin on the same CUDA
             tensors, exact equality: K1 at small shapes (2 leaves, 3
             leaves with Difference, a deep k-ary nest, ragged S), at
             engine.count's Q=1 over S=256, W=32768 (2 leaves and the
             nest) and at the serving shape (U=128, S=256, W=32768, L=2,
             Q=256); K2 at R=128 and R=1, S=256, with and without a mask.
             Times (CUDA events), bytes moved, and bounds (K1's counts the
             distinct slots a batch names, each read once).
4. main    — the bench_big serving shape through the port's entry
             points: index "big", field "f", 256 shards x 128 rows of
             random ~50%-density planes made from --seed and injected as
             dense containers (4 GiB on the host). (a) Executor.execute
             Count(Intersect) for several pairs plus a Union/Difference/
             Xor nest, (b) engine.count_batch over 256 distinct pairs, then
             timed batches, (c) TopN(f, n=10) and TopN(f, Row(f=a), n=10),
             (d) a Set on one shard and a recount (the stale stack is
             re-gathered). Every answer is checked against numpy on the
             fragments' host planes (TopN against a numpy replay of the
             two-phase ranking).
5. kernel line — launch counters set to 0 just before each path of
             phase 4 and read just after it: K1 above 0 in (a), (b) and
             (d), K2 above 0 in the filtered TopN, the plain twins at 0
             in every path; the line carries their sums.

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


def cuda_time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_kernels(torch, kernels, engine_mod, rng, report, u, s, q,
                  dev="cuda"):
    """Each kernel against its twin on the card; returns per-kernel rows.
    (u, s, q) is the main path's batch shape: leaf rows, shards, queries."""
    from pilosa_tpu_torch.constants import WORDS_PER_ROW

    dev = torch.device(dev)
    P = engine_mod.lower_tape
    maxerr = {"gather_expr_count": 0, "masked_plane_counts": 0}

    def rand_planes(shape):
        g = torch.Generator(device=dev)
        g.manual_seed(int(rng.integers(1 << 31)))
        return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def k1_case(name, u, s, w, ir, q, distinct=False):
        stacked = rand_planes((u, s, w))
        tape = P(ir)
        n_leaves = max(c >> 8 for c in tape if c & 0xFF == 0) + 1
        if distinct:  # one query over slots 0..L-1, as engine.count gives it
            idxs = torch.arange(n_leaves, dtype=torch.int32).reshape(n_leaves, 1)
        else:
            idxs = torch.from_numpy(
                rng.integers(0, u, size=(n_leaves, q)).astype(np.int32))
        got = kernels.gather_expr_count(stacked, idxs, tape)
        want = kernels.gather_expr_count_plain(stacked, idxs, tape)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        maxerr["gather_expr_count"] = max(maxerr["gather_expr_count"], err)
        if err:
            raise AssertionError(f"K1 {name}: kernel != twin (max err {err})")
        log(f"K1 {name}: U={u} S={s} W={w} L={n_leaves} Q={q} tape={len(tape)} ops: exact")

    leaf = lambda i: ("leaf", i)  # noqa: E731
    k1_case("2 leaves", 8, 4, 256, ("Intersect", (leaf(0), leaf(1))), 16)
    k1_case("3 leaves Difference", 8, 4, 512,
            ("Difference", leaf(0), (leaf(1), leaf(2))), 16)
    nest = ("Xor", (("Intersect", (("Union", (leaf(0), leaf(1))), leaf(2),
                                   ("Difference", leaf(3), (leaf(4), leaf(5))))),
                    ("Union", (leaf(6), ("Intersect", (leaf(7), leaf(8))))),
                    leaf(9)))
    k1_case("deep k-ary nest", 16, 3, 1024, nest, 12)
    k1_case("ragged S", 6, 5, 32768, ("Union", (leaf(0), leaf(1), leaf(2))), 7)
    # engine.count's shapes on the main path: Q=1 over the full S, W.
    k1_case("single Count, 2 leaves", 2, s, WORDS_PER_ROW,
            ("Intersect", (leaf(0), leaf(1))), 1, distinct=True)
    k1_case("single Count, nest", 10, s, WORDS_PER_ROW, nest, 1, distinct=True)

    # Serving shape (bench_big): U=128, S=256, W=32768, L=2, Q=256.
    w = WORDS_PER_ROW
    stacked = rand_planes((u, s, w))
    pairs = distinct_pairs(rng, u, q)
    idxs = torch.from_numpy(np.ascontiguousarray(pairs.T.astype(np.int32)))
    tape = P(("Intersect", (leaf(0), leaf(1))))
    got = kernels.gather_expr_count(stacked, idxs, tape)
    want = kernels.gather_expr_count_plain(stacked, idxs, tape)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    maxerr["gather_expr_count"] = max(maxerr["gather_expr_count"], err)
    if err:
        raise AssertionError(f"K1 serving shape: kernel != twin (max err {err})")
    k1_ms = cuda_time_ms(torch, lambda: kernels.gather_expr_count(stacked, idxs, tape), 10)
    k1_plain_ms = cuda_time_ms(
        torch, lambda: kernels.gather_expr_count_plain(stacked, idxs, tape), 1, warm=0)
    # The least the function must move: each DISTINCT slot the batch names
    # read once, the slot ids read once, the (Q,) int64 sums written once.
    k1_unique = int(torch.unique(idxs).numel())
    k1_bytes = k1_unique * s * w * 4 + idxs.numel() * 4 + q * 8
    k1_ops = q * s * w * 3  # AND, popc, add per word
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k1_streamed = q * 2 * s * w * 4  # what this kernel's grid order reads

    # Copy bandwidth of the same byte count, same script (the bound a
    # plain device copy reaches on this card).
    n_copy = min(k1_bytes // 2, 8 << 30) // 4
    src = torch.empty(n_copy, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_time_ms(torch, lambda: dst.copy_(src), 10)
    copy_bw = 2 * n_copy * 4 / (copy_ms * 1e-3)
    del src, dst
    log(f"K1 serving shape U={u} S={s} W={w} L=2 Q={q}: exact; kernel {k1_ms:.4f} ms, "
        f"twin {k1_plain_ms:.2f} ms; {k1_unique} distinct slots, {k1_bytes / 1e9:.3f} GB "
        f"needed -> {k1_bytes / (k1_ms * 1e-3) / 1e9:.1f} GB/s; bound {k1_bound:.4f} ms "
        f"at the 3.35 TB/s data sheet, {k1_bytes / copy_bw * 1e3:.4f} ms at the "
        f"measured copy rate {copy_bw / 1e9:.1f} GB/s; the kernel streams "
        f"{k1_streamed / 1e9:.3f} GB ({k1_streamed / (k1_ms * 1e-3) / 1e9:.1f} GB/s "
        f"from L2/HBM)")

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
        ms = cuda_time_ms(torch, lambda: kernels.masked_plane_counts(rows, m), 10)
        plain_ms = cuda_time_ms(
            torch, lambda: kernels.masked_plane_counts_plain(rows, m), 1, warm=0)
        nbytes = (u * s * w + (s * w if m is not None else 0)) * 4 + u * s * 4
        ops = u * s * w * (3 if m is not None else 2)
        b_ms, b_by = bound(nbytes, ops)
        k2[label] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=b_ms,
                         bound_by=b_by, bound_copy_ms=nbytes / copy_bw * 1e3)
        log(f"K2 {label} R={u} S={s} W={w}: exact; kernel {ms:.4f} ms, twin "
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
    log("library yardstick: no single PyTorch call computes either function "
        "(torch has no popcount), so library_ms is null")
    del stacked, rows, mask
    torch.cuda.empty_cache()
    report["kernel_phase"] = {
        "k1_serving": dict(ms=k1_ms, plain_ms=k1_plain_ms, bytes=k1_bytes,
                           distinct_slots=k1_unique, streamed_bytes=k1_streamed,
                           bound_ms=k1_bound, bound_by=k1_by,
                           bound_copy_ms=k1_bytes / copy_bw * 1e3),
        "k2": k2, "copy_gbs": copy_bw / 1e9, "max_abs_err": maxerr,
    }
    return {
        "gather_expr_count": dict(ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
                                  bound_by=k1_by, max_abs_err=maxerr["gather_expr_count"]),
        "masked_plane_counts": dict(ms=k2["mask R=chunk"]["ms"],
                                    plain_ms=k2["mask R=chunk"]["plain_ms"],
                                    bound_ms=k2["mask R=chunk"]["bound_ms"],
                                    bound_by=k2["mask R=chunk"]["bound_by"],
                                    max_abs_err=maxerr["masked_plane_counts"]),
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

    def end(name, *need):
        torch.cuda.synchronize()
        got = {"launches": dict(kernels.LAUNCHES), "plain_calls": dict(kernels.PLAIN_CALLS)}
        phases[name] = got
        log(f"counters {name}: launches {got['launches']}, plain twins {got['plain_calls']}")
        assert not any(got["plain_calls"].values()), (name, got)
        for k in need:
            assert got["launches"][k] > 0, (name, k, got)

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
    log(f"main (a): Executor Count(Intersect) x{len(pairs_a)} and the "
        f"Union/Difference/Xor nest equal numpy (first, cold: "
        f"{out['count_cold_s']:.2f} s)")
    end(ph, "gather_expr_count")

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
    stages["slot_gather_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng._stacked_leaf_tensor("big", list(slots), tuple(shards))
    stages["stack_probe_ms"] = (time.perf_counter() - t0) * 1e3
    stages["k1_ms"] = k1_ms
    out["batch_host_stages"] = stages
    log(f"main (b): count_batch Q={len(calls)} equals numpy (cold {out['batch_cold_s']:.2f} s "
        f"incl. leaf gathers); timed x{args.reps}: {out['batch_ms']:.3f} ms/batch, "
        f"{out['batch_qps']:.1f} queries/s, {out['batch_gbs']:.1f} GB/s; device idle "
        f"share ~{out['batch_idle_share_est']:.3f} (1 - K1 time / batch wall time); "
        f"host stages of one batch: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    end(ph, "gather_expr_count")

    # ---- (a) timed: single Counts on resident leaves (the batch above
    # gathered the leaf planes of nearly every row)
    ph = start("a_execute_count_timed")
    qpairs = distinct_pairs(rng, n_rows, args.single)
    qs = [f"Count(Intersect(Row(f={a}), Row(f={b})))" for a, b in qpairs]
    ex.execute("big", qs[0])
    t0 = time.perf_counter()
    for q in qs:
        ex.execute("big", q)
    dt = time.perf_counter() - t0
    out["count_qps"] = len(qs) / dt
    out["count_ms"] = dt / len(qs) * 1e3
    log(f"main (a) timed: {len(qs)} Executor Counts, {out['count_ms']:.3f} ms each, "
        f"{out['count_qps']:.1f} queries/s")
    end(ph, "gather_expr_count")

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
    ex.execute("big", f"TopN(f, Row(f={fb}), n=10)")
    t0 = time.perf_counter()
    ex.execute("big", f"TopN(f, Row(f={fa}), n=10)")
    out["topn_filter_ms"] = (time.perf_counter() - t0) * 1e3
    end(ph, "masked_plane_counts")
    log(f"main (c): TopN(f, n=10) and TopN(f, Row(f={fa}), n=10) equal the numpy "
        f"replay; {out['topn_ms']:.1f} ms and {out['topn_filter_ms']:.1f} ms warm "
        f"({out['topn_filter_cold_ms']:.1f} ms first)")

    # ---- (d) a write, then recounts re-gather the stale stack
    a, b = (int(x) for x in pairs[0])
    s = n_shards // 2
    cols = np.flatnonzero(np.unpackbits(
        (~H[a, s] & H[b, s]).view(np.uint8), bitorder="little"))
    col = s * (H.shape[2] * 32) + int(cols[0])
    misses = eng.snapshot()["stack_misses"]
    ph = start("d_set_recount")
    assert ex.execute("big", f"Set({col}, f={a})") == [True]
    H[a, s, int(cols[0]) >> 5] |= np.uint32(1 << (int(cols[0]) & 31))
    got = ex.execute("big", f"Count(Intersect(Row(f={a}), Row(f={b})))")[0]
    assert got == want_pair(a, b) == wants[0] + 1, (got, wants[0])
    res = eng.count_batch("big", calls, shards)
    assert int(res[0]) == wants[0] + 1 and [int(x) for x in res[1:]] == [
        want_pair(int(p[0]), int(p[1])) if a in (int(p[0]), int(p[1])) else w
        for p, w in zip(pairs[1:], wants[1:])]
    assert eng.snapshot()["stack_misses"] >= misses + 2, "stale stack not re-gathered"
    end(ph, "gather_expr_count")
    log("main (d): Set then recount: Count and count_batch see the write "
        "(stale stacks re-gathered)")
    launches = {k: sum(p["launches"][k] for p in phases.values())
                for k in kernels.LAUNCHES}
    out["engine"] = eng.snapshot()
    out["phases"] = phases
    out["launches"] = launches
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["main"] = out
    ex.close()
    holder.close()
    return launches


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
    rows = check_kernels(torch, kernels, engine_mod, rng, report,
                         args.rows, args.shards, args.batch)
    launches = main_path(torch, pt, kernels, args, rng, report)

    source = "pilosa_tpu_torch/csrc/bitplane_kernels.cu"
    replaces = {"gather_expr_count": "pilosa_tpu/ops/pallas_kernels.py:145",
                "masked_plane_counts": "pilosa_tpu/parallel/engine.py:1922"}
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
