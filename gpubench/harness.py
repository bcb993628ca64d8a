"""One run of one cell: set-up (the port's servers on the cards, as the
configuration's deployment kind starts them, the index made from the
seed, its planes made resident, a warm-up of the cell's own traffic), the
measured window, the read-back, the reference's judgement, and the
result's line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit."""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import clients, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")
CLIENTS = os.path.join(spec.HERE, "clients.py")
START_MARGIN_S = 1.5
DRAIN_S = 120.0


class Hooks:
    """What a test changes in a run: the device (the CPU skips the look
    for a card), the configuration and cell (smaller), and a function
    called with the server before the traffic (a planted fault). In a
    deployment of several server processes: each rank's device (all on
    one card, say) and the name of a fault of gpubench/tests/faults.py
    that every rank plants on its server before the traffic."""

    device: Optional[str] = None
    config: Optional[Callable[[dict], dict]] = None
    cell: Optional[Callable[[dict], dict]] = None
    after_server: Optional[Callable] = None
    shards_per_block: int = 8
    rank_devices: Optional[List[str]] = None
    rank_fault: Optional[str] = None


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def _field_calls(columns, fields: List[str]) -> List[dict]:
    """A Count of every row of each set field, the Sum of each int field."""
    calls = []
    for name in fields:
        f = columns.field(name)["field"]
        if f["type"] == "set":
            calls += [{"agg": "Count", "field": None, "where": [[name, "row", r, None]]}
                      for r in columns.rows(name)]
        else:
            calls.append({"agg": "Sum", "field": name, "where": []})
    return calls


def _render(traffic, call: dict) -> str:
    if not call["where"]:
        return f"Sum(field={call['field']})"
    return traffic.render(call)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, hooks: Optional[Hooks] = None, t_proc: Optional[float] = None) -> int:
    t_proc = time.monotonic() if t_proc is None else t_proc
    args = parse_args(argv)
    hooks = hooks or Hooks()
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.workload)
    cell = spec.workload(args.workload)
    cfg = spec.config(cell["config"])
    if hooks.config:
        cfg = hooks.config(cfg)
    if hooks.cell:
        cell = hooks.cell(cell)

    import torch

    import pilosa_tpu_torch  # noqa: F401  (the system under test; absent, the run ends here)

    if hooks.device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            log(f"needs {entry['chips']} CUDA card(s): torch.cuda.is_available() "
                f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
            return 3
    device = torch.device(hooks.device or "cuda:0")
    on_card = device.type == "cuda"
    if on_card:
        from . import probes

        print(f"# device: {torch.cuda.get_device_name(device)}; nvidia-smi name, power "
              f"limit: {probes.power_limit()}", flush=True)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    data_dir = tempfile.mkdtemp(prefix="gpubench-", dir=base)
    try:
        line, checks = _run(args, hooks, bench, entry, cell, cfg, torch, device, on_card,
                            data_dir, t_proc)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        log(f"refusing to report: modules of JAX or the JAX package are loaded: {bad}")
        return 4
    for name, (value, sense, limit) in checks.items():
        print(f"check {name}: {value} (limit {sense} {limit})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _run(args, hooks, bench, entry, cell, cfg, torch, device, on_card, data_dir, t_proc):
    from . import check, datagen, reference

    phases: Dict[str, float] = {}
    t = time.monotonic()
    phases["start"] = t - t_proc
    columns = datagen.Columns(cfg, args.seed, device, hooks.shards_per_block)
    index = cfg["index"]
    node = spec.deployment(cfg.get("deployment_kind", spec.DEFAULT_DEPLOYMENT)).Deployment(
        args, hooks, cfg, columns, torch, device, on_card, data_dir, log)
    node.start(phases, t)

    # The set-up reads every row the cell's traffic reads into the
    # servers' caches, as serving nodes hold their index, and checks
    # those answers.
    t = time.monotonic()
    traffic = spec.traffic(cell["traffic_kind"])
    warm_calls = _field_calls(columns, cell["warm_fields"])
    warm_answers = node.warm(index, [_render(traffic, c) for c in warm_calls], phases, t)

    plan = traffic.plan(cell, columns, args.seed, cell["warmup_s"] + args.seconds)
    calls_of = {pql: len(plan["requests"][tag]["calls"])
                for work in plan["readers"] for tag, pql in work}
    node.arm(args.trace)
    t_start = time.monotonic() + START_MARGIN_S
    t_win0 = t_start + cell["warmup_s"]
    t_win1 = t_win0 + args.seconds
    ing = cell.get("ingest") or {}
    client_plan = {
        "ports": node.ports, "index": index, "t0": t_start, "t_end": t_win1,
        "readers": plan["readers"],
        "rides": [[t_start + k / ing["rate_per_s"], k, r["pql"]]
                  for k, r in enumerate(plan["rides"])]}
    out_path = os.path.join(data_dir, "clients.out")
    err_path = os.path.join(data_dir, "clients.err")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, CLIENTS], stdin=subprocess.PIPE,
                                stdout=out, stderr=err, text=True)
        try:
            proc.stdin.write(json.dumps(client_plan))
            proc.stdin.close()
            _sleep_until(t_win0)
            setup_s = time.monotonic() - t_proc
            phases["warmup"] = time.monotonic() - t_start
            node.open(proc.pid)
            _sleep_until(t_win1)
            node.close()
            proc.wait(timeout=args.seconds + cell["warmup_s"] + DRAIN_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    node.disarm()
    if proc.returncode != 0:
        with open(err_path) as f:
            raise RuntimeError(f"the client process failed ({proc.returncode}): {f.read()[-2000:]}")
    with open(out_path) as f:
        records = json.load(f)

    readback_calls = _field_calls(columns, columns.loaded) if cell.get("readback") else []
    readback_answers = clients.query_all(node.ports, index,
                                        [_render(traffic, c) for c in readback_calls])
    served = node.finish()
    del node
    gc.collect()

    # ---- the reference, once the program's state is freed
    t = time.monotonic()
    all_calls = [c for r in plan["requests"] for c in r["calls"]] + readback_calls + warm_calls
    ref = reference.Reference(columns, [reference.group_of(c) for c in all_calls])
    ref.build()
    judge = check.Judge(ref, plan["requests"], plan["rides"], records["writes"])
    reads = records["reads"]
    verdict = judge.reads(reads)
    back = judge.readback(readback_calls, [a[0] if a else None for a in readback_answers])
    warm_wrong = sum(1 for c, a in zip(warm_calls, warm_answers)
                     if a != reference.expected(c, ref.answer(c)))
    ref_s = time.monotonic() - t

    in_window = [r for r in reads if t_win0 <= r[3] < t_win1]
    good_calls = sum(r[6] for r in in_window)
    bad_reads = sum(1 for r in in_window if r[6] < len(plan["requests"][r[1]]["calls"]))
    win_writes = [w for w in records["writes"] if t_win0 <= w[2] < t_win1]
    failed_writes = judge.failed_writes
    checks = {
        "wrong_calls": (verdict["wrong_calls"], "<=", 0),
        "failed_reads": (verdict["failed_reads"], "<=", 0),
        "failed_writes": (len(failed_writes), "<=", 0),
        "readback_wrong": (back["readback_wrong"], "<=", 0),
        "warm_wrong": (warm_wrong, "<=", 0),
    }
    if ing:
        behind, delivered = _ingest(records["writes"], t_start, t_win1)
        checks["ingest_behind_s"] = (behind, "<=", cell["limits"]["ingest_behind_s"])
        checks["ingest_rides_per_s"] = (delivered, ">=", cell["limits"]["ingest_rides_per_s"])
    correct = all(_holds(*c) for c in checks.values()) and verdict["calls"] > 0
    if not correct:
        log(f"not correct: reads {verdict['examples']}; read-back {back['examples']}; "
            f"writes {failed_writes[:3]}")
    rec = {
        "seconds": args.seconds, "reads": in_window, "good_calls": good_calls,
        "writes": [w for w in records["writes"] if t_win0 <= w[1] < t_win1],
        "setup_s": setup_s, "counters": served["counters"],
        "peak_window_bytes": served["peak_window"],
        "calls_of": lambda pql: calls_of.get(pql, 0),
        "read_traces": [], "launch_bytes": {}, "device": None,
    }
    device_info = {"platform": "gpu" if on_card else device.type, "kind": served["kind"],
                   "count": served["count"], "memory_peak_bytes": int(served["memory_peak"])}
    breakdown = None
    if args.trace:
        rec["read_traces"] = [tr for tr in served["traces"]
                              if tr[0] in calls_of and t_win0 <= tr[1] + tr[2] < t_win1]
        rec["launch_bytes"] = served["launch_bytes"]
        if served["device"] is not None:
            rec["device"] = served["device"]
            device_info.update(served["device_line"])
            breakdown = served["breakdown"]
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, args.workload, section):
        value = spec.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct),
            "attempted": len(in_window) + len(win_writes),
            "failed": bad_reads + sum(1 for w in win_writes if w[4] != 200),
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["run"] = {
        "setup_phases_s": phases, "reference_s": ref_s, "reads": len(reads),
        "reads_in_window": len(in_window), "calls_checked": verdict["calls"],
        "writes": len(records["writes"]), "writes_in_window": len(win_writes),
        "write_send_late_max_s": max((w[2] - w[1] for w in records["writes"]), default=None),
        "counters": {k: v for k, v in rec["counters"].items()},
        "gc": served["gc"],
        "containers": served["containers"],
        **served["run"],
    }
    line["checks"] = {k: {"value": v, "sense": sense, "limit": lim}
                      for k, (v, sense, lim) in checks.items()}
    by_second = served["by_second"]
    by_second["calls"] = _per_second(in_window, t_win0, args.seconds)
    by_second["writes_acked"] = _per_second([[0, 0, 0, w[3]] for w in win_writes], t_win0,
                                            args.seconds)
    print("# by_second: " + json.dumps(by_second), flush=True)
    return line, checks


def _holds(value, sense: str, limit) -> bool:
    return value <= limit if sense == "<=" else value >= limit


def _ingest(writes: List[list], t_first: float, t_close: float):
    """(the largest wait from a ride's due time to its answer, rides
    answered by the close a second from the first due time to the close)
    over the rides due before the close."""
    due = [w for w in writes if w[1] < t_close]
    behind = max((w[3] - w[1] for w in due), default=0.0)
    answered = sum(1 for w in due if w[4] == 200 and w[3] < t_close)
    return behind, answered / (t_close - t_first)


def _per_second(records, t0: float, seconds: float) -> List[int]:
    """Good calls (the records' last field) or records, by second of the
    window in which they were answered."""
    out = [0] * max(1, int(np.ceil(seconds)))
    for r in records:
        i = int(r[3] - t0)
        if 0 <= i < len(out):
            out[i] += r[6] if len(r) > 6 else 1
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))
