"""What a run reads: BENCHMARK.json, the cell's file, its configuration's
file, and the modules named by them. Everything is found by name, so a
new configuration, cell, traffic kind, column kind, deployment kind or
per-layer metric is a new file and no edit."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_DEPLOYMENT = "one_node"


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str) -> dict:
    """The cell's file, gpubench/workloads/<name>.json."""
    path = os.path.join(HERE, "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no cell file for workload {name!r} ({path})")
    cell = _load_json(path)
    cell.setdefault("name", name)
    return cell


def config(name: str) -> dict:
    """The configuration's file, gpubench/configs/<name>.json."""
    path = os.path.join(HERE, "configs", f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no configuration file for {name!r} ({path})")
    cfg = _load_json(path)
    cfg.setdefault("name", name)
    return cfg


def _module(folder: str, name: str):
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no module {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    """A traffic kind: gpubench/traffic/<kind>.py."""
    return _module("traffic", kind)


def column_kind(kind: str):
    """A column generator: gpubench/columns/<kind>.py."""
    return _module("columns", kind)


def deployment(kind: str):
    """A deployment kind, how a run starts the system and reads it:
    gpubench/deployments/<kind>.py. A configuration names its kind under
    `deployment_kind`; without one it is DEFAULT_DEPLOYMENT."""
    return _module("deployments", kind)


def metric(name: str):
    """A per-layer metric's reader: gpubench/metrics/<name>.py."""
    return _module("metrics", name)


def metrics_for(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    cell reports: those without a `workloads` key, and those listing it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def cell_entry(bench: dict, cell: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"workload {cell!r} is not in BENCHMARK.json")
