"""A configuration, a cell, a traffic kind, a column kind and a per-layer
metric are each one new file that the harness finds by name, with no
edit to a file that is there."""

import json
import os
import shutil

import pytest

from gpubench import datagen, spec


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's folders that spec reads instead."""
    for sub in ("configs", "workloads", "traffic", "metrics", "columns"):
        shutil.copytree(os.path.join(spec.HERE, sub), tmp_path / sub)
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    return tmp_path


def test_new_files_are_found_by_name(bench_copy):
    cfg = spec.config("taxi-1b")
    cfg["name"] = "taxi-half"
    cfg["columns_total"] = 500_000_000
    cfg["columns"].append({"name": "tip_cents", "kind": "halves", "of": "total_amount",
                           "field": {"type": "int", "min": 0, "max": 65535}})
    cfg["loaded_fields"].append("tip_cents")
    (bench_copy / "configs" / "taxi-half.json").write_text(json.dumps(cfg))
    (bench_copy / "columns" / "halves.py").write_text(
        "def generate(spec, n, gen, device, cols):\n"
        "    return cols[spec['of']] // 2\n")
    cell = spec.workload("taxi-1b.groupby-live")
    cell.update(config="taxi-half", traffic_kind="only_q3", readers=2)
    (bench_copy / "workloads" / "taxi-half.q3.json").write_text(json.dumps(cell))
    (bench_copy / "traffic" / "only_q3.py").write_text(
        "def plan(cell, columns, seed, seconds):\n"
        "    return {'requests': [], 'readers': [[]] * cell['readers'], 'rides': []}\n")
    (bench_copy / "metrics" / "rides_per_s.py").write_text(
        "def read(rec):\n    return 12.0\n")

    assert spec.config("taxi-half")["columns_total"] == 500_000_000
    assert spec.workload("taxi-half.q3")["config"] == "taxi-half"
    assert spec.traffic("only_q3").plan({"readers": 2}, None, 1, 10)["readers"] == [[], []]
    assert spec.metric("rides_per_s").read({}) == 12.0
    cols = datagen.Columns(spec.config("taxi-half"), 1, "cpu")
    assert cols.n_shards == 477
    small = spec.config("taxi-half")
    small["columns_total"] = 1 << 16
    _, _, _, c = next(datagen.Columns(small, 1, "cpu").iter_blocks())
    assert (c["tip_cents"] == c["total_amount"] // 2).all()


def test_a_missing_file_is_named_in_the_error(bench_copy):
    with pytest.raises(KeyError, match="no-such-cell"):
        spec.workload("no-such-cell")
    with pytest.raises(KeyError, match="metrics/no_such_metric.py"):
        spec.metric("no_such_metric")


def test_every_metric_and_cell_of_the_benchmark_has_its_file():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric(m["name"]).read), m["name"]
    for w in bench["workloads"]:
        cell = spec.workload(w["name"])
        assert cell["config"] == w["config"]
        assert callable(spec.traffic(cell["traffic_kind"]).plan)
    for c in bench["configs"]:
        assert os.path.join(spec.ROOT, c["file"]) == os.path.join(spec.HERE, "configs",
                                                                  c["name"] + ".json")
