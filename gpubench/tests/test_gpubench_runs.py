"""Whole runs of the cell at a few shards on the CPU: the result line's
schema, correct on sound runs, and not correct with each fault the cell
can have planted under the timed path."""

import json

import pytest

from gpubench import harness, spec
from gpubench.tests import faults
from gpubench.tests.tiny import tiny_hooks

CELLS = ("taxi-1b.groupby-live",)
# The faults each cell can have: an answer altered, half of each read
# left out, and for the cell that writes, writes acknowledged but lost.
CELL_FAULTS = [("taxi-1b.groupby-live", "alter_answers"),
               ("taxi-1b.groupby-live", "half_shards"),
               ("taxi-1b.groupby-live", "drop_writes")]


def _run(capsys, cell, seed, trace, fault=None):
    hooks = tiny_hooks(after_server=faults.ALL[fault] if fault else None)
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "2",
                       "--trace", str(trace)], hooks=hooks)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def _check_schema(line, cell, trace):
    bench = spec.benchmark()
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "sense", "limit"}, name
        assert c["sense"] in ("<=", ">="), name
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in spec.metrics_for(bench, cell, section)}
    for name, m in line["metrics"].items():
        assert want[name] == m["unit"]
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct_and_reports_its_metrics(capsys, tmpdir_env, cell, trace):
    rc, line = _run(capsys, cell, 2 ** 31 + 12345 + trace, trace)
    assert rc == 0
    _check_schema(line, cell, trace)
    assert line["correct"] is True, line
    assert line["failed"] == 0
    if not trace:
        # No card: the window's memory peak is absent, never 0.
        assert set(line["metrics"]) == {"setup_s"}
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        # No card: the device's metrics are absent, never 0.
        assert "device_idle_pct" not in line["metrics"]
        assert {"read_calls_per_s", "request_p95_ms", "parse_ms",
                "dispatch_ms"} <= set(line["metrics"])
        assert line["metrics"]["read_calls_per_s"]["value"] > 0


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_planted_fault_makes_the_run_not_correct(capsys, tmpdir_env, cell, fault):
    rc, line = _run(capsys, cell, 99, 0, fault)
    assert rc == 0
    assert line["correct"] is False, (fault, line["checks"])
    assert any(not harness._holds(c["value"], c["sense"], c["limit"])
               for c in line["checks"].values())
