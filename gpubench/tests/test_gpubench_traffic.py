"""The traffic generator follows the cell files, repeats with its seed,
and gives every seed the same mix."""

from collections import Counter

import pytest

from gpubench import datagen, spec

CELLS = ("taxi-1b.groupby-live",)


def _plan(cell_name, seed, per_reader=None, seconds=57):
    cell = spec.workload(cell_name)
    if per_reader:
        cell["requests_per_reader"] = per_reader
    cols = datagen.Columns(spec.config(cell["config"]), seed, "cpu")
    return cell, cols, spec.traffic(cell["traffic_kind"]).plan(cell, cols, seed, seconds)


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_file_names_what_the_benchmark_names(name):
    entry = spec.cell_entry(spec.benchmark(), name)
    cell = spec.workload(name)
    assert cell["config"] == entry["config"]
    cols = datagen.Columns(spec.config(cell["config"]), 1, "cpu")
    for f in cols.loaded + cell["warm_fields"]:
        cols.field(f)
    assert set(cell["warm_fields"]) <= set(cols.loaded)
    assert sum(float(eval(str(t["share"]))) for t in cell["requests"]) == pytest.approx(1)


def test_the_taxi_cell_is_as_specified():
    cell, cols, plan = _plan("taxi-1b.groupby-live", 5, per_reader=140)
    assert cell["readers"] == 32 and len(plan["readers"]) == 32
    assert cell["ingest"]["rate_per_s"] == 12
    kinds = Counter(plan["requests"][tag]["template"] for work in plan["readers"]
                    for tag, _ in work)
    assert kinds == {"Q3": 32 * 70, "Q4": 32 * 70}
    # Each reader walks a permutation: its first 70 Q3 are the 70 groups.
    first = [plan["requests"][t] for t, _ in plan["readers"][0]]
    q3 = {tuple(w[2] for w in r["calls"][0]["where"]) for r in first if r["template"] == "Q3"}
    assert len(q3) == 70
    pql = plan["readers"][0][0][1]
    assert pql.startswith("Count(Intersect(Row(passenger_count=")
    # Each ride writes every field the source's record has: 17 set
    # fields and the fare.
    ride = plan["rides"][0]
    assert ride["column"] == 1000000000
    assert ride["pql"].count("Set(") == 17 and "SetValue(col=1000000000, total_amount=" in ride["pql"]
    assert set(ride["values"]) == {c["name"] for c in cols.fields} and len(ride["values"]) == 18
    assert len(plan["rides"]) == 12 * 57


def test_a_rides_values_do_not_depend_on_the_runs_length():
    _, _, short = _plan("taxi-1b.groupby-live", 2 ** 31 + 9, per_reader=10, seconds=10)
    _, _, long = _plan("taxi-1b.groupby-live", 2 ** 31 + 9, per_reader=10, seconds=100)
    assert len(short["rides"]) == 120 and len(long["rides"]) == 1200
    assert long["rides"][:120] == short["rides"]
    assert long["rides"][1024] != long["rides"][0]


@pytest.mark.parametrize("name", CELLS)
def test_the_same_seed_repeats_the_traffic_and_another_reorders_the_same_mix(name):
    _, _, a = _plan(name, 2 ** 31 + 3, per_reader=60)
    _, _, b = _plan(name, 2 ** 31 + 3, per_reader=60)
    _, _, c = _plan(name, 2 ** 31 + 4, per_reader=60)
    assert a["readers"] == b["readers"] and a["rides"] == b["rides"]
    assert a["readers"] != c["readers"]
    mix = lambda p: Counter(p["requests"][t]["template"] for w in p["readers"] for t, _ in w)  # noqa: E731
    assert mix(a) == mix(c)
