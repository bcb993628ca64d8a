"""BSI Sum/Min/Max and Range, time-quantum Range, SetValue and attrs: the
port against the JAX package on the CPU.

A data directory is written by pilosa_tpu (3 shards): set fields f and g
(row attrs on f, column attrs on the index), int fields v (min -1000, so
the base offset is exercised), w (40 bits deep) and d1 (1 bit deep), and
a YMD time field t whose bits were set with timestamps across January to
March 2018. It is closed, copied, and opened by both packages. Every
query answers exactly what pilosa_tpu answers: ValCounts, Rows, Counts,
TopN pairs; engine.bsi_val_count equals the JAX engine's raw outputs.
"""

import shutil
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu.constants import SHARD_WIDTH
from pilosa_tpu.core.field import FieldOptions
from pilosa_tpu.parallel import EngineConfig
from pilosa_tpu.pql.parser import parse as jax_parse
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import EngineConfig as TorchEngineConfig
from pilosa_tpu_torch.pql.parser import parse as torch_parse

N_SHARDS = 3
N_ROWS = 12
W_MAX = (1 << 40) - 1
DAY0 = datetime(2018, 1, 1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bsi") / "data")
    h = pilosa_tpu.Holder(path)
    h.open()
    idx = h.create_index("i")
    rng = np.random.default_rng(33)
    n_cols = N_SHARDS * SHARD_WIDTH
    for name, density in (("f", 0.002), ("g", 0.004)):
        fld = idx.create_field(name)
        rows, cols = [], []
        for row in range(N_ROWS):
            c = rng.choice(n_cols, int(density * SHARD_WIDTH) + 50 * row, replace=False)
            rows.extend([row] * len(c))
            cols.extend(int(x) for x in c)
        fld.import_bits(rows, cols)
    for row in range(N_ROWS):
        idx.field("f").row_attr_store.set_attrs(
            row, {"color": ("red", "blue", "green")[row % 3], "rank": row})
    for col in (1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3):
        idx.column_attr_store.set_attrs(col, {"name": f"c{col}"})
    specs = (("v", -1000, 5000), ("w", 0, W_MAX), ("d1", 0, 1))
    for name, lo, hi in specs:
        fld = idx.create_field(name, FieldOptions(type="int", min=lo, max=hi))
        cols = rng.choice(n_cols, 4000, replace=False)
        vals = rng.integers(lo, hi, len(cols), endpoint=True)
        if name == "v":  # ties at both ends, and the extremes themselves
            vals[:5], vals[5:9] = lo, hi
        fld.import_value([int(c) for c in cols], [int(x) for x in vals])
    t = idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
    rows, cols, stamps = [], [], []
    for row in range(3):
        for day in range(0, 70, 3):
            c = rng.choice(n_cols, 40, replace=False)
            rows.extend([row] * len(c))
            cols.extend(int(x) for x in c)
            stamps.extend([DAY0 + timedelta(days=day + row)] * len(c))
    t.import_bits(rows, cols, stamps)
    ex = pilosa_tpu.Executor(h, workers=0)
    ex.execute("i", "SetValue(col=7, v=1234)")
    ex.execute("i", f"Set({SHARD_WIDTH + 9}, t=1, 2018-01-10T00:00)")
    ex.close()
    h.close()
    return path


def open_pair(data_dir, dst):
    jdir, tdir = str(dst / "jax"), str(dst / "torch")
    shutil.copytree(data_dir, jdir)
    shutil.copytree(data_dir, tdir)
    jh = pilosa_tpu.Holder(jdir)
    jh.open()
    th = pilosa_tpu_torch.Holder(tdir, device="cpu")
    th.open()
    jex = pilosa_tpu.Executor(
        jh, workers=0, engine_config=EngineConfig(gather_workers=1))
    # One gather thread on both sides, as on the JAX side: a module-scoped
    # pair must not start the engine's gather pool inside a test.
    tex = pilosa_tpu_torch.Executor(
        th, engine_config=TorchEngineConfig(gather_workers=1))
    return jh, th, jex, tex


def close_pair(jh, th, jex, tex):
    jex.close()
    tex.close()
    jh.close()
    th.close()


@pytest.fixture(scope="module")
def read_pair(data_dir, tmp_path_factory):
    """One pair for the read-only corpus (no test here writes to it)."""
    parts = open_pair(data_dir, tmp_path_factory.mktemp("reads"))
    yield parts[2], parts[3]
    close_pair(*parts)


@pytest.fixture
def pair(data_dir, tmp_path):
    parts = open_pair(data_dir, tmp_path)
    yield parts[2], parts[3]
    close_pair(*parts)


def norm(result):
    """Comparable form of an executor result, package-independent."""
    if hasattr(result, "columns") and hasattr(result, "segments"):
        return ("row", result.columns().tolist(), result.attrs)
    if isinstance(result, list):
        return [(p.id, p.count) for p in result]
    if hasattr(result, "val") and hasattr(result, "count"):
        return ("valcount", result.val, result.count)
    return result


def same(jex, tex, query):
    want = [norm(r) for r in jex.execute("i", query)]
    got = [norm(r) for r in tex.execute("i", query)]
    assert got == want, query
    return got


VAL_COUNTS = [
    "Sum(field=v)", "Min(field=v)", "Max(field=v)",
    "Sum(Row(g=1), field=v)", "Min(Row(g=1), field=v)", "Max(Row(g=1), field=v)",
    "Min(Intersect(Row(f=0), Row(g=0)), field=v)",
    "Max(Union(Row(f=2), Row(g=3)), field=v)",
    "Sum(Range(w > 1000000000), field=v)",
    "Max(Range(t=1, 2018-01-01T00:00, 2018-02-01T00:00), field=v)",
    # An empty filter (row 99 holds no bits).
    "Sum(Row(g=99), field=v)", "Min(Row(g=99), field=v)", "Max(Row(g=99), field=v)",
    "Sum(field=w)", "Min(field=w)", "Max(field=w)",
    "Sum(field=d1)", "Min(field=d1)", "Max(Row(f=3), field=d1)",
    # Walked: a filter the plan compiler refuses, a field with no BSI group.
    "Sum(Range(f=1, 2018-01-01T00:00, 2018-02-01T00:00), field=v)",
    "Max(Range(f=1, 2018-01-01T00:00, 2018-02-01T00:00), field=v)",
    "Sum(field=f)",
]

V_CONDITIONS = [
    "v == 1234", "v != 1234", "v < 100", "v <= 100", "v > -500", "v >= -500",
    "v >< [-200, 300]", "v != null",
    # Edges of the range: leading zeros, strict i == 0 steps, the extremes.
    "v == -1000", "v < -999", "v <= -1000", "v > 4999", "v >= 5000", "v == 5000",
    "v < 0", "v > 0", "v >< [-1000, -1000]", "v >< [4999, 5000]",
    # Out of range: collapse to zero or to not-null.
    "v > 6000", "v < -2000", "v == 9999", "v != 9999", "v < 6000",
    "v >= -1000", "v >< [-5000, 9000]", "v >< [6000, 7000]",
    # 40 bits deep, and 1 bit deep.
    "w > 123456789", "w < 549755813888", "w >< [1000, 34359738368]",
    "w == 0", "w != 5", "d1 == 1", "d1 < 1", "d1 > 0", "d1 >= 0",
]

TIME_RANGES = [
    "Range(t=1, 2018-01-05T00:00, 2018-01-15T00:00)",     # day views
    "Range(t=0, 2018-01-01T00:00, 2018-03-01T00:00)",     # month views
    "Range(t=2, 2018-01-20T00:00, 2018-02-10T00:00)",     # days across months
    "Range(t=2, 2017-01-01T00:00, 2019-01-01T00:00)",     # a year view
    "Range(f=1, 2018-01-01T00:00, 2018-02-01T00:00)",     # no quantum: walked
    "Range(t=1, 2019-05-01T00:00, 2019-06-01T00:00)",     # no populated view
]

NESTED = [
    "Intersect(Row(f=0), Range(v < 100))",
    "Union(Range(v > 4000), Range(w < 1000000))",
    "Difference(Row(f=1), Range(v >< [0, 2000]))",
    "Xor(Range(v >= 1000), Range(d1 == 1))",
    "Intersect(Range(t=1, 2018-01-01T00:00, 2018-02-15T00:00), Range(v > 0))",
    "Intersect(Row(f=2), Range(f=1, 2018-01-01T00:00, 2018-02-01T00:00))",
]

TOPN = [
    "TopN(f, Range(v > 1000), n=5)",
    "TopN(f, Range(v >< [-100, 100]), n=4)",
    "TopN(f, Range(t=1, 2018-01-01T00:00, 2018-02-01T00:00), n=4)",
    "TopN(f, Range(f=1, 2018-01-01T00:00, 2018-02-01T00:00), n=3)",
    "TopN(f, Range(v > 1000), ids=[0, 3, 5, 7])",
    'TopN(f, n=5, attrName="color", attrValues=["red"])',
    'TopN(f, Row(g=1), n=5, attrName="color", attrValues=["red", "green"])',
    'TopN(f, Row(g=1), ids=[0, 1, 2, 3, 4], attrName="color", attrValues=["blue"])',
    "TopN(f, Row(g=1), n=6, tanimotoThreshold=1)",
    "TopN(f, Row(g=2), n=6, tanimotoThreshold=3)",
    "TopN(f, Row(g=2), ids=[1, 2, 3, 4, 5, 6], tanimotoThreshold=2)",
    # Sources that overlap their rows, so the coefficient passes for some.
    "TopN(f, Union(Row(f=1), Row(f=2)), n=6, tanimotoThreshold=20)",
    "TopN(f, Union(Row(f=1), Row(g=1), Range(v > 0)), n=6, tanimotoThreshold=15)",
    "TopN(f, Union(Row(f=3), Row(f=4)), ids=[1, 2, 3, 4, 5, 6], tanimotoThreshold=30)",
    "TopN(f, n=5, tanimotoThreshold=50)",
]

CORPUS = (VAL_COUNTS
          + [f"Count(Range({c}))" for c in V_CONDITIONS]
          + [f"Range({c})" for c in V_CONDITIONS[:8] + V_CONDITIONS[18:26]]
          + [f"Count({q})" for q in TIME_RANGES] + TIME_RANGES
          + [f"Count({q})" for q in NESTED] + NESTED[:3]
          + TOPN)


@pytest.mark.parametrize("query", CORPUS)
def test_corpus_matches_jax(read_pair, query):
    same(*read_pair, query)


def test_only_refused_trees_are_walked(read_pair):
    """The compile gate refuses exactly the trees the JAX one refuses; a
    compiled tree never takes the shard walk."""
    jex, tex = read_pair
    for q in ["Count(Range(v > 10))", "Sum(Row(g=1), field=v)", TIME_RANGES[0]]:
        before = tex.engine.snapshot()["compile_gate_refusals"]
        same(jex, tex, q)
        assert tex.engine.snapshot()["compile_gate_refusals"] == before, q
    for q in [f"Count({TIME_RANGES[4]})", f"Count({TIME_RANGES[5]})"]:
        before = tex.engine.snapshot()["compile_gate_refusals"]
        same(jex, tex, q)
        assert tex.engine.snapshot()["compile_gate_refusals"] == before + 1, q


def test_range_past_256_views_is_walked(pair):
    """More than 256 populated views (a day-quantum field over 260 days):
    plan/signature.py refuses the tree, and the walk answers it as the
    JAX walk does."""
    from pilosa_tpu_torch.core.field import FieldOptions as TorchFieldOptions

    jex, tex = pair
    jex.holder.index("i").create_field("td", FieldOptions(type="time", time_quantum="D"))
    tex.holder.index("i").create_field("td", TorchFieldOptions(type="time", time_quantum="D"))
    for day in range(260):
        ts = (DAY0 + timedelta(days=day)).strftime("%Y-%m-%dT%H:%M")
        same(jex, tex, f"Set({day * 7 + day % 3 * SHARD_WIDTH}, td=2, {ts})")
    before = tex.engine.snapshot()["compile_gate_refusals"]
    q = "Count(Range(td=2, 2018-01-01T00:00, 2018-12-31T00:00))"
    assert same(jex, tex, q) == [260]
    assert tex.engine.snapshot()["compile_gate_refusals"] == before + 1


@pytest.mark.parametrize("writes,reads", [
    (["SetValue(col=5, v=4321)"],
     ["Sum(field=v)", "Count(Range(v == 4321))", "Max(field=v)", "Min(field=v)"]),
    ([f"SetValue(col={3 * SHARD_WIDTH + 1}, v=-1000)", "SetValue(col=11, v=5000, w=77)"],
     ["Min(field=v)", "Max(field=v)", "Count(Range(v == -1000))", "Sum(field=w)"]),
    (["Set(7, t=1, 2018-01-07T00:00)", "Set(9, t=5, 2019-05-02T00:00)"],
     ["Count(Range(t=1, 2018-01-05T00:00, 2018-01-15T00:00))",
      "Count(Range(t=5, 2019-05-01T00:00, 2019-06-01T00:00))",
      "Range(t=5, 2019-05-01T00:00, 2019-06-01T00:00)"]),
])
def test_writes_then_recount_match_jax(pair, writes, reads):
    jex, tex = pair
    for q in reads:  # warm both engines' caches: the recount must see the write
        same(jex, tex, q)
    for w in writes:
        same(jex, tex, w)
    for q in reads:
        same(jex, tex, q)


def test_attr_writes_match_jax(pair):
    jex, tex = pair
    for q in ['SetRowAttrs(f, 4, color="red", size=9)', 'SetColumnAttrs(99, name="x")',
              "Row(f=4)", 'TopN(f, Row(g=1), n=5, attrName="color", attrValues=["red"])']:
        same(jex, tex, q)
    jidx, tidx = jex.holder.index("i"), tex.holder.index("i")
    assert tidx.column_attr_store.attrs(99) == jidx.column_attr_store.attrs(99) == {"name": "x"}


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("flt", [None, "Row(g=1)", "Row(g=99)", "Range(v > 4000)"])
@pytest.mark.parametrize("field", ["v", "w", "d1"])
def test_bsi_val_count_matches_jax_engine(read_pair, kind, flt, field):
    """engine.bsi_val_count's raw outputs (per-plane counts, or bits and
    count) equal the JAX engine's, count 0 included."""
    jex, tex = read_pair
    shards = list(range(N_SHARDS))
    depth = tex.holder.field("i", field).bsi_group(field).bit_depth()
    jf = jax_parse(flt).calls[0] if flt else None
    tf = torch_parse(flt).calls[0] if flt else None
    want = jex.engine.bsi_val_count("i", field, kind, depth, shards, jf)
    got = tex.engine.bsi_val_count("i", field, kind, depth, shards, tf)
    if kind == "sum":
        assert np.asarray(got).tolist() == np.asarray(want).tolist()
    else:
        assert np.asarray(got[0]).tolist() == np.asarray(want[0]).tolist()
        assert got[1] == want[1]
        if flt == "Row(g=99)":
            assert got[1] == 0 and set(np.asarray(got[0]).tolist()) == {int(kind == "min")}


def test_count_batch_of_range_trees_matches_jax(read_pair):
    """count_batch serves BSI trees: one K1 launch (its twin here) for
    queries that share a predicate and differ in their rows."""
    jex, tex = read_pair
    shards = list(range(N_SHARDS))
    q = "Count(Intersect(Row(f={}), Range(v < 2500), Range(t=1, 2018-01-01T00:00, 2018-03-01T00:00)))"
    rows = [0, 3, 5, 3, 11]
    jcalls = [jax_parse(q.format(r)).calls[0].children[0] for r in rows]
    tcalls = [torch_parse(q.format(r)).calls[0].children[0] for r in rows]
    want = np.asarray(jex.engine.count_batch("i", jcalls, shards)).tolist()
    before = kernels.PLAIN_CALLS["gather_expr_count"]
    assert tex.engine.count_batch("i", tcalls, shards).tolist() == want
    assert kernels.PLAIN_CALLS["gather_expr_count"] == before + 1
    assert want == [tex.execute("i", q.format(r))[0] for r in rows]


T_WINDOW = "2018-01-01T00:00, 2018-03-01T00:00"

# count_batch shapes whose queries share spans (what K1's staged variant
# hoists): (query template over a, b, c, hoist programs K1's host plan
# makes, the rows a, b, c run over). Q above Q_TILE where the rows allow.
ROWS_ABC = "Union(Row(f={a}), Row(g={b}), Range(t={c}, %s))" % T_WINDOW
SHARED_BATCHES = {
    "one compare": ("Count(Intersect(%s, Range(v > 100)))" % ROWS_ABC, 1, (12, 12, 3)),
    "two compares": ("Count(Intersect(%s, Union(Range(v > 100), Range(w < 549755813888))))"
                     % ROWS_ABC, 1, (12, 12, 3)),
    "between": ("Count(Intersect(%s, Range(v >< [-50, 2000])))" % ROWS_ABC, 1, (12, 12, 3)),
    "shared Union filter": (
        "Count(Intersect(%s, Union(Row(f=10), Row(f=11), Range(w > 5))))" % ROWS_ABC,
        1, (10, 12, 3)),
    "spans under per-query pushes": (
        "Count(Xor(Intersect(Row(f={a}), Union(Row(f=10), Row(f=11))), "
        "Intersect(Union(Row(g={b}), Range(t={c}, %s)), Range(v > 100))))" % T_WINDOW,
        2, (10, 12, 3)),
    "nothing shared": ("Count(Intersect(Union(Row(f={a}), Row(g={b})), Range(t={c}, %s)))"
                       % T_WINDOW, 0, (12, 12, 3)),
}


@pytest.mark.parametrize("name", sorted(SHARED_BATCHES))
def test_count_batch_of_shared_spans_matches_jax(read_pair, monkeypatch, name):
    """count_batch of queries that share a compare, a filter or a nested
    span, past one query tile: the port's answers (its twin here) equal
    the JAX package's count of each query, and K1's staging for the
    engine's own launch, read as the staged kernel reads it, hoists the
    shared spans and counts the same."""
    from tests.test_torch_kernels import emulate_staged

    jex, tex = read_pair
    shards = list(range(N_SHARDS))
    template, hoists, (na, nb, nc) = SHARED_BATCHES[name]
    queries = [template.format(a=a, b=b, c=c)
               for a in range(na) for b in range(nb) for c in range(nc)]
    assert len(queries) > kernels.Q_TILE
    tcalls = [torch_parse(q).calls[0].children[0] for q in queries]
    want = [jex.engine.count("i", jax_parse(q).calls[0].children[0], shards) for q in queries]
    # The JAX package's batched program too, on a few queries of each tile.
    some = list(range(0, len(queries), 61)) + [len(queries) - 1]
    assert np.asarray(jex.engine.count_batch(
        "i", [jax_parse(queries[i]).calls[0].children[0] for i in some],
        shards)).tolist() == [want[i] for i in some]
    seen = []
    real = kernels.gather_expr_count_blocks

    def record(blocks, idxs, tape, variant=None):
        seen.append((torch.cat(list(blocks), dim=1), idxs, tape))
        return real(blocks, idxs, tape, variant)

    monkeypatch.setattr(kernels, "gather_expr_count_blocks", record)
    with tex.engine.memos_off():
        assert tex.engine.count_batch("i", tcalls, shards).tolist() == want
    (stacked, idxs, tape), = seen
    assert idxs.shape[1] == len(queries) and any(want)
    counts, staging = emulate_staged(stacked, idxs, tape)
    assert staging.n_hoist == hoists
    assert counts == kernels.gather_expr_count_plain(stacked, idxs, tape).tolist()


def test_state_carries_across(read_pair):
    """The JAX holder's BSI groups, time quantum, views and attrs, as the
    port opens them from the same data directory."""
    jex, tex = read_pair
    for name in ("f", "g", "v", "w", "d1", "t"):
        jf, tf = jex.holder.field("i", name), tex.holder.field("i", name)
        assert tf.time_quantum() == jf.time_quantum()
        assert sorted(tf.view_names()) == sorted(jf.view_names())
        jb, tb = jf.bsi_group(name), tf.bsi_group(name)
        assert (jb is None) == (tb is None)
        if jb is not None:
            assert (tb.min, tb.max, tb.bit_depth()) == (jb.min, jb.max, jb.bit_depth())
    assert tex.holder.field("i", "v").bsi_group("v").min == -1000
    assert tex.holder.field("i", "w").bsi_group("w").bit_depth() == 40
    assert tex.holder.field("i", "t").time_quantum() == "YMD"
    assert "standard_20180110" in tex.holder.field("i", "t").view_names()
    fj, ft = jex.holder.field("i", "f"), tex.holder.field("i", "f")
    for row in range(N_ROWS):
        assert ft.row_attr_store.attrs(row) == fj.row_attr_store.attrs(row)
    jidx, tidx = jex.holder.index("i"), tex.holder.index("i")
    for col in (1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 5):
        assert tidx.column_attr_store.attrs(col) == jidx.column_attr_store.attrs(col)
