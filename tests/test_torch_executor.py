"""The cases of tests/test_executor.py, run against the port on the CPU.

Executor tests driving full PQL strings on a single in-process node
(modelled on Pilosa's executor_test.go). Bit patterns deliberately span
shards (SHARD_WIDTH+x) to exercise the map/reduce path. The holder lives
on the CPU (device="cpu"), so the kernels' plain twins run."""

import pytest

from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import IndexOptions
from pilosa_tpu_torch.executor import ExecOptions, Executor
from pilosa_tpu_torch.translate import TranslateStore


@pytest.fixture
def holder(tmp_path):
    h = Holder(str(tmp_path / "data"), device="cpu")
    h.open()
    yield h
    h.close()


@pytest.fixture
def ex(holder):
    e = Executor(holder, translate_store=TranslateStore().open(), workers=0)
    yield e
    e.close()  # releases the engine's gather pool (thread-leak guard)


def setup_index(holder, name="i", keys=False):
    idx = holder.create_index_if_not_exists(name, IndexOptions(keys=keys))
    idx.create_field_if_not_exists("f")
    idx.create_field_if_not_exists("g")
    return idx


def test_row_and_set(holder, ex):
    setup_index(holder)
    res = ex.execute("i", "Set(3, f=10)")
    assert res == [True]
    res = ex.execute("i", "Set(3, f=10)")
    assert res == [False]  # already set
    ex.execute("i", f"Set({SHARD_WIDTH + 1}, f=10)")
    row = ex.execute("i", "Row(f=10)")[0]
    assert list(row.columns()) == [3, SHARD_WIDTH + 1]


def test_clear(holder, ex):
    setup_index(holder)
    ex.execute("i", "Set(3, f=10)")
    assert ex.execute("i", "Clear(3, f=10)") == [True]
    assert ex.execute("i", "Clear(3, f=10)") == [False]
    assert list(ex.execute("i", "Row(f=10)")[0].columns()) == []


def test_intersect_cross_shard(holder, ex):
    setup_index(holder)
    for col in [1, 100, SHARD_WIDTH, SHARD_WIDTH + 2]:
        ex.execute("i", f"Set({col}, f=10)")
    for col in [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH]:
        ex.execute("i", f"Set({col}, g=20)")
    row = ex.execute("i", "Intersect(Row(f=10), Row(g=20))")[0]
    assert list(row.columns()) == [1, SHARD_WIDTH + 2]
    assert ex.execute("i", "Count(Intersect(Row(f=10), Row(g=20)))") == [2]


def test_union_difference_xor(holder, ex):
    setup_index(holder)
    for col in [0, 2, SHARD_WIDTH]:
        ex.execute("i", f"Set({col}, f=1)")
    for col in [2, 3]:
        ex.execute("i", f"Set({col}, g=2)")
    assert list(ex.execute("i", "Union(Row(f=1), Row(g=2))")[0].columns()) == [0, 2, 3, SHARD_WIDTH]
    assert list(ex.execute("i", "Difference(Row(f=1), Row(g=2))")[0].columns()) == [0, SHARD_WIDTH]
    assert list(ex.execute("i", "Xor(Row(f=1), Row(g=2))")[0].columns()) == [0, 3, SHARD_WIDTH]


def test_count(holder, ex):
    setup_index(holder)
    for col in [1, 2, SHARD_WIDTH + 5]:
        ex.execute("i", f"Set({col}, f=7)")
    assert ex.execute("i", "Count(Row(f=7))") == [3]


def test_topn_two_phase_cross_shard(holder, ex):
    setup_index(holder)
    # Row 10: 2 bits in shard 0, 2 bits in shard 1 (total 4).
    # Row 20: 3 bits in shard 0 (total 3). Row 30: 1 bit.
    for col in [0, 1, SHARD_WIDTH, SHARD_WIDTH + 1]:
        ex.execute("i", f"Set({col}, f=10)")
    for col in [2, 3, 4]:
        ex.execute("i", f"Set({col}, f=20)")
    ex.execute("i", "Set(5, f=30)")
    pairs = ex.execute("i", "TopN(f, n=2)")[0]
    assert [(p.id, p.count) for p in pairs] == [(10, 4), (20, 3)]
    pairs = ex.execute("i", "TopN(f)")[0]
    assert [(p.id, p.count) for p in pairs] == [(10, 4), (20, 3), (30, 1)]


def test_topn_with_src(holder, ex):
    setup_index(holder)
    for col in [0, 1, 2]:
        ex.execute("i", f"Set({col}, f=10)")
    for col in [1, 2, 3, 4]:
        ex.execute("i", f"Set({col}, f=20)")
    for col in [0, 1]:
        ex.execute("i", f"Set({col}, g=5)")
    pairs = ex.execute("i", "TopN(f, Row(g=5), n=2)")[0]
    assert [(p.id, p.count) for p in pairs] == [(10, 2), (20, 1)]


def test_topn_with_src_batched_matches_fallback(holder, ex):
    """Phase-1-with-src runs as ONE batched device program across shards
    (union of per-shard cache candidates -> engine.topn_shard_counts ->
    per-shard heap replay). Results must be identical to the per-fragment
    fallback path (forced by pretending the engine can't compile src)."""
    import numpy as np

    setup_index(holder)
    rng = np.random.default_rng(17)
    fld = holder.index("i").field("f")
    g = holder.index("i").field("g")
    n_rows, n_shards = 24, 3
    rows, cols = [], []
    for row in range(n_rows):
        for s in range(n_shards):
            c = rng.choice(4096, size=64 + row, replace=False)
            rows.extend([row] * len(c))
            cols.extend(int(s * SHARD_WIDTH + x) for x in c)
    fld.import_bits(rows, cols)
    gc = [int(s * SHARD_WIDTH + x)
          for s in range(n_shards) for x in rng.choice(4096, 1500, replace=False)]
    g.import_bits([3] * len(gc), gc)

    q = "TopN(f, Row(g=3), n=7, threshold=2)"
    got = [(p.id, p.count) for p in ex.execute("i", q)[0]]

    real_supports = ex.engine.supports
    src_ast = None

    def no_src_supports(call, *a, **kw):
        # Refuse only the src Row so the executor takes the per-fragment
        # fallback; the phase-2 refetch path is disabled the same way.
        if call.name == "Row" and call.args.get("g") is not None:
            return False
        return real_supports(call, *a, **kw)

    ex.engine.supports = no_src_supports
    try:
        want = [(p.id, p.count) for p in ex.execute("i", q)[0]]
    finally:
        ex.engine.supports = real_supports
    assert got == want and got, (got, want)


def _force_fallback_topn(ex, q, src_field="g"):
    """Run `q` with the engine refusing the src Row, forcing the
    per-fragment TopN fallback (the semantic oracle for the batched path)."""
    real_supports = ex.engine.supports

    def no_src_supports(call, *a, **kw):
        if call.name == "Row" and call.args.get(src_field) is not None:
            return False
        return real_supports(call, *a, **kw)

    ex.engine.supports = no_src_supports
    try:
        return [(p.id, p.count) for p in ex.execute("i", q)[0]]
    finally:
        ex.engine.supports = real_supports


def test_topn_tanimoto_batched_matches_fallback(holder, ex):
    """Tanimoto TopN (the ChEMBL workload, docs/examples.md:321-328) rides
    the batched device path: the coefficient is a pure function of
    (cache_count, inter_count, src_count), all produced by ONE
    topn_shard_counts program — results must equal the per-fragment
    fallback (fragment.go:1008-1027 semantics)."""
    import numpy as np

    setup_index(holder)
    rng = np.random.default_rng(23)
    fld = holder.index("i").field("f")
    g = holder.index("i").field("g")
    n_rows, n_shards = 20, 3
    rows, cols = [], []
    for row in range(n_rows):
        for s in range(n_shards):
            c = rng.choice(2048, size=32 + 8 * row, replace=False)
            rows.extend([row] * len(c))
            cols.extend(int(s * SHARD_WIDTH + x) for x in c)
    fld.import_bits(rows, cols)
    gc = [int(s * SHARD_WIDTH + x)
          for s in range(n_shards) for x in rng.choice(2048, 300, replace=False)]
    g.import_bits([3] * len(gc), gc)

    for extra in ("", ", threshold=60"):
        # An explicit threshold must not prune tanimoto candidates
        # (reference fragment.go:909-920 branches on tanimoto before
        # minThreshold; only the heap-full early-exit, fragment.go:976-981,
        # consults it). Batched and fallback paths must agree either way.
        for thr in (5, 25, 60):
            q = f"TopN(f, Row(g=3), n=10, tanimotoThreshold={thr}{extra})"
            got = [(p.id, p.count) for p in ex.execute("i", q)[0]]
            want = _force_fallback_topn(ex, q)
            assert got == want, (thr, extra, got, want)
    # At least one threshold must produce hits or the parity is vacuous.
    assert _force_fallback_topn(ex, "TopN(f, Row(g=3), n=10, tanimotoThreshold=5)")


def test_topn_attr_filter_with_src_batched_matches_fallback(holder, ex):
    """Attr-filtered TopN WITH a src bitmap goes through the batched
    phase-1 path (attr filtering is a host-side candidate check; only
    surviving candidates ride the device program)."""
    import numpy as np

    setup_index(holder)
    rng = np.random.default_rng(31)
    fld = holder.index("i").field("f")
    g = holder.index("i").field("g")
    for row in range(12):
        c = rng.choice(2048, size=64, replace=False)
        fld.import_bits([row] * len(c), [int(x) for x in c])
        ex.execute("i", f'SetRowAttrs(f, {row}, category="{"even" if row % 2 == 0 else "odd"}")')
    gc = [int(x) for x in rng.choice(2048, 500, replace=False)]
    g.import_bits([3] * len(gc), gc)

    q = 'TopN(f, Row(g=3), n=6, attrName="category", attrValues=["even"])'
    got = [(p.id, p.count) for p in ex.execute("i", q)[0]]
    want = _force_fallback_topn(ex, q)
    assert got == want and got, (got, want)
    assert all(r % 2 == 0 for r, _ in got)

    # Explicit ids + attr filter: the batched phase-2 path prefilters rows
    # against the attr store before they join the device program.
    q2 = ('TopN(f, Row(g=3), ids=[0,1,2,3,4,5], '
          'attrName="category", attrValues=["even"])')
    got2 = [(p.id, p.count) for p in ex.execute("i", q2)[0]]
    want2 = _force_fallback_topn(ex, q2)
    assert got2 == want2 and got2, (got2, want2)
    assert {r for r, _ in got2} <= {0, 2, 4}


def test_topn_tanimoto_over_100_rejected(holder, ex):
    setup_index(holder)
    ex.execute("i", "Set(1, f=10)")
    ex.execute("i", "Set(1, g=3)")
    from pilosa_tpu_torch.errors import QueryError

    with pytest.raises(QueryError):
        ex.execute("i", "TopN(f, Row(g=3), n=5, tanimotoThreshold=101)")


def test_sum_min_max(holder, ex):
    idx = setup_index(holder)
    idx.create_field_if_not_exists("v", FieldOptions(type="int", min=-10, max=1000))
    ex.execute("i", "SetValue(col=1, v=5)")
    ex.execute("i", "SetValue(col=2, v=-10)")
    ex.execute("i", f"SetValue(col={SHARD_WIDTH + 3}, v=1000)")
    ex.execute("i", "Set(1, f=1)")
    ex.execute("i", "Set(2, f=1)")
    assert ex.execute("i", "Sum(field=v)")[0].to_dict() == {"value": 995, "count": 3}
    assert ex.execute("i", "Min(field=v)")[0].to_dict() == {"value": -10, "count": 1}
    assert ex.execute("i", "Max(field=v)")[0].to_dict() == {"value": 1000, "count": 1}
    # Filtered by Row(f=1) → columns 1, 2.
    assert ex.execute("i", "Sum(Row(f=1), field=v)")[0].to_dict() == {"value": -5, "count": 2}
    assert ex.execute("i", "Max(Row(f=1), field=v)")[0].to_dict() == {"value": 5, "count": 1}


def test_bsi_range_queries(holder, ex):
    idx = setup_index(holder)
    idx.create_field_if_not_exists("v", FieldOptions(type="int", min=0, max=100))
    for col, val in [(1, 10), (2, 20), (3, 30), (SHARD_WIDTH + 4, 40)]:
        ex.execute("i", f"SetValue(col={col}, v={val})")
    assert list(ex.execute("i", "Range(v == 20)")[0].columns()) == [2]
    assert list(ex.execute("i", "Range(v != 20)")[0].columns()) == [1, 3, SHARD_WIDTH + 4]
    assert list(ex.execute("i", "Range(v < 30)")[0].columns()) == [1, 2]
    assert list(ex.execute("i", "Range(v <= 30)")[0].columns()) == [1, 2, 3]
    assert list(ex.execute("i", "Range(v > 20)")[0].columns()) == [3, SHARD_WIDTH + 4]
    assert list(ex.execute("i", "Range(15 < v < 35)")[0].columns()) == [2, 3]
    assert list(ex.execute("i", "Range(v >< [20, 40])")[0].columns()) == [2, 3, SHARD_WIDTH + 4]
    assert list(ex.execute("i", "Range(v != null)")[0].columns()) == [1, 2, 3, SHARD_WIDTH + 4]
    # Out of range → empty.
    assert list(ex.execute("i", "Range(v == 999)")[0].columns()) == []
    # Full-range collapse to not-null.
    assert list(ex.execute("i", "Range(v < 999)")[0].columns()) == [1, 2, 3, SHARD_WIDTH + 4]


def test_time_range(holder, ex):
    idx = holder.create_index_if_not_exists("t")
    idx.create_field_if_not_exists("f", FieldOptions(type="time", time_quantum="YMDH"))
    ex.execute("t", "Set(1, f=1, 2010-01-01T00:00)")
    ex.execute("t", "Set(2, f=1, 2010-01-02T00:00)")
    ex.execute("t", "Set(3, f=1, 2010-02-01T00:00)")
    row = ex.execute("t", "Range(f=1, 2010-01-01T00:00, 2010-01-03T00:00)")[0]
    assert list(row.columns()) == [1, 2]
    row = ex.execute("t", "Range(f=1, 2009-12-01T00:00, 2010-03-01T00:00)")[0]
    assert list(row.columns()) == [1, 2, 3]
    # Standard view still has all bits.
    assert list(ex.execute("t", "Row(f=1)")[0].columns()) == [1, 2, 3]


def test_time_range_fast_path_matches_fallback(holder, ex):
    """Time-quantum Range compiles onto the engine fast path (union over
    time-view leaves, ONE device program across shards) — results must be
    identical to the per-shard per-view merge fallback
    (executor.py:_execute_time_range_shard), incl. composed in Intersect
    and as a Count input."""
    idx = holder.create_index_if_not_exists("tt")
    idx.create_field_if_not_exists("f", FieldOptions(type="time", time_quantum="YMD"))
    idx.create_field_if_not_exists("g")
    for day in range(1, 9):
        for col in (day, SHARD_WIDTH + day, 100 + day):
            ex.execute("tt", f"Set({col}, f=1, 2018-03-{day:02d}T00:00)")
    for col in (2, 3, 103, SHARD_WIDTH + 4):
        ex.execute("tt", f"Set({col}, g=9)")

    queries = [
        "Range(f=1, 2018-03-02T00:00, 2018-03-06T00:00)",
        "Count(Range(f=1, 2018-03-02T00:00, 2018-03-06T00:00))",
        "Intersect(Range(f=1, 2018-03-01T00:00, 2018-03-08T00:00), Row(g=9))",
        "Count(Union(Range(f=1, 2018-03-01T00:00, 2018-03-03T00:00), Row(g=9)))",
    ]

    def run_all():
        out = []
        for q in queries:
            r = ex.execute("tt", q)[0]
            out.append(list(r.columns()) if hasattr(r, "columns") else r)
        return out

    got = run_all()
    real_supports = ex.engine.supports

    def no_range_supports(call, *a, **kw):
        if call.name == "Range":
            return False
        return real_supports(call, *a, **kw)

    ex.engine.supports = no_range_supports
    try:
        want = run_all()
    finally:
        ex.engine.supports = real_supports
    assert got == want, (got, want)
    assert got[1] == 12  # 4 days (end-exclusive) x 3 cols: non-vacuous

    # supports() with the index is exact: a non-time field refuses (the
    # fallback returns an empty Row there; claiming support would raise).
    from pilosa_tpu_torch.pql.parser import parse

    bad = parse("Range(g=1, 2018-03-01T00:00, 2018-03-02T00:00)").calls[0]
    assert not ex.engine.supports(bad, "tt")
    good = parse("Range(f=1, 2018-03-01T00:00, 2018-03-02T00:00)").calls[0]
    assert ex.engine.supports(good, "tt")
    assert not ex.engine.supports(good)  # syntactic-only: refused


def test_row_attrs(holder, ex):
    setup_index(holder)
    ex.execute("i", 'SetRowAttrs(f, 10, foo="bar", count=123)')
    ex.execute("i", "Set(1, f=10)")
    row = ex.execute("i", "Row(f=10)")[0]
    assert row.attrs == {"foo": "bar", "count": 123}
    row = ex.execute("i", "Row(f=10)", opt=ExecOptions(exclude_row_attrs=True))[0]
    assert row.attrs == {}


def test_column_attrs(holder, ex):
    setup_index(holder)
    ex.execute("i", 'SetColumnAttrs(7, name="alice")')
    assert holder.index("i").column_attr_store.attrs(7) == {"name": "alice"}


def test_topn_attr_filter(holder, ex):
    setup_index(holder)
    for col in range(4):
        ex.execute("i", f"Set({col}, f=10)")
    for col in range(2):
        ex.execute("i", f"Set({col}, f=20)")
    ex.execute("i", 'SetRowAttrs(f, 10, category="x")')
    ex.execute("i", 'SetRowAttrs(f, 20, category="y")')
    pairs = ex.execute("i", 'TopN(f, n=5, attrName="category", attrValues=["y"])')[0]
    assert [(p.id, p.count) for p in pairs] == [(20, 2)]


def test_key_translation(holder, ex):
    idx = holder.create_index_if_not_exists("k", IndexOptions(keys=True))
    idx.create_field_if_not_exists("f", FieldOptions(keys=True))
    ex.execute("k", 'Set("alice", f="red")')
    ex.execute("k", 'Set("bob", f="red")')
    row = ex.execute("k", 'Row(f="red")')[0]
    assert sorted(row.keys) == ["alice", "bob"]
    pairs = ex.execute("k", "TopN(f, n=1)")[0]
    assert pairs[0].key == "red"
    assert pairs[0].count == 2


def test_error_on_unknown_field(holder, ex):
    setup_index(holder)
    with pytest.raises(Exception):
        ex.execute("i", "Row(nosuch=1)")


def test_write_limit(holder, ex):
    setup_index(holder)
    ex.max_writes_per_request = 2
    with pytest.raises(Exception):
        ex.execute("i", "Set(1, f=1) Set(2, f=1) Set(3, f=1)")


def test_durability_across_reopen(holder, ex, tmp_path):
    setup_index(holder)
    ex.execute("i", "Set(3, f=10)")
    ex.execute("i", f"Set({SHARD_WIDTH + 7}, f=10)")
    holder.reopen()
    ex2 = Executor(holder, translate_store=TranslateStore().open(), workers=0)
    try:
        assert list(ex2.execute("i", "Row(f=10)")[0].columns()) == [3, SHARD_WIDTH + 7]
    finally:
        ex2.close()


def test_topn_chunked_matches_single_chunk(holder, ex, monkeypatch):
    """A tiny PILOSA_TOPN_CHUNK_BYTES forces the TopN phases through many
    small device chunks; results must equal the single-chunk run (the
    chunk bound exists so 256-shard stacks don't build 16 GiB programs)."""
    import numpy as np

    setup_index(holder)
    rng = np.random.default_rng(23)
    fld = holder.index("i").field("f")
    g = holder.index("i").field("g")
    n_rows, n_shards = 40, 2
    rows, cols = [], []
    for row in range(n_rows):
        for s in range(n_shards):
            c = rng.choice(4096, size=32 + row, replace=False)
            rows.extend([row] * len(c))
            cols.extend(int(s * SHARD_WIDTH + x) for x in c)
    fld.import_bits(rows, cols)
    gc = [int(s * SHARD_WIDTH + x)
          for s in range(n_shards) for x in rng.choice(4096, 1200, replace=False)]
    g.import_bits([3] * len(gc), gc)

    q = "TopN(f, Row(g=3), n=6)"
    want = [(p.id, p.count) for p in ex.execute("i", q)[0]]
    assert want, "TopN returned nothing; test data broken"

    # 16 rows per chunk at 2 shards x 128 KiB planes.
    monkeypatch.setenv("PILOSA_TOPN_CHUNK_BYTES", str(16 * 2 * 32768 * 4))
    from pilosa_tpu_torch import executor as ex_mod

    assert ex_mod._topn_chunk(n_shards) == 16
    got = [(p.id, p.count) for p in ex.execute("i", q)[0]]
    assert got == want, (got, want)
