"""The cases of tests/test_executor_parity.py, each run on both packages.

Every case builds the same bits in a pilosa_tpu holder and in a
pilosa_tpu_torch holder (device="cpu", the kernels' plain twins), runs
the same PQL through each package's Executor, and requires equal answers:
equal columns, equal TopN pairs, equal values, and the same error type
and message where the reference raises. The reference's expected values
are checked as well, so a case cannot pass by both packages being wrong
alike. The cases mirror Pilosa's executor_test.go, case for case.
"""

from types import SimpleNamespace

import pytest

import pilosa_tpu.core.field as jfield
import pilosa_tpu.core.holder as jholder
import pilosa_tpu.core.index as jindex
import pilosa_tpu.errors as jerrors
import pilosa_tpu.executor as jexecutor
import pilosa_tpu.translate as jtranslate
import pilosa_tpu_torch.core.field as tfield
import pilosa_tpu_torch.core.holder as tholder
import pilosa_tpu_torch.core.index as tindex
import pilosa_tpu_torch.errors as terrors
import pilosa_tpu_torch.executor as texecutor
import pilosa_tpu_torch.translate as ttranslate
from pilosa_tpu_torch.constants import SHARD_WIDTH

JAX = SimpleNamespace(
    name="jax", FieldOptions=jfield.FieldOptions, IndexOptions=jindex.IndexOptions,
    PilosaError=jerrors.PilosaError, Executor=jexecutor.Executor,
    TranslateStore=jtranslate.TranslateStore,
    Holder=lambda path: jholder.Holder(path))
TORCH = SimpleNamespace(
    name="torch", FieldOptions=tfield.FieldOptions, IndexOptions=tindex.IndexOptions,
    PilosaError=terrors.PilosaError, Executor=texecutor.Executor,
    TranslateStore=ttranslate.TranslateStore,
    Holder=lambda path: tholder.Holder(path, device="cpu"))


@pytest.fixture
def both(tmp_path):
    """(package, holder, executor) for pilosa_tpu, then for the port."""
    made = []
    for pk in (JAX, TORCH):
        h = pk.Holder(str(tmp_path / pk.name))
        h.open()
        e = pk.Executor(h, translate_store=pk.TranslateStore().open(), workers=0)
        made.append((pk, h, e))
    yield made
    for _, h, e in made:
        e.close()
        h.close()


def on_both(both, case):
    """Run `case(pk, holder, ex)` on each package; the answers must be
    equal. Returns the reference's answer."""
    got = [case(pk, h, e) for pk, h, e in both]
    assert got[0] == got[1], got
    return got[0]


def raised(pk, fn):
    """The package's PilosaError raised by `fn`, as (type name, message)."""
    with pytest.raises(pk.PilosaError) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


def set_bit(holder, index, field, row, col):
    idx = holder.create_index_if_not_exists(index)
    fld = idx.create_field_if_not_exists(field)
    fld.set_bit(row, col)


def columns(res):
    return [int(c) for c in res.columns()]


def pairs(res):
    return [(p.id, p.count) for p in res]


def test_old_pql_rejected(both):
    """TestExecutor_Execute_OldPQL (executor_test.go:379)."""
    def case(pk, holder, ex):
        set_bit(holder, "i", "f", 1, 0)
        return raised(pk, lambda: ex.execute("i", "SetBit(f=1, row=11, col=1)"))

    kind, msg = on_both(both, case)
    assert "unknown call: SetBit" in msg


def test_empty_intersect_difference_error_empty_union_ok(both):
    """TestExecutor_Execute_Empty_{Intersect,Difference,Union}
    (executor_test.go:163-237)."""
    def case(pk, holder, ex):
        set_bit(holder, "i", "general", 10, 1)
        return (raised(pk, lambda: ex.execute("i", "Intersect()")),
                raised(pk, lambda: ex.execute("i", "Difference()")),
                columns(ex.execute("i", "Union()")[0]))

    assert on_both(both, case)[2] == []


def test_xor_exact_columns(both):
    """TestExecutor_Execute_Xor (executor_test.go:238)."""
    def case(pk, holder, ex):
        for row, col in [(10, 0), (10, SHARD_WIDTH + 1), (10, SHARD_WIDTH + 2),
                         (11, 2), (11, SHARD_WIDTH + 2)]:
            set_bit(holder, "i", "general", row, col)
        return columns(ex.execute("i", "Xor(Row(general=10), Row(general=11))")[0])

    assert on_both(both, case) == [0, 2, SHARD_WIDTH + 1]


def test_topn_fill(both):
    """TestExecutor_Execute_TopN_fill (executor_test.go:594): phase 2
    refetches exact counts across shards."""
    def case(pk, holder, ex):
        for row, col in [(0, 0), (0, 1), (0, 2), (0, SHARD_WIDTH),
                         (1, SHARD_WIDTH + 2), (1, SHARD_WIDTH)]:
            set_bit(holder, "i", "f", row, col)
        return pairs(ex.execute("i", "TopN(f, n=1)")[0])

    assert on_both(both, case) == [(0, 4)]


def test_topn_fill_small(both):
    """TestExecutor_Execute_TopN_fill_small (executor_test.go:618): the
    global winner only emerges from the phase-2 refetch."""
    bits = [(0, 0), (0, SHARD_WIDTH), (0, 2 * SHARD_WIDTH), (0, 3 * SHARD_WIDTH),
            (0, 4 * SHARD_WIDTH),
            (1, 0), (1, 1),
            (2, SHARD_WIDTH), (2, SHARD_WIDTH + 1),
            (3, 2 * SHARD_WIDTH), (3, 2 * SHARD_WIDTH + 1),
            (4, 3 * SHARD_WIDTH), (4, 3 * SHARD_WIDTH + 1)]

    def case(pk, holder, ex):
        for row, col in bits:
            set_bit(holder, "i", "f", row, col)
        return pairs(ex.execute("i", "TopN(f, n=1)")[0])

    assert on_both(both, case) == [(0, 5)]


def test_set_value_ok_and_errors(both):
    """TestExecutor_Execute_SetValue (executor_test.go:393-470), with the
    error messages equal across the packages."""
    def case(pk, holder, ex):
        idx = holder.create_index_if_not_exists("i")
        idx.create_field_if_not_exists(
            "f", pk.FieldOptions(type="int", min=0, max=50))
        idx.create_field_if_not_exists("xxx")
        ex.execute("i", "SetValue(col=10, f=25)")
        ex.execute("i", "SetValue(col=100, f=10)")
        f = idx.field("f")
        return (f.value(10), f.value(100),
                raised(pk, lambda: ex.execute("i", "SetValue(invalid_column_name=10, f=100)")),
                raised(pk, lambda: ex.execute("i", 'SetValue(invalid_column_name="bad_column", f=100)')),
                raised(pk, lambda: ex.execute("i", 'SetValue(col=10, f="hello")')))

    v10, v100, e1, e2, e3 = on_both(both, case)
    assert (v10, v100) == ((25, True), (10, True))
    assert "SetValue() column field 'col' required" in e1[1]
    assert "SetValue() column field 'col' required" in e2[1]
    assert "invalid bsigroup value type" in e3[1]


def test_set_column_attrs_excludes_field(both):
    """TestExecutor_SetColumnAttrs_ExcludeField (executor_test.go:1265)."""
    def case(pk, holder, ex):
        idx = holder.create_index_if_not_exists("i")
        idx.create_field_if_not_exists("f")
        ex.execute("i", "Set(10, f=1)")
        ex.execute("i", "SetColumnAttrs(10, foo='bar')")
        a10 = idx.column_attr_store.attrs(10)
        ex.execute("i", "Set(20, f=10)")
        ex.execute("i", "SetColumnAttrs(20, foo='bar')")
        return a10, idx.column_attr_store.attrs(20)

    assert on_both(both, case) == ({"foo": "bar"}, {"foo": "bar"})


TIME_CLEAR_CASES = [
    ("Y", [3, 4, 5, 6]),
    ("M", [3, 4, 6]),
    ("D", [3, 4, 5, 6]),
    ("H", [3, 4, 5, 6, 7]),
    ("YM", [3, 4, 5, 6]),
    ("YMD", [3, 4, 5, 6]),
    ("YMDH", [3, 4, 5, 6, 7]),
    ("MD", [3, 4, 5, 6]),
    ("MDH", [3, 4, 5, 6, 7]),
    ("DH", [3, 4, 5, 6, 7]),
]


@pytest.mark.parametrize("quantum,expected", TIME_CLEAR_CASES)
def test_time_clear_quantums(both, quantum, expected):
    """TestExecutor_Time_Clear_Quantums (executor_test.go:1315): Clear()
    removes the column from every quantum view."""
    def case(pk, holder, ex):
        index_name = quantum.lower()
        idx = holder.create_index_if_not_exists(index_name)
        idx.create_field_if_not_exists(
            "f", pk.FieldOptions(type="time", time_quantum=quantum))
        ex.execute(index_name, """
            Set(2, f=1, 1999-12-31T00:00)
            Set(3, f=1, 2000-01-01T00:00)
            Set(4, f=1, 2000-01-02T00:00)
            Set(5, f=1, 2000-02-01T00:00)
            Set(6, f=1, 2001-01-01T00:00)
            Set(7, f=1, 2002-01-01T02:00)
            Set(2, f=1, 1999-12-30T00:00)
            Set(2, f=1, 2002-02-01T00:00)
            Set(2, f=10, 2001-01-01T00:00)
        """)
        ex.execute(index_name, "Clear( 2, f=1)")
        return columns(ex.execute(
            index_name, "Range(f=1, 1999-12-31T00:00, 2002-01-01T03:00)")[0])

    assert on_both(both, case) == expected, quantum


def test_translate_does_not_abort_valid_writes(both):
    """'Set(1, f=1) Clear(2)' applies the Set, then rejects only the
    Clear at execution time (executor.go:1600)."""
    def case(pk, holder, ex):
        idx = holder.create_index_if_not_exists("i")
        idx.create_field_if_not_exists("f")
        err = raised(pk, lambda: ex.execute("i", "Set(1, f=1)\nClear(2)"))
        return err, ex.execute("i", "Count(Row(f=1))")

    assert on_both(both, case)[1] == [1]


def test_empty_key_not_translated(both):
    """Empty string keys are skipped by translation (executor.go:1613)
    and rejected downstream: no phantom id."""
    def case(pk, holder, ex):
        holder.create_index_if_not_exists("k", pk.IndexOptions(keys=True)) \
            .create_field_if_not_exists("f")
        err = raised(pk, lambda: ex.execute("k", 'Set("", f=1)'))
        return err, ex.execute("k", "Count(Row(f=1))")

    assert on_both(both, case)[1] == [0]
