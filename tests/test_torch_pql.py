"""The cases of tests/test_pql.py, run against the port on the CPU.

PQL parser tests (model: the grammar in reference pql/pql.peg and
parser usage throughout executor_test.go)."""

import pytest

from pilosa_tpu_torch.pql.ast import BETWEEN, Condition, EQ, GT, LTE
from pilosa_tpu_torch.pql.parser import ParseError, parse


def one(q):
    query = parse(q)
    assert len(query.calls) == 1
    return query.calls[0]


def test_row():
    c = one("Row(f=10)")
    assert c.name == "Row"
    assert c.args == {"f": 10}
    assert c.field_arg() == "f"
    assert c.uint_arg("f") == (10, True)


def test_nested_calls():
    c = one("Count(Intersect(Row(a=1), Row(b=2)))")
    assert c.name == "Count"
    inner = c.children[0]
    assert inner.name == "Intersect"
    assert [ch.name for ch in inner.children] == ["Row", "Row"]
    assert inner.children[0].args == {"a": 1}


def test_set():
    c = one("Set(100, f=10)")
    assert c.name == "Set"
    assert c.args == {"_col": 100, "f": 10}


def test_set_with_timestamp():
    c = one("Set(9, f=10, 2016-01-01T00:00)")
    assert c.args == {"_col": 9, "f": 10, "_timestamp": "2016-01-01T00:00"}
    c = one('Set(9, f=10, "2016-01-01T00:00")')
    assert c.args["_timestamp"] == "2016-01-01T00:00"


def test_set_string_col():
    c = one('Set("foo", f=10)')
    assert c.args == {"_col": "foo", "f": 10}


def test_clear():
    c = one("Clear(5, f=3)")
    assert c.name == "Clear"
    assert c.args == {"_col": 5, "f": 3}


def test_set_row_attrs():
    c = one('SetRowAttrs(f, 10, foo="bar", baz=123, active=true, x=null)')
    assert c.args == {
        "_field": "f",
        "_row": 10,
        "foo": "bar",
        "baz": 123,
        "active": True,
        "x": None,
    }


def test_set_column_attrs():
    c = one('SetColumnAttrs(7, foo="bar")')
    assert c.args == {"_col": 7, "foo": "bar"}


def test_topn():
    c = one("TopN(f, n=2)")
    assert c.args == {"_field": "f", "n": 2}
    c = one("TopN(f)")
    assert c.args == {"_field": "f"}


def test_topn_with_src_and_filters():
    c = one('TopN(f, Row(other=10), n=5, attrname="category", attrvalues=[1,2])')
    assert c.args["_field"] == "f"
    assert c.children[0].name == "Row"
    assert c.args["n"] == 5
    assert c.args["attrname"] == "category"
    assert c.args["attrvalues"] == [1, 2]


def test_range_condition():
    c = one("Range(f > 20)")
    assert isinstance(c.args["f"], Condition)
    assert c.args["f"].op == GT
    assert c.args["f"].value == 20


def test_range_between_conditional():
    c = one("Range(10 < f < 20)")
    cond = c.args["f"]
    assert cond.op == BETWEEN
    assert cond.value == [11, 20]
    c = one("Range(10 <= f <= 20)")
    assert c.args["f"].value == [10, 21]


def test_range_between_op():
    c = one("Range(f >< [10, 20])")
    assert c.args["f"].op == BETWEEN
    assert c.args["f"].value == [10, 20]


def test_range_neq_null():
    c = one("Range(f != null)")
    assert c.args["f"].op == "neq"
    assert c.args["f"].value is None


def test_range_timerange():
    c = one("Range(f=1, 2010-01-01T00:00, 2010-01-02T03:00)")
    assert c.args == {
        "f": 1,
        "_start": "2010-01-01T00:00",
        "_end": "2010-01-02T03:00",
    }


def test_multiple_calls():
    q = parse("Set(1, f=1)\nSet(2, f=1) Count(Row(f=1))")
    assert [c.name for c in q.calls] == ["Set", "Set", "Count"]


def test_lists_and_strings():
    c = one('Eq(f=["a", "b", 3, 4.5])')
    assert c.args["f"] == ["a", "b", 3, 4.5]


def test_float_and_negative():
    c = one("Range(f > -10)")
    assert c.args["f"].value == -10
    c = one("X(f=1.5)")
    assert c.args["f"] == 1.5


def test_call_roundtrip_str():
    c = one("Count(Intersect(Row(a=1), Row(b=2)))")
    assert str(c) == "Count(Intersect(Row(a=1), Row(b=2)))"


def test_parse_error():
    with pytest.raises(ParseError):
        parse("Row(f=")
    with pytest.raises(ParseError):
        parse("Row f=1)")


def test_empty_call():
    c = one("Status()")
    assert c.name == "Status"
    assert c.args == {} and c.children == []
