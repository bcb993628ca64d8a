"""Bytes and numbers the two packages must share, on the CPU: the same
inputs through pilosa_tpu and pilosa_tpu_torch give equal

- fragment files (snapshot) and WAL records (point ops, bulk imports,
  BSI values), and a B-tree container store's serialized bitmap;
- the node-to-node wire encoding of query results, the public protobuf
  QueryResponse, and the private-plane envelope of cluster messages;
- PQL ASTs and plan signatures (canonical structure and leaf order);
- iterator and URI outputs.
"""

import os

import numpy as np
import pytest

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu import iterator as j_iterator
from pilosa_tpu import uri as j_uri
from pilosa_tpu.core.fragment import Fragment as JFragment
from pilosa_tpu.plan import build_plan as j_build_plan
from pilosa_tpu.pql.parser import parse as j_parse
from pilosa_tpu.server import proto as j_proto
from pilosa_tpu.server import wire as j_wire
from pilosa_tpu.server.proto import envelope as j_env
from pilosa_tpu.storage import bitmap as j_bm
from pilosa_tpu.storage.btree_containers import BTreeContainers as JBTree
from pilosa_tpu_torch import iterator as t_iterator
from pilosa_tpu_torch import uri as t_uri
from pilosa_tpu_torch.core.fragment import Fragment as TFragment
from pilosa_tpu_torch.plan import build_plan as t_build_plan
from pilosa_tpu_torch.pql.parser import parse as t_parse
from pilosa_tpu_torch.server import proto as t_proto
from pilosa_tpu_torch.server import wire as t_wire
from pilosa_tpu_torch.server.proto import envelope as t_env
from pilosa_tpu_torch.storage import bitmap as t_bm
from pilosa_tpu_torch.storage.btree_containers import BTreeContainers as TBTree

from .test_envelope import ROUND_TRIP_CASES as MESSAGES

W = 1 << 20  # SHARD_WIDTH


def fragment_ops(frag):
    """Point sets and clears, a bulk import, BSI values, in one order."""
    rng = np.random.default_rng(4)
    for _ in range(300):
        frag.set_bit(int(rng.integers(8)), int(rng.integers(W)))
    for _ in range(60):
        frag.clear_bit(int(rng.integers(8)), int(rng.integers(W)))
    rows = rng.integers(8, 12, size=2000)
    cols = rng.integers(0, W, size=2000)
    frag.bulk_import(rows.astype(np.uint64), cols.astype(np.uint64))
    for col in range(40):
        frag.set_value(col * 997, 12, int(rng.integers(0, 4000)))


@pytest.mark.parametrize("snapshot", [False, True], ids=["wal", "snapshot"])
def test_fragment_files_and_wal_records_are_equal(tmp_path, snapshot):
    paths = {}
    for name, cls in (("jax", JFragment), ("torch", TFragment)):
        path = str(tmp_path / name)
        frag = cls(path, "i", "f", "standard", 0)
        frag.open()
        fragment_ops(frag)
        if snapshot:
            frag.snapshot()
        frag.close()
        paths[name] = path
    files = {name: sorted(f for f in os.listdir(os.path.dirname(p))
                          if f.startswith(os.path.basename(p)))
             for name, p in paths.items()}
    assert [f.replace("jax", "x") for f in files["jax"]] == \
        [f.replace("torch", "x") for f in files["torch"]]
    for fj, ft in zip(files["jax"], files["torch"]):
        with open(os.path.join(tmp_path, fj), "rb") as a, \
                open(os.path.join(tmp_path, ft), "rb") as b:
            assert a.read() == b.read(), (fj, ft)


def test_btree_backend_serializes_like_jax():
    rng = np.random.default_rng(9)
    vals = np.unique(rng.integers(0, 1 << 22, size=5000)).astype(np.uint64)
    out = {}
    for name, bm, tree in (("jax", j_bm, JBTree), ("torch", t_bm, TBTree)):
        bm.set_container_factory(tree)
        try:
            b = bm.Bitmap(vals)
            assert isinstance(b.containers.store, tree)
            out[name] = b.to_bytes()
        finally:
            bm.set_container_factory(dict)
    assert out["torch"] == out["jax"] == j_bm.Bitmap(vals).to_bytes()


@pytest.fixture
def executors(tmp_path_factory):
    """One holder per package with the same bits and values."""
    out = {}
    for pkg, kw in ((pilosa_tpu, {}), (pilosa_tpu_torch, {"device": "cpu"})):
        h = pkg.Holder(str(tmp_path_factory.mktemp(pkg.__name__)), **kw)
        h.open()
        idx = h.create_index("i")
        idx.create_field("f")
        rng = np.random.default_rng(8)
        cols = rng.integers(0, 3 * W, size=600)
        idx.fields["f"].import_bits([int(c) % 4 for c in cols], [int(c) for c in cols])
        ex = pkg.Executor(h)
        ex.execute("i", "SetRowAttrs(f, 1, color=\"red\")")
        out[pkg.__name__] = ex
    yield out
    for ex in out.values():
        ex.close()
        ex.holder.close()


QUERIES = ["Row(f=1)", "Intersect(Row(f=1), Row(f=2))", "Count(Row(f=3))",
           "TopN(f, n=3)", "Set(5, f=2)", "Clear(7, f=3)"]


@pytest.mark.parametrize("q", QUERIES)
def test_wire_and_proto_encodings_are_equal(executors, q):
    got = {name: ex.execute("i", q) for name, ex in executors.items()}
    assert t_wire.encode_results(got["pilosa_tpu_torch"]) == \
        j_wire.encode_results(got["pilosa_tpu"])
    assert t_proto.encode_query_response(got["pilosa_tpu_torch"]) == \
        j_proto.encode_query_response(got["pilosa_tpu"])


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: m["type"])
def test_envelope_bytes_are_equal(msg):
    assert t_env.encode_message(dict(msg)) == j_env.encode_message(dict(msg))


PQL = [
    "Count(Intersect(Row(f=1), Union(Row(g=2), Row(f=3))))",
    "Difference(Row(f=0), Row(f=2), Row(f=1))",
    "TopN(f, Row(g=1), n=5, attrName=\"color\", attrValues=[\"red\", 2])",
    "Range(v > 10)", "Range(v >< [1, 9])",
    "Range(t=1, 2018-01-01T00:00, 2018-02-01T00:00)",
    "Set(5, f=1) Clear(6, f=2) SetValue(col=3, v=9)",
    "Sum(Row(f=1), field=v) Min(field=v) Max(Row(g=2), field=v)",
    "SetRowAttrs(f, 1, color=\"blue\", n=3) Options(Row(f=1), shards=[0, 2])",
]


@pytest.mark.parametrize("q", PQL)
def test_pql_asts_are_equal(q):
    assert str(t_parse(q)) == str(j_parse(q))


PLANS = [
    "Intersect(Row(f=1), Row(f=2))",
    "Intersect(Row(f=2), Row(f=1))",
    "Union(Row(f=3), Intersect(Row(f=1), Row(f=2)))",
    "Difference(Difference(Row(f=0), Row(f=1)), Row(f=2))",
    "Xor(Row(f=1), Union(Row(f=2), Row(f=3)), Row(f=0))",
]


@pytest.mark.parametrize("q", PLANS)
def test_plan_signatures_are_equal(executors, q):
    j = j_build_plan(executors["pilosa_tpu"].holder, "i", j_parse(q).calls[0])
    t = t_build_plan(executors["pilosa_tpu_torch"].holder, "i", t_parse(q).calls[0])
    assert t.sig_tuple == j.sig_tuple and repr(t.leaves) == repr(j.leaves)


def test_iterators_and_uris_are_equal(tmp_path):
    out = {}
    for name, cls, it in (("jax", JFragment, j_iterator), ("torch", TFragment, t_iterator)):
        frag = cls(str(tmp_path / name), "i", "f", "standard", 1)
        frag.open()
        for r, c in ((3, 9), (1, 4), (3, 2), (0, 7), (1, W - 1)):
            frag.set_bit(r, W + c)
        out[name] = (list(it.fragment_iterator(frag)),
                     list(it.fragment_iterator(frag, seek_row=1)),
                     list(it.limit_iterator(it.slice_iterator([5, 1, 3, 1], [6, 9, 4, 2]), 4, 7)))
        frag.close()
    assert out["torch"] == out["jax"]
    for s in ("https://example.com:8080", "example.com", ":9999", "localhost:1"):
        t, j = t_uri.URI.parse(s), j_uri.URI.parse(s)
        assert (t.scheme, t.host, t.port, t.normalize()) == (j.scheme, j.host, j.port,
                                                              j.normalize())
