"""The port's read path end to end against the JAX package, on the CPU.

A data directory is written by pilosa_tpu (3 shards, 16 rows, fields f and
g, seeded columns up past 2^21), closed, copied, and opened by both
packages: pilosa_tpu.Holder on one copy and pilosa_tpu_torch.Holder(path,
device="cpu") on the other — the roaring files carry the state across.
A PQL corpus (Counts of nested Intersect/Union/Difference/Xor, Row columns,
TopN with and without a filter, Set/Clear followed by recounts) runs
through both Executors, and engine.count_batch through both engines (the
JAX one forced onto its Pallas kernel, interpret mode). Every comparison
is exact.
"""

import shutil

import numpy as np
import pytest

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu.constants import SHARD_WIDTH
from pilosa_tpu.parallel import EngineConfig
from pilosa_tpu.pql.parser import parse as jax_parse
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel import EngineConfig as TorchEngineConfig
from pilosa_tpu_torch.pql.parser import parse as torch_parse

N_SHARDS = 3
N_ROWS = 16


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "data")
    h = pilosa_tpu.Holder(path)
    h.open()
    idx = h.create_index("i")
    rng = np.random.default_rng(21)
    for name, density in (("f", 0.02), ("g", 0.05)):
        fld = idx.create_field(name)
        rows, cols = [], []
        for row in range(N_ROWS):
            n = int(rng.integers(50, 400)) if row % 5 else 2000
            c = rng.choice(N_SHARDS * SHARD_WIDTH, n, replace=False)
            rows.extend([row] * n)
            cols.extend(int(x) for x in c)
        fld.import_bits(rows, cols)
    # A few point writes so the WAL tail (not only snapshots) carries over.
    ex = pilosa_tpu.Executor(h, workers=0)
    ex.execute("i", f"Set({2 * SHARD_WIDTH + 7}, f=3)")
    ex.execute("i", f"Set({SHARD_WIDTH + 5}, g=1)")
    ex.execute("i", "Clear(1, f=1)")
    ex.close()
    h.close()
    return path


def open_pair(data_dir, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
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


@pytest.fixture
def pair(data_dir, tmp_path):
    jh, th, jex, tex = open_pair(data_dir, tmp_path)
    yield jex, tex
    jex.close()
    tex.close()
    jh.close()
    th.close()


def norm(result):
    """Comparable form of an executor result, package-independent."""
    if hasattr(result, "columns") and hasattr(result, "segments"):
        return ("row", result.columns().tolist())
    if isinstance(result, list):
        return [(p.id, p.count) for p in result]
    return result


CORPUS = [
    "Count(Row(f=0))",
    "Count(Row(f=15))",
    "Count(Intersect(Row(f=0), Row(g=0)))",
    "Count(Intersect(Row(f=5), Row(f=10), Row(g=5)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Difference(Row(f=5), Row(g=5)))",
    "Count(Difference(Row(f=0), Row(f=1), Union(Row(g=2), Row(g=3))))",
    "Count(Difference(Row(f=0), Difference(Row(f=5), Row(g=10))))",
    "Count(Xor(Row(f=5), Row(g=5), Row(f=10)))",
    "Count(Intersect(Union(Row(f=0), Row(f=1)), Row(g=0), Row(g=5)))",
    "Count(Intersect(Row(f=3), Union(Row(f=1), Row(f=0)), Row(f=2)))",
    "Count(Xor(Intersect(Row(f=0), Row(g=0)), Difference(Row(f=5), Row(g=10))))",
    "Count(Intersect(Row(f=0), Row(f=0)))",
    "Count(Row(f=99))",
    "Row(f=3)",
    "Intersect(Row(f=0), Row(g=0))",
    "Union(Row(f=1), Row(g=1))",
    "Difference(Row(f=10), Row(g=10))",
    "Xor(Row(f=5), Row(g=5))",
    "TopN(f, n=5)",
    "TopN(g, n=3)",
    "TopN(f)",
    "TopN(f, Row(g=0), n=4)",
    "TopN(f, Intersect(Row(g=0), Row(g=5)), n=6)",
    "TopN(g, Union(Row(f=0), Row(f=10)), n=5)",
    "TopN(f, ids=[0, 1, 5, 12])",
    "TopN(f, Row(g=5), ids=[0, 2, 5, 10])",
    "TopN(f, n=5, threshold=300)",
    # 40 distinct rows in one tree (past the old 32-row tape limit).
    "Count(Union(" + ", ".join(f"Row({fl}={r})" for fl in "fg" for r in range(20)) + "))",
    "Count(Difference(Row(f=0), " + ", ".join(
        f"Intersect(Row(f={r}), Row(g={r}))" for r in range(1, 21)) + "))",
]


@pytest.mark.parametrize("query", CORPUS)
def test_corpus_matches_jax(pair, query):
    jex, tex = pair
    want = [norm(r) for r in jex.execute("i", query)]
    got = [norm(r) for r in tex.execute("i", query)]
    assert got == want


@pytest.mark.parametrize("writes", [
    [f"Set({SHARD_WIDTH + 11}, f=0)"],
    [f"Set({2 * SHARD_WIDTH + 3}, g=0)", "Clear(3, f=0)"],
    [f"Set({3 * SHARD_WIDTH + 1}, f=5)"],   # a new shard appears
])
def test_writes_then_recount_match_jax(pair, writes):
    jex, tex = pair
    reads = ["Count(Intersect(Row(f=0), Row(g=0)))",
             "Count(Union(Row(f=0), Row(f=5)))", "TopN(f, n=4)",
             "TopN(f, Row(g=0), n=4)"]
    # Warm both engines' caches first: the recount must see the write.
    for q in reads:
        assert norm(tex.execute("i", q)[0]) == norm(jex.execute("i", q)[0])
    for w in writes:
        assert tex.execute("i", w) == jex.execute("i", w)
    for q in reads:
        assert norm(tex.execute("i", q)[0]) == norm(jex.execute("i", q)[0]), q


BATCH = [(0, 1), (0, 2), (5, 10), (0, 1), (15, 3), (2, 0), (7, 7)]


def test_count_batch_matches_jax_kernel(pair, monkeypatch):
    """Batched counts, the JAX engine forced onto its Pallas kernel."""
    jex, tex = pair
    monkeypatch.setenv("PILOSA_PALLAS_BATCH", "1")
    shards = list(range(N_SHARDS))
    q = "Count(Intersect(Row(f={}), Row(g={})))"
    jcalls = [jax_parse(q.format(a, b)).calls[0].children[0] for a, b in BATCH]
    tcalls = [torch_parse(q.format(a, b)).calls[0].children[0] for a, b in BATCH]
    want = jex.engine.count_batch("i", jcalls, shards)
    got = tex.engine.count_batch("i", tcalls, shards)
    assert got.tolist() == np.asarray(want).tolist()
    singles = [tex.execute("i", q.format(a, b))[0] for a, b in BATCH]
    assert got.tolist() == singles


def test_count_batch_difference_trees_match_jax(pair, monkeypatch):
    jex, tex = pair
    monkeypatch.setenv("PILOSA_PALLAS_BATCH", "1")
    shards = list(range(N_SHARDS))
    q = "Count(Difference(Union(Row(f={}), Row(g={})), Row(f={})))"
    args = [(0, 1, 5), (2, 3, 0), (10, 0, 15)]
    jcalls = [jax_parse(q.format(*a)).calls[0].children[0] for a in args]
    tcalls = [torch_parse(q.format(*a)).calls[0].children[0] for a in args]
    want = np.asarray(jex.engine.count_batch("i", jcalls, shards)).tolist()
    assert tex.engine.count_batch("i", tcalls, shards).tolist() == want


@pytest.mark.parametrize("src", [None, "Row(g=0)", "Union(Row(g=1), Row(f=2))"])
def test_topn_count_matrices_match_jax(pair, src):
    """engine.topn_shard_counts / topn_counts (K2) against the JAX
    engine's jnp popcount programs, in the requested (unsorted) row order."""
    jex, tex = pair
    shards = list(range(N_SHARDS))
    rows = [5, 0, 12, 5, 3]
    jsrc = jax_parse(src).calls[0] if src else None
    tsrc = torch_parse(src).calls[0] if src else None
    want = jex.engine.topn_shard_counts("i", "f", rows, shards, jsrc)
    got = tex.engine.topn_shard_counts("i", "f", rows, shards, tsrc)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(
        tex.engine.topn_counts("i", "f", rows, shards, tsrc),
        np.asarray(jex.engine.topn_counts("i", "f", rows, shards, jsrc)))


def test_respellings_share_one_plan_and_fit_the_kernel(pair):
    """tests/test_plan.py's respellings corpus: one canonical signature,
    a tape within the kernel's limits, one answer (equal to JAX's)."""
    from tests.test_plan import RESPELLINGS

    jex, tex = pair
    sigs = set()
    for q in RESPELLINGS:
        plan = tex.engine.plan("i", torch_parse(q).calls[0].children[0])
        sigs.add(plan.sig_tuple)
        ops = [code & 0xFF for code in plan.expr.tape]
        n = sum(op == kernels.OP_PUSH or bool(op & kernels.OP_ACC) for op in ops)
        assert kernels.tape_depth(plan.expr.tape) <= n.bit_length() <= kernels.MAX_STACK
    assert len(sigs) == 1
    answers = {tex.execute("i", q)[0] for q in RESPELLINGS}
    assert answers == {jex.execute("i", RESPELLINGS[0])[0]}


def test_calls_outside_the_slice_raise_not_ported(pair):
    """An engine mesh stays outside the port (by design): it raises
    instead of answering. A point-in-time read is in: on a holder without
    change capture it raises the JAX package's typed error. The read
    path's peer fan-out is in: a two-node executor queries its peer for
    the shards the peer owns and reduces the answer with its own."""
    jex, tex = pair
    from pilosa_tpu.executor import ExecOptions as JExecOptions
    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.errors import QueryError
    from pilosa_tpu_torch.executor import ExecOptions, Executor
    from pilosa_tpu_torch.server.server import Server

    with pytest.raises(QueryError, match="require change capture") as ei:
        tex.execute("i", "Count(Row(f=1))", opt=ExecOptions(at_position=1))
    with pytest.raises(Exception) as ej:
        jex.execute("i", "Count(Row(f=1))", opt=JExecOptions(at_position=1))
    assert str(ei.value) == str(ej.value)
    with pytest.raises(QueryError, match="not ported"):
        Server(data_dir=None, device="cpu",
               engine_config=TorchEngineConfig(mesh_devices=2))

    class Peer:
        """Answers every forwarded Count with 1000 and records its shards."""

        def __init__(self):
            self.shards = []

        def query_node(self, node, index, query, shards=None, remote=True, **kw):
            self.shards.append((node.id, list(shards), remote))
            return [1000]

    cluster = Cluster(node=Node(id="a", uri="a:1"), hasher=ModHasher())
    cluster.add_node(Node(id="b", uri="b:1"))
    peer = Peer()
    ex = Executor(tex.holder, cluster=cluster, client=peer)
    mine = [s for s in range(N_SHARDS) if cluster.shard_nodes("i", s)[0].id == "a"]
    theirs = [s for s in range(N_SHARDS) if s not in mine]
    assert mine and theirs
    want = tex.execute("i", "Count(Row(f=1))", shards=mine)[0] + 1000
    assert ex.execute("i", "Count(Row(f=1))") == [want]
    assert peer.shards == [("b", theirs, True)]
    ex.close()
