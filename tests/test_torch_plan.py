"""The cases of tests/test_plan.py, run against the port on the CPU.

Query-plan compiler tests (docs/query-compiler.md).

Covers the canonicalization contract end to end: commutative/associative
respellings of one query share ONE compiled program (proven by the
engine's compile-cache counters), one memo space, and one micro-batcher
group; signatures are injective over canonical programs (equal signature
+ equal leaf binding implies equal semantics, and structurally different
programs never collide); the per-query plan cache on the Call tree
compiles once per query instead of once per dispatch site; and compiled
results stay bit-exact against the per-shard walk and the host ladder —
including while the fused program's signature breaker opens mid-run.
"""

import threading

import numpy as np
import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cluster.health import ResilienceConfig
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder as _Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel import EngineConfig
from pilosa_tpu_torch.parallel.engine import ShardedQueryEngine
from pilosa_tpu_torch.plan import build_plan, cached_plan, snapshot as plan_snapshot
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.sched import MicroBatcher


def Holder(*args, **kw):
    """The port's holder on the CPU."""
    kw.setdefault("device", "cpu")
    return _Holder(*args, **kw)


N_SHARDS = 2
SHARDS = tuple(range(N_SHARDS))


@pytest.fixture
def holder():
    h = Holder(None)
    h.open()
    idx = h.create_index("i")
    fld = idx.create_field("f")
    rng = np.random.default_rng(11)
    for row in range(8):
        cols = []
        for s in range(N_SHARDS):
            local = np.flatnonzero(rng.random(4096) < 0.2)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        fld.import_bits([row] * len(cols), cols)
    vfld = idx.create_field("v", FieldOptions(type="int", min=0, max=100))
    for col in range(0, 600, 7):
        vfld.set_value(col, col % 97)
    yield h
    h.close()


def tree(q: str):
    return parse(q).calls[0].children[0] if q.startswith("Count(") \
        else parse(q).calls[0]


def tape_of(eng, q: str):
    """The K1 op tape a Count's tree lowers to: the port's program."""
    from pilosa_tpu_torch.parallel.engine import _lowered

    return tuple(_lowered(eng.plan("i", tree(q))).tape)


def sig_of(holder, q: str):
    plan = build_plan(holder, "i", tree(q))
    return plan.sig_tuple, tuple(plan.leaves)


# --------------------------------------------------- canonical sharing


RESPELLINGS = [
    "Count(Intersect(Union(Row(f=0), Row(f=1)), Row(f=2), Row(f=3)))",
    "Count(Intersect(Row(f=3), Union(Row(f=1), Row(f=0)), Row(f=2)))",
    "Count(Intersect(Intersect(Row(f=2), Row(f=3)), Union(Row(f=0), Row(f=1))))",
    "Count(Intersect(Union(Row(f=1), Row(f=0)), Intersect(Row(f=3), Row(f=2))))",
]


def test_respellings_share_one_compiled_program(holder, monkeypatch):
    """THE canonicalization acceptance: commutative operand reorderings
    and associative renestings of one tree share one compiled program.
    The port compiles nothing per shape: its program is the K1 op tape
    the plan lowers to, so every respelling lowers to one tape (the
    reference's compile-cache counters, one build and hits thereafter,
    have no counterpart) and each Count is one K1 dispatch."""
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")  # every count dispatches
    eng = ShardedQueryEngine(holder)
    results = [eng.count("i", tree(q), SHARDS) for q in RESPELLINGS]
    assert len(set(results)) == 1
    snap = eng.snapshot()
    assert snap["count_dispatches"] == len(RESPELLINGS), snap
    assert len({tape_of(eng, q) for q in RESPELLINGS}) == 1
    # All respellings share signature AND leaf-binding order.
    sigs = {sig_of(holder, q) for q in RESPELLINGS}
    assert len(sigs) == 1


def test_respellings_share_collective_descriptor_and_program(holder):
    """The COLLECTIVE plane's descriptor signature is the same canonical
    plan signature (parallel/collective.py _call_sig): every respelling
    in the corpus produces one descriptor sig, shares one collective
    compiled program, and answers identically through the one-pod
    collective path (PR 12 satellite)."""
    from types import SimpleNamespace

    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.logger import NopLogger
    from pilosa_tpu_torch.parallel import CollectiveConfig
    from pilosa_tpu_torch.parallel.collective import CollectiveBackend

    node = Node(id="n0", process_idx=0)
    backend = CollectiveBackend(
        SimpleNamespace(
            holder=holder, logger=NopLogger(),
            cluster=Cluster(node=node, nodes=[node], replica_n=1),
            client=None,
        ),
        CollectiveConfig(single_process=1),
    )
    try:
        sigs = {backend._call_sig("i", tree(q)) for q in RESPELLINGS}
        assert len(sigs) == 1, sigs
        results = {backend.count("i", tree(q)) for q in RESPELLINGS}
        assert len(results) == 1
        count_fns = [k for k in backend._fn_cache if k[0] == "count"]
        assert len(count_fns) == 1, count_fns
    finally:
        backend.close()


def test_respellings_share_memo(holder):
    """With memos on, a respelling of an answered query is a memo hit —
    no second dispatch at all."""
    eng = ShardedQueryEngine(holder)
    r1 = eng.count("i", tree(RESPELLINGS[0]), SHARDS)
    d1 = eng.snapshot()["count_dispatches"]
    for q in RESPELLINGS[1:]:
        assert eng.count("i", tree(q), SHARDS) == r1
    snap = eng.snapshot()
    assert snap["count_dispatches"] == d1, snap
    assert snap["memo_hits"] >= len(RESPELLINGS) - 1, snap


def test_difference_normalizations_bit_exact(holder, monkeypatch):
    """Difference canonicalization: head-nesting flattens, subtracting
    Unions merge into the tail, the tail sorts — one signature, one
    program, answers equal to the reference per-shard walk."""
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    spellings = [
        "Count(Difference(Difference(Row(f=0), Row(f=1)), Row(f=2)))",
        "Count(Difference(Row(f=0), Row(f=2), Row(f=1)))",
        "Count(Difference(Row(f=0), Union(Row(f=1), Row(f=2))))",
    ]
    assert len({sig_of(holder, q) for q in spellings}) == 1
    ex = Executor(holder, workers=0)
    got = [ex.execute("i", q)[0] for q in spellings]
    walk = sum(
        ex._execute_bitmap_call_shard("i", tree(spellings[0]), s).count()
        for s in SHARDS)
    assert got == [walk] * len(spellings)
    assert len({tape_of(ex.engine, q) for q in spellings}) == 1


def test_head_nested_difference_is_not_flattened_into_tail(holder):
    """a \\ (b \\ c) is NOT a \\ b \\ c: only head-position nesting and
    subtracting Unions may flatten."""
    s1 = sig_of(holder, "Count(Difference(Row(f=0), Difference(Row(f=1), Row(f=2))))")
    s2 = sig_of(holder, "Count(Difference(Row(f=0), Row(f=1), Row(f=2)))")
    assert s1[0] != s2[0]


# ------------------------------------------------------- injectivity


DISTINCT_CORPUS = [
    "Count(Row(f=0))",
    "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Intersect(Row(f=0), Row(f=0)))",      # slot aliasing differs
    "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))",  # arity differs
    "Count(Union(Row(f=0), Row(f=1)))",
    "Count(Xor(Row(f=0), Row(f=1)))",
    "Count(Difference(Row(f=0), Row(f=1)))",
    "Count(Difference(Row(f=0), Difference(Row(f=1), Row(f=2))))",
    "Count(Intersect(Union(Row(f=0), Row(f=1)), Row(f=2)))",
    "Count(Union(Intersect(Row(f=0), Row(f=1)), Row(f=2)))",
    "Count(Range(v > 3))",
    "Count(Range(v > 4))",                        # baked predicate differs
    "Count(Range(v >= 3))",
    "Count(Range(v < 3))",
    "Count(Range(v == 3))",
    "Count(Range(v != 3))",
    "Count(Range(v != null))",
    "Count(Range(v >< [1, 2]))",
    "Count(Range(v >< [2, 3]))",
    "Count(Intersect(Row(f=0), Range(v > 3)))",
]


def test_semantically_different_programs_never_collide(holder):
    """Every corpus entry lowers to a distinct signature: the signature
    is a faithful serialization of the canonical program (ops, arities,
    slot aliasing, baked predicates), so no two different programs can
    share one. Verified doubly: the evaluated answers that DO differ
    prove the programs are genuinely different."""
    sigs = [sig_of(holder, q)[0] for q in DISTINCT_CORPUS]
    assert len(set(sigs)) == len(sigs), "signature collision in corpus"


def test_equal_signature_equal_binding_implies_equal_answer(holder):
    """The no-collision contract, stated positively: any two trees that
    canonicalize to the same (signature, leaf binding) must answer
    identically — checked over every pair the corpus + respellings
    produce, against the reference per-shard walk."""
    ex = Executor(holder, workers=0)
    pool = DISTINCT_CORPUS + RESPELLINGS + [
        "Count(Union(Row(f=1), Row(f=0)))",
        "Count(Xor(Row(f=1), Row(f=0)))",
    ]
    by_key = {}
    for q in pool:
        key = sig_of(holder, q)
        walk = sum(
            ex._execute_bitmap_call_shard("i", tree(q), s).count()
            for s in SHARDS)
        by_key.setdefault(key, set()).add(walk)
    collisions = {k: v for k, v in by_key.items() if len(v) > 1}
    assert not collisions, collisions


# ------------------------------------------------------ per-query cache


def test_plan_cached_on_call_across_dispatch_sites(holder):
    """The satellite fix: one canonical lowering per query, reused across
    every dispatch-site touch of the same Call tree (support gate, count,
    host ladder), instead of one rebuild per touch."""
    eng = ShardedQueryEngine(holder)
    call = tree("Count(Intersect(Row(f=0), Row(f=1)))")
    before = plan_snapshot()
    assert eng.supports(call, "i")
    eng.count("i", call, SHARDS)
    eng.host_count("i", call, SHARDS)
    delta = {k: v - before[k] for k, v in plan_snapshot().items()}
    assert delta["plan_builds"] == 1, delta
    assert delta["plan_cache_hits"] >= 2, delta


def test_plan_cache_invalidated_by_write_epoch(holder):
    """A write anywhere in the index invalidates the cached plan (a write
    can create time views or stretch a BSI range, changing the correct
    lowering)."""
    eng = ShardedQueryEngine(holder)
    call = tree("Count(Row(f=0))")
    cached_plan(holder, "i", call)
    p1 = cached_plan(holder, "i", call)
    holder.field("i", "f").set_bit(0, 9)
    before = plan_snapshot()
    p2 = cached_plan(holder, "i", call)
    assert plan_snapshot()["plan_builds"] == before["plan_builds"] + 1
    assert p2 is not p1


def test_plan_cache_knob_disables(holder):
    eng = ShardedQueryEngine(holder, config=EngineConfig(plan_cache=0))
    call = tree("Count(Row(f=1))")
    before = plan_snapshot()
    assert eng.supports(call, "i")
    assert eng.supports(call, "i")
    delta = plan_snapshot()
    assert delta["plan_builds"] - before["plan_builds"] == 2
    assert delta["plan_cache_hits"] == before["plan_cache_hits"]


# ------------------------------------------- ladder bit-exactness/chaos


def test_fused_answers_bit_exact_under_sig_breaker_chaos(holder, monkeypatch):
    """Seed-pinned chaos acceptance: the fused program's signature
    breaker opens MID-RUN (one injected dispatch error at
    device-sig-failures=1) and the ladder serves the SAME answers — the
    fault is a routing event, never a correctness event."""
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    ex = Executor(holder, workers=0)
    ex.cluster.health.configure(ResilienceConfig(
        device_sig_failures=1, device_sig_backoff=60.0).validate())
    queries = RESPELLINGS + ["Count(Union(Row(f=2), Row(f=4)))"]
    try:
        baseline = [ex.execute("i", q)[0] for q in queries]
        host = [ex.engine.host_count("i", tree(q), SHARDS) for q in queries]
        assert baseline == host
        failpoints.configure("device-dispatch", "error", count=1)
        chaos = [ex.execute("i", q)[0] for q in queries]
        assert chaos == baseline
        dh = ex.engine.device_health.snapshot()
        assert dh["sig_quarantined"] >= 1, dh
        # Still quarantined (backoff 60s): a second pass routes the
        # per-shard rung and stays bit-exact with zero new dispatches
        # for the quarantined shape.
        d0 = ex.engine.snapshot()["count_dispatches"]
        assert [ex.execute("i", q)[0] for q in RESPELLINGS] == \
            baseline[: len(RESPELLINGS)]
        assert ex.engine.snapshot()["count_dispatches"] == d0
    finally:
        failpoints.reset()
        ex.close()


def test_plan_lower_failpoint_falls_back_per_shard(holder):
    """An injected lowering failure makes the support gate refuse; the
    query is served by the reference per-shard walk, not an error."""
    ex = Executor(holder, workers=0)
    want = ex.execute("i", "Count(Intersect(Row(f=0), Row(f=1)))")[0]
    refusals0 = ex.engine.snapshot()["compile_gate_refusals"]
    failpoints.configure("plan-lower", "error")
    try:
        got = ex.execute("i", "Count(Intersect(Row(f=0), Row(f=1)))")[0]
    finally:
        failpoints.reset()
    assert got == want
    assert ex.engine.snapshot()["compile_gate_refusals"] > refusals0


# ------------------------------------------------ batcher generalization


def _batcher_setup(holder, monkeypatch, n):
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    ex = Executor(holder, workers=0)
    engine = ex.engine
    batcher = MicroBatcher(
        lambda: engine, window=2.0, window_max=10.0, batch_max=n,
        depth_fn=lambda: n,
    )
    ex.batcher = batcher
    return ex, engine, batcher


def test_batcher_coalesces_commutative_respellings(holder, monkeypatch):
    """The generalized compatibility key is the CANONICAL signature:
    operand-shuffled spellings of one shape land in ONE group and one
    fused launch."""
    n = 4
    ex0 = Executor(holder, workers=0)
    truth = [ex0.execute("i", q)[0] for q in RESPELLINGS]
    ex, engine, batcher = _batcher_setup(holder, monkeypatch, n)
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait(timeout=10)
        results[i] = ex.execute("i", RESPELLINGS[i])[0]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    before = engine.counters["count_dispatches"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == truth
    assert engine.counters["count_dispatches"] - before == 1
    assert batcher.counters["launches"] == 1
    assert batcher.counters["coalesced"] == n - 1


def test_batcher_batches_bitmap_expressions(holder, monkeypatch):
    """Beyond Counts: same-signature BITMAP dispatches coalesce into one
    fused bitmap_batch launch, each caller getting its own exact Row."""
    n = 4
    ex0 = Executor(holder, workers=0)
    queries = [f"Intersect(Row(f={r}), Row(f={r + 1}))" for r in range(n)]
    truth = [sorted(ex0.execute("i", q)[0].columns()) for q in queries]
    ex, engine, batcher = _batcher_setup(holder, monkeypatch, n)
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        barrier.wait(timeout=10)
        results[i] = sorted(ex.execute("i", queries[i])[0].columns())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    before = engine.counters["bitmap_dispatches"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == truth
    assert engine.counters["bitmap_dispatches"] - before == 1
    assert batcher.counters["launches"] == 1
    assert batcher.counters["coalesced"] == n - 1


def test_bitmap_batch_direct_matches_unbatched(holder):
    """engine.bitmap_batch == engine.bitmap per query, including the
    non-set-op (BSI) per-call fallback path."""
    eng = ShardedQueryEngine(holder)
    calls = [tree("Count(Intersect(Row(f=0), Row(f=1)))"),
             tree("Count(Intersect(Row(f=2), Row(f=3)))"),
             # Duplicate of the first: the within-batch dedup computes
             # its plane once and both Rows must still be exact.
             tree("Count(Intersect(Row(f=1), Row(f=0)))")]
    rows = eng.bitmap_batch("i", calls, SHARDS)
    for call, row in zip(calls, rows):
        assert sorted(row.columns()) == \
            sorted(eng.bitmap("i", call, SHARDS).columns())
    bsi = [tree("Count(Range(v > 10))"), tree("Count(Range(v > 20))")]
    rows = eng.bitmap_batch("i", bsi, SHARDS)
    for call, row in zip(bsi, rows):
        assert sorted(row.columns()) == \
            sorted(eng.bitmap("i", call, SHARDS).columns())


# ----------------------------------------------------------- plumbing


def test_plan_counter_group_shape():
    snap = plan_snapshot()
    for key in ("plan_builds", "plan_cache_hits", "plan_reorders",
                "plan_flattens"):
        assert key in snap
