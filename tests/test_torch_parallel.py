"""The port's engine over several shard partitions, on the CPU.

The first part mirrors tests/test_parallel.py on the port: there the
reference's engine runs on the virtual 8-device CPU mesh; here the port's
runs on 8 partitions of the CPU (`mesh=["cpu"] * 8`, parallel/mesh.py),
against the same planted ground truth: every leaf is held as one block
of S_padded / N shards per partition, padding slots are zero, and the
partial counts reduce across the partitions.

The second part holds the port on N = 2, 3 (5 shards padded to 6) and 8
partitions against pilosa_tpu on an N-device CPU mesh (`[engine]
mesh-devices` N), on the same numpy-seeded data: Counts, count_batch with
and without duplicate queries, bitmaps and bitmap_batch, TopN with and
without a filter, Sum/Min/Max with a maximum tied across partitions, BSI
and time Ranges, and the counters of delta refresh, tiering and the memo,
all exactly. A single Count reads a stack of its leaves in the port and
the leaf planes in the reference (tests/test_torch_delta.py), so the
refresh counters are compared on stack reads. Last, a server of each
package with `mesh_devices = 4` answers test_torch_mux_parity.py's reads
alike.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.tier import TierConfig as JTierConfig
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
from pilosa_tpu_torch.executor import Executor as TExecutor
from pilosa_tpu_torch.parallel import EngineConfig as TEngineConfig
from pilosa_tpu_torch.parallel import mesh as tmesh
from pilosa_tpu_torch.parallel.engine import Blocks, Leaf, ShardedQueryEngine
from pilosa_tpu_torch.tier import TierConfig as TTierConfig
from tests.test_torch_delta import BOTH, JAX, SHARED, TORCH, counters

CPU8 = ["cpu"] * 8


# ------------------------------------------------ mirror of test_parallel.py


@pytest.fixture
def holder(tmp_path):
    h = TORCH.Holder(str(tmp_path / "data"))
    h.open()
    yield h
    h.close()


@pytest.fixture
def ex(holder):
    e = TExecutor(holder, workers=0, engine_config=TEngineConfig(mesh_devices=8))
    yield e
    e.close()


def plant(holder, n_shards=5):
    """tests/test_parallel.py's data: f=1 in every shard, f=2 in even
    shards, g=3 sparse."""
    idx = holder.create_index_if_not_exists("i")
    idx.create_field_if_not_exists("f")
    idx.create_field_if_not_exists("g")
    rng = np.random.default_rng(3)
    expected = {}
    for name, row, density in [("f", 1, 0.001), ("f", 2, 0.0005), ("g", 3, 0.0008)]:
        cols = []
        for s in range(n_shards):
            if name == "f" and row == 2 and s % 2:
                continue
            local = np.flatnonzero(rng.random(4096) < density * 256)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        idx.field(name).import_bits([row] * len(cols), cols)
        expected[(name, row)] = set(cols)
    return expected


def parse(q):
    return TORCH.parse(q).calls[0]


def test_default_mesh_and_placement():
    """The mesh helpers: the CPU alone by default, N partitions of it for
    mesh-devices N, contiguous shard runs per partition, padding to a
    partition multiple."""
    assert tmesh.default_mesh(device="cpu") == [torch.device("cpu")]
    assert tmesh.default_mesh(CPU8) == [torch.device("cpu")] * 8
    assert tmesh.engine_mesh(0, "cpu") == [torch.device("cpu")]
    assert tmesh.engine_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        tmesh.engine_mesh(-1, "cpu")
    assert [tmesh.pad_shards(n, 8) for n in (0, 5, 8, 9)] == [0, 8, 8, 16]
    assert [tmesh.device_for_shard(i, 8, 4) for i in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]


def test_engine_count_matches_per_shard(holder):
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(5))
    want = len(expected[("f", 1)] & expected[("g", 3)])
    assert engine.count("i", parse("Intersect(Row(f=1), Row(g=3))"), shards) == want
    for name, op in [("Union", set.union), ("Difference", set.difference),
                     ("Xor", set.symmetric_difference)]:
        want = len(op(expected[("f", 1)], expected[("f", 2)]))
        assert engine.count("i", parse(f"{name}(Row(f=1), Row(f=2))"), shards) == want, name


def test_engine_bitmap_matches(holder):
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    row = engine.bitmap("i", parse("Union(Row(f=1), Row(g=3))"), list(range(5)))
    assert set(row.columns().tolist()) == expected[("f", 1)] | expected[("g", 3)]
    assert sorted(row.segments) == list(range(5))


def test_engine_leaf_is_sharded(holder):
    """An 8-shard leaf is 8 blocks of one shard each, one per partition,
    each on its partition's device; joined they are the fragments'
    planes."""
    plant(holder, n_shards=8)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    arr = engine._gather_leaf("i", Leaf("f", "standard", 1), tuple(range(8)))
    assert isinstance(arr, Blocks) and len(arr) == 8
    assert all(b.shape == (1, arr[0].shape[1]) for b in arr)
    assert [b.device for b in arr] == engine.mesh
    want = np.stack([holder.fragment("i", "f", "standard", s).plane_np(1) for s in range(8)])
    np.testing.assert_array_equal(arr.joined().numpy().view(np.uint32), want)
    assert arr.nbytes == want.nbytes


def test_mesh_on_a_named_card_stays_on_it(monkeypatch):
    """With four cards (a faked count; nothing launches): "cuda" spreads
    the partitions round-robin over every card, and a device naming one
    card keeps them all on it, so a rank given cuda:r stays on its card
    at any mesh-devices. One card per rank is mesh-devices 1 on cuda:r."""
    from pilosa_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert tmesh.engine_mesh(0, "cuda") == cards
    assert tmesh.engine_mesh(6, "cuda") == cards + cards[:2]
    for r in range(4):
        assert tmesh.engine_mesh(0, f"cuda:{r}") == [cards[r]]
        assert tmesh.engine_mesh(1, f"cuda:{r}") == [cards[r]]
        assert tmesh.engine_mesh(2, f"cuda:{r}") == [cards[r]] * 2
        assert distributed.global_mesh(None, f"cuda:{r}") == [cards[r]]
    with pytest.raises(RuntimeError, match="4 cards"):
        tmesh.engine_mesh(1, "cuda:4")


def test_engine_mesh_devices_knob(holder, monkeypatch):
    """[engine] mesh-devices N builds N partitions, from a config or from
    the env spelling when no config is given; 0 is one per local device
    (one on the CPU). Results stay exact."""
    expected = plant(holder)
    call = parse("Intersect(Row(f=1), Row(g=3))")
    want = len(expected[("f", 1)] & expected[("g", 3)])
    for n in (1, 3):
        engine = ShardedQueryEngine(holder, config=TEngineConfig(mesh_devices=n))
        assert engine.n_devices == n and engine.mesh == [torch.device("cpu")] * n
        assert engine.count("i", call, list(range(5))) == want
    assert ShardedQueryEngine(holder, config=TEngineConfig()).n_devices == 1
    monkeypatch.setenv("PILOSA_TPU_ENGINE_MESH_DEVICES", "4")
    assert ShardedQueryEngine(holder).n_devices == 4


def test_engine_executor_integration(holder, ex):
    expected = plant(holder)
    want = len(expected[("f", 1)] & expected[("g", 3)])
    assert ex.execute("i", "Count(Intersect(Row(f=1), Row(g=3)))") == [want]
    row = ex.execute("i", "Intersect(Row(f=1), Row(g=3))")[0]
    assert set(row.columns().tolist()) == expected[("f", 1)] & expected[("g", 3)]
    assert ex.engine.n_devices == 8


def test_engine_cache_invalidation(holder, ex):
    plant(holder)
    res1 = ex.execute("i", "Count(Row(f=1))")[0]
    ex.execute("i", f"Set({3 * SHARD_WIDTH + 77}, f=1)")
    assert ex.execute("i", "Count(Row(f=1))")[0] == res1 + 1


def test_engine_bsi_range(holder):
    idx = holder.create_index_if_not_exists("i")
    idx.create_field_if_not_exists("v", TFieldOptions(type="int", min=0, max=100))
    cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 3 * SHARD_WIDTH + 4]
    idx.field("v").import_value(cols, [10, 20, 30, 40])
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    row = engine.bitmap("i", parse("Range(v > 15)"), list(range(4)))
    assert row.columns().tolist() == cols[1:]
    assert engine.count("i", parse("Range(15 < v < 35)"), list(range(4))) == 2


def test_engine_topn_counts(holder):
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    counts = engine.topn_counts("i", "f", [1, 2], list(range(5)))
    assert counts.tolist() == [len(expected[("f", 1)]), len(expected[("f", 2)])]
    counts = engine.topn_counts("i", "f", [1, 2], list(range(5)), src_call=parse("Row(g=3)"))
    assert counts.tolist() == [len(expected[("f", 1)] & expected[("g", 3)]),
                               len(expected[("f", 2)] & expected[("g", 3)])]


def test_engine_padding_non_divisible(holder):
    """5 shards on 8 partitions: three blocks hold only zero padding and
    change no answer; per-shard counts come back trimmed to the 5."""
    expected = plant(holder, n_shards=5)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    assert engine.count("i", parse("Row(f=1)"), list(range(5))) == len(expected[("f", 1)])
    arr = engine._gather_leaf("i", Leaf("f", "standard", 1), tuple(range(5)))
    assert len(arr) == 8 and not any(int(b.abs().sum()) for b in arr[5:])
    rows, _, _ = engine.topn_shard_counts("i", "f", [1], list(range(5)))
    assert rows.shape == (1, 5) and int(rows.sum()) == len(expected[("f", 1)])


def test_engine_count_batch_setops(holder):
    """Batched counts over partitions match single counts, for batch
    sizes 1, 3, 5, with duplicate queries computed once and fanned back."""
    plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(5))
    queries = ["Intersect(Row(f=1), Row(g=3))", "Intersect(Row(f=1), Row(f=2))",
               "Intersect(Row(f=2), Row(g=3))", "Intersect(Row(f=1), Row(g=3))",
               "Intersect(Row(g=3), Row(f=1))"]
    calls = [parse(q) for q in queries]
    singles = [engine.count("i", c, shards) for c in calls]
    for q in (1, 3, 5):
        assert engine.count_batch("i", calls[:q], shards).tolist() == singles[:q], q
    more = [parse("Intersect(Row(f=2), Row(f=1))")] * 4
    got = engine.count_batch("i", more + calls[:1], shards)
    assert got.tolist() == [engine.count("i", more[0], shards)] * 4 + singles[:1]


def test_engine_count_batch_async_and_stack_invalidation(holder):
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(5))
    calls = [parse("Intersect(Row(f=1), Row(g=3))"), parse("Intersect(Row(f=1), Row(f=2))")]
    singles = [engine.count("i", c, shards) for c in calls]
    assert np.asarray(engine.count_batch_async("i", calls, shards)).tolist() == singles
    frag = holder.fragment("i", "f", "standard", 0)
    col = 777
    if frag.bit(1, col):
        frag.clear_bit(1, col)
        expected[("f", 1)].discard(col)
    else:
        frag.set_bit(1, col)
        expected[("f", 1)].add(col)
    assert engine.count_batch("i", calls, shards).tolist() == [
        len(expected[("f", 1)] & expected[("g", 3)]),
        len(expected[("f", 1)] & expected[("f", 2)])]


def test_engine_leaf_cache_eviction_under_tiny_budget(holder, monkeypatch):
    """Budgets count the padded bytes of every partition's block; under a
    budget smaller than one plane the caches evict without corrupting
    answers."""
    monkeypatch.setenv("PILOSA_LEAF_CACHE_BYTES", "8192")
    monkeypatch.setenv("PILOSA_STACK_CACHE_BYTES", "8192")
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    counts = engine.topn_counts("i", "f", list(range(40)), [0])
    in_shard0 = lambda cols: sum(1 for c in cols if c < SHARD_WIDTH)  # noqa: E731
    assert counts[1] == in_shard0(expected[("f", 1)])
    assert counts[2] == in_shard0(expected[("f", 2)])
    assert engine.topn_counts("i", "f", list(range(40)), [0]).tolist() == counts.tolist()
    calls = [parse("Intersect(Row(f=1), Row(f=2))")] * 3
    want = len(expected[("f", 1)] & expected[("f", 2)])
    assert engine.count_batch("i", calls, list(range(5))).tolist() == [want] * 3
    with engine._lock:
        assert engine._leaf_bytes == sum(e[1].nbytes for e in engine._leaf_cache.values())


def test_engine_memo_skips_device_on_repeat(holder):
    expected = plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(5))
    call = parse("Intersect(Row(f=1), Row(g=3))")
    want = len(expected[("f", 1)] & expected[("g", 3)])
    assert engine.count("i", call, shards) == want
    base = dict(engine.counters)
    assert engine.count("i", call, shards) == want
    assert engine.counters["memo_hits"] == base["memo_hits"] + 1
    assert engine.counters["count_dispatches"] == base["count_dispatches"]
    new_col = 777_777
    holder.index("i").field("f").set_bit(1, new_col)
    assert engine.count("i", call, shards) == want + (new_col in expected[("g", 3)])


def test_topn_shard_counts_memo_and_invalidation(holder):
    plant(holder)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(5))
    a1, _, _ = engine.topn_shard_counts("i", "f", [2, 1], shards)
    base = dict(engine.counters)
    a2, _, _ = engine.topn_shard_counts("i", "f", [1, 2], shards)
    assert engine.counters["memo_hits"] == base["memo_hits"] + 1
    np.testing.assert_array_equal(a1[0], a2[1])
    np.testing.assert_array_equal(a1[1], a2[0])
    assert holder.fragment("i", "f", "standard", 0).set_bit(1, 5000)
    a3, _, _ = engine.topn_shard_counts("i", "f", [2, 1], shards)
    assert int(a3[1].sum()) == int(a1[1].sum()) + 1
    assert engine.counters["memo_misses"] > base["memo_misses"]


def test_bsi_val_count_memo_and_invalidation(holder, ex):
    idx = holder.create_index_if_not_exists("i")
    idx.create_field_if_not_exists("v", TFieldOptions(type="int", min=0, max=1000))
    ex.execute("i", "SetValue(col=1, v=5)")
    ex.execute("i", "SetValue(col=2, v=7)")
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    depth = idx.field("v").bsi_group("v").bit_depth()
    counts1 = engine.bsi_val_count("i", "v", "sum", depth, [0])
    base = dict(engine.counters)
    np.testing.assert_array_equal(counts1, engine.bsi_val_count("i", "v", "sum", depth, [0]))
    assert engine.counters["memo_hits"] == base["memo_hits"] + 1
    ex.execute("i", "SetValue(col=3, v=9)")
    counts3 = engine.bsi_val_count("i", "v", "sum", depth, [0])
    assert int(counts3[depth]) == int(counts1[depth]) + 1


def test_gather_kernel_per_partition(holder):
    """K1 runs once per partition per batch (its plain twin on the CPU,
    one call per block) and the partial counts sum to the planted
    truth, as the reference's kernel under shard_map with a psum."""
    from pilosa_tpu_torch.ops import kernels

    expected = plant(holder, n_shards=8)
    engine = ShardedQueryEngine(holder, mesh=CPU8)
    shards = list(range(8))
    pairs = [("f", 1, "g", 3), ("f", 1, "f", 2), ("f", 2, "g", 3)]
    calls = [parse(f"Intersect(Row({fa}={ra}), Row({fb}={rb}))") for fa, ra, fb, rb in pairs]
    want = [len(expected[(fa, ra)] & expected[(fb, rb)]) for fa, ra, fb, rb in pairs]
    before = kernels.PLAIN_CALLS["gather_expr_count"]
    with engine.memos_off():
        assert engine.count_batch("i", calls, shards).tolist() == want
    assert kernels.PLAIN_CALLS["gather_expr_count"] - before == 8
    assert [engine.count("i", c, shards) for c in calls] == want


# ------------------------------------------ parity with pilosa_tpu's mesh

N_SHARDS = 5
N_ROWS = 6
DAY = "2018-01-{:02d}T00:00"


def fill(pk, holder):
    """The same numpy-seeded data into a holder of either package: rows
    of f and g, an int field v whose maximum 1000 sits in shards 0 and 4
    (a tie across partitions at N = 2, 3 and 8), and a YMD time field t."""
    rng = np.random.default_rng(17)
    idx = holder.create_index_if_not_exists("i")
    opts = JFieldOptions if pk is JAX else TFieldOptions
    for name in ("f", "g"):
        fld = idx.create_field_if_not_exists(name)
        for row in range(N_ROWS):
            cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 1500 + 200 * row))
            fld.import_bits([row] * len(cols), cols.tolist())
    v = idx.create_field_if_not_exists("v", opts(type="int", min=0, max=1000))
    cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 4000))
    vals = rng.integers(0, 990, len(cols))
    cols = np.concatenate([cols, [N_SHARDS * SHARD_WIDTH - 5, 11]])
    vals = np.concatenate([vals, [1000, 1000]])
    keep = np.unique(cols, return_index=True)[1]
    v.import_value(cols[keep].tolist(), vals[keep].tolist())
    idx.create_field_if_not_exists("t", opts(type="time", time_quantum="YMD"))
    ex = (JExecutor(holder, workers=0) if pk is JAX
          else TExecutor(holder, workers=0))
    tcols = rng.integers(0, N_SHARDS * SHARD_WIDTH, 40)
    days = rng.integers(1, 28, 40)
    ex.execute("i", " ".join(f"Set({int(c)}, t={i % 2}, {DAY.format(int(d))})"
                             for i, (c, d) in enumerate(zip(tcols, days))))
    ex.close()


@pytest.fixture(scope="module")
def pair_holders(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel_parity")
    hs = {}
    for pk in BOTH:
        h = pk.Holder(str(base / pk.name))
        h.open()
        fill(pk, h)
        hs[pk.name] = h
    yield hs
    for h in hs.values():
        h.close()


def make_engine(pk, holder, n, **kw):
    if pk is JAX:
        return pk.Engine(holder, config=JEngineConfig(mesh_devices=n, gather_workers=1), **kw)
    return pk.Engine(holder, mesh=["cpu"] * n, **kw)


@pytest.fixture(scope="module")
def engine_pairs(pair_holders):
    """One engine of each package per mesh width, shared by the read
    cases (they do not write)."""
    made = {}

    def get(n):
        if n not in made:
            made[n] = {pk.name: make_engine(pk, pair_holders[pk.name], n) for pk in BOTH}
        return made[n]

    yield get
    for engs in made.values():
        for e in engs.values():
            e.close()


def norm(x):
    """A comparable form of an engine answer of either package."""
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    if isinstance(x, list):
        return [norm(v) for v in x]
    if hasattr(x, "columns") and hasattr(x, "segments"):
        return ("row", x.columns().tolist())
    if x is None or isinstance(x, (int, np.integer)):
        return None if x is None else int(x)
    return np.asarray(x).tolist()


WIDTHS = [2, 3, 8]
SHARDS = list(range(N_SHARDS))
TREES = ["Intersect(Row(f=1), Row(g=2))", "Union(Row(f=0), Row(g=5), Row(f=3))",
         "Difference(Row(f=4), Row(g=4), Row(f=1))", "Xor(Row(f=2), Row(g=3))",
         "Intersect(Union(Row(f=0), Row(f=1)), Difference(Row(g=0), Row(g=1)))"]


def both_answers(engine_pairs, n, fn):
    engs = engine_pairs(n)
    out = {pk.name: norm(fn(engs[pk.name], lambda q, pk=pk: pk.parse(q).calls[0]))
           for pk in BOTH}
    assert out["torch"] == out["jax"], n
    return out["torch"]


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_counts(engine_pairs, n):
    """count and count_batch, with and without duplicate queries (the
    inverse fan-out), equal the reference's mesh."""
    def run(e, p):
        batch = [p(TREES[0]), p("Intersect(Row(f=2), Row(g=5))"), p(TREES[0]),
                 p("Intersect(Row(f=5), Row(g=0))")]
        return ([e.count("i", p(t), SHARDS) for t in TREES],
                e.count_batch("i", batch, SHARDS),
                e.count_batch("i", batch[1:], SHARDS),
                int(np.asarray(e.count_async("i", p(TREES[1]), SHARDS))))

    got = both_answers(engine_pairs, n, run)
    assert got[1][0] == got[1][2] == got[0][0]


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_bitmaps(engine_pairs, n):
    def run(e, p):
        return ([e.bitmap("i", p(t), SHARDS) for t in TREES],
                e.bitmap_batch("i", [p("Union(Row(f=1), Row(g=1))"),
                                     p("Union(Row(f=2), Row(g=4))"),
                                     p("Union(Row(f=1), Row(g=1))")], SHARDS))

    both_answers(engine_pairs, n, run)


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_topn(engine_pairs, n):
    """TopN's count matrices: per-row totals and per-(row, shard) counts,
    with and without a filter."""
    def run(e, p):
        rows = [5, 0, 3, 1]
        return (e.topn_counts("i", "f", rows, SHARDS),
                e.topn_counts("i", "f", rows, SHARDS, src_call=p("Row(g=2)")),
                e.topn_shard_counts("i", "f", rows, SHARDS),
                e.topn_shard_counts("i", "f", rows, SHARDS, src_call=p(TREES[3])))

    both_answers(engine_pairs, n, run)


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_bsi(engine_pairs, n, pair_holders):
    """Sum/Min/Max, with and without a filter; Max 1000 is held in shards
    0 and 4, on different partitions, and counted on both."""
    depth = pair_holders["torch"].index("i").field("v").bsi_group("v").bit_depth()

    def run(e, p):
        return [e.bsi_val_count("i", "v", kind, depth, SHARDS, f)
                for kind in ("sum", "min", "max") for f in (None, p("Row(f=3)"))]

    got = both_answers(engine_pairs, n, run)
    bits, count = got[4]
    assert sum(b << i for i, b in enumerate(bits)) == 1000 and count == 2


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_ranges(engine_pairs, n):
    """BSI Ranges (count and bitmap) and a time-quantum Range."""
    trange = f"Range(t=1, {DAY.format(3)}, {DAY.format(20)})"

    def run(e, p):
        return (e.count("i", p("Range(v > 600)"), SHARDS),
                e.count("i", p("Intersect(Row(f=1), Range(v < 300))"), SHARDS),
                e.bitmap("i", p("Range(200 < v < 210)"), SHARDS),
                e.count("i", p(trange), SHARDS),
                e.bitmap("i", p(trange), SHARDS))

    got = both_answers(engine_pairs, n, run)
    assert got[3] > 0


@pytest.fixture
def write_holders(tmp_path):
    hs = {}
    for pk in BOTH:
        h = pk.Holder(str(tmp_path / pk.name))
        h.open()
        fill(pk, h)
        hs[pk.name] = h
    yield hs
    for h in hs.values():
        h.close()


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_delta_refresh(write_holders, n):
    """Writes to resident stacks refresh by deltas in both packages: equal
    answers, equal refresh and memo counters, and no full regather; the
    port touches only the written shard's block."""
    got = {}
    for pk in BOTH:
        h = write_holders[pk.name]
        e = make_engine(pk, h, n)
        try:
            p = lambda q, pk=pk: pk.parse(q).calls[0]  # noqa: E731
            batch = [p("Intersect(Row(f=1), Row(g=2))"), p("Intersect(Row(f=0), Row(g=2))")]
            answers = [e.count_batch("i", batch, SHARDS).tolist(),
                       e.topn_counts("i", "f", [0, 1, 2], SHARDS).tolist()]
            leaves = [pk.Leaf("f", "standard", r) for r in (0, 1)]
            if pk is TORCH:
                before = e._stacked_leaf_tensor("i", leaves, tuple(SHARDS))
            base = e.snapshot()
            f = h.index("i").field("f")
            for col in (3 * SHARD_WIDTH + 12, 3 * SHARD_WIDTH + 4000, 17):
                f.set_bit(1, col)
            answers += [e.count_batch("i", batch, SHARDS).tolist(),
                        e.topn_counts("i", "f", [0, 1, 2], SHARDS).tolist()]
            snap = e.snapshot()
            assert snap["full_refresh_bytes"] == base["full_refresh_bytes"], pk.name
            got[pk.name] = (answers, counters(e, base))
            if pk is TORCH:
                after = e._stacked_leaf_tensor("i", leaves, tuple(SHARDS))
                per = tmesh.pad_shards(N_SHARDS, n) // n
                touched = sorted({3 // per, 0})
                assert [i for i in range(n) if after[i] is not before[i]] == touched
        finally:
            e.close()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_tier(write_holders, n, monkeypatch):
    """A leaf cache of two planes over a sweep of six rows: evicted planes
    demote into the host tier and promote back, with equal answers and
    equal tier hits in both packages (byte budgets of padded planes, the
    same in both). Each count's demotions are captured before the next
    count runs: a re-touch that races the demote worker regathers, and
    the hits would depend on each package's worker keeping pace."""
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    plane = tmesh.pad_shards(N_SHARDS, n) * 32768 * 4
    got = {}
    for pk in BOTH:
        tc = (JTierConfig if pk is JAX else TTierConfig)(host_bytes=64 << 20, disk_bytes=0)
        cfg = pk.EngineConfig(leaf_cache_bytes=2 * plane, stack_cache_bytes=2 * plane,
                              cold_host_count=0, mesh_devices=n, gather_workers=1)
        e = (pk.Engine(write_holders["jax"], config=cfg, tier_config=tc) if pk is JAX
             else pk.Engine(write_holders["torch"], mesh=["cpu"] * n, config=cfg,
                            tier_config=tc))
        try:
            base = e.snapshot()
            answers = []
            for _ in range(2):
                for r in range(N_ROWS):
                    answers.append(int(e.count_async(
                        "i", pk.parse(f"Row(f={r})").calls[0], SHARDS)))
                    assert e.tier.drain()
            got[pk.name] = (answers, counters(e, base),
                            {k: e.tier.snapshot()[k] for k in ("promotions_host",)})
        finally:
            e.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["leaf_tier_hits"] > 0


@pytest.mark.parametrize("n", WIDTHS)
def test_parity_memo(write_holders, n):
    """Repeated Counts, TopN matrices and BSI answers are memo hits in both
    packages, and a write invalidates exactly what it touches."""
    got = {}
    for pk in BOTH:
        h = write_holders[pk.name]
        e = make_engine(pk, h, n)
        try:
            p = lambda q, pk=pk: pk.parse(q).calls[0]  # noqa: E731
            depth = h.index("i").field("v").bsi_group("v").bit_depth()
            base = e.snapshot()
            answers = []
            for _ in range(2):
                answers.append(e.count_batch("i", [p(TREES[0]), p("Intersect(Row(f=2), Row(g=5))")], SHARDS).tolist())
                answers.append(e.topn_counts("i", "g", [1, 2], SHARDS).tolist())
                answers.append(norm(e.bsi_val_count("i", "v", "max", depth, SHARDS)))
            h.index("i").field("g").set_bit(2, 2 * SHARD_WIDTH + 5)
            answers.append(e.count_batch("i", [p(TREES[0]), p("Intersect(Row(f=2), Row(g=5))")], SHARDS).tolist())
            got[pk.name] = (answers, counters(e, base))
        finally:
            e.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["memo_hits"] >= 4


# ------------------------------------------------------- two servers, mesh 4


def test_servers_with_mesh_devices_answer_alike(tmp_path):
    """A pilosa_tpu Server with `[engine] mesh-devices` 4 and a port Server
    on the CPU with the same setting, loaded with the same writes over
    HTTP, give the same answers to test_torch_mux_parity.py's reads; the
    port's engine has 4 partitions."""
    from pilosa_tpu.server.server import Server as JServer
    from pilosa_tpu_torch.server.server import Server as TServer
    from tests.test_torch_mux_parity import READS, free_port_pair, load, post

    answers, servers = {}, []
    try:
        for pkg in ("jax", "torch"):
            port = free_port_pair()
            kw = dict(data_dir=str(tmp_path / pkg), port=port, cache_flush_interval=0,
                      anti_entropy_interval=0, member_monitor_interval=0, executor_workers=0)
            if pkg == "jax":
                srv = JServer(engine_config=JEngineConfig(mesh_devices=4, gather_workers=1),
                              **kw).open()
            else:
                srv = TServer(engine_config=TEngineConfig(mesh_devices=4), device="cpu",
                              **kw).open()
            servers.append(srv)
            load(port, np.random.default_rng(5))
            answers[pkg] = [post(port, "/index/i/query", q) for q in READS]
        assert answers["torch"] == answers["jax"]
        assert servers[1].executor.engine.n_devices == 4
    finally:
        for s in servers:
            s.close()
