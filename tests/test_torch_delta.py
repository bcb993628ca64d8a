"""Delta refresh, the dirty-word journal and the result memo: the port
against the JAX package on the CPU.

The same seeded data and the same write sequence go through both
packages (pilosa_tpu and pilosa_tpu_torch, holder on device="cpu"). Each
case requires equal answers, equal deltas of the counters both engines
share, and delta-refreshed planes and stacks bit-equal to the
reference's (its first S shards: its CPU mesh pads the shard axis) and
to a fresh regather. Mirrors tests/test_delta.py: the journal unit
tests, the every-mutation-path audit (here over every write path of the
port's fragment), recreated indexes and fields never serving a stale
delta or memo, and the memo's O(1) epoch short-circuit.

One difference is by design and is not compared: a single Count reads a
stack of its leaves in the port (K1 reads one stack) and the leaf planes
in the reference, so its refresh lands in stack_delta_hits there and in
leaf_delta_hits here. count_batch, TopN and BSI read stacks in both.
"""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pilosa_tpu
import pilosa_tpu_torch
from pilosa_tpu.constants import SHARD_WIDTH, WORDS_PER_ROW
from pilosa_tpu.core import fragment as jfragment
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.parallel import engine as jengine
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu.tier import TierConfig as JTierConfig
from pilosa_tpu_torch.core import fragment as tfragment
from pilosa_tpu_torch.parallel import EngineConfig as TEngineConfig
from pilosa_tpu_torch.parallel import engine as tengine
from pilosa_tpu_torch.pql.parser import parse as tparse
from pilosa_tpu_torch.tier import TierConfig as TTierConfig

JAX = SimpleNamespace(
    name="jax", pkg=pilosa_tpu, Holder=pilosa_tpu.Holder, parse=jparse,
    Engine=jengine.ShardedQueryEngine, EngineConfig=JEngineConfig,
    TierConfig=JTierConfig, Leaf=jengine.Leaf, Fragment=jfragment.Fragment,
    WriteEpoch=jfragment.WriteEpoch)
TORCH = SimpleNamespace(
    name="torch", pkg=pilosa_tpu_torch,
    Holder=lambda path=None, **kw: pilosa_tpu_torch.Holder(path, device="cpu", **kw),
    parse=tparse, Engine=tengine.ShardedQueryEngine, EngineConfig=TEngineConfig,
    TierConfig=TTierConfig, Leaf=tengine.Leaf, Fragment=tfragment.Fragment,
    WriteEpoch=tfragment.WriteEpoch)
BOTH = (JAX, TORCH)

# The counters both engines keep with the same meaning.
SHARED = ("memo_hits", "memo_misses", "leaf_delta_hits", "stack_delta_hits",
          "leaf_tier_hits", "host_counts", "host_cold_counts",
          "oom_backpressure", "oom_retries")


# ---------------------------------------------------------------- helpers


def plant(holder, n_shards=4, n_rows=4, per_row=300, seed=7, index="i"):
    """tests/test_delta.py's data, into a holder of either package."""
    idx = holder.create_index_if_not_exists(index)
    fld = idx.create_field_if_not_exists("f")
    rng = np.random.default_rng(seed)
    for row in range(n_rows):
        cols = []
        for s in range(n_shards):
            local = rng.choice(SHARD_WIDTH, size=per_row, replace=False)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        fld.import_bits([row] * len(cols), cols)
    return idx.field("f")


def words(arr, *lead) -> np.ndarray:
    """A cached plane or stack of either engine as uint32 words, cut to
    the leading sizes `lead` (the reference pads the shard axis, and its
    stacks' leaf axis to a power of two; the port's are joined first)."""
    if isinstance(arr, tengine.Blocks):  # the port's partition blocks
        arr = arr.joined()
    a = arr.numpy().view(np.uint32) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return a[tuple(slice(0, n) for n in lead)]


def full_leaf(holder, leaf, shards, index="i"):
    """Ground-truth plane assembly straight from storage."""
    bufs = []
    for s in shards:
        frag = holder.fragment(index, leaf.field, leaf.view, s)
        bufs.append(frag.plane_np(leaf.row) if frag is not None
                    else np.zeros(WORDS_PER_ROW, np.uint32))
    return np.stack(bufs)


def counters(eng, base=None):
    snap = eng.snapshot()
    return {k: snap[k] - (base or {}).get(k, 0) for k in SHARED}


@pytest.fixture
def holders(tmp_path):
    """One open holder per package (same data once planted)."""
    hs = {}
    for pk in BOTH:
        h = pk.Holder(str(tmp_path / pk.name))
        h.open()
        hs[pk.name] = h
    yield hs
    for h in hs.values():
        h.close()


@pytest.fixture
def engines():
    """Engines a test builds; closed at teardown (the port's, like the
    reference's, keep a gather pool)."""
    made = []

    def make(pk, holder, **kw):
        eng = pk.Engine(holder, **kw)
        made.append(eng)
        return eng

    yield make
    for e in made:
        e.close()


# ------------------------------------------------------------ journal unit


def _point_writes(f):
    g0 = f.generation
    f.set_bit(1, 64 * 3 + 5)
    f.set_bit(1, 64 * 9)
    f.clear_bit(1, 64 * 3 + 5)
    return (sorted(f.dirty_words_since(1, g0).tolist()),
            f.dirty_words_since(2, g0).tolist(),
            f.dirty_words_since(1, f.generation).tolist())


def _future_generation(f):
    return f.dirty_words_since(1, f.generation + 5)


def _overflow(f):
    f.delta_journal_ops = 8
    g0 = f.generation
    for k in range(12):
        f.set_bit(1, 64 * k)
    poisoned = f.dirty_words_since(1, g0)
    g1 = f.generation
    f.set_bit(1, 64 * 50)
    return poisoned, f.dirty_words_since(1, g1).tolist()


def _hot_word_churn(f):
    f.delta_journal_ops = 8
    g0 = f.generation
    for k in range(100):
        f.set_bit(1, 64 * (k % 2) + k % 32)
        f.clear_bit(1, 64 * (k % 2) + k % 32)
    return sorted(f.dirty_words_since(1, g0).tolist())


def _bulk_import_poisons(f):
    f.delta_journal_ops = 4
    g0 = f.generation
    f.set_bit(2, 7)
    f.bulk_import(np.full(6, 1, np.uint64), np.arange(6, dtype=np.uint64))
    return f.dirty_words_since(1, g0), f.dirty_words_since(2, g0).tolist()


def _read_from_resets(f):
    src = type(f)(None, "i", "f", "standard", 0)
    src.open()
    src.set_bit(1, 100)
    buf = io.BytesIO()
    src.write_to(buf)
    g0 = f.generation
    f.set_bit(1, 200)
    buf.seek(0)
    f.read_from(buf)
    return f.dirty_words_since(1, g0)


def _row_words64(f):
    rng = np.random.default_rng(3)
    for c in rng.integers(0, SHARD_WIDTH, 200):
        f.set_bit(2, int(c))
    idxs = np.unique(rng.integers(0, SHARD_WIDTH // 64, 32))
    got = f.row_words64(2, idxs)
    np.testing.assert_array_equal(got, f.plane_np(2).view(np.uint64)[idxs])
    return got.tolist()


JOURNAL = {
    "point_writes_journal_their_words": _point_writes,
    "future_generation_refuses": _future_generation,
    "overflow_poisons_then_recovers": _overflow,
    "hot_word_churn_does_not_overflow": _hot_word_churn,
    "bulk_import_poisons_touched_rows_only": _bulk_import_poisons,
    "read_from_resets_journal": _read_from_resets,
    "row_words64_matches_plane": _row_words64,
}


@pytest.mark.parametrize("name", sorted(JOURNAL))
def test_journal_matches_jax(name):
    """tests/test_delta.py's journal unit tests, each run on both
    packages' Fragment: the port answers exactly what the reference does."""
    out = {}
    for pk in BOTH:
        f = pk.Fragment(None, "i", "f", "standard", 0)
        f.open()
        res = JOURNAL[name](f)
        out[pk.name] = repr(res)
    assert out["torch"] == out["jax"]
    if name == "future_generation_refuses":
        assert out["torch"] == "None"


# ------------------------------------------------- mutation-path audit


def _merge_small(f):
    rows = np.array([1, 1], dtype=np.uint64)
    cols = np.array([10, 11], dtype=np.uint64)
    f.merge_block(0, [(rows, cols), (rows, cols)])


def _merge_bulk(f):
    n = f.MERGE_BULK_THRESHOLD + 8
    rows = np.full(n, 1, dtype=np.uint64)
    cols = np.arange(n, dtype=np.uint64)
    f.merge_block(0, [(rows, cols), (rows, cols)])


def _read_from(f):
    src = type(f)(None, "i", "f", "standard", 0)
    src.open()
    src.set_bit(3, 123)
    buf = io.BytesIO()
    src.write_to(buf)
    buf.seek(0)
    f.read_from(buf)


def _migrate_install(f):
    mod = pilosa_tpu if isinstance(f, jfragment.Fragment) else pilosa_tpu_torch
    bm = mod.storage.bitmap.Bitmap(np.array([5, SHARD_WIDTH + 9], dtype=np.uint64))
    f.migrate_install(bm.to_bytes())


def _migrate_apply_ops(f):
    mod = pilosa_tpu if isinstance(f, jfragment.Fragment) else pilosa_tpu_torch
    b = mod.storage.bitmap
    f.migrate_apply_ops(b.encode_op(b.OP_ADD, 2 * SHARD_WIDTH + 17))


# Every write path of the port's fragment (core/fragment.py): the point
# writes, SetValue, the bulk imports and clears, the BSI import, the
# anti-entropy merge (per-bit and bulk), hint replay (both sizes), a full
# read_from restore and the live-migration install and op replay.
MUTATIONS = {
    "set_bit": lambda f: f.set_bit(1, 500),
    "clear_bit": lambda f: f.clear_bit(0, 0),  # row 0 bit 0 pre-planted
    "set_value": lambda f: f.set_value(3, 8, 77),
    "bulk_import": lambda f: f.bulk_import(
        np.array([2, 2], np.uint64), np.array([5, 6], np.uint64)),
    "remove_bulk": lambda f: f.remove_bulk(
        np.array([0, 0], np.uint64), np.array([0, 64], np.uint64)),
    "import_value": lambda f: f.import_value(
        np.array([9], np.uint64), np.array([41], np.uint64), 8),
    "merge_block_small": _merge_small,
    "merge_block_bulk": _merge_bulk,
    "apply_hint_small": lambda f: f.apply_hint_positions(
        [SHARD_WIDTH * 2 + 70], [0]),
    "apply_hint_bulk": lambda f: f.apply_hint_positions(
        np.arange(300, dtype=np.uint64) * 65 + SHARD_WIDTH, []),
    "read_from": _read_from,
    "migrate_install": _migrate_install,
    "migrate_apply_ops": _migrate_apply_ops,
}
AUDIT_ROWS = range(10)


def _audit(pk, name):
    epoch = pk.WriteEpoch()
    f = pk.Fragment(None, "i", "f", "standard", 0, epoch=epoch)
    f.open()
    f.set_bit(0, 0)  # seed so clear_bit actually clears
    f.set_bit(4, 64 * 7 + 1)
    before = {r: f.plane_np(r).copy() for r in AUDIT_ROWS}
    g0, e0 = f.generation, epoch.value
    MUTATIONS[name](f)
    assert f.generation > g0, f"{name} did not bump generation"
    assert epoch.value > e0, f"{name} did not bump write epoch"
    journal = {}
    for r in AUDIT_ROWS:
        w = f.dirty_words_since(r, g0)
        journal[r] = None if w is None else sorted(w.tolist())
        if w is None:
            continue
        # What the journal names is all that changed: the old plane with
        # the named words re-read equals the new plane (never a partial
        # delta).
        patched = before[r].view(np.uint64).copy()
        patched[w] = f.row_words64(r, w)
        np.testing.assert_array_equal(patched.view(np.uint32), f.plane_np(r),
                                      err_msg=f"{name}: row {r} journal incomplete")
    return f.generation - g0, journal


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_every_mutation_path_bumps_and_journals_like_jax(name):
    """A write path that skips the generation or epoch bump, or journals
    fewer words than it changed, serves a stale delta silently: each path
    bumps both, its journal re-reads to the new plane, and generation
    steps and journal answers equal the reference's."""
    assert _audit(TORCH, name) == _audit(JAX, name)


# ---------------------------------------------------- engine delta refresh


def test_single_set_refreshes_leaf_via_delta(holders, engines):
    """One set() on a resident leaf refreshes the cached plane through
    the delta path in both engines; the plane equals the reference's and
    a storage regather."""
    shards = tuple(range(4))
    leaf_of = {pk.name: pk.Leaf("f", "standard", 0) for pk in BOTH}
    col = 3 * SHARD_WIDTH + 4321
    seen = {}
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h)
        eng = engines(pk, h)
        eng._gather_leaf("i", leaf_of[pk.name], shards)
        full = eng.snapshot()["full_refresh_bytes"]
        assert full >= 4 * WORDS_PER_ROW * 4
        base = eng.snapshot()
        assert fld.set_bit(0, col)
        arr = eng._gather_leaf("i", leaf_of[pk.name], shards)
        assert eng.snapshot()["full_refresh_bytes"] == full
        assert 0 < eng.snapshot()["delta_bytes"] <= 1024
        seen[pk.name] = (counters(eng, base), words(arr, 4))
        np.testing.assert_array_equal(
            seen[pk.name][1], full_leaf(h, leaf_of[pk.name], shards))
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["torch"][0]["leaf_delta_hits"] == 1
    np.testing.assert_array_equal(seen["torch"][1], seen["jax"][1])


def test_single_set_refreshes_stack_via_delta(holders, engines):
    """count_batch's stack after a one-bit Set: one scattered update, the
    same counters as the reference, the counts of a regather."""
    shards = list(range(4))
    pairs = [(0, 1), (1, 2), (2, 3)]
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h)
        eng = engines(pk, h)
        calls = [pk.parse(f"Intersect(Row(f={a}), Row(f={b}))").calls[0]
                 for a, b in pairs]
        eng.count_batch("i", calls, shards)
        full = eng.snapshot()["full_refresh_bytes"]
        base = eng.snapshot()
        assert fld.set_bit(2, 2 * SHARD_WIDTH + 99)
        res = [int(x) for x in eng.count_batch("i", calls, shards)]
        assert eng.snapshot()["full_refresh_bytes"] == full
        want = [int(np.bitwise_count(np.bitwise_and(
            full_leaf(h, pk.Leaf("f", "standard", a), shards),
            full_leaf(h, pk.Leaf("f", "standard", b), shards))).sum())
            for a, b in pairs]
        assert res == want
        got[pk.name] = (res, counters(eng, base))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["stack_delta_hits"] == 1


def test_executor_count_after_set_is_a_delta_refresh(holders):
    """Executor.execute: a one-bit Set on a resident leaf, then the
    recount: the reference's answer, a delta refresh (the port's Count
    reads a stack), no full refresh."""
    answers = {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h)
        kw = {"workers": 0} if pk is JAX else {}
        ex = pk.pkg.Executor(h, engine_config=pk.EngineConfig(gather_workers=1), **kw)
        try:
            q = "Count(Intersect(Row(f=0), Row(f=1)))"
            before = ex.execute("i", q)[0]
            snap = ex.engine.snapshot()
            ex.execute("i", f"Set({3 * SHARD_WIDTH + 777}, f=0)")
            after = ex.execute("i", q)[0]
            now = ex.engine.snapshot()
            assert now["full_refresh_bytes"] == snap["full_refresh_bytes"]
            assert (now["leaf_delta_hits"] + now["stack_delta_hits"]
                    > snap["leaf_delta_hits"] + snap["stack_delta_hits"])
            answers[pk.name] = (before, after)
            if pk is TORCH:
                assert now["stack_delta_hits"] == snap["stack_delta_hits"] + 1
                assert now["memo_misses"] == snap["memo_misses"] + 1
        finally:
            ex.close()
    assert answers["torch"] == answers["jax"]


@pytest.mark.parametrize("cfg, want_delta", [
    ({"delta_max_fraction": 0.0}, False),      # disabled by config
    ({"delta_max_fraction": 1e-9}, False),     # past the budget: regather
    ({}, True),
])
def test_delta_budget_like_jax(holders, engines, cfg, want_delta):
    shards = list(range(4))
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h)
        eng = engines(pk, h, config=pk.EngineConfig(**cfg))
        call = pk.parse("Row(f=0)").calls[0]
        c0 = eng.count("i", call, shards)
        added = sum(fld.set_bit(0, c) for c in (7, 71, 717))
        base = eng.snapshot()
        c1 = eng.count("i", call, shards)
        assert c1 == c0 + added
        d = counters(eng, base)
        got[pk.name] = (c0, c1, d["memo_hits"], d["memo_misses"])
        refreshed = d["leaf_delta_hits"] + d["stack_delta_hits"]
        assert bool(refreshed) == want_delta, (pk.name, d)
    assert got["torch"] == got["jax"]


def test_random_writes_delta_equals_full_and_jax(holders, engines):
    """Property: across randomized write sequences — point sets/clears,
    bursts, bulk imports past tiny journals — the delta-maintained leaf
    and stack tensors stay byte-identical to a storage regather and to
    the reference's tensors, with the same delta counters."""
    shards = (0, 1, 2)
    stacks, planes, deltas = {}, {}, {}
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h, n_shards=3, n_rows=4)
        for s in shards:
            h.fragment("i", "f", "standard", s).delta_journal_ops = 64
        eng = engines(pk, h)
        leaves = [pk.Leaf("f", "standard", r) for r in range(4)]
        rng = np.random.default_rng(42)
        base = eng.snapshot()
        stacks[pk.name], planes[pk.name] = [], []
        for round_ in range(8):
            kind = rng.integers(0, 4)
            row = int(rng.integers(0, 4))
            col = int(rng.integers(0, 3 * SHARD_WIDTH))
            if kind == 0:
                fld.set_bit(row, col)
            elif kind == 1:
                fld.clear_bit(row, col)
            elif kind == 2:
                b = col - col % 64
                for k in range(int(rng.integers(1, 8))):
                    fld.set_bit(row, min(b + k, 3 * SHARD_WIDTH - 1))
            else:
                cols = rng.integers(0, 3 * SHARD_WIDTH, 200).astype(np.uint64)
                fld.import_bits(np.full(200, row, np.uint64), cols)
            kw = {"pad_pow2": True} if pk is JAX else {}
            stack = words(eng._stacked_leaf_tensor("i", leaves, shards, **kw), 4, 3)
            plane = words(eng._gather_leaf("i", leaves[0], shards), 3)
            for u, leaf in enumerate(leaves):
                np.testing.assert_array_equal(
                    stack[u], full_leaf(h, leaf, shards),
                    err_msg=f"{pk.name} round {round_} leaf {u} stack diverged")
            np.testing.assert_array_equal(plane, full_leaf(h, leaves[0], shards))
            stacks[pk.name].append(stack)
            planes[pk.name].append(plane)
        deltas[pk.name] = counters(eng, base)
    for a, b in zip(stacks["torch"] + planes["torch"], stacks["jax"] + planes["jax"]):
        np.testing.assert_array_equal(a, b)
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"]["stack_delta_hits"] > 0


def test_recreated_index_never_serves_stale_delta(holders, engines):
    """A deleted+recreated index resets generation counters while the
    engine's name-keyed caches survive; the incarnation half of the
    fingerprint forces a full regather even when the fresh counter climbs
    back past the cached generation."""
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h, n_shards=2, n_rows=2)
        eng = engines(pk, h)
        call = pk.parse("Row(f=0)").calls[0]
        old = eng.count("i", call, [0, 1])
        gen0 = h.fragment("i", "f", "standard", 0).generation
        h.delete_index("i")
        fld = h.create_index("i").create_field("f")
        for k in range(gen0 + 3):
            fld.set_bit(0, k)
        base = eng.snapshot()
        new = eng.count("i", call, [0, 1])
        assert new == gen0 + 3 != old
        d = counters(eng, base)
        assert d["leaf_delta_hits"] == d["stack_delta_hits"] == 0
        got[pk.name] = (old, new, d)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("what", ["index", "field"])
def test_recreated_index_or_field_never_serves_stale_memo(holders, engines, what):
    """The memo's epoch fast path: a recreated index whose fresh epoch
    climbs back to the stored value, or a recreated field (which shares
    the index's epoch), must not alias the old count."""
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h, n_shards=1, n_rows=1)
        eng = engines(pk, h)
        call = pk.parse("Row(f=0)").calls[0]
        old = eng.count("i", call, [0])
        assert old > 0
        if what == "index":
            epoch0 = h.index("i").write_epoch.value
            h.delete_index("i")
            fld = h.create_index("i").create_field("f")
            for k in range(epoch0):
                fld.set_bit(0, k)
            assert h.index("i").write_epoch.value == epoch0
            want = epoch0
        else:
            h.index("i").delete_field("f")
            h.index("i").create_field("f")
            want = 0
        got[pk.name] = (old, eng.count("i", call, [0]))
        assert got[pk.name][1] == want
    assert got["torch"] == got["jax"]


# ----------------------------------------------- byte-cache accounting


@pytest.mark.parametrize("pk", BOTH, ids=lambda p: p.name)
def test_byte_cache_accounting(holders, engines, pk):
    """Insert / replace / evict keep the used-bytes counter exact, and an
    oversized entry is admitted alone; both engines alike."""
    eng = engines(pk, holders[pk.name])
    cache, used, budget = {}, 0, 100
    with eng._lock:
        used = eng._byte_cache_put(cache, "a", ((), np.zeros(10, np.uint8)),
                                   budget, used, "leaf_evictions")
        used = eng._byte_cache_put(cache, "b", ((), np.zeros(40, np.uint8)),
                                   budget, used, "leaf_evictions")
        assert used == 50
        used = eng._byte_cache_put(cache, "a", ((), np.zeros(40, np.uint8)),
                                   budget, used, "leaf_evictions")
        assert used == 80 and eng.counters["leaf_evictions"] == 0
        used = eng._byte_cache_put(cache, "c", ((), np.zeros(60, np.uint8)),
                                   budget, used, "leaf_evictions")
    assert used == sum(e[1].nbytes for e in cache.values()) <= budget
    assert "c" in cache and eng.counters["leaf_evictions"] > 0
    with eng._lock:
        used = eng._byte_cache_put({}, "k", ((), np.zeros(500, np.uint8)), 100,
                                   0, "leaf_evictions")
    assert used == 500


def test_live_refresh_accounting_through_delta(holders, engines):
    """Deltas and full refreshes across writes keep the leaf/stack byte
    counters equal to the resident sum."""
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h)
        eng = engines(pk, h)
        shards = tuple(range(4))
        leaves = [pk.Leaf("f", "standard", r) for r in range(2)]
        base = eng.snapshot()
        for k in range(6):
            eng._stacked_leaf_tensor("i", leaves, shards)
            eng._gather_leaf("i", leaves[0], shards)
            fld.set_bit(k % 2, k * 64)
        with eng._lock:
            assert eng._leaf_bytes == sum(
                e[1].nbytes for e in eng._leaf_cache.values())
            assert eng._stack_bytes == sum(
                e[1].nbytes for e in eng._stack_cache.values())
        got[pk.name] = counters(eng, base)
    assert got["torch"] == got["jax"]


# ------------------------------------------------- memo epoch fast path


def test_memo_probe_short_circuits_on_quiet_epoch(holders, engines, monkeypatch):
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h)
        idx = h.index("i")
        idx.create_field_if_not_exists("g")
        idx.field("g").set_bit(1, 2)
        eng = engines(pk, h)
        shards = list(range(4))
        call = pk.parse("Intersect(Row(f=0), Row(f=1))").calls[0]
        want = eng.count("i", call, shards)
        walks = {"n": 0}
        real_fp = eng._fingerprint

        def counting_fp(*a, real_fp=real_fp, walks=walks, **kw):
            walks["n"] += 1
            return real_fp(*a, **kw)

        monkeypatch.setattr(eng, "_fingerprint", counting_fp)
        # Quiet index: the repeat probe answers WITHOUT the walk.
        assert eng.count("i", call, shards) == want
        assert walks["n"] == 0
        # A write elsewhere moves the epoch: one walk re-validates, and
        # the refreshed epoch makes the next probe O(1) again.
        idx.field("g").set_bit(1, 77)
        assert eng.count("i", call, shards) == want
        assert walks["n"] > 0
        walks["n"] = 0
        assert eng.count("i", call, shards) == want
        assert walks["n"] == 0
        # A write to a member fragment invalidates for real.
        idx.field("f").set_bit(0, 13)
        frag0 = h.fragment("i", "f", "standard", 0)
        got_after = eng.count("i", call, shards)
        assert got_after == want + (1 if frag0.bit(1, 13) else 0)
        snap = eng.snapshot()
        got[pk.name] = (want, got_after, snap["memo_hits"], snap["memo_misses"])
    assert got["torch"] == got["jax"]


def test_memo_and_aux_memo_counters_match_jax(holders):
    """A query stream through both executors — repeats, a batch, TopN,
    Sum, writes between — gives equal answers and equal memo counters;
    repeats launch nothing in the port."""
    from pilosa_tpu.core.field import FieldOptions as JFieldOptions
    from pilosa_tpu_torch.core.field import FieldOptions as TFieldOptions
    from pilosa_tpu_torch.ops import kernels

    answers, snaps = {}, {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h)
        opts = (JFieldOptions if pk is JAX else TFieldOptions)(type="int", min=0, max=1000)
        v = h.index("i").create_field("v", opts)
        for col in range(0, 4 * SHARD_WIDTH, SHARD_WIDTH // 7):
            v.set_value(col, col % 997)
        kw = {"workers": 0} if pk is JAX else {}
        ex = pk.pkg.Executor(h, engine_config=pk.EngineConfig(gather_workers=1), **kw)
        try:
            out = []
            qs = ["Count(Intersect(Row(f=0), Row(f=1)))", "Count(Row(f=2))",
                  "TopN(f, Row(f=3), n=3)", "Sum(Row(f=1), field=v)",
                  "Max(field=v)", "Min(Row(f=0), field=v)"]
            for rnd in range(3):
                kernels.reset_counters()
                for q in qs:
                    r = ex.execute("i", q)[0]
                    out.append(repr([(p.id, p.count) for p in r])
                               if isinstance(r, list) else repr(getattr(r, "val", r))
                               + repr(getattr(r, "count", "")))
                if pk is TORCH and rnd == 1:  # the repeat launched nothing
                    assert not any(kernels.PLAIN_CALLS.values()), kernels.PLAIN_CALLS
                if rnd == 1:
                    ex.execute("i", f"Set({SHARD_WIDTH + 5}, f=1)")
                    ex.execute("i", f"SetValue(col={2 * SHARD_WIDTH + 1}, v=999)")
            answers[pk.name] = out
            snap = ex.engine.snapshot()
            snaps[pk.name] = {k: snap[k] for k in ("memo_hits", "memo_misses")}
        finally:
            ex.close()
    assert answers["torch"] == answers["jax"]
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"]["memo_hits"] > 0


def test_stack_generation_and_budgets(holders, engines):
    for pk in BOTH:
        h = holders[pk.name]
        fld = plant(h, n_shards=1, n_rows=1)
        eng = engines(pk, h, config=pk.EngineConfig(memo_entries=33, aux_memo_entries=44))
        g0 = eng.stack_generation("i")
        fld.set_bit(0, 3)
        assert eng.stack_generation("i") > g0
        assert eng.stack_generation("nope") == -1
        assert eng.budgets["memo_entries"] == 33
        assert eng.budgets["aux_memo_entries"] == 44


# ------------------------------------------------- single-flight build gate


@pytest.mark.parametrize("what", ["leaf", "stack"])
def test_concurrent_misses_gather_once_like_jax(holders, engines, what):
    """Eight threads miss on one key at once: the build gate lets one
    gather and the others wait for its entry, in both engines."""
    import threading

    shards = (0, 1, 2, 3)
    got = {}
    for pk in BOTH:
        h = holders[pk.name]
        plant(h)
        eng = engines(pk, h)
        leaves = [pk.Leaf("f", "standard", r) for r in range(3)]
        start = threading.Barrier(8)
        out, errors = [], []

        def run():
            try:
                start.wait()
                if what == "leaf":
                    arr = eng._gather_leaf("i", leaves[0], shards)
                else:
                    arr = eng._stacked_leaf_tensor("i", leaves, shards)
                out.append(words(arr, *((4,) if what == "leaf" else (3, 4))))
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(out) == 8 and all(np.array_equal(o, out[0]) for o in out)
        snap = eng.snapshot()
        got[pk.name] = (snap["leaf_misses"], snap[f"{what}_misses"])
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 1
