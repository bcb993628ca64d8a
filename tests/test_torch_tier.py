"""Tiered plane storage (pilosa_tpu_torch/tier/) and the engine's tier
hooks: the port against the JAX package on the CPU.

Mirrors the engine-hook and promotion tests of tests/test_tier.py: the
compressed plane codec, demote -> re-promote round trips bit-exact against
a cold gather and against the reference's planes, the journal fold on
promotion, per-shard walks past an overflowed journal, recreated indexes,
the inclusive host tier, a query stream racing demotions and writes, the
disk tier (round trip, corrupt and missing spills, its budget), the
prefetcher, the byte-cache policies and the budget resolution. Every
paired case runs the same data and the same sweep through both packages
and requires equal answers and equal engine and tier counter deltas.

Both engines run with the result memo off (PILOSA_MEMO_ENTRIES=0, as
tests/test_device_faults.py does) and cold_host_count=0, so every sweep
really reaches the leaf cache and the tier. The reference's sweeps use
its count_async, which skips the memo: the `*_count_async` cases run the
same sweeps through both packages' count_async. The reference engine's
budgets are in bytes of its padded planes (its CPU mesh pads the shard
axis), so each engine gets the same number of planes.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest

from pilosa_tpu.constants import SHARD_WIDTH, WORDS_PER_ROW
from pilosa_tpu.errors import CorruptFragmentError as JCorrupt
from pilosa_tpu.parallel.mesh import pad_shards
from pilosa_tpu.storage import bitmap as jbitmap
from pilosa_tpu_torch.errors import CorruptFragmentError as TCorrupt
from pilosa_tpu_torch.storage import bitmap as tbitmap
from pilosa_tpu_torch.tier import TierConfig
from pilosa_tpu_torch.tier.manager import TierManager, _PlaneEntry
from tests.test_torch_delta import BOTH, JAX, SHARED, TORCH, counters, engines, words  # noqa: F401

N_WORDS64 = WORDS_PER_ROW // 2  # decode_plane_words speaks 64-bit words
TIER_COUNTERS = ("demotions_host", "demotions_disk", "demotions_skipped",
                 "promotions_host", "promotions_disk", "delta_folds",
                 "shard_walks", "corrupt_spills", "disk_evictions")


@pytest.fixture
def holders(tmp_path):
    hs = {}
    for pk in BOTH:
        h = pk.Holder(str(tmp_path / pk.name / "data"))
        h.open()
        hs[pk.name] = h
    yield hs
    for h in hs.values():
        h.close()


@pytest.fixture
def memo_off(monkeypatch):
    monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")


def plant(holder, n_shards=2, n_rows=8, per_row=300, seed=7, index="i"):
    idx = holder.create_index_if_not_exists(index)
    fld = idx.create_field_if_not_exists("f")
    rng = np.random.default_rng(seed)
    expected = {}
    for row in range(n_rows):
        cols = []
        for s in range(n_shards):
            local = rng.choice(SHARD_WIDTH, size=per_row, replace=False)
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
        fld.import_bits([row] * len(cols), cols)
        expected[row] = set(cols)
    return fld, expected


def plane_bytes(pk, n_shards: int) -> int:
    s = pad_shards(n_shards, jax.device_count()) if pk is JAX else n_shards
    return s * WORDS_PER_ROW * 4


def tiny_engine(make, pk, holder, n_keep, n_shards, tier=None, **tier_kw):
    """An engine whose leaf (and stack) cache holds `n_keep` planes, so a
    sweep over more planes evicts — and demotes, with a tier enabled."""
    if tier is None:
        tier_kw.setdefault("host_bytes", 1 << 28)
        tier_kw.setdefault("prefetch_interval", 0)
        tier = pk.TierConfig(**tier_kw)
    budget = n_keep * plane_bytes(pk, n_shards)
    return make(pk, holder, config=pk.EngineConfig(
        leaf_cache_bytes=budget, stack_cache_bytes=budget, cold_host_count=0),
        tier_config=tier)


def sweep(pk, eng, rows, shards, index="i", settle=True):
    """Counts of `rows`. With `settle`, each count's demotions are
    captured before the next count runs: a re-touch that races the
    asynchronous demote worker misses the tier and regathers (never
    wrong), so otherwise a sweep's tier counters would depend on each
    package's worker keeping pace."""
    out = []
    for r in rows:
        out.append(int(eng.count(index, pk.parse(f"Row(f={r})").calls[0],
                                 shards)))
        assert not settle or eng.tier.drain()
    return out


def sweep_async(pk, eng, rows, shards, index="i", settle=True):
    """tests/test_tier.py's sweep: count_async's device scalar, read back
    through numpy; `settle` as in sweep()."""
    out = []
    for r in rows:
        out.append(int(np.asarray(eng.count_async(
            index, pk.parse(f"Row(f={r})").calls[0], shards))))
        assert not settle or eng.tier.drain()
    return out


def tier_counters(eng):
    # The demote worker is asynchronous: settle the last sweep's
    # demotions first, or the counts depend on the worker's timing.
    assert eng.tier.drain()
    snap = eng.tier.snapshot()
    return {k: snap[k] for k in TIER_COUNTERS}


def same_run(holders, make, body):
    """Run body(pk, holder, make) on both packages; returns {name: out}."""
    return {pk.name: body(pk, holders[pk.name], make) for pk in BOTH}


# ------------------------------------------------------- plane-section codec


def _codec(pk, holder, cols):
    idx = holder.create_index_if_not_exists("codec")
    fld = idx.create_field_if_not_exists("f")
    if len(cols):
        fld.import_bits([0] * len(cols), sorted(int(c) for c in cols))
    bm = jbitmap if pk is JAX else tbitmap
    frag = holder.fragment("codec", "f", "standard", 0)
    if frag is None:
        data = bm.Bitmap().to_bytes()
        assert not bm.decode_plane_words(data, N_WORDS64).any()
        return data
    frag.storage.optimize()
    data, fp = frag.row_compressed(0)
    got = bm.decode_plane_words(data, N_WORDS64).view(np.uint32)
    np.testing.assert_array_equal(got, frag.plane_np(0))
    assert fp == (frag.incarnation, frag.generation)
    return data


CODEC = {
    "array": lambda: np.random.default_rng(3).choice(SHARD_WIDTH, 700, replace=False),
    "run": lambda: (list(range(1000, 9000)) + list(range(70000, 70100))
                    + [0, 63, 64, SHARD_WIDTH - 1]),
    "bitmap": lambda: np.random.default_rng(4).choice(1 << 17, 40000, replace=False),
    "word_boundaries": lambda: list(range(64, 256)) + [63, 256, 319],
    "empty": lambda: [],
}


@pytest.mark.parametrize("name", sorted(CODEC))
def test_row_compressed_codec_matches_jax(holders, name):
    """Fragment.row_compressed + decode_plane_words round-trip the plane,
    and the port's compressed bytes equal the reference's."""
    out = {pk.name: _codec(pk, holders[pk.name], CODEC[name]()) for pk in BOTH}
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("mutate", [
    lambda d: d[:4],                # truncated header
    lambda d: b"XX" + d[2:],        # bad magic
    lambda d: d[: len(d) // 2],     # truncated payload
    lambda d: d + b"opslog-junk",   # trailing bytes are ignored
], ids=["truncated_header", "bad_magic", "truncated_payload", "trailing_bytes"])
def test_corrupt_plane_bytes_like_jax(holders, mutate):
    out = {}
    for pk in BOTH:
        plant(holders[pk.name], n_shards=1, n_rows=1)
        data, _ = holders[pk.name].fragment("i", "f", "standard", 0).row_compressed(0)
        bm, err = (jbitmap, JCorrupt) if pk is JAX else (tbitmap, TCorrupt)
        try:
            out[pk.name] = bm.decode_plane_words(mutate(data), N_WORDS64).tolist()
        except err:
            out[pk.name] = "corrupt"
    assert out["torch"] == out["jax"]


def test_partial_and_out_of_plane_containers_like_jax():
    """Exotic planes smaller than one container decode their in-plane
    bits, and bits beyond the plane raise a typed corruption."""
    for bm, err in ((jbitmap, JCorrupt), (tbitmap, TCorrupt)):
        got = bm.decode_plane_words(
            bm.Bitmap(np.array([0, 5, 64, 511], dtype=np.uint64)).to_bytes(), 8)
        want = np.zeros(8, dtype=np.uint64)
        want[0], want[1], want[7] = (1 << 0) | (1 << 5), 1, 1 << 63
        np.testing.assert_array_equal(got, want)
        with pytest.raises(err):
            bm.decode_plane_words(bm.Bitmap(np.array([512], np.uint64)).to_bytes(), 8)
        with pytest.raises(err):
            bm.decode_plane_words(bm.Bitmap(np.array([5], np.uint64)).to_bytes(), 0)


# --------------------------------------------------- demote/promote (host)


def test_repromotion_is_bit_exact_vs_cold_gather(holders, engines, memo_off):
    n_rows, n_shards = 8, 2
    shards = tuple(range(n_shards))

    def body(pk, h, make):
        _, expected = plant(h, n_shards, n_rows)
        eng = tiny_engine(make, pk, h, 3, n_shards)
        got1 = sweep(pk, eng, range(n_rows), shards)
        eng.tier.drain()
        base = eng.snapshot()
        got2 = sweep(pk, eng, range(n_rows), shards)
        assert got1 == got2 == [len(expected[r]) for r in range(n_rows)]
        assert eng.snapshot()["leaf_misses"] == base["leaf_misses"], \
            "a warm tier must absorb every device-cache miss"
        d = counters(eng, base)
        assert d["leaf_tier_hits"] > 0
        cold = make(pk, h, tier_config=pk.TierConfig(host_bytes=0, disk_bytes=0))
        planes = []
        for r in range(n_rows):
            leaf = pk.Leaf("f", "standard", r)
            a = words(eng._gather_leaf("i", leaf, shards), n_shards)
            np.testing.assert_array_equal(
                a, words(cold._gather_leaf("i", leaf, shards), n_shards))
            planes.append(a)
        return got2, d, tier_counters(eng), planes

    out = same_run(holders, engines, body)
    (tg, td, tt, tp), (jg, jd, jt, jp) = out["torch"], out["jax"]
    assert (tg, td, tt) == (jg, jd, jt)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)


def test_delta_fold_on_promotion_matches_regather(holders, engines, memo_off):
    n_rows, n_shards = 8, 2
    shards = tuple(range(n_shards))

    def body(pk, h, make):
        fld, expected = plant(h, n_shards, n_rows)
        eng = tiny_engine(make, pk, h, 3, n_shards)
        sweep(pk, eng, range(n_rows), shards)
        eng.tier.drain()
        for r in range(n_rows):  # writes to every plane, demoted ones too
            col = (r * 977) % SHARD_WIDTH
            if fld.set_bit(r, col):
                expected[r].add(col)
            rm = min(expected[r])
            fld.clear_bit(r, rm)
            expected[r].discard(rm)
        base = eng.snapshot()
        got = sweep(pk, eng, range(n_rows), shards)
        assert got == [len(expected[r]) for r in range(n_rows)]
        assert eng.snapshot()["leaf_misses"] == base["leaf_misses"]
        assert eng.tier.counters["delta_folds"] > 0
        return got, counters(eng, base), tier_counters(eng)

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


def test_journal_overflow_walks_that_shard_only(tmp_path, engines, memo_off):
    shards = (0, 1)

    def body(pk):
        h = pk.Holder(str(tmp_path / pk.name / "ovf"), delta_journal_ops=8)
        h.open()
        try:
            fld, expected = plant(h, 2, 4)
            eng = tiny_engine(engines, pk, h, 1, 2)
            sweep(pk, eng, range(4), shards)
            eng.tier.drain()
            for k in range(16):  # past the journal bound, row 0 shard 0
                if fld.set_bit(0, 64 * k):
                    expected[0].add(64 * k)
            got = sweep(pk, eng, range(4), shards)
            assert got == [len(expected[r]) for r in range(4)]
            assert eng.tier.counters["shard_walks"] >= 1
            return got, tier_counters(eng)
        finally:
            h.close()

    assert body(TORCH) == body(JAX)


def test_recreated_index_never_serves_stale_blob(holders, engines, memo_off):
    shards = (0, 1)

    def body(pk, h, make):
        plant(h, 2, 4)
        eng = tiny_engine(make, pk, h, 1, 2)
        sweep(pk, eng, range(4), shards)
        eng.tier.drain()
        h.delete_index("i")
        f2 = h.create_index("i").create_field("f")
        f2.set_bit(0, 5)
        f2.set_bit(0, SHARD_WIDTH + 9)
        got = sweep(pk, eng, [0], shards)
        assert got == [2]
        return got

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


def test_sweep_count_async_demotes_and_repromotes_like_jax(holders, engines):
    """tests/test_tier.py's sweep helper (count_async, no memo, memos left
    on): two sweeps over more planes than the leaf cache holds demote and
    re-promote, with exact counts and the reference's tier counters."""
    n_rows, shards = 6, (0, 1)

    def body(pk, h, make):
        _, expected = plant(h, 2, n_rows)
        eng = tiny_engine(make, pk, h, 2, 2)
        got = [sweep_async(pk, eng, range(n_rows), shards) for _ in range(2)]
        assert got[0] == got[1] == [len(expected[r]) for r in range(n_rows)]
        assert eng.snapshot()["memo_hits"] == 0
        return got, tier_counters(eng)

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


def test_recreated_index_never_serves_stale_blob_count_async(holders, engines):
    """tests/test_tier.py's recreated-index case as the reference runs it,
    through count_async."""
    shards = (0, 1)

    def body(pk, h, make):
        plant(h, 2, 4)
        eng = tiny_engine(make, pk, h, 1, 2)
        sweep_async(pk, eng, range(4), shards)
        eng.tier.drain()
        h.delete_index("i")
        f2 = h.create_index("i").create_field("f")
        f2.set_bit(0, 5)
        f2.set_bit(0, SHARD_WIDTH + 9)
        got = sweep_async(pk, eng, [0], shards)
        assert got == [2]
        return got

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


def test_inclusive_host_tier_skips_unchanged_recapture(holders, engines, memo_off):
    """Evict -> promote -> evict again with no writes in between does not
    re-serialize the plane."""
    shards = (0, 1)

    def body(pk, h, make):
        plant(h, 2, 8)
        eng = tiny_engine(make, pk, h, 2, 2)
        for _ in range(2):
            sweep(pk, eng, range(8), shards)
            eng.tier.drain()
        assert eng.tier.counters["demotions_skipped"] > 0
        return tier_counters(eng)

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


# ------------------------------------------------------------- engine hooks


def test_engine_hooks_promote_headroom_resident_demote(holders, engines, memo_off):
    """The hooks the manager calls: promotion installs the plane through
    the gather path (a tier hit), headroom is the leaf budget left,
    residency is leaf-cache membership, demotion failures are counted."""
    shards = (0, 1)

    def body(pk, h, make):
        plant(h, 2, 4)
        eng = tiny_engine(make, pk, h, 2, 2)
        key = ("i", pk.Leaf("f", "standard", 1), shards)
        budget = eng.budgets["leaf_cache_bytes"]
        assert eng._hbm_headroom() == budget
        assert not eng._tier_resident(key)
        eng.tier.demote(key)
        assert eng.tier.drain()
        assert eng._tier_promote_key(key) is True
        assert eng._tier_resident(key)
        assert eng._hbm_headroom() == budget - plane_bytes(pk, 2)
        assert eng.snapshot()["leaf_tier_hits"] == 1
        # A key whose gather raises: the hook reports False and counts.
        bad = ("nope", pk.Leaf("f", "standard", 1), shards)
        ok = eng._tier_promote_key(bad)
        eng.tier.demote = lambda k: (_ for _ in ()).throw(RuntimeError("boom"))
        eng._demote_keys([key])
        snap = eng.snapshot()
        return ok, snap["tier_promote_errors"], snap["tier_demote_errors"]

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 1


# ------------------------------------------------------------- concurrency


def test_no_torn_plane_during_demotion_churn(holders, engines, memo_off):
    """Queries racing the demote worker, forced demote churn and
    concurrent writes see every plane at SOME valid state: counts on the
    unwritten rows are exact, never torn (the port alone: its tier
    manager is a copy; the race is in its engine)."""
    _torn_plane_churn(holders, engines, sweep)


def test_no_torn_plane_during_demotion_churn_count_async(holders, engines):
    """The same race read through count_async, as tests/test_tier.py's
    race reads it."""
    _torn_plane_churn(holders, engines, sweep_async)


def _torn_plane_churn(holders, engines, sweep_fn):
    h = holders["torch"]
    n_rows, n_shards = 10, 2
    fld, expected = plant(h, n_shards, n_rows)
    shards = tuple(range(n_shards))
    eng = tiny_engine(engines, TORCH, h, 2, n_shards)
    stop = threading.Event()
    errors = []

    def demote_churn():
        while not stop.is_set():
            for r in range(n_rows):
                eng.tier.demote(("i", TORCH.Leaf("f", "standard", r), shards))
            time.sleep(0.001)

    def write_churn():
        k = 0
        while not stop.is_set():
            fld.set_bit(2 + (k % (n_rows - 2)), (k * 131) % SHARD_WIDTH)
            k += 1
            time.sleep(0.0005)

    threads = [threading.Thread(target=demote_churn),
               threading.Thread(target=write_churn)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not errors:
            got_rows = sweep_fn(TORCH, eng, range(n_rows), shards, settle=False)
            for r, got in zip(range(n_rows), got_rows):
                if (r < 2 and got != len(expected[r])) or got < len(expected[r]):
                    errors.append((r, got, len(expected[r])))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


# ---------------------------------------------------------------- disk tier


def _spill_engine(make, pk, h, tmp_path, host_bytes=4096, disk_bytes=1 << 22):
    return tiny_engine(make, pk, h, 1, 2, tier=pk.TierConfig(
        host_bytes=host_bytes, disk_bytes=disk_bytes,
        disk_path=str(tmp_path / pk.name / "spill"), prefetch_interval=0))


@pytest.mark.parametrize("damage", ["none", "corrupt", "missing"])
def test_disk_tier_round_trip_like_jax(holders, engines, memo_off, tmp_path, damage):
    """Demotions cascade to disk; re-promotion is exact; a corrupted or
    deleted spill file degrades to a regather, never to a query error."""
    n_rows, shards = 6, (0, 1)

    def body(pk, h, make):
        _, expected = plant(h, 2, n_rows)
        eng = _spill_engine(make, pk, h, tmp_path)
        got1 = sweep(pk, eng, range(n_rows), shards)
        eng.tier.drain()
        spill = tmp_path / pk.name / "spill"
        files = sorted(os.listdir(spill))
        assert files and eng.tier.snapshot()["demotions_disk"] > 0
        for name in files:
            p = spill / name
            if damage == "corrupt":
                raw = bytearray(p.read_bytes())
                raw[len(raw) // 2] ^= 0xFF
                p.write_bytes(bytes(raw))
            elif damage == "missing":
                os.remove(p)
        got2 = sweep(pk, eng, range(n_rows), shards)
        assert got1 == got2 == [len(expected[r]) for r in range(n_rows)]
        snap = eng.tier.snapshot()
        if damage == "none":
            assert snap["promotions_disk"] > 0
        if damage == "corrupt":
            assert snap["corrupt_spills"] == len(files)
        # The re-sweep's own demotions race its promotions (the demote
        # worker is asynchronous), so which tier each promotion reads, and
        # how many demotions the worker's queue merges, vary from run to
        # run in both packages: only the corrupt-spill count is fixed.
        return got2, snap["corrupt_spills"], len(files)

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


def test_disk_budget_evicts_oldest_spill(holders, engines, memo_off, tmp_path):
    def body(pk, h, make):
        plant(h, 2, 8)
        eng = _spill_engine(make, pk, h, tmp_path, disk_bytes=6000)
        sweep(pk, eng, range(8), (0, 1))
        eng.tier.drain()
        snap = eng.tier.snapshot()
        assert snap["disk_bytes"] <= 6000 and snap["disk_evictions"] > 0
        return tier_counters(eng)

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


# ----------------------------------------------------- predictive prefetch


def test_hot_index_promoted_before_query(holders, engines, memo_off):
    h = holders["torch"]
    n_rows, shards = 6, (0, 1)
    _, expected = plant(h, 2, n_rows)
    traffic = {"n": 1}
    eng = engines(TORCH, h, config=TORCH.EngineConfig(
        leaf_cache_bytes=4 * n_rows * plane_bytes(TORCH, 2), cold_host_count=0),
        tier_config=TierConfig(host_bytes=1 << 28, prefetch_interval=0.01,
                               prefetch_batch=8),
        traffic_fn=lambda: {"i": traffic["n"]})
    for r in range(n_rows):
        eng.tier.demote(("i", TORCH.Leaf("f", "standard", r), shards))
    eng.tier.drain()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        traffic["n"] += 1
        if eng.tier.snapshot()["prefetch_promotions"] >= n_rows:
            break
        time.sleep(0.02)
    assert eng.tier.snapshot()["prefetch_promotions"] >= n_rows
    base = eng.snapshot()
    assert sweep(TORCH, eng, range(n_rows), shards) == [
        len(expected[r]) for r in range(n_rows)]
    # Every plane was already resident: no tier or container work.
    assert eng.snapshot()["leaf_misses"] == base["leaf_misses"]
    assert eng.snapshot()["leaf_tier_hits"] == base["leaf_tier_hits"]
    assert eng.tier.snapshot()["prefetch_hits"] >= 1


def test_cold_index_not_promoted(holders, engines):
    h = holders["torch"]
    plant(h, 2, 4)
    eng = engines(TORCH, h, config=TORCH.EngineConfig(leaf_cache_bytes=1 << 26),
                  tier_config=TierConfig(host_bytes=1 << 28, prefetch_interval=0.01),
                  traffic_fn=lambda: {"other-index": 1})
    for r in range(4):
        eng.tier.demote(("i", TORCH.Leaf("f", "standard", r), (0, 1)))
    eng.tier.drain()
    time.sleep(0.2)
    assert eng.tier.snapshot()["prefetch_promotions"] == 0


def test_prefetch_never_evicts():
    m = TierManager(holder=None, config=TierConfig(
        host_bytes=1 << 20, prefetch_interval=0))
    promoted = []
    m.bind(promote_fn=lambda k: promoted.append(k) or True,
           headroom_fn=lambda: 0,  # no free device memory
           resident_fn=lambda k: False)
    with m._lock:
        m._host[("i", TORCH.Leaf("f", "standard", 0), (0,))] = _PlaneEntry(
            [(0, 0)], [b"x"])
    m.config.prefetch_interval = 0.01
    t = threading.Thread(target=m._prefetch_loop, daemon=True)
    t.start()
    time.sleep(0.1)
    m.close()
    t.join(timeout=5)
    assert not t.is_alive()
    assert promoted == []


# ------------------------------------------- engine byte-cache policies


@pytest.mark.parametrize("pk", BOTH, ids=lambda p: p.name)
def test_oversized_entry_admitted_alone_and_counted(holders, engines, pk):
    eng = engines(pk, holders[pk.name],
                  tier_config=pk.TierConfig(host_bytes=0, disk_bytes=0))
    cache, used, budget, evicted = {}, 0, 100, []
    with eng._lock:
        for key, n in (("a", 40), ("b", 40), ("huge", 500)):
            used = eng._byte_cache_put(cache, key, ((), np.zeros(n, np.uint8)),
                                       budget, used, "leaf_evictions", evicted)
    assert list(cache) == ["huge"] and used == 500
    assert eng.counters["oversized_admits"] == 1
    assert evicted == ["a", "b"]
    with eng._lock:
        used = eng._byte_cache_put(cache, "c", ((), np.zeros(60, np.uint8)),
                                   budget, used, "leaf_evictions", evicted)
    assert "huge" not in cache and used == 60 and "huge" in evicted


def test_memo_and_aux_eviction_counters(holders, engines):
    def body(pk, h, make):
        plant(h, 1, 4)
        eng = make(pk, h, config=pk.EngineConfig(memo_entries=2, aux_memo_entries=2),
                   tier_config=pk.TierConfig(host_bytes=0, disk_bytes=0))
        for r in range(4):
            eng.count("i", pk.parse(f"Row(f={r})").calls[0], (0,))
        for k in range(4):
            eng._aux_store((("k", k), ("fp",)), ("fp",), k)
        snap = eng.snapshot()
        assert snap["memo_evictions"] >= 2 and snap["aux_evictions"] >= 2
        return snap["memo_evictions"], snap["aux_evictions"], snap["memo_misses"]

    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]


# ------------------------------------------- budgets + config resolution


@pytest.mark.parametrize("case", ["config", "env_beats_config", "hbm_split",
                                  "explicit_beats_split"])
def test_budget_resolution_like_jax(holders, engines, monkeypatch, case):
    def body(pk, h, make):
        kw = {"tier_config": pk.TierConfig(host_bytes=0, disk_bytes=0)}
        if case == "config":
            kw["config"] = pk.EngineConfig(leaf_cache_bytes=111, stack_cache_bytes=222,
                                           memo_entries=33, aux_memo_entries=44)
        elif case == "env_beats_config":
            kw["config"] = pk.EngineConfig(leaf_cache_bytes=111, memo_entries=33)
        elif case == "hbm_split":
            kw["tier_config"] = pk.TierConfig(hbm_bytes=1 << 20, host_bytes=0,
                                              disk_bytes=0)
        else:
            kw["config"] = pk.EngineConfig(leaf_cache_bytes=12345)
            kw["tier_config"] = pk.TierConfig(hbm_bytes=1 << 20, host_bytes=0,
                                              disk_bytes=0)
        b = make(pk, h, **kw).budgets
        return {k: b[k] for k in ("leaf_cache_bytes", "stack_cache_bytes",
                                  "memo_entries", "aux_memo_entries")}

    if case == "env_beats_config":
        monkeypatch.setenv("PILOSA_LEAF_CACHE_BYTES", "777")
        monkeypatch.setenv("PILOSA_MEMO_ENTRIES", "0")
    out = same_run(holders, engines, body)
    assert out["torch"] == out["jax"]
    want = {"config": (111, 222), "env_beats_config": (777, None),
            "hbm_split": (1 << 19, 1 << 19), "explicit_beats_split": (12345, 1 << 19)}[case]
    assert out["torch"]["leaf_cache_bytes"] == want[0]
    if want[1] is not None:
        assert out["torch"]["stack_cache_bytes"] == want[1]
    if case == "env_beats_config":
        assert out["torch"]["memo_entries"] == 0


def test_tier_config_validate():
    with pytest.raises(ValueError):
        TierConfig(host_bytes=-1).validate()
    with pytest.raises(ValueError):
        TierConfig(prefetch_interval=-0.1).validate()
    with pytest.raises(ValueError):
        TierConfig(prefetch_batch=0).validate()
    assert not TierConfig(host_bytes=0, disk_bytes=0).enabled()
    assert TierConfig(host_bytes=1).enabled()
    assert not TierConfig(host_bytes=0, disk_bytes=1).enabled()
    assert TierConfig(host_bytes=0, disk_bytes=1, disk_path="/x").enabled()


def test_tier_config_from_env(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_TIER_HOST_BYTES", "21")
    monkeypatch.setenv("PILOSA_TPU_TIER_PREFETCH_INTERVAL", "0.5")
    c = TierConfig.from_env()
    assert c.host_bytes == 21 and c.prefetch_interval == 0.5
