"""The cases of tests/test_fragment.py, run against the port on the CPU.

Fragment tests (model: reference fragment_internal_test.go).

Covers setBit/clearBit, BSI value/sum/min/max/range, TopN (cache sizes,
src-intersection, tanimoto), merkle blocks, WAL + snapshot durability across
reopen, bulk import, and cache persistence.
"""

import numpy as np
import pytest

from pilosa_tpu_torch.constants import CACHE_TYPE_RANKED, SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment, TopOptions
from pilosa_tpu_torch.core.row import Row


def make_fragment(tmp_path=None, shard=0, **kw):
    path = str(tmp_path / f"frag.{shard}") if tmp_path else None
    f = Fragment(path, "i", "f", "standard", shard, **kw)
    f.open()
    return f


def test_set_clear_bit(tmp_path):
    f = make_fragment(tmp_path)
    assert f.set_bit(120, 1)
    assert f.set_bit(120, 6)
    assert f.set_bit(121, 0)
    assert not f.set_bit(120, 6)  # already set
    assert list(f.row(120).columns()) == [1, 6]
    assert f.row_count(120) == 2
    assert f.clear_bit(120, 1)
    assert not f.clear_bit(120, 1)
    assert list(f.row(120).columns()) == [6]


def test_shard_offset_columns(tmp_path):
    f = make_fragment(tmp_path, shard=2)
    base = 2 * SHARD_WIDTH
    assert f.set_bit(7, base + 5)
    assert list(f.row(7).columns()) == [base + 5]
    with pytest.raises(Exception):
        f.set_bit(7, 5)  # column outside shard


def test_wal_and_snapshot_durability(tmp_path):
    f = make_fragment(tmp_path, max_op_n=5)
    for i in range(12):  # crosses snapshot threshold twice
        f.set_bit(1, i)
    f.close()
    f2 = make_fragment(tmp_path)
    assert list(f2.row(1).columns()) == list(range(12))


def test_wal_replay_without_snapshot(tmp_path):
    f = make_fragment(tmp_path, max_op_n=10_000)
    f.set_bit(3, 42)
    f.clear_bit(3, 42)
    f.set_bit(3, 43)
    f.close()
    f2 = make_fragment(tmp_path)
    assert list(f2.row(3).columns()) == [43]


def test_bsi_value_roundtrip(tmp_path):
    f = make_fragment(tmp_path)
    assert f.set_value(100, 8, 177)
    value, exists = f.value(100, 8)
    assert (value, exists) == (177, True)
    _, exists = f.value(101, 8)
    assert not exists
    # Overwrite.
    f.set_value(100, 8, 23)
    assert f.value(100, 8) == (23, True)


def test_bsi_sum_min_max(tmp_path):
    f = make_fragment(tmp_path)
    vals = {10: 7, 20: 100, 30: 100, 40: 3}
    for col, v in vals.items():
        f.set_value(col, 8, v)
    assert f.sum(None, 8) == (210, 4)
    assert f.min(None, 8) == (3, 1)
    assert f.max(None, 8) == (100, 2)
    filt = Row(columns=[10, 20])
    assert f.sum(filt, 8) == (107, 2)
    assert f.min(filt, 8) == (7, 1)
    assert f.max(filt, 8) == (100, 1)


def test_bsi_range(tmp_path):
    f = make_fragment(tmp_path)
    vals = {1: 10, 2: 20, 3: 30, 4: 40}
    for col, v in vals.items():
        f.set_value(col, 8, v)
    assert list(f.range_op("eq", 8, 20).columns()) == [2]
    assert list(f.range_op("neq", 8, 20).columns()) == [1, 3, 4]
    assert list(f.range_op("lt", 8, 30).columns()) == [1, 2]
    assert list(f.range_op("lte", 8, 30).columns()) == [1, 2, 3]
    assert list(f.range_op("gt", 8, 20).columns()) == [3, 4]
    assert list(f.range_op("gte", 8, 20).columns()) == [2, 3, 4]
    assert list(f.range_between(8, 15, 35).columns()) == [2, 3]
    assert list(f.not_null(8).columns()) == [1, 2, 3, 4]


def test_top_basic(tmp_path):
    f = make_fragment(tmp_path)
    for col in range(5):
        f.set_bit(100, col)
    for col in range(3):
        f.set_bit(101, col)
    f.set_bit(102, 0)
    pairs = f.top(TopOptions(n=2))
    assert [(p.id, p.count) for p in pairs] == [(100, 5), (101, 3)]
    # All rows when n=0.
    pairs = f.top(TopOptions(n=0))
    assert [(p.id, p.count) for p in pairs] == [(100, 5), (101, 3), (102, 1)]


def test_top_with_src(tmp_path):
    f = make_fragment(tmp_path)
    for col in range(10):
        f.set_bit(100, col)
    for col in range(4, 12):
        f.set_bit(101, col)
    for col in range(8, 9):
        f.set_bit(102, col)
    src = Row(columns=list(range(5, 20)))
    pairs = f.top(TopOptions(n=2, src=src))
    # row 101 ∩ src = {5..11} = 7; row 100 ∩ src = {5..9} = 5; row 102 = 1
    assert [(p.id, p.count) for p in pairs] == [(101, 7), (100, 5)]


def test_top_row_ids(tmp_path):
    f = make_fragment(tmp_path)
    for col in range(5):
        f.set_bit(100, col)
    for col in range(3):
        f.set_bit(101, col)
    f.set_bit(102, 9)
    pairs = f.top(TopOptions(n=1, row_ids=[101, 102]))
    # Explicit row ids disable truncation (reference fragment.go:873-876).
    assert [(p.id, p.count) for p in pairs] == [(101, 3), (102, 1)]


def test_top_min_threshold(tmp_path):
    f = make_fragment(tmp_path)
    for col in range(5):
        f.set_bit(100, col)
    for col in range(3):
        f.set_bit(101, col)
    f.set_bit(102, 0)
    pairs = f.top(TopOptions(n=10, min_threshold=3))
    assert [(p.id, p.count) for p in pairs] == [(100, 5), (101, 3)]


def test_top_tanimoto(tmp_path):
    f = make_fragment(tmp_path)
    # src = {0..9}; row 100 = {0..9} (tanimoto 100), row 101 = {0..4,20..24}
    # (intersection 5, union 15 → ceil(5*100/15)=34), row 102 = {50} (0).
    for col in range(10):
        f.set_bit(100, col)
    for col in list(range(5)) + list(range(20, 25)):
        f.set_bit(101, col)
    f.set_bit(102, 50)
    src = Row(columns=list(range(10)))
    pairs = f.top(TopOptions(src=src, tanimoto_threshold=50))
    assert [(p.id, p.count) for p in pairs] == [(100, 10)]
    pairs = f.top(TopOptions(src=src, tanimoto_threshold=30))
    assert [(p.id, p.count) for p in pairs] == [(100, 10), (101, 5)]


def test_top_attr_filter(tmp_path):
    class AttrStore:
        def attrs(self, row_id):
            return {"x": row_id % 2}

    f = make_fragment(tmp_path, row_attr_store=AttrStore())
    for col in range(5):
        f.set_bit(100, col)
    for col in range(3):
        f.set_bit(101, col)
    pairs = f.top(TopOptions(n=10, filter_name="x", filter_values=[1]))
    assert [(p.id, p.count) for p in pairs] == [(101, 3)]


def test_blocks_change_on_write(tmp_path):
    f = make_fragment(tmp_path)
    f.set_bit(0, 1)
    b1 = f.blocks()
    assert [b.id for b in b1] == [0]
    f.set_bit(0, 2)
    b2 = f.blocks()
    assert b1[0].checksum != b2[0].checksum
    f.set_bit(250, 1)  # block 2
    assert [b.id for b in f.blocks()] == [0, 2]


def test_merge_block_consensus(tmp_path):
    f = make_fragment(tmp_path)
    f.set_bit(0, 1)  # local has (0,1)
    # Two replicas both have (0,2) and neither has (0,1): consensus = {(0,2)}.
    replica = (np.array([0]), np.array([2]))
    sets, clears = f.merge_block(0, [replica, replica])
    assert list(f.row(0).columns()) == [2]
    assert sets == [[], []] and clears == [[], []]


def test_open_is_lazy_mmap_with_copy_on_write(tmp_path):
    """Reopen parses container payloads zero-copy from an mmap (open cost
    O(headers), no double-buffering; fragment.go:167-224 mmaps likewise).
    Dense payloads stay read-only views until first mutation promotes them."""
    import mmap as mmap_mod

    f = make_fragment(tmp_path)
    for col in range(0, 12000, 2):  # dense, non-runny: serializes as bitset
        f.set_bit(3, col)
    f.set_bit(4, 9)  # sparse container (array form)
    f.snapshot()
    f.close()

    from pilosa_tpu_torch.constants import SHARD_WIDTH

    f2 = make_fragment(tmp_path)
    dense = f2.storage.containers[(3 * SHARD_WIDTH) >> 16]
    assert dense.bits is not None and not dense.bits.flags.writeable
    assert isinstance(dense.bits.base, (mmap_mod.mmap, memoryview)) or isinstance(
        getattr(dense.bits.base, "obj", None), mmap_mod.mmap
    )
    assert f2.row_count(3) == 6000 and f2.bit(4, 9)
    # Copy-on-write: mutating the dense row must not touch the file.
    before = open(f2.path, "rb").read()
    assert f2.set_bit(3, 6001)
    assert dense.bits.flags.writeable  # promoted to a private copy
    assert f2.row_count(3) == 6001
    # Snapshot replaces the inode; stale views stay valid and reopen agrees.
    f2.snapshot()
    f2.close()
    f3 = make_fragment(tmp_path)
    assert f3.row_count(3) == 6001 and f3.bit(4, 9)
    f3.close()


def test_merge_block_rejects_out_of_range_replica_data(tmp_path):
    """Replica pairs outside the block must not wrap uint64 into phantom
    positions that reach consensus (block 0 spans rows 0..99): they are
    dropped before voting."""
    from pilosa_tpu_torch.constants import HASH_BLOCK_SIZE

    f = make_fragment(tmp_path)
    f.set_bit(0, 1)
    # Both replicas agree on (0,1) but also send garbage: a row beyond the
    # block and, for block_id>0 semantics, a row below it (wraps negative).
    bad = (np.array([0, HASH_BLOCK_SIZE + 5], dtype=np.uint64),
           np.array([1, 7], dtype=np.uint64))
    sets, clears = f.merge_block(0, [bad, bad])
    assert list(f.row(0).columns()) == [1]
    assert f.row(HASH_BLOCK_SIZE + 5).count() == 0  # no phantom row
    assert sets == [[], []] and clears == [[], []]
    # Below-block garbage for a non-zero block wraps uint64; also dropped.
    f.set_bit(HASH_BLOCK_SIZE * 2, 3)  # block 2
    bad2 = (np.array([HASH_BLOCK_SIZE * 2, 1], dtype=np.uint64),
            np.array([3, 9], dtype=np.uint64))
    sets, clears = f.merge_block(2, [bad2, bad2])
    assert list(f.row(HASH_BLOCK_SIZE * 2).columns()) == [3]
    assert f.row(1).count() == 0
    assert sets == [[], []] and clears == [[], []]


def test_bulk_import(tmp_path):
    f = make_fragment(tmp_path)
    rows = np.array([1, 1, 2, 2, 2])
    cols = np.array([10, 20, 10, 30, 40])
    f.bulk_import(rows, cols)
    assert list(f.row(1).columns()) == [10, 20]
    assert list(f.row(2).columns()) == [10, 30, 40]
    pairs = f.top(TopOptions(n=2))
    assert [(p.id, p.count) for p in pairs] == [(2, 3), (1, 2)]


def test_import_value(tmp_path):
    f = make_fragment(tmp_path)
    cols = np.array([5, 6, 7])
    vals = np.array([100, 0, 255])
    f.import_value(cols, vals, 8)
    assert f.value(5, 8) == (100, True)
    assert f.value(6, 8) == (0, True)
    assert f.value(7, 8) == (255, True)
    assert f.sum(None, 8) == (355, 3)


def test_cache_persistence(tmp_path):
    f = make_fragment(tmp_path, cache_type=CACHE_TYPE_RANKED)
    for col in range(5):
        f.set_bit(7, col)
    f.close()
    f2 = make_fragment(tmp_path)
    assert f2.cache.get(7) == 5


def test_write_read_roundtrip(tmp_path):
    f = make_fragment(tmp_path)
    f.set_bit(1, 10)
    f.set_bit(2, 20)
    import io

    buf = io.BytesIO()
    f.write_to(buf)
    buf.seek(0)
    g = make_fragment(tmp_path / "other" if False else None)
    g = Fragment(None, "i", "f", "standard", 0)
    g.open()
    g.read_from(buf)
    assert list(g.row(1).columns()) == [10]
    assert list(g.row(2).columns()) == [20]
    assert g.cache.get(1) == 1


def test_merge_block_dense_scale(tmp_path):
    """Anti-entropy consensus over a dense block (>1M bits) must run at
    numpy speed, not per-pair Python objects (fragment.go:1176-1293)."""
    import time

    from pilosa_tpu_torch.constants import SHARD_WIDTH

    f = make_fragment(tmp_path)
    # Local replica: rows 0-1 dense (even columns), plus noise missing
    # from the others.
    local = np.arange(0, SHARD_WIDTH, 2, dtype=np.uint64)
    f.bulk_import(np.zeros(len(local), dtype=np.uint64), local)
    f.bulk_import(np.ones(len(local), dtype=np.uint64), local)
    # Replica A: same + extra bits; replica B: same as A. 2-of-3 majority
    # should adopt the extras locally.
    extra = np.arange(1, 200_001, 2, dtype=np.uint64)  # odd cols, row 0
    rows_a = np.concatenate([np.zeros(len(local) + len(extra), dtype=np.uint64),
                             np.ones(len(local), dtype=np.uint64)])
    cols_a = np.concatenate([local, extra, local])
    t0 = time.monotonic()
    sets, clears = f.merge_block(0, [(rows_a, cols_a), (rows_a.copy(), cols_a.copy())])
    dt = time.monotonic() - t0
    assert dt < 10.0, f"dense merge too slow: {dt:.1f}s"
    # Local fragment adopted the majority extras.
    assert f.row_count(0) == len(local) + len(extra)
    assert f.row_count(1) == len(local)
    # Replicas already agree with consensus: no diffs pushed back.
    assert sets == [[], []] and clears == [[], []]


def test_merge_block_pushes_diffs_to_minority_replica(tmp_path):
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    f = make_fragment(tmp_path)
    f.set_bit(0, 1)
    f.set_bit(0, 2)
    # Replica agrees on bit 1 and has a spurious bit 5; majority of 2
    # ((2+1)//2 = 1 vote needed) keeps everything -> local adopts 5,
    # replica is told to set 2.
    sets, clears = f.merge_block(0, [(np.array([0, 0], dtype=np.uint64),
                                      np.array([1, 5], dtype=np.uint64))])
    assert f.bit(0, 5)
    assert (0, 2) in sets[0]
    assert clears[0] == []


def test_blocks_streaming_digest_parity(tmp_path):
    """blocks() streams containers instead of materializing slice() (8
    bytes per set bit — on run-heavy fragments that would undo the run
    form's memory bound every anti-entropy sweep). Digests must be
    byte-identical to the all-at-once oracle (_block_hash over the full
    position list), including across a run-heavy row and block gaps."""
    import numpy as np

    from pilosa_tpu_torch.constants import HASH_BLOCK_SIZE, SHARD_WIDTH
    from pilosa_tpu_torch.core.fragment import Fragment, _block_hash

    f = Fragment(None, "i", "f", "standard", 0)
    f.open()
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 300, 20000).astype(np.uint64)
    cols = rng.integers(0, SHARD_WIDTH, 20000).astype(np.uint64)
    f.bulk_import(rows, cols)
    # A run-heavy row (runified in memory) and a far block (gap coverage).
    f.bulk_import(np.full(70000, 150, dtype=np.uint64),
                  np.arange(70000, dtype=np.uint64))
    f.bulk_import(np.array([950], dtype=np.uint64),
                  np.array([123], dtype=np.uint64))
    f.invalidate_checksums()
    got = {b.id: b.checksum for b in f.blocks()}

    vals = f.storage.slice()
    bw = HASH_BLOCK_SIZE * SHARD_WIDTH
    bids = (vals // np.uint64(bw)).astype(np.int64)
    want = {int(b): _block_hash(vals[bids == b]) for b in np.unique(bids)}
    assert got == want and len(got) >= 3


def test_concurrent_writes_lose_nothing(tmp_path):
    """Concurrent set_bit from many threads into the SAME container must
    not lose updates (reference fragment.go guards writes with f.mu; the
    container mutation is a multi-step numpy read-modify-write)."""
    import threading

    f = make_fragment(tmp_path)
    n_threads, per_thread = 8, 400
    errs = []

    def worker(t):
        try:
            for i in range(per_thread):
                f.set_bit(1, t * per_thread + i)  # all in one container
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), t.name
    assert not errs
    assert f.row_count(1) == n_threads * per_thread
    # WAL/snapshot survived the concurrency: reopen and recount.
    f.close()
    f2 = make_fragment(tmp_path)
    assert f2.row_count(1) == n_threads * per_thread
    f2.close()
