"""The cases of tests/test_bitmap.py, run against the port on the CPU.

Host bitmap unit tests: container ops, set algebra oracle, serialization.

Mirrors the reference's kernel-level strategy (roaring_internal_test.go):
exhaustive container-form coverage (array/bitmap/run) and serialization
round-trips, driven against a plain python-set oracle.
"""

import random

import numpy as np
import pytest

from pilosa_tpu_torch.storage.bitmap import (
    OP_ADD,
    OP_REMOVE,
    Bitmap,
    encode_op,
    parse_op,
)


def random_values(rng, n, span=1 << 22):
    return sorted(rng.sample(range(span), n))


def test_add_remove_contains():
    b = Bitmap()
    assert b.add(100)
    assert not b.add(100)
    assert b.contains(100)
    assert not b.contains(101)
    assert b.add(1 << 40)
    assert b.count() == 2
    assert b.remove(100)
    assert not b.remove(100)
    assert b.count() == 1
    assert b.max() == 1 << 40


def test_add_many_matches_scalar():
    rng = random.Random(1)
    vals = random_values(rng, 5000)
    a, b = Bitmap(), Bitmap()
    for v in vals:
        a.add(v)
    b.add_many(np.array(vals, dtype=np.uint64))
    assert a == b
    assert list(a.slice()) == vals


def test_remove_many():
    vals = list(range(0, 200000, 3))
    b = Bitmap(vals)
    b.remove_many(np.array(vals[::2], dtype=np.uint64))
    assert list(b.slice()) == vals[1::2]


def test_count_range_and_slice_range():
    vals = [0, 1, 65535, 65536, 65537, 1 << 20, (1 << 20) + 5]
    b = Bitmap(vals)
    assert b.count_range(0, 1 << 21) == len(vals)
    assert b.count_range(1, 65537) == 3  # 1, 65535, 65536
    assert list(b.slice_range(65536, (1 << 20) + 1)) == [65536, 65537, 1 << 20]


@pytest.mark.parametrize("seed", range(3))
def test_set_algebra_oracle(seed):
    rng = random.Random(seed)
    # Mix densities so serialization forms array, bitmap and run all occur.
    xs = set(random_values(rng, 3000)) | set(range(70000, 80000))
    ys = set(random_values(rng, 3000)) | set(range(75000, 95000, 2))
    a, b = Bitmap(sorted(xs)), Bitmap(sorted(ys))
    assert set(a.union(b).slice()) == xs | ys
    assert set(a.intersect(b).slice()) == xs & ys
    assert set(a.difference(b).slice()) == xs - ys
    assert set(a.xor(b).slice()) == xs ^ ys
    assert a.intersection_count(b) == len(xs & ys)


def test_flip():
    b = Bitmap([2, 4, 6])
    f = b.flip(1, 6)
    assert list(f.slice()) == [1, 3, 5]
    # Flip is inclusive of end, preserves bits outside range.
    b2 = Bitmap([0, 10])
    f2 = b2.flip(2, 4)
    assert list(f2.slice()) == [0, 2, 3, 4, 10]


def test_offset_range():
    sw = 1 << 20
    b = Bitmap([5, 100, sw + 7, 2 * sw + 9])
    # Extract "row 1" ([sw, 2*sw)) rebased to offset 3*sw.
    out = b.offset_range(3 * sw, sw, 2 * sw)
    assert list(out.slice()) == [3 * sw + 7]


@pytest.mark.parametrize(
    "vals",
    [
        [],
        [0],
        [65535, 65536],
        list(range(1000)),  # run container
        list(range(0, 130000, 2)),  # bitmap container (dense even bits)
        [1 << 48, (1 << 48) + 1],
    ],
)
def test_serialization_roundtrip(vals):
    b = Bitmap(vals)
    data = b.to_bytes()
    b2 = Bitmap.from_bytes(data)
    assert b == b2
    assert list(b2.slice()) == vals


def test_serialization_roundtrip_random_forms():
    rng = random.Random(42)
    vals = (
        random_values(rng, 2000)  # arrays
        + list(range(1 << 17, (1 << 17) + 60000))  # runs
        + list(range(1 << 18, (1 << 18) + 131072, 2))  # bitmaps, 2 containers
    )
    vals = sorted(set(vals))
    b = Bitmap(vals)
    b2 = Bitmap.from_bytes(b.to_bytes())
    assert np.array_equal(b.slice(), b2.slice())


def test_op_log_roundtrip():
    b = Bitmap([1, 2, 3])
    data = b.to_bytes() + encode_op(OP_ADD, 99) + encode_op(OP_REMOVE, 2)
    b2 = Bitmap.from_bytes(data)
    assert list(b2.slice()) == [1, 3, 99]
    assert b2.op_n == 2


def test_op_checksum():
    raw = encode_op(OP_ADD, 12345)
    assert parse_op(raw) == (OP_ADD, 12345)
    corrupted = bytes([raw[0] ^ 1]) + raw[1:]
    with pytest.raises(ValueError):
        parse_op(corrupted)


def test_header_layout():
    # Byte-level check of the fixed header against the reference layout
    # (cookie 12348 LE in bytes 0-3, container count in 4-7).
    b = Bitmap([7])
    data = b.to_bytes()
    assert data[0:2] == (12348).to_bytes(2, "little")
    assert data[2:4] == b"\x00\x00"
    assert int.from_bytes(data[4:8], "little") == 1


# ------------------------- two-form container behavior (round-2 rework) ----


def test_container_densify_and_sparsify():
    from pilosa_tpu_torch.storage.bitmap import ARRAY_MAX_SIZE

    b = Bitmap()
    # Cross the array->bitset threshold via point adds.
    for v in range(ARRAY_MAX_SIZE + 10):
        assert b.add(v)
    c = b.containers[0]
    assert c.bits is not None and c.arr is None
    assert b.count() == ARRAY_MAX_SIZE + 10
    assert b.contains(17) and not b.contains(ARRAY_MAX_SIZE + 10)
    # Remove below the hysteresis point (half the array threshold):
    # converts back to array form.
    for v in range(ARRAY_MAX_SIZE + 10):
        if v % 3:
            assert b.remove(v)
    c = b.containers[0]
    assert c.arr is not None and c.bits is None
    assert b.count() == len([v for v in range(ARRAY_MAX_SIZE + 10) if v % 3 == 0])


def test_dense_bulk_roundtrip_all_forms():
    rng = np.random.default_rng(7)
    vals = rng.choice(1 << 20, size=200_000, replace=False).astype(np.uint64)
    b = Bitmap(vals)
    assert any(c.bits is not None for c in b.containers.values())
    # serialization round trip preserves content regardless of form
    b2 = Bitmap.from_bytes(b.to_bytes())
    assert b == b2
    assert np.array_equal(b.slice(), np.sort(vals))


def test_slice_range_walks_containers_only():
    # values spread over many containers; range covers a partial window
    b = Bitmap()
    b.add_many(np.arange(0, 1 << 22, 13, dtype=np.uint64))
    lo, hi = (1 << 18) + 5, (1 << 21) - 3
    got = b.slice_range(lo, hi)
    all_vals = np.arange(0, 1 << 22, 13, dtype=np.uint64)
    want = all_vals[(all_vals >= lo) & (all_vals < hi)]
    assert np.array_equal(got, want)
    assert b.count_range(lo, hi) == len(want)


def test_range_words_matches_pack_bits():
    from pilosa_tpu_torch.ops.bitplane import pack_bits

    rng = np.random.default_rng(11)
    width = 1 << 17  # two containers
    cols = np.sort(rng.choice(width, size=30_000, replace=False)).astype(np.uint64)
    b = Bitmap(cols)
    words = b.range_words(0, width).view(np.uint32)
    assert np.array_equal(words, pack_bits(cols.astype(np.uint32), width=width))


def test_mixed_form_algebra_matches_oracle():
    rng = np.random.default_rng(3)
    dense = rng.choice(1 << 16, size=30_000, replace=False).astype(np.uint64)
    sparse = rng.choice(1 << 16, size=500, replace=False).astype(np.uint64)
    bd, bs = Bitmap(dense), Bitmap(sparse)
    assert bd.containers[0].bits is not None
    assert bs.containers[0].arr is not None
    sd, ss = set(dense.tolist()), set(sparse.tolist())
    for a, bb, sa, sb in [(bd, bs, sd, ss), (bs, bd, ss, sd)]:
        assert set(a.intersect(bb).slice().tolist()) == sa & sb
        assert set(a.union(bb).slice().tolist()) == sa | sb
        assert set(a.difference(bb).slice().tolist()) == sa - sb
        assert set(a.xor(bb).slice().tolist()) == sa ^ sb
        assert a.intersection_count(bb) == len(sa & sb)


def test_full_container_run_roundtrip():
    # A completely full container serializes as run [0, 65535]; decode must
    # not wrap uint16 at the +1 (would silently drop 65536 bits).
    b = Bitmap(np.arange(1 << 16, dtype=np.uint64))
    b2 = Bitmap.from_bytes(b.to_bytes())
    assert b2.count() == 1 << 16
    assert b == b2


def test_direct_container_assignment_updates_key_cache():
    b = Bitmap(np.arange(0, 1 << 18, 7, dtype=np.uint64))
    _ = b.slice()  # populates the sorted-key cache
    b.containers[1 << 10] = np.array([7], dtype=np.uint16)  # legacy direct set
    assert b.count_range((1 << 10) << 16, ((1 << 10) + 1) << 16) == 1
    assert ((1 << 26) | 7) in set(b.slice().tolist())


def test_lazy_open_detects_corrupt_header_cardinality():
    # The mmap open path trusts the header n at parse time (open stays
    # O(headers)); the first count/mutation touch must recompute and raise
    # (ADVICE r3: a corrupt n silently poisoned Count on the lazy path).
    import struct

    from pilosa_tpu_torch.storage.bitmap import HEADER_BASE_SIZE

    b = Bitmap(np.arange(0, 1 << 16, 2, dtype=np.uint64))  # one dense bitset
    data = bytearray(b.to_bytes())
    n_off = HEADER_BASE_SIZE + 8 + 2  # first container header's n-1 field
    (n_minus_1,) = struct.unpack_from("<H", data, n_off)
    assert n_minus_1 + 1 == 1 << 15
    struct.pack_into("<H", data, n_off, n_minus_1 - 1000)  # corrupt n
    lazy = Bitmap.from_buffer(bytes(data), copy=False)
    with pytest.raises(ValueError, match="corrupt"):
        lazy.count()
    # Eager parse derives n from the payload, so it self-heals.
    assert Bitmap.from_bytes(bytes(data)).count() == 1 << 15


def test_lazy_open_verifies_on_mutation():
    import struct

    from pilosa_tpu_torch.storage.bitmap import HEADER_BASE_SIZE

    b = Bitmap(np.arange(0, 1 << 16, 2, dtype=np.uint64))
    data = bytearray(b.to_bytes())
    n_off = HEADER_BASE_SIZE + 8 + 2
    (n_minus_1,) = struct.unpack_from("<H", data, n_off)
    struct.pack_into("<H", data, n_off, n_minus_1 - 7)
    lazy = Bitmap.from_buffer(bytes(data), copy=False)
    with pytest.raises(ValueError, match="corrupt"):
        lazy.add(1)
    # An uncorrupted lazy open counts fine and settles the flag.
    ok = Bitmap.from_buffer(b.to_bytes(), copy=False)
    assert ok.count() == 1 << 15
    assert ok.count() == 1 << 15  # second count: verified path


def test_corrupt_container_keeps_raising_and_wont_serialize():
    # A caught first error must not silently poison later counts, and
    # to_bytes must refuse to write an internally inconsistent file.
    import struct

    from pilosa_tpu_torch.storage.bitmap import HEADER_BASE_SIZE

    b = Bitmap(np.arange(0, 1 << 16, 2, dtype=np.uint64))
    data = bytearray(b.to_bytes())
    n_off = HEADER_BASE_SIZE + 8 + 2
    (n_minus_1,) = struct.unpack_from("<H", data, n_off)
    struct.pack_into("<H", data, n_off, n_minus_1 - 1000)
    lazy = Bitmap.from_buffer(bytes(data), copy=False)
    for _ in range(2):  # raises EVERY time, not just once
        with pytest.raises(ValueError, match="corrupt"):
            lazy.count()
    with pytest.raises(ValueError, match="corrupt"):
        lazy.to_bytes()
    # copy() must not launder an unverified n either.
    lazy2 = Bitmap.from_buffer(bytes(data), copy=False)
    with pytest.raises(ValueError, match="corrupt"):
        lazy2.clone().count()


# ------------------------------------------------------- run form (in-memory)


def test_run_container_is_compute_form():
    """Runs are a compute+memory form (reference roaring.go:1906-1949
    computes on runs): a contiguous bulk import runifies in memory, ops
    answer from intervals, and a fully-set container costs bytes, not 8 KiB."""
    from pilosa_tpu_torch.storage.bitmap import Container, _as_container

    b = Bitmap()
    b.add_many(np.arange(0, 1 << 16, dtype=np.uint64))  # full container
    c = _as_container(b.containers[0])
    assert c.runs is not None and len(c.runs) == 1
    assert c.runs.nbytes == 4  # vs 8192 for the bitset form
    assert c.n == 1 << 16
    assert b.count() == 1 << 16
    assert b.contains(12345) and not b.contains(1 << 16)
    assert b.count_range(100, 300) == 200
    # Point mutation flattens; a TINY bulk op no longer probes for the
    # run form (the O(n) probe per touch dominated incremental ingest —
    # docs/ingest.md), so re-compression waits for optimize()/snapshot
    # or a chunk that rewrites a meaningful fraction of the container.
    b.remove(500)
    c = _as_container(b.containers[0])
    assert c.runs is None and c.n == (1 << 16) - 1
    b.add_many(np.array([500], dtype=np.uint64))
    c = _as_container(b.containers[0])
    assert c.runs is None and c.n == 1 << 16
    b.optimize()
    c = _as_container(b.containers[0])
    assert c.runs is not None and c.n == 1 << 16


def test_run_intersection_count_all_form_pairs():
    """intersection_count must agree across all 3x3 form combinations."""
    from pilosa_tpu_torch.storage.bitmap import Container

    rng = np.random.default_rng(77)

    def forms(values):
        arr = np.array(sorted(values), dtype=np.uint16)
        a = Container(arr=arr.copy())
        bts = Container(bits=a.as_words().copy())
        r = Container(arr=arr.copy())
        r._maybe_runify()
        if r.runs is None:  # force the run form regardless of heuristics
            from pilosa_tpu_torch.storage.bitmap import _runs_of_array

            r = Container(runs=_runs_of_array(arr))
        return [a, bts, r]

    va = set(range(100, 1000)) | set(rng.integers(0, 1 << 16, 500).tolist())
    vb = set(range(500, 1500)) | set(rng.integers(0, 1 << 16, 500).tolist())
    want = len(va & vb)
    for ca in forms(va):
        for cb in forms(vb):
            assert ca.intersection_count(cb) == want, (ca, cb)


def test_run_container_survives_roundtrip_as_runs():
    b = Bitmap()
    b.add_many(np.arange(1000, 60000, dtype=np.uint64))
    data = b.to_bytes()
    for copy in (True, False):
        rt = Bitmap.from_buffer(data, copy=copy)
        from pilosa_tpu_torch.storage.bitmap import _as_container

        c = _as_container(rt.containers[0])
        assert c.runs is not None, f"copy={copy}"
        assert rt.count() == 59000
        assert rt == b


def test_adversarial_contiguous_import_memory_bounded():
    """1B-bit-scale contiguous range scaled down: every full container must
    hold runs (≈4 B), not bitsets (8 KiB) — the host-memory blowup the
    run form exists to prevent."""
    from pilosa_tpu_torch.storage.bitmap import _as_container

    b = Bitmap()
    n_containers = 64
    b.add_many(np.arange(0, n_containers << 16, dtype=np.uint64))
    payload = sum(
        _as_container(c).runs.nbytes
        for c in b.containers.values()
        if _as_container(c).runs is not None
    )
    runified = sum(
        1 for c in b.containers.values() if _as_container(c).runs is not None
    )
    assert runified == n_containers
    assert payload == 4 * n_containers  # one [start,last] pair each
    assert b.count() == n_containers << 16


def test_run_form_ops_parity_with_oracle():
    """Union/intersect/difference/xor and range reads on run containers
    match the value-set oracle."""
    from pilosa_tpu_torch.storage.bitmap import Container, _runs_of_array

    va = set(range(0, 30000)) | {40000, 40002, 50000}
    vb = set(range(20000, 35000)) | {40002, 60001}
    ca = Container(runs=_runs_of_array(np.array(sorted(va), dtype=np.uint16)))
    cb = Container(runs=_runs_of_array(np.array(sorted(vb), dtype=np.uint16)))
    assert set(ca.union(cb).to_array().tolist()) == va | vb
    assert set(ca.intersect(cb).to_array().tolist()) == va & vb
    assert set(ca.difference(cb).to_array().tolist()) == va - vb
    assert set(ca.xor(cb).to_array().tolist()) == va ^ vb
    assert ca.count_range(100, 25000) == len([v for v in va if 100 <= v < 25000])
    assert list(ca.slice_range(29990, 40003)) == (
        [v for v in sorted(va) if 29990 <= v < 40003]
    )
    assert ca.check("k") == []


def test_fragment_snapshot_optimizes_to_runs(tmp_path):
    """Point-mutation churn leaves flat forms; snapshot() re-compresses
    (reference Optimize at snapshot)."""
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.storage.bitmap import _as_container

    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0)
    f.open()
    f.bulk_import(np.zeros(60000, dtype=np.uint64),
                  np.arange(60000, dtype=np.uint64))
    f.clear_bit(0, 123)  # flattens the run container
    f.snapshot()
    c = _as_container(f.storage.containers[0])
    assert c.runs is not None and c.n == 59999
    f.close()
    # And it reopens correctly from the run-encoded file.
    f2 = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0)
    f2.open()
    assert f2.row_count(0) == 59999
    f2.close()


def test_corrupt_run_intervals_rejected():
    """A hostile/corrupt run container (inverted or overlapping intervals)
    must fail at parse time, not silently poison count/membership math."""
    import struct

    from pilosa_tpu_torch.storage.bitmap import HEADER_BASE_SIZE

    b = Bitmap()
    b.add_many(np.arange(100, 50000, dtype=np.uint64))  # run-encoded
    data = bytearray(b.to_bytes())
    run_off = HEADER_BASE_SIZE + 12 + 4  # one container: header + offset
    run_n, s0, l0 = struct.unpack_from("<HHH", data, run_off)
    assert run_n == 1 and s0 == 100
    struct.pack_into("<HH", data, run_off + 2, 50000, 100)  # inverted
    with pytest.raises(ValueError, match="corrupt run"):
        Bitmap.from_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt run"):
        Bitmap.from_buffer(bytes(data), copy=False)


def test_container_forms_fuzz_against_set_oracle():
    """Randomized op sequences over all three container forms vs a python
    set oracle: point ops, bulk ops, algebra, range reads, serialization
    round trips. Catches form-transition edge cases (runify/flatten/
    densify/sparsify interactions) that targeted tests miss."""
    rng = np.random.default_rng(2024)

    for trial in range(6):
        oracle = set()
        b = Bitmap()
        for step in range(12):
            op = rng.integers(0, 6)
            if op == 0:  # point adds
                vals = rng.integers(0, 1 << 18, rng.integers(1, 50))
                for v in vals:
                    b.add(int(v))
                    oracle.add(int(v))
            elif op == 1:  # point removes
                if oracle:
                    pool = rng.choice(list(oracle), min(len(oracle), 30))
                    for v in pool:
                        b.remove(int(v))
                        oracle.discard(int(v))
            elif op == 2:  # bulk contiguous add (exercises runify)
                start = int(rng.integers(0, 1 << 17))
                width = int(rng.integers(100, 80000))
                vals = np.arange(start, start + width, dtype=np.uint64)
                b.add_many(vals)
                oracle.update(range(start, start + width))
            elif op == 3:  # bulk random add (exercises densify)
                vals = np.unique(rng.integers(0, 1 << 18, 5000)).astype(np.uint64)
                b.add_many(vals)
                oracle.update(int(v) for v in vals)
            elif op == 4:  # bulk remove
                if oracle:
                    pool = np.unique(
                        rng.choice(list(oracle), min(len(oracle), 4000))
                    ).astype(np.uint64)
                    b.remove_many(pool)
                    oracle.difference_update(int(v) for v in pool)
            else:  # serialization round trip (both eager and lazy)
                data = b.to_bytes()
                b = Bitmap.from_buffer(
                    data, copy=bool(rng.integers(0, 2))
                )
            assert b.count() == len(oracle), (trial, step)
            assert b.check() == [], (trial, step, b.check())

        # Final algebra vs oracle against a second random bitmap.
        other_vals = np.unique(np.concatenate([
            rng.integers(0, 1 << 18, 3000),
            np.arange(5000, 45000),  # run-heavy region
        ])).astype(np.uint64)
        other = Bitmap(other_vals)
        other.optimize()
        oset = set(int(v) for v in other_vals)
        assert set(int(v) for v in b.union(other).slice()) == oracle | oset
        assert set(int(v) for v in b.intersect(other).slice()) == oracle & oset
        assert set(int(v) for v in b.difference(other).slice()) == oracle - oset
        assert set(int(v) for v in b.xor(other).slice()) == oracle ^ oset
        assert b.intersection_count(other) == len(oracle & oset)
        # Range reads on the final state.
        lo, hi = 3000, 120000
        assert b.count_range(lo, hi) == len([v for v in oracle if lo <= v < hi])
