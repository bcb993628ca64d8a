"""The cases of tests/test_native.py, run against the port's copy.

pilosa_tpu_torch/native is the port's own copy of the native C++ host
kernels (ops/bitplane.py and storage/bitmap.py load it): built with make
on first use, compared against numpy. Skipped, as in the reference, when
the toolchain cannot build the library."""

import numpy as np
import pytest

from pilosa_tpu_torch import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

RNG = np.random.default_rng(11)


def sorted_u16(n, span=65536):
    return np.unique(RNG.integers(0, span, n)).astype(np.uint16)


def test_pack_unpack():
    cols = np.unique(RNG.integers(0, 1 << 16, 5000)).astype(np.uint32)
    words = native.pack_bits(cols, (1 << 16) // 32)
    ref = np.zeros((1 << 16) // 32, dtype=np.uint32)
    np.bitwise_or.at(ref, cols >> 5, np.uint32(1) << (cols & np.uint32(31)))
    assert np.array_equal(words, ref)
    assert np.array_equal(native.unpack_bits(words), cols.astype(np.uint64))


def test_container_ops_vs_numpy():
    a, b = sorted_u16(3000), sorted_u16(3000)
    assert native.intersection_count_u16(a, b) == len(
        np.intersect1d(a, b, assume_unique=True)
    )
    assert np.array_equal(native.intersect_u16(a, b), np.intersect1d(a, b))
    assert np.array_equal(native.union_u16(a, b), np.union1d(a, b))
    assert np.array_equal(
        native.difference_u16(a, b), np.setdiff1d(a, b, assume_unique=True)
    )
    assert np.array_equal(native.xor_u16(a, b), np.setxor1d(a, b))


def test_empty_inputs():
    e = np.empty(0, dtype=np.uint16)
    a = sorted_u16(100)
    assert native.intersection_count_u16(a, e) == 0
    assert len(native.intersect_u16(e, e)) == 0
    assert np.array_equal(native.union_u16(a, e), a)


def test_bitmap_uses_native():
    from pilosa_tpu_torch.storage.bitmap import Bitmap

    xs, ys = set(range(0, 100000, 3)), set(range(0, 100000, 7))
    a, b = Bitmap(sorted(xs)), Bitmap(sorted(ys))
    assert set(a.intersect(b).slice().tolist()) == xs & ys
    assert a.intersection_count(b) == len(xs & ys)
