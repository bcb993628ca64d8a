"""pilosa_tpu_torch.ops.bitplane against pilosa_tpu.ops.bitplane.

The same seeded uint32 planes (numpy) go through the JAX functions and
their torch counterparts on the CPU, where the torch side runs the plain
versions. Bitwise ops and integer counts have no rounding: every
comparison is exact (planes bit-equal, counts equal). The planes include
all-ones words and words with only the sign bit set, which int32 tensors
hold as negative numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bitplane as jbp
from pilosa_tpu_torch.ops import bitplane as tbp

W = 32768


def planes(seed: int, r: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << 32, (r, W), dtype=np.uint32)
    p[:, :64] = 0xFFFFFFFF          # all-ones words
    p[:, 64:128] = 0x80000000       # sign bit only
    p[:, 128:192] = 0               # empty words
    p[:, 192:256] = 0x7FFFFFFF
    return p


def tt(a: np.ndarray) -> torch.Tensor:
    return tbp.to_tensor(a, "cpu")


def jj(a: np.ndarray):
    return jnp.asarray(a)


def test_to_tensor_roundtrip_is_bitwise():
    p = planes(0)
    t = tt(p)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tbp.to_numpy(t), p)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_popcount_matches_jax(seed):
    p = planes(seed)
    np.testing.assert_array_equal(
        tbp.popcount(tt(p)).numpy(), np.asarray(jbp.popcount(jj(p))))
    assert int(tbp.popcount(tt(p[0]))) == int(jbp.popcount(jj(p[0])))
    np.testing.assert_array_equal(
        tbp.popcount_words(tt(p)).numpy(),
        np.bitwise_count(p).astype(np.int64))


@pytest.mark.parametrize("seed", [4, 5])
def test_row_counts_matches_jax(seed):
    p = planes(seed, r=6)
    f = planes(seed + 100, r=1)[0]
    np.testing.assert_array_equal(
        tbp.row_counts(tt(p)).numpy(), np.asarray(jbp.row_counts(jj(p))))
    np.testing.assert_array_equal(
        tbp.row_counts(tt(p), tt(f)).numpy(),
        np.asarray(jbp.row_counts(jj(p), jj(f))))
    assert int(tbp.intersection_count(tt(p[0]), tt(f))) == int(
        jbp.intersection_count(jj(p[0]), jj(f)))


@pytest.mark.parametrize("op", ["p_and", "p_or", "p_andnot", "p_xor"])
def test_algebra_matches_jax(op):
    p = planes(7, r=2)
    got = getattr(tbp, op)(tt(p[0]), tt(p[1]))
    want = np.asarray(getattr(jbp, op)(jj(p[0]), jj(p[1])))
    np.testing.assert_array_equal(tbp.to_numpy(got), want)


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(8)
    cols = np.unique(rng.integers(0, W * 32, 5000)).astype(np.uint32)
    packed = tbp.pack_bits(cols)
    np.testing.assert_array_equal(packed, jbp.pack_bits(cols))
    np.testing.assert_array_equal(tbp.unpack_bits(packed), jbp.unpack_bits(packed))
    np.testing.assert_array_equal(tbp.unpack_bits(packed), cols.astype(np.uint64))


# ------------------------------------------------------------------ BSI

DEPTH = 6


def bsi_planes(seed: int) -> np.ndarray:
    """(DEPTH + 1, W) planes of random values (< 2^DEPTH) at random
    columns; plane DEPTH is the not-null row."""
    rng = np.random.default_rng(seed)
    cols = np.unique(rng.integers(0, W * 32, 3000)).astype(np.uint32)
    vals = rng.integers(0, 1 << DEPTH, len(cols))
    out = np.zeros((DEPTH + 1, W), dtype=np.uint32)
    for i in range(DEPTH):
        out[i] = jbp.pack_bits(cols[(vals >> i) & 1 == 1])
    out[DEPTH] = jbp.pack_bits(cols)
    return out


def test_bsi_plane_counts_matches_jax():
    p = bsi_planes(9)
    f = planes(10, r=1)[0]
    np.testing.assert_array_equal(
        tbp.bsi_plane_counts(tt(p), tt(f)).numpy(),
        np.asarray(jbp.bsi_plane_counts(jj(p), jj(f))))


@pytest.mark.parametrize("fn", ["bsi_min", "bsi_max"])
@pytest.mark.parametrize("filtered", [False, True])
def test_bsi_min_max_matches_jax(fn, filtered):
    p = bsi_planes(11)
    f = planes(12, r=1)[0] if filtered else None
    tbits, tcount = getattr(tbp, fn)(tt(p), DEPTH, None if f is None else tt(f))
    jbits, jcount = getattr(jbp, fn)(jj(p), DEPTH, None if f is None else jj(f))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert int(tcount) == int(jcount)
    assert tbp.compose_bits(tbits) == jbp.compose_bits(np.asarray(jbits))


@pytest.mark.parametrize("predicate", [0, 1, 17, 32, 63])
@pytest.mark.parametrize("op", ["eq", "neq", "lt", "lte", "gt", "gte"])
def test_bsi_range_matches_jax(op, predicate):
    p = bsi_planes(13)
    if op in ("eq", "neq"):
        name = "bsi_range_" + op
        got = getattr(tbp, name)(tt(p), DEPTH, predicate)
        want = getattr(jbp, name)(jj(p), DEPTH, predicate)
    else:
        name = "bsi_range_" + op[:2]
        eq = op.endswith("e")
        got = getattr(tbp, name)(tt(p), DEPTH, predicate, eq)
        want = getattr(jbp, name)(jj(p), DEPTH, predicate, eq)
    np.testing.assert_array_equal(tbp.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0, 63), (5, 40), (17, 17), (33, 2)])
def test_bsi_range_between_matches_jax(lo, hi):
    p = bsi_planes(14)
    got = tbp.bsi_range_between(tt(p), DEPTH, lo, hi)
    want = jbp.bsi_range_between(jj(p), DEPTH, lo, hi)
    np.testing.assert_array_equal(tbp.to_numpy(got), np.asarray(want))
