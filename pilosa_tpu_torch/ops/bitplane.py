"""Dense bitplane ops on torch tensors.

A *bitplane* is one fragment row's 2^20 column bits packed into 32-bit
words: shape (WORDS_PER_ROW,) = (32768,). Batches of rows stack to
(R, WORDS_PER_ROW). Roaring survives only as the host/disk format
(storage/bitmap.py).

Planes are ``torch.int32`` tensors holding the uint32 words bit for bit:
torch on the CPU has no ``bitwise_not`` and no ``>>`` for uint32, while
every bitwise op below is sign-agnostic on int32. Host <-> device
conversion is a reinterpreting view (``to_tensor`` / ``to_numpy``), never a
value conversion; the CUDA kernels read the same memory as ``uint32_t``.

Counts: torch has no popcount. ``popcount`` / ``intersection_count`` /
``row_counts`` compute on CPU tensors with the plain SWAR formula below and
send CUDA tensors to the hand-written kernel ``masked_plane_counts``
(ops/kernels.py), which counts with ``__popc``.

BSI algorithms are the bit-sliced routines of reference fragment.go:
565-837 (sum/min/max/rangeEQ/NEQ/LT/GT/Between), re-derived for bitplanes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BITS_PER_WORD, SHARD_WIDTH

# ------------------------------------------------------------- host packing


def pack_bits(cols: np.ndarray, width: int = SHARD_WIDTH) -> np.ndarray:
    """Pack sorted column ids (< width) into a uint32 bitplane (host).

    Uses the native C++ kernel when built (np.bitwise_or.at is an order of
    magnitude slower); numpy fallback otherwise.
    """
    n_words = width // BITS_PER_WORD
    if len(cols):
        from .. import native

        packed = native.pack_bits(np.asarray(cols, dtype=np.uint32), n_words)
        if packed is not None:
            return packed
    words = np.zeros(n_words, dtype=np.uint32)
    if len(cols):
        cols = np.asarray(cols, dtype=np.uint32)
        np.bitwise_or.at(words, cols >> 5, np.uint32(1) << (cols & np.uint32(31)))
    return words


def unpack_bits(plane: np.ndarray) -> np.ndarray:
    """Bitplane -> ascending uint64 column ids (numpy, host)."""
    plane = np.ascontiguousarray(np.asarray(plane, dtype=np.uint32))
    from .. import native

    if native.available():
        out = native.unpack_bits(plane)
        if out is not None:
            return out
    bits = np.unpackbits(plane.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint64)


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor on `device`, bit for bit. Always
    copies, so the tensor never aliases storage that a writer (or an
    mmap'd fragment file) may change underneath it."""
    host = np.array(words, dtype=np.uint32, copy=True).view(np.int32)
    return torch.from_numpy(host).to(device)


def to_numpy(plane: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> uint32 numpy words, bit for bit."""
    return plane.detach().cpu().contiguous().numpy().view(np.uint32)


# ------------------------------------------------------------- basic algebra


def p_and(a, b):
    return torch.bitwise_and(a, b)


def p_or(a, b):
    return torch.bitwise_or(a, b)


def p_andnot(a, b):
    return torch.bitwise_and(a, torch.bitwise_not(b))


def p_xor(a, b):
    return torch.bitwise_xor(a, b)


def popcount_words(plane: torch.Tensor) -> torch.Tensor:
    """Elementwise popcounts of int32 words (as int64), the plain SWAR
    formula. The words are widened to their unsigned value in int64 first,
    so no shift below ever sees a sign bit and no sum overflows."""
    x = plane.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(plane) -> torch.Tensor:
    """Total set bits. Sums over the trailing word axis; keeps leading axes
    (int32: per-shard counts are <= 2^20 per row)."""
    if plane.is_cuda:
        from . import kernels

        w = plane.shape[-1]
        flat = plane.reshape(-1, 1, w)
        out = kernels.masked_plane_counts(flat, None)
        return out.reshape(plane.shape[:-1])
    return popcount_words(plane).sum(dim=-1).to(torch.int32)


def intersection_count(a, b) -> torch.Tensor:
    """popcount(a & b)."""
    return popcount(torch.bitwise_and(a, b))


def row_counts(planes, filter_plane=None) -> torch.Tensor:
    """Per-row counts of a (R, W) stack, optionally ANDed with a (W,) filter.

    This is the TopN inner loop (reference fragment.go:870-1058): all candidate
    rows are counted in one batched popcount instead of a per-row heap walk.
    On the card the AND and the count are one pass of masked_plane_counts;
    the masked stack is never materialized.
    """
    if planes.is_cuda:
        from . import kernels

        mask = None if filter_plane is None else filter_plane.reshape(1, -1)
        out = kernels.masked_plane_counts(planes.unsqueeze(1), mask)
        return out.reshape(planes.shape[0])
    if filter_plane is not None:
        planes = torch.bitwise_and(planes, filter_plane[None, :])
    return popcount(planes)


# ----------------------------------------------------------------- BSI ops


def bsi_plane_counts(planes, filter_plane=None) -> torch.Tensor:
    """Per-plane popcounts for BSI sum (reference fragment.go:565-600).

    planes: (bit_depth + 1, W) — planes[i] is value-bit i, planes[bit_depth]
    is the not-null row. Returns (bit_depth + 1,) int32 counts; the weighted
    sum(2^i * counts[i]) is composed on host in Python ints to avoid overflow.
    """
    return row_counts(planes, filter_plane)


def bsi_min(planes, bit_depth: int, filter_plane=None):
    """Min over a BSI group (reference fragment.go:603-637).

    Returns (bits, count): bits is (bit_depth,) int32 0/1 — bit i of the min —
    and count is how many columns hold that min. Branch-free: each step keeps
    `consider` = columns still able to be minimal.
    """
    consider = planes[bit_depth]
    if filter_plane is not None:
        consider = torch.bitwise_and(consider, filter_plane)
    bits = []
    for i in range(bit_depth - 1, -1, -1):
        x = p_andnot(consider, planes[i])
        nonzero = popcount(x) > 0
        bits.append(torch.logical_not(nonzero).to(torch.int32))
        consider = torch.where(nonzero, x, consider)
    bits = (torch.stack(bits[::-1]) if bits
            else torch.zeros((0,), dtype=torch.int32, device=planes.device))
    return bits, popcount(consider)


def bsi_max(planes, bit_depth: int, filter_plane=None):
    """Max over a BSI group (reference fragment.go:640-657)."""
    consider = planes[bit_depth]
    if filter_plane is not None:
        consider = torch.bitwise_and(consider, filter_plane)
    bits = []
    for i in range(bit_depth - 1, -1, -1):
        x = torch.bitwise_and(planes[i], consider)
        nonzero = popcount(x) > 0
        bits.append(nonzero.to(torch.int32))
        consider = torch.where(nonzero, x, consider)
    bits = (torch.stack(bits[::-1]) if bits
            else torch.zeros((0,), dtype=torch.int32, device=planes.device))
    return bits, popcount(consider)


def bsi_range_eq(planes, bit_depth: int, predicate: int):
    """Columns whose value == predicate (reference fragment.go:683-699)."""
    b = planes[bit_depth]
    for i in range(bit_depth - 1, -1, -1):
        if (predicate >> i) & 1:
            b = torch.bitwise_and(b, planes[i])
        else:
            b = p_andnot(b, planes[i])
    return b


def bsi_range_neq(planes, bit_depth: int, predicate: int):
    """not-null minus EQ (reference fragment.go:701-714)."""
    return p_andnot(planes[bit_depth], bsi_range_eq(planes, bit_depth, predicate))


def bsi_range_lt(planes, bit_depth: int, predicate: int, allow_equality: bool):
    """Columns whose value < (or <=) predicate (reference fragment.go:716-762)."""
    zero = torch.zeros_like(planes[bit_depth])
    keep = zero
    b = planes[bit_depth]
    leading_zeros = True
    for i in range(bit_depth - 1, -1, -1):
        row = planes[i]
        bit = (predicate >> i) & 1
        if leading_zeros:
            if bit == 0:
                b = p_andnot(b, row)
                continue
            leading_zeros = False
        if i == 0 and not allow_equality:
            if bit == 0:
                return keep
            return p_andnot(b, p_andnot(row, keep))
        if bit == 0:
            b = p_andnot(b, p_andnot(row, keep))
            continue
        if i > 0:
            keep = torch.bitwise_or(keep, p_andnot(b, row))
    return b


def bsi_range_gt(planes, bit_depth: int, predicate: int, allow_equality: bool):
    """Columns whose value > (or >=) predicate (reference fragment.go:764-800)."""
    zero = torch.zeros_like(planes[bit_depth])
    keep = zero
    b = planes[bit_depth]
    for i in range(bit_depth - 1, -1, -1):
        row = planes[i]
        bit = (predicate >> i) & 1
        if i == 0 and not allow_equality:
            if bit == 1:
                return keep
            return p_andnot(b, p_andnot(p_andnot(b, row), keep))
        if bit == 1:
            b = p_andnot(b, p_andnot(p_andnot(b, row), keep))
            continue
        if i > 0:
            keep = torch.bitwise_or(keep, torch.bitwise_and(b, row))
    return b


def bsi_range_between(planes, bit_depth: int, pmin: int, pmax: int):
    """Columns with pmin <= value <= pmax (reference fragment.go:812-851)."""
    zero = torch.zeros_like(planes[bit_depth])
    b = planes[bit_depth]
    keep1 = zero  # GTE side
    keep2 = zero  # LTE side
    for i in range(bit_depth - 1, -1, -1):
        row = planes[i]
        bit1 = (pmin >> i) & 1
        bit2 = (pmax >> i) & 1
        if bit1 == 1:
            b = p_andnot(b, p_andnot(p_andnot(b, row), keep1))
        elif i > 0:
            keep1 = torch.bitwise_or(keep1, torch.bitwise_and(b, row))
        if bit2 == 0:
            b = p_andnot(b, p_andnot(row, keep2))
        elif i > 0:
            keep2 = torch.bitwise_or(keep2, p_andnot(b, row))
    return b


# ------------------------------------------------------------ entry points

# Names kept from the JAX package, where these were jitted wrappers; in
# PyTorch, which runs eagerly, they are the functions themselves.
and_count = intersection_count
count = popcount
topn_counts = row_counts


def compose_bits(bits) -> int:
    """(bit_depth,) 0/1 vector -> python int value (host, overflow-safe)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return sum((1 << i) for i, b in enumerate(np.asarray(bits)) if b)
