"""Host-side 64-bit bitmap with roaring-compatible serialization.

This is the *cold* / interchange representation: the on-disk format is
byte-compatible with the reference's roaring files (cookie 12348; see
reference roaring/roaring.go:29-64 WriteTo/UnmarshalBinary and
docs/architecture.md). On-device compute never touches this structure —
fragments materialize dense uint32 bitplanes in HBM (see ops/bitplane.py);
this class exists for persistence, imports, WAL replay, and as a numpy
oracle for kernel tests.

Containers are three-way, mirroring the reference's array/bitmap/run
forms (roaring/roaring.go:988-1061): a sorted np.uint16 array while sparse
(≤4096 values, ≤8KiB), a 1024-word uint64 bitset once dense (8KiB flat,
O(1) point ops), and an (R, 2) [start, last] run-interval array for
RLE-heavy data — a fully-set container is 4 bytes of runs instead of 8KiB,
so adversarial imports of huge contiguous ranges stay memory-bounded
(reference computes on runs too, roaring.go:1906-1949). Runs are a
compute+memory form here: count/contains/range/intersection-count operate
on intervals directly; point mutations convert to the flat forms
(re-runified on the next bulk op or optimize()). The dense form is what
lets imports of billions of bits run at memory bandwidth instead of O(n)
numpy inserts, and lets row planes be assembled by copying words instead
of re-packing value lists.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..errors import CorruptFragmentError

MAGIC_NUMBER = 12348
STORAGE_VERSION = 0
COOKIE = MAGIC_NUMBER + (STORAGE_VERSION << 16)
HEADER_BASE_SIZE = 8
BITMAP_N = (1 << 16) // 64  # words per bitset container

CONTAINER_ARRAY = 1
CONTAINER_BITMAP = 2
CONTAINER_RUN = 3

ARRAY_MAX_SIZE = 4096
RUN_MAX_SIZE = 2048

OP_ADD = 0
OP_REMOVE = 1
OP_SIZE = 1 + 8 + 4

# Bulk WAL record: one append per import batch instead of a snapshot —
# the record that makes ingest cost O(batch) instead of O(fragment).
# Layout: <B typ> <I n_add> <I n_remove> adds(<u8 * n_add)
# removes(<u8 * n_remove) <I crc32-of-preceding>. One record covers
# bulk-set (n_remove=0), bulk-clear (n_add=0), and BSI imports (both:
# per-plane on/off positions are disjoint, so replay order within the
# record doesn't matter) — replay is atomic per record, exactly like the
# 13-byte point ops. Checksum is zlib.crc32, not fnv32a: the fnv loop is
# pure Python and would cost more than the import it protects on a
# megabyte record.
OP_BULK = 2
_BULK_HEADER = struct.Struct("<BII")
BULK_MIN_SIZE = _BULK_HEADER.size + 4

_WORD_ONE = np.uint64(1)


def fnv32a(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def _empty() -> np.ndarray:
    return np.empty(0, dtype=np.uint16)


def _popcount(words: np.ndarray) -> int:
    return int(np.bitwise_count(words).sum())


def _arr_to_words(arr: np.ndarray) -> np.ndarray:
    """Sorted uint16 values -> 1024-word uint64 bitset. Bool-scatter +
    packbits runs at C speed (np.bitwise_or.at is an order of magnitude
    slower on duplicate-free scatters)."""
    bools = np.zeros(1 << 16, dtype=bool)
    if len(arr):
        bools[arr] = True
    return np.packbits(bools, bitorder="little").view(np.uint64).copy()


def _words_to_arr(words: np.ndarray) -> np.ndarray:
    """1024-word uint64 bitset -> sorted uint16 values."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _in_bits(words: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """Boolean mask: which of the sorted uint16 `arr` are set in `words`."""
    idx = arr.astype(np.uint32)
    return (words[idx >> 6] >> (idx & np.uint32(63)).astype(np.uint64)) & _WORD_ONE != 0




def _merge_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted unique uint16 arrays in O(n + m log n):
    searchsorted + one vectorized insert (memmove), replacing union1d's
    concatenate-and-full-sort — the dominant cost of small incremental
    batches landing on populated containers."""
    if not len(a):
        return np.ascontiguousarray(b, dtype=np.uint16)
    if not len(b):
        return a
    idx = np.searchsorted(a, b)
    hit = idx < len(a)
    hit[hit] = a[idx[hit]] == b[hit]
    new = b[~hit]
    if not len(new):
        return a
    return np.insert(a, idx[~hit], new)


def _runs_of_array(c: np.ndarray) -> np.ndarray:
    """Sorted uint16 values -> (r, 2) [start, last] inclusive run pairs."""
    if len(c) == 0:
        return np.empty((0, 2), dtype=np.uint16)
    brk = np.flatnonzero(np.diff(c.astype(np.int32)) != 1)
    starts = np.concatenate(([0], brk + 1))
    lasts = np.concatenate((brk, [len(c) - 1]))
    return np.stack([c[starts], c[lasts]], axis=1)


def _runs_n(runs: np.ndarray) -> int:
    return int((runs[:, 1].astype(np.int64) - runs[:, 0] + 1).sum())


def _runs_to_arr(runs: np.ndarray) -> np.ndarray:
    if len(runs) == 0:
        return _empty()
    return np.concatenate(
        [np.arange(int(s), int(l) + 1, dtype=np.uint32) for s, l in runs]
    ).astype(np.uint16)


def _runs_to_words(runs: np.ndarray) -> np.ndarray:
    bools = np.zeros(1 << 16, dtype=bool)
    for s, l in runs:
        bools[int(s) : int(l) + 1] = True
    return np.packbits(bools, bitorder="little").view(np.uint64).copy()


def _bits_run_count(words: np.ndarray) -> int:
    """Number of runs in a bitset = popcount of run-start bits (a set bit
    whose predecessor is clear), without materializing the value list."""
    shifted = (words << _WORD_ONE) | np.concatenate(
        ([np.uint64(0)], words[:-1] >> np.uint64(63))
    )
    return _popcount(words & ~shifted)



class Container:
    """One 2^16-bit block: sorted uint16 array (sparse), uint64 bitset
    (dense), or (r, 2) [start, last] run intervals (RLE-heavy). `n` is
    always the exact cardinality."""

    __slots__ = ("arr", "bits", "runs", "n", "nv")

    def __init__(self, arr: Optional[np.ndarray] = None,
                 bits: Optional[np.ndarray] = None, n: Optional[int] = None,
                 runs: Optional[np.ndarray] = None):
        self.arr = arr
        self.bits = bits
        self.runs = runs
        if n is None:
            if arr is not None:
                n = len(arr)
            elif runs is not None:
                n = _runs_n(runs)
            else:
                n = _popcount(bits)
        self.n = n
        # n-verified: False only for lazily-opened bitset containers whose
        # header cardinality was trusted without paging in the payload
        # (Bitmap.from_buffer copy=False); verify_n() settles it on first use.
        self.nv = True

    def verify_n(self) -> None:
        """Validate a header-trusted cardinality on first touch: the mmap
        open path (fragment.open -> from_buffer copy=False) trusts the
        on-disk n so open stays O(headers); the first count/mutation of the
        container recomputes the popcount and raises on mismatch, so a
        corrupt file is detected instead of silently poisoning count math."""
        if self.nv:
            return
        real = _popcount(self.bits)
        if real != self.n:
            # Leave nv False so EVERY touch keeps raising — a caller that
            # catches one error must not get silently-poisoned counts next.
            raise CorruptFragmentError(
                f"corrupt bitmap container: header cardinality {self.n} != "
                f"payload popcount {real}"
            )
        self.nv = True

    # ------------------------------------------------------------ factories

    @classmethod
    def from_sorted(cls, arr: np.ndarray) -> "Container":
        """From a sorted unique uint16 array; picks the right form
        (including runs when at most half the flat size)."""
        if len(arr) > ARRAY_MAX_SIZE:
            c = cls(bits=_arr_to_words(arr), n=len(arr))
        else:
            c = cls(arr=np.ascontiguousarray(arr, dtype=np.uint16))
        c._maybe_runify()
        return c

    # --------------------------------------------------------------- views

    def to_array(self) -> np.ndarray:
        """Sorted uint16 values (materializes from a bitset / runs)."""
        if self.arr is not None:
            return self.arr
        if self.runs is not None:
            return _runs_to_arr(self.runs)
        return _words_to_arr(self.bits)

    def as_words(self) -> np.ndarray:
        """1024-word uint64 bitset view (materializes from array / runs)."""
        if self.bits is not None:
            return self.bits
        if self.runs is not None:
            return _runs_to_words(self.runs)
        return _arr_to_words(self.arr)

    def run_pairs(self) -> np.ndarray:
        """(r, 2) [start, last] inclusive run view (computed for flat
        forms; free for run containers)."""
        return self.runs if self.runs is not None else _runs_of_array(self.to_array())

    def run_count_lazy(self):
        """(run count, run pairs or None): the count without materializing
        a bitmap container's value list (one popcount pass). Callers that
        decide the run form WINS call run_pairs() then — sizing a form
        must not cost a conversion (this dominated snapshot time)."""
        if self.runs is not None:
            return len(self.runs), self.runs
        if self.arr is not None:
            runs = _runs_of_array(self.arr)
            return len(runs), runs
        return _bits_run_count(self.bits), None

    # ----------------------------------------------------- form management

    def _maybe_densify(self) -> None:
        if self.arr is not None and self.n > ARRAY_MAX_SIZE:
            self.bits = _arr_to_words(self.arr)
            self.arr = None

    def _maybe_sparsify(self) -> None:
        # Hysteresis at half the threshold so add/remove churn around the
        # boundary doesn't convert back and forth (the reference converts
        # eagerly at the boundary; we keep its serialized form identical).
        if self.bits is not None and self.n <= ARRAY_MAX_SIZE // 2:
            self.arr = _words_to_arr(self.bits)
            self.bits = None

    def _flatten_runs(self) -> None:
        """Convert the run form to array/bitset before a point mutation.
        Deliberately NOT re-runified here: WAL replay applies ops one at a
        time, and converting back per op would be O(n) per bit. Bulk ops
        and optimize() re-compress."""
        if self.runs is None:
            return
        if self.n <= ARRAY_MAX_SIZE:
            self.arr = _runs_to_arr(self.runs)
        else:
            self.bits = _runs_to_words(self.runs)
        self.runs = None

    def _maybe_runify(self) -> None:
        """Adopt the run form when it is at most half the size of the
        current form (hysteresis, like _maybe_sparsify) — a fully-set
        container drops from 8 KiB to 4 bytes, which is what keeps
        adversarial contiguous imports memory-bounded."""
        if self.runs is not None or self.n == 0:
            return
        if self.bits is not None and not self.nv:
            return  # lazily-opened: don't page in to maybe-compress
        cur_bytes = 2 * self.n if self.arr is not None else 8 * BITMAP_N
        r, runs = self.run_count_lazy()
        if r <= RUN_MAX_SIZE and 4 * r * 2 <= cur_bytes:
            self.runs = runs if runs is not None else _runs_of_array(self.to_array())
            self.arr = None
            self.bits = None

    def _mutable_bits(self) -> np.ndarray:
        """Copy-on-write: bitset payloads parsed zero-copy from an mmap (or
        bytes) are read-only views; the first in-place mutation promotes
        them to a private copy."""
        if not self.bits.flags.writeable:
            self.bits = self.bits.copy()
        return self.bits

    # ------------------------------------------------------------ point ops

    def add(self, low: int) -> bool:
        self.verify_n()
        if self.runs is not None:
            if self.contains(low):
                return False
            self._flatten_runs()
        if self.bits is not None:
            w, b = low >> 6, np.uint64(low & 63)
            if (self.bits[w] >> b) & _WORD_ONE:
                return False
            self._mutable_bits()[w] |= _WORD_ONE << b
            self.n += 1
            return True
        c = self.arr
        i = int(np.searchsorted(c, np.uint16(low)))
        if i < len(c) and c[i] == low:
            return False
        self.arr = np.insert(c, i, np.uint16(low))
        self.n += 1
        self._maybe_densify()
        return True

    def remove(self, low: int) -> bool:
        self.verify_n()
        if self.runs is not None:
            if not self.contains(low):
                return False
            self._flatten_runs()
        if self.bits is not None:
            w, b = low >> 6, np.uint64(low & 63)
            if not (self.bits[w] >> b) & _WORD_ONE:
                return False
            self._mutable_bits()[w] &= ~(_WORD_ONE << b)
            self.n -= 1
            self._maybe_sparsify()
            return True
        c = self.arr
        i = int(np.searchsorted(c, np.uint16(low)))
        if i >= len(c) or c[i] != low:
            return False
        self.arr = np.delete(c, i)
        self.n -= 1
        return True

    def contains(self, low: int) -> bool:
        if self.runs is not None:
            i = int(np.searchsorted(self.runs[:, 0], np.uint16(low), "right")) - 1
            return i >= 0 and low <= int(self.runs[i, 1])
        if self.bits is not None:
            return bool((self.bits[low >> 6] >> np.uint64(low & 63)) & _WORD_ONE)
        i = int(np.searchsorted(self.arr, np.uint16(low)))
        return i < len(self.arr) and self.arr[i] == low

    # ------------------------------------------------------------- bulk ops

    def add_sorted(self, chunk: np.ndarray) -> None:
        """Union in a sorted unique uint16 chunk."""
        self.verify_n()
        self._flatten_runs()
        if self.bits is None and self.n + len(chunk) > ARRAY_MAX_SIZE:
            self._force_densify()
        if self.bits is not None:
            bits = self._mutable_bits()
            bits |= _arr_to_words(chunk)
            self.n = _popcount(bits)
        else:
            self.arr = _merge_sorted(self.arr, chunk)
            self.n = len(self.arr)
            self._maybe_densify()
        # Re-compression probe only when the chunk rewrote a meaningful
        # fraction of the container: the probe is O(n) (a run walk /
        # popcount pass), and small incremental batches used to pay it on
        # EVERY touch just to rediscover that random data never runifies.
        # Adversarial contiguous imports still compress mid-import —
        # add_many chunks per container, so a range import lands as one
        # big chunk — and everything else re-compresses at
        # optimize()/snapshot time.
        if 4 * len(chunk) >= self.n:
            self._maybe_runify()

    def remove_sorted(self, chunk: np.ndarray) -> None:
        self.verify_n()
        self._flatten_runs()
        if self.bits is not None:
            bits = self._mutable_bits()
            bits &= ~_arr_to_words(chunk)
            self.n = _popcount(bits)
            self._maybe_sparsify()
        else:
            self.arr = np.setdiff1d(self.arr, chunk, assume_unique=True)
            self.n = len(self.arr)
        if 4 * len(chunk) >= self.n:
            self._maybe_runify()

    def _force_densify(self) -> None:
        self.bits = _arr_to_words(self.arr)
        self.arr = None

    # ---------------------------------------------------------- range reads

    def count_range(self, lo: int, hi: int) -> int:
        """Set bits in [lo, hi); hi may be 65536."""
        if lo <= 0 and hi >= 1 << 16:
            self.verify_n()
            return self.n
        if self.runs is not None:
            s = self.runs[:, 0].astype(np.int64)
            l = self.runs[:, 1].astype(np.int64)
            overlap = np.minimum(l, hi - 1) - np.maximum(s, lo) + 1
            return int(overlap[overlap > 0].sum())
        if self.arr is not None:
            i = np.searchsorted(self.arr, np.uint16(lo)) if lo > 0 else 0
            j = np.searchsorted(self.arr, np.uint16(hi)) if hi < (1 << 16) else len(self.arr)
            return int(j - i)
        wl, wh = lo >> 6, (hi + 63) >> 6
        words = self.bits[wl:wh].copy()
        if lo & 63:
            words[0] &= ~np.uint64(0) << np.uint64(lo & 63)
        if hi & 63:
            words[-1] &= (_WORD_ONE << np.uint64(hi & 63)) - _WORD_ONE
        return _popcount(words)

    def slice_range(self, lo: int, hi: int) -> np.ndarray:
        """Sorted uint16 values in [lo, hi)."""
        arr = self.to_array()
        if lo <= 0 and hi >= 1 << 16:
            return arr
        i = np.searchsorted(arr, np.uint16(lo)) if lo > 0 else 0
        j = np.searchsorted(arr, np.uint16(hi)) if hi < (1 << 16) else len(arr)
        return arr[i:j]

    # -------------------------------------------------------------- algebra

    def intersection_count(self, other: "Container") -> int:
        a, b = self, other
        if a.runs is not None or b.runs is not None:
            return self._intersection_count_runs(other)
        if a.bits is not None and b.bits is not None:
            return _popcount(a.bits & b.bits)
        if a.arr is not None and b.arr is not None:
            from .. import native

            if native.available():
                return native.intersection_count_u16(a.arr, b.arr)
            return len(np.intersect1d(a.arr, b.arr, assume_unique=True))
        arr, bits = (a.arr, b.bits) if a.arr is not None else (b.arr, a.bits)
        return int(np.count_nonzero(_in_bits(bits, arr))) if len(arr) else 0

    def _intersection_count_runs(self, other: "Container") -> int:
        """Run-aware |a ∩ b| without materializing either side, the
        in-memory analog of the reference's intersectionCount*Run family
        (roaring.go:1906-1949): run x run sums clipped interval overlaps
        over the (linear) set of overlapping run pairs; run x array is a
        vectorized interval membership test; run x bitset clips per-run
        word popcounts."""
        a, b = self, other
        if a.runs is None:
            a, b = b, a  # a has runs now
        if b.runs is not None:
            ra, rb = a.runs, b.runs
            if len(ra) == 0 or len(rb) == 0:
                return 0
            # For each a-run, the b-runs overlapping it are a contiguous
            # span [jlo, jhi); total overlapping pairs is O(Ra + Rb).
            jlo = np.searchsorted(rb[:, 1], ra[:, 0], "left")
            jhi = np.searchsorted(rb[:, 0], ra[:, 1], "right")
            reps = (jhi - jlo).clip(min=0)
            ai = np.repeat(np.arange(len(ra)), reps)
            bi = np.concatenate(
                [np.arange(l, h) for l, h in zip(jlo, jhi) if h > l]
            ) if reps.sum() else np.empty(0, dtype=np.int64)
            if len(ai) == 0:
                return 0
            s = np.maximum(ra[ai, 0].astype(np.int64), rb[bi, 0].astype(np.int64))
            l = np.minimum(ra[ai, 1].astype(np.int64), rb[bi, 1].astype(np.int64))
            overlap = l - s + 1
            return int(overlap[overlap > 0].sum())
        if b.arr is not None:
            arr = b.arr
            if len(arr) == 0 or len(a.runs) == 0:
                return 0
            i = np.searchsorted(a.runs[:, 0], arr, "right") - 1
            ok = i >= 0
            ok[ok] &= arr[ok] <= a.runs[i[ok], 1]
            return int(np.count_nonzero(ok))
        # runs x bitset: clip each run's words against the bitset.
        total = 0
        words = b.bits
        for s, l in a.runs:
            s, l = int(s), int(l)
            wl, wh = s >> 6, (l >> 6) + 1
            chunk = words[wl:wh].copy()
            if s & 63:
                chunk[0] &= ~np.uint64(0) << np.uint64(s & 63)
            if (l & 63) != 63:
                chunk[-1] &= (_WORD_ONE << np.uint64((l & 63) + 1)) - _WORD_ONE
            total += _popcount(chunk)
        return total

    def _binop_words(self, other: "Container", op) -> "Container":
        words = op(self.as_words(), other.as_words())
        n = _popcount(words)
        if n <= ARRAY_MAX_SIZE:
            c = Container(arr=_words_to_arr(words), n=n)
        else:
            c = Container(bits=words, n=n)
        c._maybe_runify()
        return c

    def union(self, other: "Container") -> "Container":
        if self.arr is not None and other.arr is not None:
            return Container.from_sorted(_np_or_native("union_u16", np.union1d)(self.arr, other.arr))
        return self._binop_words(other, np.bitwise_or)

    def intersect(self, other: "Container") -> "Container":
        if self.arr is not None and other.arr is not None:
            fn = _np_or_native(
                "intersect_u16", lambda a, b: np.intersect1d(a, b, assume_unique=True)
            )
            return Container.from_sorted(fn(self.arr, other.arr))
        if self.arr is not None or other.arr is not None:
            arr, dense = (self.arr, other) if self.arr is not None else (other.arr, self)
            bits = dense.as_words()
            return Container.from_sorted(arr[_in_bits(bits, arr)] if len(arr) else _empty())
        return self._binop_words(other, np.bitwise_and)

    def difference(self, other: "Container") -> "Container":
        if self.arr is not None:
            if other.arr is not None:
                fn = _np_or_native(
                    "difference_u16", lambda a, b: np.setdiff1d(a, b, assume_unique=True)
                )
                return Container.from_sorted(fn(self.arr, other.arr))
            return Container.from_sorted(
                self.arr[~_in_bits(other.as_words(), self.arr)] if len(self.arr) else _empty()
            )
        return self._binop_words(other, lambda a, b: a & ~b)

    def xor(self, other: "Container") -> "Container":
        if self.arr is not None and other.arr is not None:
            return Container.from_sorted(_np_or_native("xor_u16", np.setxor1d)(self.arr, other.arr))
        return self._binop_words(other, np.bitwise_xor)

    # ------------------------------------------------------------- plumbing

    def copy(self) -> "Container":
        if self.runs is not None:
            return Container(runs=self.runs.copy(), n=self.n)
        if self.bits is not None:
            c = Container(bits=self.bits.copy(), n=self.n)
            c.nv = self.nv  # an unverified n must not launder through a copy
            return c
        return Container(arr=self.arr.copy(), n=self.n)

    def __len__(self) -> int:
        return self.n

    def __eq__(self, other) -> bool:
        if not isinstance(other, Container):
            return NotImplemented
        if self.n != other.n:
            return False
        if self.bits is not None and other.bits is not None:
            return bool(np.array_equal(self.bits, other.bits))
        return bool(np.array_equal(self.to_array(), other.to_array()))

    def __hash__(self):  # pragma: no cover - containers are not hashable keys
        raise TypeError("Container is unhashable")

    def check(self, key) -> List[str]:
        problems = []
        if self.runs is not None:
            r = self.runs
            if len(r) == 0:
                problems.append(f"{key}: empty container present")
                return problems
            if self.n != _runs_n(r):
                problems.append(f"{key}: cardinality {self.n} != run total")
            s = r[:, 0].astype(np.int64)
            l = r[:, 1].astype(np.int64)
            if np.any(l < s):
                problems.append(f"{key}: run with last < start")
            # Consecutive runs must be ascending AND non-adjacent (adjacent
            # runs should have been coalesced into one).
            if len(r) > 1 and np.any(s[1:] <= l[:-1] + 1):
                problems.append(f"{key}: runs overlapping or adjacent")
            return problems
        if self.bits is not None:
            if len(self.bits) != BITMAP_N:
                problems.append(f"{key}: bitset has {len(self.bits)} words")
            elif self.n != _popcount(self.bits):
                problems.append(f"{key}: cardinality {self.n} != popcount")
            elif self.n == 0:
                problems.append(f"{key}: empty container present")
            return problems
        c = self.arr
        if len(c) == 0:
            problems.append(f"{key}: empty container present")
            return problems
        if c.dtype != np.uint16:
            problems.append(f"{key}: wrong dtype {c.dtype}")
        if self.n != len(c):
            problems.append(f"{key}: cardinality {self.n} != len {len(c)}")
        diffs = np.diff(c.astype(np.int32))
        if np.any(diffs <= 0):
            problems.append(f"{key}: values not strictly ascending")
        return problems


def _np_or_native(native_name: str, fallback):
    from .. import native

    fn = getattr(native, native_name, None) if native.available() else None
    return fn if fn is not None else fallback


def _as_container(c) -> Container:
    """Accept raw sorted uint16 ndarrays wherever a Container is expected
    (older callers and tests hand those in directly)."""
    return c if isinstance(c, Container) else Container(arr=np.asarray(c, dtype=np.uint16))


# Pluggable container-store backend (the reference's Containers interface,
# roaring.go:66-99). Default is a plain dict; the B+tree store
# (btree_containers.BTreeContainers) can be swapped in globally — the
# equivalent of the enterprise build-tag swap
# `roaring.NewFileBitmap = b.NewBTreeBitmap` (enterprise/enterprise.go:31).
_CONTAINER_FACTORY = dict


def set_container_factory(factory) -> None:
    global _CONTAINER_FACTORY
    _CONTAINER_FACTORY = factory


def get_container_factory():
    return _CONTAINER_FACTORY


from collections.abc import MutableMapping


class _ContainerMap(MutableMapping):
    """Thin wrapper around the container store that notifies the owning
    Bitmap when the *key set* changes, keeping the sorted-key cache honest
    even for callers that assign `bm.containers[key] = ...` directly."""

    __slots__ = ("store", "_on_keys_changed")

    def __init__(self, store, on_keys_changed):
        self.store = store
        self._on_keys_changed = on_keys_changed

    def __getitem__(self, key):
        return self.store[key]

    def __setitem__(self, key, value):
        if key not in self.store:
            self._on_keys_changed()
        self.store[key] = value

    def __delitem__(self, key):
        del self.store[key]
        self._on_keys_changed()

    def __iter__(self):
        return iter(self.store)

    def __len__(self):
        return len(self.store)


class Bitmap:
    """Two-form-container bitmap over uint64 values."""

    __slots__ = ("containers", "op_n", "_skeys", "valid_len",
                 "truncated_bytes", "ops_bytes", "_cow", "_cow_refs")

    def __init__(self, values=None):
        # key (value >> 16) -> Container of low 16 bits
        self.containers = _ContainerMap(_CONTAINER_FACTORY(), self._inval_keys)
        self.op_n = 0
        # Torn-tail recovery bookkeeping, set by from_buffer: byte length of
        # the last valid record boundary, and how many trailing bytes past
        # it were discarded (0 = the whole buffer parsed clean).
        self.valid_len = 0
        self.truncated_bytes = 0
        # Bytes of the valid region occupied by op-log records (the rest is
        # the container section) — seeds the fragment's snapshot-trigger
        # accounting across a reopen.
        self.ops_bytes = 0
        self._skeys: Optional[np.ndarray] = None  # sorted key cache
        # Keys whose containers are shared with a cow_clone() snapshot: the
        # next mutation of such a container copies it first, so the clone
        # stays frozen while live writes proceed (background snapshots,
        # migration base streams). Refcounted: a background snapshot and a
        # migration begin can hold clones simultaneously, and one clone's
        # release must not strip the other's protection.
        self._cow: Optional[set] = None
        self._cow_refs = 0
        if values is not None:
            self.add_many(np.asarray(values, dtype=np.uint64))

    # ------------------------------------------------------- key management

    def _inval_keys(self) -> None:
        self._skeys = None

    def _put(self, key: int, c: Container) -> None:
        self.containers[key] = c

    def _drop(self, key: int) -> None:
        self.containers.pop(key, None)

    def _sorted_keys(self) -> np.ndarray:
        if self._skeys is None:
            self._skeys = np.array(sorted(self.containers), dtype=np.int64)
        return self._skeys

    def _live(self, key) -> Optional[Container]:
        """Container for key, upgraded in place if stored as a raw ndarray
        (legacy callers/tests) so mutations are not lost. The single
        gateway every mutation path flows through, which is what makes
        copy-on-write snapshots sound: a container shared with a
        cow_clone() is copied here before its first post-snapshot
        mutation."""
        c = self.containers.get(key)
        if c is None:
            return None
        if not isinstance(c, Container):
            c = _as_container(c)
            self.containers[key] = c
        if self._cow and key in self._cow:
            self._cow.discard(key)
            c = c.copy()
            self.containers[key] = c
        return c

    def cow_clone(self) -> "Bitmap":
        """Shallow snapshot sharing Container objects with this bitmap.
        O(container count), not O(bytes): the handoff a background
        snapshot or a migration base stream takes under a brief mutex
        hold. After the clone, this (live) bitmap copies any shared
        container before mutating it, so the clone observes a frozen
        point-in-time state while writes proceed. The clone itself must
        be treated as read-only, and the caller must pair the clone with
        cow_release() once done serializing. Clones stack: a second
        clone re-arms every current key (copied-then-mutated containers
        included — the new clone references the current objects), and
        protection drops only when the LAST clone releases."""
        b = Bitmap()
        items = list(self.containers.items())
        for k, c in items:
            b.containers[k] = c
        keys = {k for k, _ in items}
        self._cow = keys if self._cow is None else (self._cow | keys)
        self._cow_refs += 1
        return b

    def cow_release(self) -> None:
        """Drop one cow_clone()'s copy-on-write protection. Must be
        called under the owning fragment's mutex (like cow_clone)."""
        self._cow_refs = max(0, self._cow_refs - 1)
        if self._cow_refs == 0:
            self._cow = None

    # ------------------------------------------------------------------ basic

    def add(self, value: int) -> bool:
        key, low = value >> 16, int(value) & 0xFFFF
        c = self._live(key)
        if c is None:
            self._put(key, Container(arr=np.array([low], dtype=np.uint16)))
            return True
        return c.add(low)

    def remove(self, value: int) -> bool:
        key, low = value >> 16, int(value) & 0xFFFF
        c = self._live(key)
        if c is None:
            return False
        if not c.remove(low):
            return False
        if c.n == 0:
            self._drop(key)
        return True

    def contains(self, value: int) -> bool:
        key, low = value >> 16, int(value) & 0xFFFF
        c = self.containers.get(key)
        return c is not None and _as_container(c).contains(low)

    def _chunked(self, values: np.ndarray):
        """Yield (key, sorted unique uint16 chunk) per container key."""
        values = np.unique(np.asarray(values, dtype=np.uint64))
        keys = values >> np.uint64(16)
        lows = (values & np.uint64(0xFFFF)).astype(np.uint16)
        boundaries = np.flatnonzero(np.diff(keys)) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [len(values)]))
        for s, e in zip(starts, ends):
            yield int(keys[s]), lows[s:e]

    def add_many(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        for key, chunk in self._chunked(values):
            c = self._live(key)
            if c is None:
                self._put(key, Container.from_sorted(chunk.copy()))
            else:
                c.add_sorted(chunk)

    def remove_many(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        for key, chunk in self._chunked(values):
            c = self._live(key)
            if c is None:
                continue
            c.remove_sorted(chunk)
            if c.n == 0:
                self._drop(key)

    def count(self) -> int:
        total = 0
        for c in self.containers.values():
            c = _as_container(c)
            c.verify_n()  # settles header-trusted n on the lazy open path
            total += c.n
        return total

    def any(self) -> bool:
        return bool(self.containers)

    def max(self) -> int:
        if not self.containers:
            return 0
        key = max(self.containers)
        return (key << 16) | int(_as_container(self.containers[key]).to_array()[-1])

    def _keys_in(self, skey: int, ekey: int) -> np.ndarray:
        """Container keys in [skey, ekey], ascending — O(log C + hits)."""
        keys = self._sorted_keys()
        lo = np.searchsorted(keys, skey)
        hi = np.searchsorted(keys, ekey, side="right")
        return keys[lo:hi]

    def count_range(self, start: int, end: int) -> int:
        """Number of set bits in [start, end)."""
        if end <= start:
            return 0
        n = 0
        skey, ekey = start >> 16, (end - 1) >> 16
        for key in self._keys_in(skey, ekey):
            c = _as_container(self.containers[int(key)])
            lo = (start & 0xFFFF) if key == skey else 0
            hi = ((end - 1) & 0xFFFF) + 1 if key == ekey else 1 << 16
            n += c.count_range(lo, hi)
        return n

    def slice(self) -> np.ndarray:
        """All set values, ascending, as uint64."""
        if not self.containers:
            return np.empty(0, dtype=np.uint64)
        parts = []
        for key in self._sorted_keys():
            c = _as_container(self.containers[int(key)])
            parts.append(
                (np.uint64(key) << np.uint64(16)) | c.to_array().astype(np.uint64)
            )
        return np.concatenate(parts)

    def slice_range(self, start: int, end: int) -> np.ndarray:
        """Set values in [start, end), ascending. Walks only the containers
        overlapping the range (the hot path behind per-row extraction)."""
        if end <= start:
            return np.empty(0, dtype=np.uint64)
        skey, ekey = start >> 16, (end - 1) >> 16
        parts = []
        for key in self._keys_in(skey, ekey):
            c = _as_container(self.containers[int(key)])
            lo = (start & 0xFFFF) if key == skey else 0
            hi = ((end - 1) & 0xFFFF) + 1 if key == ekey else 1 << 16
            vals = c.slice_range(lo, hi)
            if len(vals):
                parts.append((np.uint64(key) << np.uint64(16)) | vals.astype(np.uint64))
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    def words64(self, idxs: np.ndarray) -> np.ndarray:
        """Values of the given global 64-bit word indices (word i covers
        bits [64i, 64i+64)). O(touched containers): the point-read analog
        of range_words, used by delta refreshes to fetch only the words a
        write changed. Missing containers read as zero."""
        idxs = np.asarray(idxs, dtype=np.int64)
        out = np.zeros(len(idxs), dtype=np.uint64)
        keys = idxs >> 10  # BITMAP_N (1024) words per container
        for key in np.unique(keys):
            c = self.containers.get(int(key))
            if c is None:
                continue
            m = keys == key
            out[m] = _as_container(c).as_words()[idxs[m] & 1023]
        return out

    def range_words(self, start: int, end: int) -> np.ndarray:
        """Bits [start, end) as a dense little-endian uint64 word array
        ((end-start)//64 words). start/end must be container-aligned. Dense
        containers are copied wholesale; this is how fragments assemble row
        bitplanes without materializing value lists."""
        if start & 0xFFFF or end & 0xFFFF:
            raise ValueError("range_words arguments must be container-aligned")
        skey, ekey = start >> 16, end >> 16
        out = np.zeros((end - start) // 64, dtype=np.uint64)
        for key in self._keys_in(skey, ekey - 1):
            c = _as_container(self.containers[int(key)])
            off = (int(key) - skey) * BITMAP_N
            out[off : off + BITMAP_N] = c.as_words()
        return out

    def __iter__(self) -> Iterator[int]:
        for v in self.slice():
            yield int(v)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Bitmap):
            return NotImplemented
        if set(self.containers) != set(other.containers):
            return False
        return all(
            _as_container(c) == _as_container(other.containers[k])
            for k, c in self.containers.items()
        )

    def __len__(self) -> int:
        return self.count()

    def clone(self) -> "Bitmap":
        b = Bitmap()
        for k, c in self.containers.items():
            b.containers[k] = _as_container(c).copy()
        return b

    # ------------------------------------------------------ set algebra (oracle)

    def _binop(self, other: "Bitmap", method: str) -> "Bitmap":
        out = Bitmap()
        for key in set(self.containers) | set(other.containers):
            a = self.containers.get(key)
            b = other.containers.get(key)
            a = _as_container(a) if a is not None else Container(arr=_empty())
            b = _as_container(b) if b is not None else Container(arr=_empty())
            c = getattr(a, method)(b)
            if c.n:
                out.containers[key] = c
        return out

    def union(self, other: "Bitmap") -> "Bitmap":
        return self._binop(other, "union")

    def intersect(self, other: "Bitmap") -> "Bitmap":
        return self._binop(other, "intersect")

    def difference(self, other: "Bitmap") -> "Bitmap":
        return self._binop(other, "difference")

    def xor(self, other: "Bitmap") -> "Bitmap":
        return self._binop(other, "xor")

    def intersection_count(self, other: "Bitmap") -> int:
        n = 0
        for key, a in self.containers.items():
            b = other.containers.get(key)
            if b is None:
                continue
            n += _as_container(a).intersection_count(_as_container(b))
        return n

    def flip(self, start: int, end: int) -> "Bitmap":
        """Logical negate of bits in [start, end] (inclusive, as reference)."""
        out = self.clone()
        rng = np.arange(start, end + 1, dtype=np.uint64)
        present = np.isin(rng, self.slice_range(start, end + 1))
        out.remove_many(rng[present])
        out.add_many(rng[~present])
        return out

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """Bits in [start, end) rebased to offset (reference roaring.go:311).

        offset/start/end must be container-aligned (multiples of 2^16).
        """
        if offset & 0xFFFF or start & 0xFFFF or end & 0xFFFF:
            raise ValueError("offset_range arguments must be container-aligned")
        off_key, s_key, e_key = offset >> 16, start >> 16, end >> 16
        out = Bitmap()
        for key, c in self.containers.items():
            if s_key <= key < e_key:
                out.containers[off_key + (key - s_key)] = _as_container(c).copy()
        return out

    # ---------------------------------------------------------- serialization

    def to_bytes(self) -> bytes:
        # list() first: a C-level snapshot of the key set, so serialization
        # racing a concurrent writer's container insert cannot raise
        # mid-iteration (fragment reads are lock-free by design).
        items = sorted(
            (k, _as_container(c)) for k, c in list(self.containers.items())
            if len(_as_container(c))
        )
        buf = io.BytesIO()
        buf.write(struct.pack("<II", COOKIE, len(items)))

        # Pick the smallest of array / bitmap / run per container. Run
        # containers reuse their in-memory intervals directly (no value
        # list is ever materialized for, e.g., a fully-set container).
        payloads = []
        for key, cont in items:
            # A lazy-opened container may still carry a header-trusted n;
            # serializing with a corrupt n would write an internally
            # inconsistent file (array form reads back n elements and
            # misparses the tail as op-log). Settle it now.
            cont.verify_n()
            n = cont.n
            r, runs = cont.run_count_lazy()
            sizes = {
                CONTAINER_ARRAY: 2 * n,
                CONTAINER_BITMAP: 8 * BITMAP_N,
                CONTAINER_RUN: 2 + 4 * r,
            }
            if r > RUN_MAX_SIZE:
                del sizes[CONTAINER_RUN]
            if n > ARRAY_MAX_SIZE:
                del sizes[CONTAINER_ARRAY]
            typ = min(sizes, key=lambda t: (sizes[t], t))
            if typ == CONTAINER_ARRAY:
                data = cont.to_array().astype("<u2").tobytes()
            elif typ == CONTAINER_RUN:
                if runs is None:  # bitmap container that runifies on disk
                    runs = cont.run_pairs()
                data = struct.pack("<H", len(runs)) + runs.astype("<u2").tobytes()
            else:
                data = cont.as_words().astype("<u8").tobytes()
            payloads.append(data)
            buf.write(struct.pack("<QHH", key, typ, n - 1))

        offset = HEADER_BASE_SIZE + len(items) * (12 + 4)
        for data in payloads:
            buf.write(struct.pack("<I", offset))
            offset += len(data)
        for data in payloads:
            buf.write(data)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Bitmap":
        return cls.from_buffer(data, copy=True)

    @classmethod
    def from_buffer(cls, data, copy: bool = True) -> "Bitmap":
        """Parse a roaring buffer. With copy=False, array/bitset payloads
        stay zero-copy read-only views into `data` (an mmap, typically):
        open cost is O(headers), untouched containers are never paged in,
        and the first mutation of a bitset promotes it via copy-on-write
        (Container._mutable_bits). The views keep `data` alive."""
        b = cls()
        if len(data) < HEADER_BASE_SIZE:
            raise CorruptFragmentError("data too small", offset=0)
        magic = struct.unpack_from("<H", data, 0)[0]
        version = struct.unpack_from("<H", data, 2)[0]
        if magic != MAGIC_NUMBER:
            raise CorruptFragmentError(
                f"invalid roaring file, magic number {magic}", offset=0)
        if version != STORAGE_VERSION:
            raise CorruptFragmentError(
                f"wrong roaring version {version}", offset=2)
        key_n = struct.unpack_from("<I", data, 4)[0]

        # The container region is written atomically (snapshot tmp+rename),
        # so ANY structural damage here — short headers, wild offsets, bad
        # payloads — is corruption, not a torn append: raise, don't truncate.
        headers = []
        pos = HEADER_BASE_SIZE
        try:
            for _ in range(key_n):
                key, typ, n_minus_1 = struct.unpack_from("<QHH", data, pos)
                headers.append((key, typ, n_minus_1 + 1))
                pos += 12
            offsets = struct.unpack_from(f"<{key_n}I", data, pos) if key_n else ()
        except struct.error as e:
            raise CorruptFragmentError(
                f"truncated container header region: {e}", offset=pos) from e
        ops_offset = pos + 4 * key_n

        for (key, typ, n), off in zip(headers, offsets):
            if off >= len(data):
                raise CorruptFragmentError(
                    f"offset out of bounds: off={off}, len={len(data)}",
                    offset=off)
            if typ == CONTAINER_ARRAY:
                if off + 2 * n > len(data):
                    raise CorruptFragmentError(
                        f"array payload out of bounds at key {key}", offset=off)
                arr = np.frombuffer(data, dtype="<u2", count=n, offset=off)
                if copy:
                    arr = arr.astype(np.uint16)
                c = Container(arr=arr, n=n)
                ops_offset = max(ops_offset, off + 2 * n)
            elif typ == CONTAINER_BITMAP:
                if off + 8 * BITMAP_N > len(data):
                    raise CorruptFragmentError(
                        f"bitset payload out of bounds at key {key}", offset=off)
                words = np.frombuffer(data, dtype="<u8", count=BITMAP_N, offset=off)
                # Dense containers stay bitsets — no value-list round trip.
                # In copy mode cardinality is derived from the payload so a
                # corrupt/foreign n field cannot poison count math; in lazy
                # mode recounting would page in every dense container, so
                # the header n is provisionally trusted (as the reference
                # reader does, roaring.go UnmarshalBinary) and settled by
                # Container.verify_n on the first count/mutation touch.
                if copy:
                    c = Container(bits=words.astype(np.uint64))
                    n = c.n
                else:
                    c = Container(bits=words, n=n)
                    c.nv = False
                ops_offset = max(ops_offset, off + 8 * BITMAP_N)
            elif typ == CONTAINER_RUN:
                if off + 2 > len(data):
                    raise CorruptFragmentError(
                        f"run header out of bounds at key {key}", offset=off)
                run_n = struct.unpack_from("<H", data, off)[0]
                if off + 2 + 4 * run_n > len(data):
                    raise CorruptFragmentError(
                        f"run payload out of bounds at key {key}", offset=off)
                runs = np.frombuffer(
                    data, dtype="<u2", count=2 * run_n, offset=off + 2
                ).reshape(run_n, 2)
                if run_n == 0:
                    c = Container(arr=_empty(), n=0)
                else:
                    # Runs STAY runs in memory (a fully-set container is 4
                    # bytes, not 8 KiB); cardinality is derived from the
                    # intervals, so the header n can't poison count math —
                    # but the intervals themselves must be validated, or a
                    # corrupt/hostile file (inverted, unsorted, or
                    # overlapping runs) silently breaks count and
                    # binary-search membership math.
                    s = runs[:, 0].astype(np.int64)
                    l = runs[:, 1].astype(np.int64)
                    if np.any(l < s) or (
                        run_n > 1 and np.any(s[1:] <= l[:-1])
                    ):
                        raise CorruptFragmentError(
                            f"corrupt run container at key {key}: intervals "
                            "inverted, unsorted, or overlapping",
                            offset=off,
                        )
                    if copy:
                        runs = runs.astype(np.uint16)
                    c = Container(runs=runs)
                n = c.n
                ops_offset = max(ops_offset, off + 2 + 4 * run_n)
            else:
                raise CorruptFragmentError(
                    f"unknown container type {typ}", offset=off)
            if n:
                b.containers[key] = c

        # Replay trailing op log (reference roaring.go:2889-2953) with
        # torn-tail recovery: a crash mid-append leaves a short or
        # checksum-failing record at the END of the log — stop there and
        # report the discard; every fully-appended op before it is
        # preserved, and the caller (fragment open) truncates the file back
        # to valid_len so the torn bytes never poison a later append. A
        # checksum failure with MORE data beyond the record is different:
        # appends only ever tear the final record, so a bad mid-log record
        # is bit rot — raise (quarantine + replica repair) rather than
        # silently truncating away every acknowledged op after it.
        #
        # Records are either 13-byte point ops (typ 0/1) or variable-length
        # bulk records (typ 2). Appends write a whole record in one
        # flush, so a torn record's PREFIX — including its type byte and,
        # when present, its length fields — is trustworthy; a bulk record
        # whose declared size overruns the buffer is therefore a torn
        # final append (truncate), with one caveat: bit rot inside a
        # mid-log bulk record's length fields is indistinguishable from
        # that tear and also truncates (reported via truncated_bytes;
        # anti-entropy repairs the difference from a replica).
        op_start = ops_offset
        ops_offset = _apply_op_stream(b, data, ops_offset)
        b.valid_len = ops_offset
        b.truncated_bytes = len(data) - ops_offset
        b.ops_bytes = ops_offset - op_start
        return b

    def apply_op(self, typ: int, value: int) -> bool:
        if typ == OP_ADD:
            return self.add(value)
        if typ == OP_REMOVE:
            return self.remove(value)
        raise ValueError(f"invalid op type: {typ}")

    def write_to(self, f) -> int:
        data = self.to_bytes()
        f.write(data)
        return len(data)

    def optimize(self) -> None:
        """Adopt the run form wherever it at least halves a container's
        memory (reference roaring.go Optimize). Called at snapshot time so
        point-mutation churn between snapshots re-compresses. Goes through
        _live: a container shared with a cow_clone() snapshot must be
        copied before the in-place form change, or the clone's serializer
        could observe a torn form transition mid-read."""
        for k in list(self.containers):
            c = self._live(k)
            if c is None:
                continue
            before = c.runs is None
            c._maybe_runify()
            if before and c.runs is not None:
                self.containers[k] = c  # write back for factory stores

    def check(self) -> List[str]:
        """Consistency check (reference roaring.go:745 Bitmap.Check /
        Container.check): containers sorted, unique, non-empty, in-range.
        Returns a list of problems; empty means consistent."""
        problems = []
        for key, c in self.containers.items():
            problems.extend(_as_container(c).check(key))
        return problems


# --------------------------------------------------- plane-section codec
#
# The tier manager (tier/manager.py) keeps demoted row planes container-
# compressed in host RAM and on disk. The encoded form IS the roaring
# serialization above (Bitmap.to_bytes of the row's containers rebased to
# key 0, via offset_range), so a spilled plane and a fragment file share
# one format and one set of corruption checks. Decode is a dedicated
# streaming pass rather than from_buffer + range_words: promotion is
# serving-path work, and skipping Container/Bitmap object construction —
# one row-wide bool scatter + ONE packbits for every sparse container
# instead of a packbits per container — is what lets a host-tier
# re-promotion undercut the cold per-container walk.


def decode_plane_words(data, n_words: int) -> np.ndarray:
    """Decode a plane-section roaring buffer (to_bytes of a bitmap whose
    containers were rebased to key 0) into a dense little-endian uint64
    word array of exactly `n_words` words. Containers beyond the plane,
    unknown types, or out-of-bounds payloads raise CorruptFragmentError
    (the tier manager treats that as "regather, don't error"). Trailing
    bytes past the container region are ignored — section images carry
    no op log."""
    out = np.zeros(n_words, dtype=np.uint64)
    if len(data) < HEADER_BASE_SIZE:
        raise CorruptFragmentError("plane section too small", offset=0)
    magic = struct.unpack_from("<H", data, 0)[0]
    if magic != MAGIC_NUMBER:
        raise CorruptFragmentError(
            f"invalid plane section, magic number {magic}", offset=0)
    key_n = struct.unpack_from("<I", data, 4)[0]
    pos = HEADER_BASE_SIZE
    try:
        headers = [struct.unpack_from("<QHH", data, pos + 12 * i)
                   for i in range(key_n)]
        offsets = struct.unpack_from(
            f"<{key_n}I", data, pos + 12 * key_n) if key_n else ()
    except struct.error as e:
        raise CorruptFragmentError(
            f"truncated plane section headers: {e}", offset=pos) from e
    one = np.uint64(1)
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    # Array containers accumulate global bit positions and scatter in ONE
    # vectorized pass at the end: container keys are serialized ascending
    # and each array's values are sorted, so the concatenation is globally
    # sorted and the per-word OR groups are contiguous — one reduceat
    # replaces per-container python/numpy round trips (which dominate at
    # typical container sizes) and never materializes per-bit booleans.
    arr_positions: list = []
    for (key, typ, _n1), off in zip(headers, offsets):
        base = int(key) * BITMAP_N
        if base < 0 or base >= n_words:
            raise CorruptFragmentError(
                f"plane section container key {key} out of plane",
                offset=off)
        # A container may extend past a sub-container plane (exotic
        # SHARD_WIDTH < 2^16, tests only): its in-plane words decode, and
        # bits beyond the plane are corruption (the encoder never writes
        # them), checked per form below.
        n_copy = min(BITMAP_N, n_words - base)
        if typ == CONTAINER_BITMAP:
            if off + 8 * BITMAP_N > len(data):
                raise CorruptFragmentError(
                    f"bitset payload out of bounds at key {key}", offset=off)
            words = np.frombuffer(data, dtype="<u8", count=BITMAP_N,
                                  offset=off)
            if n_copy < BITMAP_N and words[n_copy:].any():
                raise CorruptFragmentError(
                    f"bitset bits beyond plane at key {key}", offset=off)
            out[base : base + n_copy] = words[:n_copy]
        elif typ == CONTAINER_ARRAY:
            n = _n1 + 1
            if off + 2 * n > len(data):
                raise CorruptFragmentError(
                    f"array payload out of bounds at key {key}", offset=off)
            arr = np.frombuffer(data, dtype="<u2", count=n, offset=off)
            arr_positions.append((base << 6) + arr.astype(np.int64))
        elif typ == CONTAINER_RUN:
            if off + 2 > len(data):
                raise CorruptFragmentError(
                    f"run header out of bounds at key {key}", offset=off)
            run_n = struct.unpack_from("<H", data, off)[0]
            if off + 2 + 4 * run_n > len(data):
                raise CorruptFragmentError(
                    f"run payload out of bounds at key {key}", offset=off)
            runs = np.frombuffer(
                data, dtype="<u2", count=2 * run_n, offset=off + 2
            ).reshape(run_n, 2)
            for s, l in runs:
                s, l = int(s), int(l)
                if l < s:
                    raise CorruptFragmentError(
                        f"inverted run at key {key}", offset=off)
                if (base << 6) + l >= n_words * 64:
                    raise CorruptFragmentError(
                        f"run beyond plane at key {key}", offset=off)
                w0, w1 = base + (s >> 6), base + (l >> 6)
                m0 = (full << np.uint64(s & 63)) & full
                m1 = full >> np.uint64(63 - (l & 63))
                if w0 == w1:
                    out[w0] |= m0 & m1
                else:
                    out[w0] |= m0
                    out[w0 + 1 : w1] = full
                    out[w1] |= m1
        else:
            raise CorruptFragmentError(
                f"unknown container type {typ}", offset=off)
    if arr_positions:
        glob = (arr_positions[0] if len(arr_positions) == 1
                else np.concatenate(arr_positions))
        if int(glob[-1]) >= n_words * 64:  # sorted: the max bit position
            raise CorruptFragmentError("array bits beyond plane", offset=0)
        words = glob >> 6
        vals = one << (glob.astype(np.uint64) & np.uint64(63))
        starts = np.concatenate(([0], np.flatnonzero(np.diff(words)) + 1))
        out[words[starts]] |= np.bitwise_or.reduceat(vals, starts)
    return out


def encode_op(typ: int, value: int) -> bytes:
    body = struct.pack("<BQ", typ, value)
    return body + struct.pack("<I", fnv32a(body))


def encode_bulk_op(adds=None, removes=None) -> bytes:
    """One WAL record for a whole import batch (see OP_BULK). `adds` and
    `removes` are uint64 position arrays (either may be None/empty);
    duplicates are fine (replay add_many/remove_many dedups)."""
    a = np.ascontiguousarray(
        adds if adds is not None else (), dtype="<u8")
    r = np.ascontiguousarray(
        removes if removes is not None else (), dtype="<u8")
    body = _BULK_HEADER.pack(OP_BULK, len(a), len(r)) + a.tobytes() + r.tobytes()
    return body + struct.pack("<I", zlib.crc32(body))


def _apply_op_stream(b: "Bitmap", data, ops_offset: int) -> int:
    """THE WAL-record replayer, shared by from_buffer's op-log tail and
    migration catch-up streams (cluster/rebalance.py) so the two paths
    cannot drift on record framing. Applies point + bulk records starting
    at `ops_offset`, returns the offset of the first byte NOT applied
    (end of data, or an incomplete/checksum-failing FINAL record — the
    torn-append case). A bad record with MORE data beyond it is bit rot,
    not a tear, and raises."""
    while ops_offset < len(data):
        remaining = len(data) - ops_offset
        if data[ops_offset] == OP_BULK:
            if remaining < BULK_MIN_SIZE:
                break  # incomplete trailing record
            _, n_add, n_rem = _BULK_HEADER.unpack_from(data, ops_offset)
            size = _BULK_HEADER.size + 8 * (n_add + n_rem) + 4
            if size > remaining:
                break  # torn final append (see the caveat in from_buffer)
            body_end = ops_offset + size - 4
            chk = struct.unpack_from("<I", data, body_end)[0]
            if chk != zlib.crc32(bytes(data[ops_offset:body_end])):
                if size < remaining:
                    raise CorruptFragmentError(
                        "bulk op checksum failure mid-log (not a torn "
                        "tail)", offset=ops_offset)
                break  # corrupt FINAL record: a torn append
            off = ops_offset + _BULK_HEADER.size
            adds = np.frombuffer(data, dtype="<u8", count=n_add,
                                 offset=off)
            rems = np.frombuffer(data, dtype="<u8", count=n_rem,
                                 offset=off + 8 * n_add)
            b.add_many(adds.astype(np.uint64))
            b.remove_many(rems.astype(np.uint64))
            b.op_n += 1
            ops_offset += size
            continue
        if remaining < OP_SIZE:
            break  # incomplete trailing record
        try:
            op = parse_op(data, ops_offset)
        except CorruptFragmentError:
            if remaining > OP_SIZE:
                raise CorruptFragmentError(
                    "op checksum failure mid-log (not a torn tail)",
                    offset=ops_offset,
                )
            break  # corrupt FINAL record: a torn append
        b.apply_op(*op)
        b.op_n += 1
        ops_offset += OP_SIZE
    return ops_offset


class _OpRecordSink:
    """Bitmap-protocol shim for _apply_op_stream: instead of mutating a
    bitmap, collect each replayed record's (adds, removes) position
    arrays IN ORDER. Lets hint delivery (cluster/hints.py) decode a
    shipped op run through THE one replayer — same framing, same torn-
    tail rules — and apply it record-by-record via fragment-level calls
    that keep WAL/journal/epoch semantics."""

    __slots__ = ("records", "op_n", "_adds")

    def __init__(self):
        self.records = []  # [(adds, removes)] per record, in order
        self.op_n = 0
        self._adds = None

    def _flush(self):
        if self._adds is not None:
            self.records.append((self._adds, _EMPTY_U8))
            self._adds = None

    def add_many(self, pos):
        self._flush()
        self._adds = np.asarray(pos, dtype=np.uint64)

    def remove_many(self, pos):
        # _apply_op_stream pairs add_many + remove_many per OP_BULK record.
        adds = self._adds if self._adds is not None else _EMPTY_U8
        self._adds = None
        self.records.append((adds, np.asarray(pos, dtype=np.uint64)))

    def apply_op(self, typ, value):
        self._flush()
        one = np.asarray([value], dtype=np.uint64)
        if typ == OP_ADD:
            self.records.append((one, _EMPTY_U8))
        elif typ == OP_REMOVE:
            self.records.append((_EMPTY_U8, one))
        else:
            raise CorruptFragmentError(f"invalid op type: {typ}")
        return True


_EMPTY_U8 = np.zeros(0, dtype=np.uint64)


def decode_op_records(data: bytes):
    """Decode a shipped run of WAL records into ordered (adds, removes)
    position-array pairs. Strict like replay_ops: a stream that does not
    parse whole is a transport/sender fault and raises, never a silent
    partial apply."""
    sink = _OpRecordSink()
    end = _apply_op_stream(sink, data, 0)
    sink._flush()
    if end != len(data):
        raise CorruptFragmentError(
            f"torn hint op stream: {len(data) - end} trailing bytes "
            "unparseable", offset=end)
    return sink.records


def replay_ops(b: "Bitmap", data: bytes) -> None:
    """Apply a SHIPPED run of WAL records (a migration catch-up tail) to
    `b`. Unlike a local reopen — where a torn FINAL record is an expected
    crash artifact — a stream that doesn't parse whole is a transport or
    sender fault: raise so the receiver restarts rather than silently
    installing a partial tail."""
    end = _apply_op_stream(b, data, 0)
    if end != len(data):
        raise CorruptFragmentError(
            f"torn migration op stream: {len(data) - end} trailing bytes "
            "unparseable", offset=end)


def parse_op(data: bytes, offset: int = 0) -> Tuple[int, int]:
    if len(data) - offset < OP_SIZE:
        raise CorruptFragmentError(
            f"op data out of bounds: len={len(data) - offset}", offset=offset)
    typ, value = struct.unpack_from("<BQ", data, offset)
    chk = struct.unpack_from("<I", data, offset + 9)[0]
    if chk != fnv32a(data[offset : offset + 9]):
        raise CorruptFragmentError("op checksum mismatch", offset=offset)
    return typ, value
