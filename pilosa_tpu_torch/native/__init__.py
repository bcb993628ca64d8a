"""ctypes bindings for the native host kernels (bitmap_ops.cpp).

Loads libbitmap_ops.so, building it with `make` on first use if the
toolchain is available. All entry points have numpy fallbacks — the
framework works without the native library, just slower on host paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libbitmap_ops.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR], check=True, capture_output=True, timeout=120
        )
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.pack_bits.argtypes = [u32p, ctypes.c_size_t, u32p]
        lib.pack_bits.restype = None
        lib.unpack_bits.argtypes = [u32p, ctypes.c_size_t, u32p]
        lib.unpack_bits.restype = ctypes.c_size_t
        lib.popcount_words.argtypes = [u32p, ctypes.c_size_t]
        lib.popcount_words.restype = ctypes.c_uint64
        lib.and_count_words.argtypes = [u32p, u32p, ctypes.c_size_t]
        lib.and_count_words.restype = ctypes.c_uint64
        lib.intersection_count_u16.argtypes = [u16p, ctypes.c_size_t, u16p, ctypes.c_size_t]
        lib.intersection_count_u16.restype = ctypes.c_uint64
        for name in ("intersect_u16", "union_u16", "difference_u16", "xor_u16"):
            fn = getattr(lib, name)
            fn.argtypes = [u16p, ctypes.c_size_t, u16p, ctypes.c_size_t, u16p]
            fn.restype = ctypes.c_size_t
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# ------------------------------------------------------------ typed wrappers


def pack_bits(cols: np.ndarray, n_words: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    cols = np.ascontiguousarray(cols, dtype=np.uint32)
    words = np.zeros(n_words, dtype=np.uint32)
    lib.pack_bits(cols, len(cols), words)
    return words


def unpack_bits(words: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    total = int(lib.popcount_words(words, len(words)))
    out = np.empty(total, dtype=np.uint32)
    n = lib.unpack_bits(words, len(words), out)
    return out[:n].astype(np.uint64)


def and_count_words(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    """popcount(a & b) over packed uint32 planes (the host hot loop)."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    return int(lib.and_count_words(a, b, min(len(a), len(b))))


def intersection_count_u16(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint16)
    b = np.ascontiguousarray(b, dtype=np.uint16)
    return int(lib.intersection_count_u16(a, len(a), b, len(b)))


def _binop_u16(name: str, a: np.ndarray, b: np.ndarray, out_cap: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint16)
    b = np.ascontiguousarray(b, dtype=np.uint16)
    out = np.empty(out_cap, dtype=np.uint16)
    n = getattr(lib, name)(a, len(a), b, len(b), out)
    return out[:n]


def intersect_u16(a, b):
    return _binop_u16("intersect_u16", a, b, min(len(a), len(b)))


def union_u16(a, b):
    return _binop_u16("union_u16", a, b, len(a) + len(b))


def difference_u16(a, b):
    return _binop_u16("difference_u16", a, b, len(a))


def xor_u16(a, b):
    return _binop_u16("xor_u16", a, b, len(a) + len(b))
