"""The hand-written CUDA kernels of the read path, their plain twins, and
the build that makes them.

K1 ``gather_expr_count(stacked, idxs, tape) -> (Q,) int64``
    For each query q: popcount of the set-op expression `tape` over the
    leaf planes ``stacked[idxs[0][q]], ..., stacked[idxs[L-1][q]]``,
    summed over every shard and word. Replaces the TPU kernel
    ``batched_gather_expr_count`` (pilosa_tpu/ops/pallas_kernels.py:61).
K2 ``masked_plane_counts(stack, mask) -> (R, S) int32``
    ``popcount(stack[r][s] & mask[s])`` per (row, shard); ``mask=None``
    counts the rows alone. Replaces the XLA popcount reductions of the
    TPU engine's TopN and per-shard counting paths.

Both kernels live in csrc/bitplane_kernels.cu (design and bounds are
noted there), are compiled with ``nvcc`` for sm_90a into
``_build/libbitplane_kernels.so`` at first use, and are bound with
ctypes. Each wrapper checks device, dtype, shape and contiguity; on a CUDA
tensor it launches its kernel (and counts the launch in ``LAUNCHES``) or
raises; it takes the plain twin only for CPU tensors. The twins count
their own calls in ``PLAIN_CALLS``, so a run can show which one served.

The expression reaches K1 as a postfix op tape: a sequence of int32 codes
``op | slot << 8`` with ops PUSH (slot), AND, OR, XOR, ANDNOT — the binary
op pops the right operand, then the left, and pushes ``left OP right``
(ANDNOT: ``left & ~right``). parallel/engine.py ``lower_tape`` compiles
the canonical set-op IR into it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

import torch

from .bitplane import popcount_words

OP_PUSH, OP_AND, OP_OR, OP_XOR, OP_ANDNOT = 0, 1, 2, 3, 4

# Limits of K1's by-value tape (must match csrc/bitplane_kernels.cu).
MAX_TAPE = 64
MAX_STACK = 8
MAX_LEAVES = 32

LAUNCHES: Dict[str, int] = {"gather_expr_count": 0, "masked_plane_counts": 0}
PLAIN_CALLS: Dict[str, int] = {"gather_expr_count": 0, "masked_plane_counts": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ----------------------------------------------------------------- build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bitplane_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libbitplane_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> float:
    """Compile csrc/bitplane_kernels.cu into the shared library unless an
    up-to-date build exists; returns the seconds spent compiling. The
    compiler's report (`-Xptxas -v`: registers, shared memory, spills)
    lands in BUILD_LOG."""
    global BUILD_LOG
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    BUILD_LOG = proc.stdout + proc.stderr
    return time.perf_counter() - t0


def load():
    """The bound library, building it first if needed. Raises when it can
    neither be built nor loaded — there is no fallback for CUDA tensors."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(LIBRARY)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pt_gather_expr_count.argtypes = [
            vp, i64, vp, i32, i32, ctypes.POINTER(ctypes.c_int), i32, vp, vp]
        lib.pt_gather_expr_count.restype = i32
        lib.pt_masked_plane_counts.argtypes = [vp, vp, i32, i32, i64, vp, vp]
        lib.pt_masked_plane_counts.restype = i32
        _lib = lib
        return _lib


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ tape


def tape_depth(tape: Sequence[int]) -> int:
    """Largest evaluation-stack depth the tape reaches; raises on a tape
    that underflows or does not leave exactly one value."""
    depth = peak = 0
    for code in tape:
        if code & 0xFF == OP_PUSH:
            depth += 1
        else:
            depth -= 1
            if depth < 1:
                raise ValueError(f"op tape underflows: {list(tape)}")
        peak = max(peak, depth)
    if depth != 1:
        raise ValueError(f"op tape leaves {depth} values: {list(tape)}")
    return peak


def _eval_tape(tape: Sequence[int], leaf):
    """Plain tape evaluation; `leaf(slot)` returns that slot's plane."""
    stack = []
    for code in tape:
        op = code & 0xFF
        if op == OP_PUSH:
            stack.append(leaf(code >> 8))
            continue
        b = stack.pop()
        a = stack.pop()
        if op == OP_AND:
            stack.append(torch.bitwise_and(a, b))
        elif op == OP_OR:
            stack.append(torch.bitwise_or(a, b))
        elif op == OP_XOR:
            stack.append(torch.bitwise_xor(a, b))
        elif op == OP_ANDNOT:
            stack.append(torch.bitwise_and(a, torch.bitwise_not(b)))
        else:
            raise ValueError(f"unknown tape op {op}")
    return stack[0]


# -------------------------------------------------------------------- K1


def _check_k1(stacked, idxs, tape) -> None:
    if stacked.dtype != torch.int32 or stacked.dim() != 3:
        raise ValueError(f"stacked must be (U, S, W) int32, got "
                         f"{tuple(stacked.shape)} {stacked.dtype}")
    if idxs.dtype != torch.int32 or idxs.dim() != 2 or idxs.is_cuda:
        raise ValueError(f"idxs must be an (L, Q) int32 host tensor, got "
                         f"{tuple(idxs.shape)} {idxs.dtype} on {idxs.device}")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if idxs.numel() and not (0 <= int(idxs.min()) and int(idxs.max()) < stacked.shape[0]):
        raise ValueError(f"idxs must lie in [0, {stacked.shape[0]})")
    n_leaves = idxs.shape[0]
    if not 1 <= n_leaves <= MAX_LEAVES:
        raise ValueError(f"{n_leaves} leaves; the kernel takes 1..{MAX_LEAVES}")
    if not 1 <= len(tape) <= MAX_TAPE:
        raise ValueError(f"tape of {len(tape)} ops; the kernel takes 1..{MAX_TAPE}")
    if tape_depth(tape) > MAX_STACK:
        raise ValueError(f"tape needs a stack deeper than {MAX_STACK}")
    for code in tape:
        if code & 0xFF == OP_PUSH and not 0 <= code >> 8 < n_leaves:
            raise ValueError(f"tape pushes slot {code >> 8} of {n_leaves}")


def gather_expr_count_plain(stacked: torch.Tensor, idxs: torch.Tensor,
                            tape: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch twin of K1: one query at a time, so the (Q, S, W)
    gather is never materialized here either."""
    PLAIN_CALLS["gather_expr_count"] += 1
    out = torch.empty(idxs.shape[1], dtype=torch.int64, device=stacked.device)
    for q in range(idxs.shape[1]):
        plane = _eval_tape(tape, lambda slot: stacked[int(idxs[slot, q])])
        out[q] = popcount_words(plane).sum()
    return out


def gather_expr_count(stacked: torch.Tensor, idxs: torch.Tensor,
                      tape: Sequence[int]) -> torch.Tensor:
    """K1: (Q,) int64 counts. `stacked` (U, S, W) int32 resident leaf
    stack; `idxs` (L, Q) int32 slot ids on the host (row j = leaf position
    j of the tape), range-checked here and copied to the stack's device;
    `tape` the postfix op codes."""
    tape = [int(c) for c in tape]
    _check_k1(stacked, idxs, tape)
    if not stacked.is_cuda:
        return gather_expr_count_plain(stacked, idxs, tape)
    u, s, w = stacked.shape
    if (s * w) % 4 or stacked.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned planes (S*W % 4 == 0)")
    q = idxs.shape[1]
    out = torch.zeros(q, dtype=torch.int64, device=stacked.device)
    if q == 0 or s * w == 0:
        return out
    lib = load()
    idx_dev = idxs.contiguous().to(stacked.device)
    ops = (ctypes.c_int * len(tape))(*tape)
    err = lib.pt_gather_expr_count(
        stacked.data_ptr(), s * w, idx_dev.data_ptr(), q, idxs.shape[0], ops,
        len(tape), out.data_ptr(), _stream(stacked))
    _check_launch("gather_expr_count", err)
    LAUNCHES["gather_expr_count"] += 1
    return out


# -------------------------------------------------------------------- K2


def _check_k2(stack, mask) -> None:
    if stack.dtype != torch.int32 or stack.dim() != 3:
        raise ValueError(f"stack must be (R, S, W) int32, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    if mask is not None:
        if mask.dtype != torch.int32 or tuple(mask.shape) != tuple(stack.shape[1:]):
            raise ValueError(f"mask must be (S, W) int32 matching the stack, "
                             f"got {tuple(mask.shape)} {mask.dtype}")
        if mask.device != stack.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on the stack's device")


def masked_plane_counts_plain(stack: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of K2, one row at a time (bounded temporaries)."""
    PLAIN_CALLS["masked_plane_counts"] += 1
    out = torch.empty(stack.shape[:2], dtype=torch.int32, device=stack.device)
    for r in range(stack.shape[0]):
        plane = stack[r] if mask is None else torch.bitwise_and(stack[r], mask)
        out[r] = popcount_words(plane).sum(dim=-1).to(torch.int32)
    return out


def masked_plane_counts(stack: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: (R, S) int32 per-(row, shard) counts of stack (R, S, W) int32,
    each ANDed with mask (S, W) when given."""
    _check_k2(stack, mask)
    if not stack.is_cuda:
        return masked_plane_counts_plain(stack, mask)
    r, s, w = stack.shape
    if w % 4 or stack.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("K2 needs 16-byte aligned planes (W % 4 == 0)")
    out = torch.zeros((r, s), dtype=torch.int32, device=stack.device)
    if r == 0 or s == 0 or w == 0:
        return out
    lib = load()
    err = lib.pt_masked_plane_counts(
        stack.data_ptr(), None if mask is None else mask.data_ptr(), r, s, w,
        out.data_ptr(), _stream(stack))
    _check_launch("masked_plane_counts", err)
    LAUNCHES["masked_plane_counts"] += 1
    return out
