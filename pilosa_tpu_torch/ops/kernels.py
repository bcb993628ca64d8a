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
``op | slot << 8``. PUSH (slot) pushes leaf plane `slot`. A binary op
(AND, OR, XOR, ANDNOT, NOTAND) pops the right operand, then the left, and
pushes ``left OP right`` (ANDNOT: ``left & ~right``; NOTAND:
``~left & right``). A fused op ``OP_ACC | op`` with a slot applies
``top = top OP plane[slot]`` without touching the stack, so a left-folded
k-ary node over leaves needs no stack at all. parallel/engine.py
``lower_tape`` compiles the canonical set-op IR into it.

K1 has two variants, chosen by ``k1_plan`` from the batch's distinct
slots and Q alone: "staged" (Q > 1, and the distinct slots fit a ring of
at least two stages in shared memory) reads each distinct slot from HBM
once per batch; "streaming" (Q = 1, or too many distinct slots) reads
each query's planes, queries fastest in the grid so queries that share a
chunk meet it in L2.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bitplane import popcount_words

OP_PUSH, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_NOTAND = 0, 1, 2, 3, 4, 5
OP_ACC = 8  # OP_ACC | op: top = top OP plane[slot]

# K1's limits (must match csrc/bitplane_kernels.cu). The evaluation stack
# holds MAX_STACK planes; lower_tape's child order keeps a tree of n
# leaves within floor(log2 n) + 1, so any tree of fewer than 2^24 leaves
# fits. Slots are the 23 bits above the op byte.
MAX_STACK = 24
MAX_SLOTS = 1 << 23

# The staged variant's ring (must match csrc/bitplane_kernels.cu): each
# stage holds RING_CHUNK uint4 (512 bytes) of every distinct slot of a
# tile of Q_TILE queries, and the ring takes at most RING_BYTES, the
# shared memory one block may use on an H100 (227 KB).
RING_CHUNK = 32
RING_SLOT_BYTES = RING_CHUNK * 16
RING_BYTES = 232448
RING_MAX_STAGES = 4
Q_TILE = 256

K1_VARIANTS = ("staged", "streaming")
LAUNCHES: Dict[str, int] = {"gather_expr_count": 0, "gather_expr_count_staged": 0,
                            "gather_expr_count_streaming": 0, "masked_plane_counts": 0}
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
        lib.pt_k1_streaming.argtypes = [vp, i64, vp, i32, vp, i32, vp, vp]
        lib.pt_k1_streaming.restype = i32
        lib.pt_k1_staged.argtypes = [
            vp, i64, vp, i32, i32, vp, i32, vp, vp, i32, i32, i32, vp, vp]
        lib.pt_k1_staged.restype = i32
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
    that underflows, names an unknown op, or does not leave exactly one
    value."""
    depth = peak = 0
    for code in tape:
        op = code & 0xFF
        if op == OP_PUSH:
            depth += 1
        elif not OP_AND <= op & ~OP_ACC <= OP_NOTAND:
            raise ValueError(f"unknown tape op {op}")
        elif op & OP_ACC:
            if depth < 1:
                raise ValueError(f"op tape underflows: {list(tape)}")
        else:
            depth -= 1
            if depth < 1:
                raise ValueError(f"op tape underflows: {list(tape)}")
        peak = max(peak, depth)
    if depth != 1:
        raise ValueError(f"op tape leaves {depth} values: {list(tape)}")
    return peak


def _apply(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == OP_AND:
        return torch.bitwise_and(a, b)
    if op == OP_OR:
        return torch.bitwise_or(a, b)
    if op == OP_XOR:
        return torch.bitwise_xor(a, b)
    if op == OP_ANDNOT:
        return torch.bitwise_and(a, torch.bitwise_not(b))
    if op == OP_NOTAND:
        return torch.bitwise_and(torch.bitwise_not(a), b)
    raise ValueError(f"unknown tape op {op}")


def _eval_tape(tape: Sequence[int], leaf):
    """Plain tape evaluation; `leaf(slot)` returns that slot's plane."""
    stack = []
    for code in tape:
        op = code & 0xFF
        if op == OP_PUSH:
            stack.append(leaf(code >> 8))
        elif op & OP_ACC:
            stack[-1] = _apply(op & ~OP_ACC, stack[-1], leaf(code >> 8))
        else:
            b = stack.pop()
            stack[-1] = _apply(op, stack[-1], b)
    return stack[0]


# -------------------------------------------------------------------- K1


def k1_ring_stages(distinct: int) -> int:
    """Stages of the staged variant's ring that `distinct` slots fill
    (at most RING_MAX_STAGES); below 2 the ring cannot overlap a copy
    with the compute, and the staged variant is not taken."""
    if distinct < 1:
        return 0
    return min(RING_MAX_STAGES, RING_BYTES // (distinct * RING_SLOT_BYTES))


def k1_plan(distinct: int, q: int) -> Tuple[str, int]:
    """(variant, ring stages) for a batch of `q` queries whose largest
    Q_TILE-query tile names `distinct` distinct slots. A single query
    streams: each of its planes is read once either way. A batch whose
    slots fit a ring of two or more stages is staged, reading each
    distinct slot once; a larger one streams. Plane width does not enter:
    the ring's chunk per slot is fixed."""
    stages = k1_ring_stages(distinct)
    if q > 1 and stages >= 2:
        return "staged", stages
    return "streaming", 0


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
    if not 1 <= n_leaves <= MAX_SLOTS:
        raise ValueError(f"{n_leaves} leaves; the kernel takes 1..{MAX_SLOTS}")
    if not tape:
        raise ValueError("empty op tape")
    if tape_depth(tape) > MAX_STACK:
        raise ValueError(f"tape needs a stack deeper than {MAX_STACK}")
    for code in tape:
        if (code & 0xFF == OP_PUSH or code & OP_ACC) and not 0 <= code >> 8 < n_leaves:
            raise ValueError(f"tape names slot {code >> 8} of {n_leaves}")


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


def k1_tiles(idx_np: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """The staged variant's remap of an (L, Q) slot array: per tile of
    Q_TILE queries, its distinct stack rows (ascending), and for every
    query the ring position of each leaf position, (Q, L) int32."""
    n_leaves, q = idx_np.shape
    urows: List[np.ndarray] = []
    qpos = np.empty((q, n_leaves), dtype=np.int32)
    for t0 in range(0, q, Q_TILE):
        part = idx_np[:, t0:t0 + Q_TILE]
        uniq, inv = np.unique(part, return_inverse=True)
        urows.append(uniq.astype(np.int32))
        qpos[t0:t0 + part.shape[1]] = inv.reshape(part.shape).T
    return urows, qpos


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host-to-device copy that does not wait for the stream: staged
    through pinned memory from PyTorch's caching host allocator, which
    keeps the pinned block until the copy has run."""
    return torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)


def gather_expr_count(stacked: torch.Tensor, idxs: torch.Tensor,
                      tape: Sequence[int],
                      variant: Optional[str] = None) -> torch.Tensor:
    """K1: (Q,) int64 counts. `stacked` (U, S, W) int32 resident leaf
    stack; `idxs` (L, Q) int32 slot ids on the host (row j = leaf position
    j of the tape), range-checked here and copied to the stack's device
    with the tape in one buffer; `tape` the postfix op codes. `variant`
    names the kernel variant (k1_plan chooses when it is None); naming
    "staged" for slots that do not fit its ring raises."""
    tape = [int(c) for c in tape]
    _check_k1(stacked, idxs, tape)
    if variant is not None and variant not in K1_VARIANTS:
        raise ValueError(f"unknown K1 variant {variant!r}")
    if not stacked.is_cuda:
        return gather_expr_count_plain(stacked, idxs, tape)
    u, s, w = stacked.shape
    if (s * w) % 4 or stacked.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned planes (S*W % 4 == 0)")
    n_leaves, q = idxs.shape
    out = torch.zeros(q, dtype=torch.int64, device=stacked.device)
    if q == 0 or s * w == 0:
        return out
    idx_np = np.ascontiguousarray(idxs.numpy())
    tape_np = np.asarray(tape, dtype=np.int32)
    if variant != "streaming" and (q > 1 or variant == "staged"):
        urows, qpos = k1_tiles(idx_np)
        distinct = max(len(r) for r in urows)
        if variant is None:
            variant, stages = k1_plan(distinct, q)
        else:
            stages = k1_ring_stages(distinct)
            if stages < 2:
                raise ValueError(
                    f"{distinct} distinct slots do not fit the staged variant's ring "
                    f"({RING_BYTES // (2 * RING_SLOT_BYTES)} at most)")
    variant = variant or "streaming"
    lib = load()
    dev, stream = stacked.device, _stream(stacked)
    if variant == "staged":
        # One buffer: tape | tiles (offset into urows, distinct slots) |
        # urows | qpos.
        sizes = [len(r) for r in urows]
        tiles = np.stack([np.cumsum([0] + sizes[:-1]), sizes], axis=1).astype(np.int32)
        buf = _to_device(np.concatenate([tape_np, tiles.ravel(), *urows, qpos.ravel()]), dev)
        tiles_at = buf.data_ptr() + 4 * len(tape)
        urows_at = tiles_at + 4 * tiles.size
        qpos_at = urows_at + 4 * sum(sizes)
        err = lib.pt_k1_staged(
            stacked.data_ptr(), s * w, buf.data_ptr(), len(tape), n_leaves, tiles_at,
            len(urows), urows_at, qpos_at, q, max(sizes), stages, out.data_ptr(), stream)
    else:
        buf = _to_device(np.concatenate([tape_np, idx_np.ravel()]), dev)
        err = lib.pt_k1_streaming(
            stacked.data_ptr(), s * w, buf.data_ptr(), len(tape),
            buf.data_ptr() + 4 * len(tape), q, out.data_ptr(), stream)
    _check_launch(f"gather_expr_count ({variant})", err)
    LAUNCHES["gather_expr_count"] += 1
    LAUNCHES[f"gather_expr_count_{variant}"] += 1
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
