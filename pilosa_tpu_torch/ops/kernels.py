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
    TPU engine's TopN, per-shard counting and BSI Sum paths.
K3 ``bsi_minmax(planes, mask, maximize) -> (bits (D,) int32, count)``
    The bit-sliced Min/Max scan of a (D+1, S, W) BSI stack (plane D is
    the not-null row) over every shard at once, optionally filtered.
    Replaces the XLA min/max program of the TPU engine's
    ``bsi_val_count`` (pilosa_tpu/parallel/engine.py:2099-2119).

The kernels live in csrc/bitplane_kernels.cu (design and bounds are
noted there), are compiled with ``nvcc`` for sm_90a into
``_build/libbitplane_kernels.so`` at first use, and are bound with
ctypes. Each wrapper checks device, dtype, shape and contiguity; on a CUDA
tensor it launches its kernel on that tensor's device, made current for
the launch (and counts the launch in ``LAUNCHES``), or raises; it takes
the plain twin only for CPU tensors. The twins count
their own calls in ``PLAIN_CALLS``, so a run can show which one served.

The expression reaches K1 as a postfix op tape: a sequence of int32 codes
``op | slot << 8``. PUSH (slot) pushes leaf plane `slot`. A binary op
(AND, OR, XOR, ANDNOT, NOTAND) pops the right operand, then the left, and
pushes ``left OP right`` (ANDNOT: ``left & ~right``; NOTAND:
``~left & right``). A fused op ``OP_ACC | op`` with a slot applies
``top = top OP plane[slot]`` without touching the stack, so a left-folded
k-ary node over leaves needs no stack at all. parallel/engine.py
``lower_tape`` compiles the canonical IR into it.

BSI compares (the bit-serial programs of reference fragment.go:683-851)
are unrolled on the host into one code per value plane; the evaluator
keeps two masks, keep1 (the ">" side) and keep2 (the "<" side), beside
the top of the stack:

- ``OP_BSI_PUSH`` (slot): push plane[slot] (the not-null row) and set
  keep1 = keep2 = 0: the start of a compare.
- ``OP_BSI_STEP | gt | lt << 2`` (slot): with row = plane[slot], first the
  ">" part (``GT_KEEP``: keep1 |= top & row; ``GT_CLEAR``: top &= row |
  keep1), then the "<" part (``LT_CLEAR``: top &= ~row | keep2;
  ``LT_KEEP``: keep2 |= top & ~row). A ``between`` step carries both.
- ``OP_BSI_KEEP1`` / ``OP_BSI_KEEP2`` (no slot): top = keep1 / keep2, the
  early ``return keep`` of a strict compare.

Steps and keeps act only inside a compare, after its ``OP_BSI_PUSH``;
fused ops may sit between them (leading zeros). Predicates never enter a
code: each plane's predicate bits select the step kind.

K1 has two variants, chosen by ``k1_plan`` from the batch's distinct
slots and Q alone: "staged" (Q > 1, and the distinct slots fit a ring of
at least two stages in shared memory) reads each distinct slot from HBM
once per batch; "streaming" (Q = 1, or too many distinct slots) reads
each query's planes, queries fastest in the grid so queries that share a
chunk meet it in L2.

The staged variant computes once per staged chunk what every query of
the launch shares (``k1_split``): a span of the tape whose leaf
positions name the same slot for every query (a BSI compare over one
predicate, a shared filter) becomes a hoist program, evaluated by the
block over the chunk into a synthetic ring row, and each query's tape
reads that row as one leaf.
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

from ..obs import NOP_SPAN
from ..obs import span as obs_span
from .bitplane import bsi_max, bsi_min, popcount_words

OP_PUSH, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_NOTAND = 0, 1, 2, 3, 4, 5
OP_ACC = 8  # OP_ACC | op: top = top OP plane[slot]
# BSI compare codes (module docstring); must match csrc/bitplane_kernels.cu.
OP_BSI_PUSH = 0x10
OP_BSI_STEP = 0x10  # | gt | lt << 2, (gt, lt) != (0, 0)
OP_BSI_KEEP1, OP_BSI_KEEP2 = 0x20, 0x21
GT_KEEP, GT_CLEAR = 1, 2
LT_CLEAR, LT_KEEP = 1, 2

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
# An SM's shared memory (H100: 228 KB), of which the runtime keeps 1 KB
# per resident block: a hoisted launch sizes its ring so that two blocks
# share an SM (k1_hoist_stages).
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024

K1_VARIANTS = ("staged", "streaming")
# K3's first pass: each block scans K3_BLOCK_WORDS words of every plane
# (must match csrc/bitplane_kernels.cu: 256 threads x 4 uint4).
K3_BLOCK_WORDS = 4096
K3_MAX_DEPTH = 63
# Launches per kernel; K1's also per variant, and its staged launches that
# ran hoist programs under gather_expr_count_hoisted.
LAUNCHES: Dict[str, int] = {"gather_expr_count": 0, "gather_expr_count_staged": 0,
                            "gather_expr_count_streaming": 0, "gather_expr_count_hoisted": 0,
                            "masked_plane_counts": 0, "bsi_minmax": 0}
PLAIN_CALLS: Dict[str, int] = {"gather_expr_count": 0, "masked_plane_counts": 0,
                               "bsi_minmax": 0}
# Host-to-device copies of K1's staging buffer: one per distinct device
# per device call, whatever the number of blocks.
STAGED: Dict[str, int] = {"gather_expr_count": 0}


# The server launches from many threads: a count is one locked add.
_count_lock = threading.Lock()


def _count(counters: Dict[str, int], *names: str) -> None:
    with _count_lock:
        for name in names:
            counters[name] += 1


def reset_counters() -> None:
    with _count_lock:
        for d in (LAUNCHES, PLAIN_CALLS, STAGED):
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


class KernelBuildError(RuntimeError):
    """The kernel library could not be built or loaded. Not a device
    fault: the engine's dispatch guard re-raises it untouched (no
    classification, no breaker record, no fallback rung), so a broken
    build stops the caller instead of being answered on the host."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


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
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise KernelBuildError(f"cannot run nvcc ({cmd[0]}): {e}") from e
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    BUILD_LOG = proc.stdout + proc.stderr
    return time.perf_counter() - t0


def load():
    """The bound library, building it first if needed. Raises
    KernelBuildError when it can neither be built nor loaded — there is
    no fallback for CUDA tensors."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()  # pilint: allow-blocking(one build per process; every caller waits for the library)
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise KernelBuildError(f"cannot load {LIBRARY}: {e}") from e
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pt_k1_streaming.argtypes = [vp, i64, vp, i32, vp, i32, i32, vp, vp]
        lib.pt_k1_streaming.restype = i32
        lib.pt_k1_staged.argtypes = [
            vp, i64, vp, i32, i32, vp, i32, vp, vp, i32, i32, i32, i32, vp, i32, vp, vp]
        lib.pt_k1_staged.restype = i32
        lib.pt_masked_plane_counts.argtypes = [vp, vp, i32, i32, i64, vp, vp]
        lib.pt_masked_plane_counts.restype = i32
        lib.pt_bsi_minmax.argtypes = [vp, vp, i32, i64, i32, vp, i32, vp, vp, vp]
        lib.pt_bsi_minmax.restype = i32
        _lib = lib
        return _lib


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ tape


def bsi_step(gt: int, lt: int, slot: int) -> int:
    """The code of one BSI plane step (module docstring)."""
    return OP_BSI_STEP | gt | (lt << 2) | (slot << 8)


def _op_kind(op: int) -> str:
    """'push', 'binary', 'acc', 'bsi_push', 'step' or 'keep'; raises on an
    op byte no evaluator knows."""
    if op == OP_PUSH:
        return "push"
    if OP_AND <= op <= OP_NOTAND:
        return "binary"
    if OP_AND <= op - OP_ACC <= OP_NOTAND:
        return "acc"
    if op == OP_BSI_PUSH:
        return "bsi_push"
    if op in (OP_BSI_KEEP1, OP_BSI_KEEP2):
        return "keep"
    if op & ~0xF == OP_BSI_STEP and (op & 3) <= 2 and (op >> 2) & 3 <= 2:
        return "step"
    raise ValueError(f"unknown tape op {op}")


def reads_slot(code: int) -> bool:
    """Whether a code reads a leaf plane (its slot field is a slot)."""
    return _op_kind(code & 0xFF) in ("push", "acc", "bsi_push", "step")


def has_bsi(tape: Sequence[int]) -> bool:
    return any(code & 0xFF >= OP_BSI_PUSH for code in tape)


def tape_depth(tape: Sequence[int]) -> int:
    """Largest evaluation-stack depth the tape reaches; raises on a tape
    that underflows, names an unknown op, does not leave exactly one
    value, or holds a BSI step or keep outside a compare (before any
    OP_BSI_PUSH, or after a push, binary op or keep ended the compare)."""
    depth = peak = 0
    in_compare = False
    for code in tape:
        kind = _op_kind(code & 0xFF)
        if kind in ("push", "bsi_push"):
            depth += 1
            in_compare = kind == "bsi_push"
        elif kind == "binary":
            depth -= 1
            in_compare = False
            if depth < 1:
                raise ValueError(f"op tape underflows: {list(tape)}")
        else:
            if depth < 1:
                raise ValueError(f"op tape underflows: {list(tape)}")
            if kind != "acc" and not in_compare:
                raise ValueError(f"BSI {kind} outside a compare: {list(tape)}")
            if kind == "keep":
                if code >> 8:
                    raise ValueError(f"BSI keep code {code} carries a slot")
                in_compare = False
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
    keep1 = keep2 = None
    for code in tape:
        op = code & 0xFF
        kind = _op_kind(op)
        if kind in ("push", "bsi_push"):
            stack.append(leaf(code >> 8))
            if kind == "bsi_push":
                keep1 = keep2 = torch.zeros_like(stack[-1])
        elif kind == "acc":
            stack[-1] = _apply(op & ~OP_ACC, stack[-1], leaf(code >> 8))
        elif kind == "binary":
            b = stack.pop()
            stack[-1] = _apply(op, stack[-1], b)
        elif kind == "keep":
            stack[-1] = keep1 if op == OP_BSI_KEEP1 else keep2
        else:  # step: the ">" part, then the "<" part
            row, gt, lt = leaf(code >> 8), op & 3, (op >> 2) & 3
            if gt == GT_KEEP:
                keep1 = torch.bitwise_or(keep1, torch.bitwise_and(stack[-1], row))
            elif gt == GT_CLEAR:
                stack[-1] = torch.bitwise_and(stack[-1], torch.bitwise_or(row, keep1))
            if lt == LT_CLEAR:
                stack[-1] = torch.bitwise_and(
                    stack[-1], torch.bitwise_or(torch.bitwise_not(row), keep2))
            elif lt == LT_KEEP:
                keep2 = torch.bitwise_or(
                    keep2, torch.bitwise_and(stack[-1], torch.bitwise_not(row)))
    return stack[0]


# -------------------------------------------------------------------- K1


def k1_ring_stages(distinct: int) -> int:
    """Stages of the staged variant's ring that `distinct` rows fill
    (at most RING_MAX_STAGES): the distinct slots of a tile, plus one
    synthetic row per hoist program when the launch has any. Below 2 the
    ring cannot overlap a copy with the compute, and the staged variant
    is not taken."""
    if distinct < 1:
        return 0
    return min(RING_MAX_STAGES, RING_BYTES // (distinct * RING_SLOT_BYTES))


def k1_hoist_stages(rows: int) -> int:
    """Ring stages of a hoisted launch whose query tape holds no BSI codes
    (`rows` = synthetic rows + distinct slots): as many as let two blocks
    share an SM (at most RING_MAX_STAGES), since a block's hoist programs
    are one short dependent chain per chunk and a second block's chain and
    copies fill the SM meanwhile; below two such stages, the one-block
    ring's."""
    two = (SM_SHARED_BYTES // 2 - BLOCK_RESERVED_BYTES) // (rows * RING_SLOT_BYTES)
    return min(RING_MAX_STAGES, two) if two >= 2 else k1_ring_stages(rows)


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
        if reads_slot(code) and not 0 <= code >> 8 < n_leaves:
            raise ValueError(f"tape names slot {code >> 8} of {n_leaves}")


def gather_expr_count_plain(stacked: torch.Tensor, idxs: torch.Tensor,
                            tape: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch twin of K1: one query at a time, so the (Q, S, W)
    gather is never materialized here either."""
    _count(PLAIN_CALLS, "gather_expr_count")
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


# A value of a tape, parsed: (start code, mods). A mod is a code that acts
# on the value in place (a fused op, a BSI step or keep) or a pair (nested
# value, the binary op code that folds it in).
_Value = Tuple[int, list]


def _parse_value(tape: Sequence[int], i: int) -> Tuple[_Value, int]:
    """The value whose start code is tape[i], up to the binary op that
    ends its stack level or the tape's end; returns it and that index."""
    start, mods = tape[i], []
    i += 1
    while i < len(tape):
        kind = _op_kind(tape[i] & 0xFF)
        if kind == "binary":
            break
        if kind in ("push", "bsi_push"):
            sub, i = _parse_value(tape, i)
            mods.append((sub, tape[i]))
        else:
            mods.append(tape[i])
        i += 1
    return (start, mods), i


def _emit_value(value: _Value, out: List[int]) -> List[int]:
    start, mods = value
    out.append(start)
    for m in mods:
        if isinstance(m, tuple):
            _emit_value(m[0], out)
            out.append(m[1])
        else:
            out.append(m)
    return out


def _value_reads(value: _Value, invariant: Sequence[bool]) -> Tuple[int, bool]:
    """(codes of the value that read a plane, whether all of them read an
    invariant leaf position)."""
    start, mods = value
    n, inv = 1, bool(invariant[start >> 8])
    for m in mods:
        if isinstance(m, tuple):
            sub_n, sub_inv = _value_reads(m[0], invariant)
            n, inv = n + sub_n, inv and sub_inv
        elif reads_slot(m):
            n, inv = n + 1, inv and bool(invariant[m >> 8])
    return n, inv


def k1_split(tape: Sequence[int],
             invariant: Sequence[bool]) -> Tuple[List[int], List[List[int]]]:
    """Split a valid tape into (query tape, hoist programs). `invariant[j]`
    says leaf position j names the same slot for every query of the
    launch. Each maximal span that yields one value from invariant
    positions alone and reads two planes or more becomes a program (its
    codes as they were, slots still leaf positions): a whole value (a BSI
    compare with its steps and keep, a nested subtree, the whole tape), or
    the invariant prefix of a value's fold (``PUSH g1, ACC_AND g2`` before
    a per-query ``ACC_AND f``). Program h's result is leaf position
    L + h of the query tape (L = len(invariant)), read there by a PUSH, or
    by one fused op where the span was a nested value, so neither tape
    is deeper than the original.

    Left as they were, since hoisting them would reorder operands or save
    nothing: invariant operands of a fold after its first per-query one;
    a compare whose steps interleave with a per-query fused op; a lone
    invariant leaf. Invariance is over the launch, not per tile, so one
    query tape serves every tile."""
    n_leaves = len(invariant)
    programs: List[List[int]] = []

    def hoist(value: _Value) -> int:
        programs.append(_emit_value(value, []))
        return n_leaves + len(programs) - 1

    def mod_invariant(m) -> bool:
        if isinstance(m, tuple):
            return _value_reads(m[0], invariant)[1]
        return not reads_slot(m) or bool(invariant[m >> 8])

    def split(value: _Value) -> Tuple[_Value, bool]:
        start, mods = value
        n, inv = _value_reads(value, invariant)
        if inv and n >= 2:
            return (OP_PUSH | hoist(value) << 8, []), True
        k = 0
        if invariant[start >> 8]:
            while k < len(mods) and mod_invariant(mods[k]):
                k += 1
            # A compare's keeps live until its last step or keep: a prefix
            # that stops before it would lose them.
            if start & 0xFF == OP_BSI_PUSH and any(
                    not isinstance(m, tuple) and _op_kind(m & 0xFF) in ("step", "keep")
                    for m in mods[k:]):
                k = 0
            if k and _value_reads((start, mods[:k]), invariant)[0] >= 2:
                start, mods = OP_PUSH | hoist((start, mods[:k])) << 8, mods[k:]
        out = []
        for m in mods:
            if isinstance(m, tuple):
                sub, whole = split(m[0])
                out.append((OP_ACC | m[1]) | (sub[0] & ~0xFF) if whole else (sub, m[1]))
            else:
                out.append(m)
        return (start, out), False

    root, end = _parse_value(list(tape), 0)
    if end != len(tape):
        raise ValueError(f"op tape leaves more than one value: {list(tape)}")
    return _emit_value(split(root)[0], []), programs


def k1_hoisted_tiles(idx_np: np.ndarray, programs: Sequence[Sequence[int]]
                     ) -> Tuple[List[np.ndarray], np.ndarray, List[List[int]]]:
    """The staged ring's remap for a launch with H hoist programs. A stage
    holds the H synthetic rows first, then the tile's staged rows: the
    rows the programs read (the same in every tile, ascending), then the
    tile's other distinct rows (ascending). Returns (staged rows per tile,
    qpos (Q, L + H) stage rows, the last H columns the synthetic rows,
    the programs with each slot rebased onto its stage row). A code that
    reads no slot (a binary op, a keep) is pointed at row H, the first
    staged row: the kernel loads its operand word before it decodes the
    op, and that row is landed and written by no thread while the
    programs run."""
    n_leaves, q = idx_np.shape
    h = len(programs)
    read = sorted({c >> 8 for p in programs for c in p if reads_slot(c)})
    shared = np.unique(idx_np[read, 0]).astype(np.int32)
    row_at = {int(r): h + i for i, r in enumerate(shared)}
    rebased = [[(c & 0xFF) | ((row_at[int(idx_np[c >> 8, 0])] if reads_slot(c) else h) << 8)
                for c in p] for p in programs]
    urows: List[np.ndarray] = []
    qpos = np.empty((q, n_leaves + h), dtype=np.int32)
    qpos[:, n_leaves:] = np.arange(h, dtype=np.int32)
    for t0 in range(0, q, Q_TILE):
        part = idx_np[:, t0:t0 + Q_TILE]
        rows = np.concatenate([shared, np.setdiff1d(part, shared)]).astype(np.int32)
        order = np.argsort(rows)
        pos = order[np.searchsorted(rows[order], part)]
        urows.append(rows)
        qpos[t0:t0 + part.shape[1], :n_leaves] = h + pos.T
    return urows, qpos, rebased


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host-to-device copy that does not wait for the stream: staged
    through pinned memory from PyTorch's caching host allocator, which
    keeps the pinned block until the copy has run. Counted in STAGED."""
    _count(STAGED, "gather_expr_count")
    return torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)


class _K1Staging:
    """K1's host work for one device call, done once whatever the number
    of blocks: the variant, the staged ring's tiles and hoist programs,
    and the one int32 buffer every launch reads (streaming: tape | idxs;
    staged: tape | hoists | tiles (offset into urows, distinct slots) |
    urows | qpos, hoists = H + 1 program offsets then the programs,
    present when H > 0), with the element offset of each part."""

    __slots__ = ("variant", "stages", "bsi", "q", "n_leaves", "n_tape", "host",
                 "tiles_at", "n_tiles", "urows_at", "qpos_at", "max_distinct",
                 "n_hoist", "hoists_at")

    def __init__(self, idxs: torch.Tensor, tape: List[int], variant: Optional[str]):
        idx_np = np.ascontiguousarray(idxs.numpy())
        self.n_leaves, self.q = idx_np.shape
        self.stages = self.n_hoist = 0
        if variant != "streaming" and (self.q > 1 or variant == "staged"):
            urows, qpos = k1_tiles(idx_np)
            distinct = max(len(r) for r in urows)
            if variant is None:
                variant, self.stages = k1_plan(distinct, self.q)
            else:
                self.stages = k1_ring_stages(distinct)
                if self.stages < 2:
                    raise ValueError(
                        f"{distinct} distinct slots do not fit the staged variant's ring "
                        f"({RING_BYTES // (2 * RING_SLOT_BYTES)} at most)")
        self.variant = variant or "streaming"
        hoists = np.empty(0, dtype=np.int32)
        if self.variant == "staged":
            invariant = (idx_np == idx_np[:, :1]).all(axis=1)
            if invariant.any():
                q_tape, programs = k1_split(tape, invariant)
                # The synthetic rows must leave the ring two stages.
                rows = distinct + len(programs)
                stages = k1_ring_stages(rows) if has_bsi(q_tape) else k1_hoist_stages(rows)
                if programs and stages >= 2:
                    urows, qpos, rebased = k1_hoisted_tiles(idx_np, programs)
                    tape, self.stages, self.n_hoist = q_tape, stages, len(programs)
                    self.n_leaves += self.n_hoist
                    hoists = np.concatenate([np.cumsum([0] + [len(p) for p in rebased]),
                                             *rebased]).astype(np.int32)
        # Tapes with BSI codes run the kernels' instantiation that keeps
        # the two compare masks; set-op tapes keep the registers for the
        # rest. Hoist programs run the BSI evaluator whatever they hold.
        self.bsi = has_bsi(tape)
        tape_np = np.asarray(tape, dtype=np.int32)
        self.n_tape = len(tape_np)
        self.hoists_at = self.n_tape
        if self.variant == "staged":
            sizes = [len(r) for r in urows]
            tiles = np.stack([np.cumsum([0] + sizes[:-1]), sizes], axis=1).astype(np.int32)
            self.host = np.concatenate([tape_np, hoists, tiles.ravel(), *urows, qpos.ravel()])
            self.tiles_at = self.hoists_at + hoists.size
            self.n_tiles = len(urows)
            self.urows_at = self.tiles_at + tiles.size
            self.qpos_at = self.urows_at + sum(sizes)
            self.max_distinct = max(sizes)
        else:
            self.host = np.concatenate([tape_np, idx_np.ravel()])

    def launch(self, lib, block: torch.Tensor, buf: torch.Tensor,
               out: torch.Tensor) -> int:
        """One launch over `block` reading `buf` (this staging's buffer on
        the block's device); returns the library's cudaError_t."""
        _, s, w = block.shape
        at = buf.data_ptr()
        if self.variant == "staged":
            return lib.pt_k1_staged(
                block.data_ptr(), s * w, at, self.n_tape, self.n_leaves,
                at + 4 * self.tiles_at, self.n_tiles, at + 4 * self.urows_at,
                at + 4 * self.qpos_at, self.q, self.max_distinct, self.stages,
                int(self.bsi), at + 4 * self.hoists_at if self.n_hoist else None,
                self.n_hoist, out.data_ptr(), _stream(block))
        return lib.pt_k1_streaming(
            block.data_ptr(), s * w, at, self.n_tape, at + 4 * self.n_tape, self.q,
            int(self.bsi), out.data_ptr(), _stream(block))


def gather_expr_count(stacked: torch.Tensor, idxs: torch.Tensor,
                      tape: Sequence[int],
                      variant: Optional[str] = None) -> torch.Tensor:
    """K1: (Q,) int64 counts. `stacked` (U, S, W) int32 resident leaf
    stack; `idxs` (L, Q) int32 slot ids on the host (row j = leaf position
    j of the tape), range-checked here and copied to the stack's device
    with the tape in one buffer; `tape` the postfix op codes. `variant`
    names the kernel variant (k1_plan chooses when it is None); naming
    "staged" for slots that do not fit its ring raises."""
    return gather_expr_count_blocks([stacked], idxs, tape, variant)[0]


def gather_expr_count_blocks(blocks: Sequence[torch.Tensor], idxs: torch.Tensor,
                             tape: Sequence[int],
                             variant: Optional[str] = None) -> List[torch.Tensor]:
    """K1 over every block of one device call: the (Q,) int64 counts of
    each (U, S_b, W) block (the same U slots over its own shards), one
    launch per block on the block's device, made current for it. The
    host work runs once: the checks, k1_tiles and k1_plan, and the one
    staging buffer, copied once to each distinct device among the blocks
    (STAGED counts the copies). The ring plan depends on `idxs` and Q
    alone, so every block takes the same variant; blocks must agree in U,
    W and dtype. CPU blocks run the plain twin. The call runs in one
    `k1.stage` span (tags `variant`, "plain" where no block is on a card,
    `q` and `blocks`): the host work up to the last launch's return, and
    on the CPU the plain twin's count."""
    with obs_span("k1.stage") as sp:
        outs, ran = _k1_call(blocks, idxs, tape, variant)
        if sp is not NOP_SPAN:
            sp.tag(variant=ran, q=int(idxs.shape[1]), blocks=len(blocks))
    return outs


def _k1_call(blocks: Sequence[torch.Tensor], idxs: torch.Tensor,
             tape: Sequence[int], variant: Optional[str]):
    """gather_expr_count_blocks' work: (the counts of each block, the
    variant launched or "plain")."""
    tape = [int(c) for c in tape]
    if not blocks:
        raise ValueError("no blocks")
    _check_k1(blocks[0], idxs, tape)
    for block in blocks[1:]:
        _check_k1_like(blocks[0], block)
    if variant is not None and variant not in K1_VARIANTS:
        raise ValueError(f"unknown K1 variant {variant!r}")
    q = idxs.shape[1]
    outs: List[Optional[torch.Tensor]] = [None] * len(blocks)
    on_card = []
    for i, block in enumerate(blocks):
        if not block.is_cuda:
            outs[i] = gather_expr_count_plain(block, idxs, tape)
            continue
        _, s, w = block.shape
        if (s * w) % 4 or block.data_ptr() % 16:
            raise ValueError("K1 needs 16-byte aligned planes (S*W % 4 == 0)")
        outs[i] = torch.zeros(q, dtype=torch.int64, device=block.device)
        if q and s * w:
            on_card.append(i)
    if not on_card:
        return outs, "plain"
    staging = _K1Staging(idxs, tape, variant)
    lib = load()
    bufs: Dict[torch.device, torch.Tensor] = {}
    for i in on_card:
        block = blocks[i]
        dev = block.device
        # The library launches on the current device and reads its
        # attributes (the staged variant's shared-memory limit): make the
        # block's current.
        with torch.cuda.device(dev):
            if dev not in bufs:
                bufs[dev] = _to_device(staging.host, dev)
            err = staging.launch(lib, block, bufs[dev], outs[i])
        _check_launch(f"gather_expr_count ({staging.variant})", err)
        _count(LAUNCHES, "gather_expr_count", f"gather_expr_count_{staging.variant}",
               *(("gather_expr_count_hoisted",) if staging.n_hoist else ()))
    return outs, staging.variant


def _check_k1_like(first: torch.Tensor, block: torch.Tensor) -> None:
    """A further block of one K1 call: the first block's slots (U), width
    (W) and dtype, contiguous."""
    if block.dim() != 3 or block.dtype != first.dtype \
            or block.shape[0] != first.shape[0] or block.shape[2] != first.shape[2]:
        raise ValueError(f"block {tuple(block.shape)} {block.dtype} does not match "
                         f"the first block {tuple(first.shape)} {first.dtype} in U, W "
                         "and dtype")
    if not block.is_contiguous():
        raise ValueError("blocks must be contiguous")


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
    _count(PLAIN_CALLS, "masked_plane_counts")
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
    with torch.cuda.device(stack.device):
        err = lib.pt_masked_plane_counts(
            stack.data_ptr(), None if mask is None else mask.data_ptr(), r, s, w,
            out.data_ptr(), _stream(stack))
    _check_launch("masked_plane_counts", err)
    _count(LAUNCHES, "masked_plane_counts")
    return out


# -------------------------------------------------------------------- K3


def _check_k3(planes, mask) -> None:
    _check_k2(planes, mask)
    if not 1 <= planes.shape[0] <= K3_MAX_DEPTH + 1:
        raise ValueError(f"a BSI stack holds 1..{K3_MAX_DEPTH + 1} planes, "
                         f"got {planes.shape[0]}")


def bsi_minmax_plain(planes: torch.Tensor, mask: Optional[torch.Tensor],
                     maximize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K3: ops/bitplane.py's bsi_max / bsi_min over
    the stack flattened to (D+1, S*W), so every step's "popcount > 0" is
    global across the shards."""
    _count(PLAIN_CALLS, "bsi_minmax")
    depth = planes.shape[0] - 1
    flat = planes.reshape(depth + 1, -1)
    flt = None if mask is None else mask.reshape(-1)
    bits, count = (bsi_max if maximize else bsi_min)(flat, depth, flt)
    return bits, count.to(torch.int64)


def bsi_minmax(planes: torch.Tensor, mask: Optional[torch.Tensor] = None,
               maximize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: the Min (maximize=False) or Max scan of a (D+1, S, W) int32 BSI
    stack, plane D the not-null row, its columns ANDed with mask (S, W)
    when given. Returns (bits (D,) int32, count () int64) on the stack's
    device: bit i of the extreme value, and how many columns hold it.
    With no column considered, bits are all 0 (max) or all 1 (min) and
    count is 0, as the TPU engine's scan gives them."""
    _check_k3(planes, mask)
    if not planes.is_cuda:
        return bsi_minmax_plain(planes, mask, maximize)
    d1, s, w = planes.shape
    if w % 4 or planes.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("K3 needs 16-byte aligned planes (W % 4 == 0)")
    bits = torch.zeros(d1 - 1, dtype=torch.int32, device=planes.device)
    count = torch.zeros((), dtype=torch.int64, device=planes.device)
    if s * w == 0:
        if not maximize:
            bits.fill_(1)
        return bits, count
    n_blocks = -(-s * w // K3_BLOCK_WORDS)
    part = torch.empty((n_blocks, 2), dtype=torch.int64, device=planes.device)
    lib = load()
    with torch.cuda.device(planes.device):
        err = lib.pt_bsi_minmax(
            planes.data_ptr(), None if mask is None else mask.data_ptr(), d1 - 1, s * w,
            int(maximize), part.data_ptr(), n_blocks, bits.data_ptr(), count.data_ptr(),
            _stream(planes))
    _check_launch("bsi_minmax", err)
    _count(LAUNCHES, "bsi_minmax")
    return bits, count
