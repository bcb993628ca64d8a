"""One node's query engine: resident leaf planes and stacks in device
memory over the node's shard partitions, counted by the hand-written
kernels of ops/kernels.py.

The counterpart of pilosa_tpu/parallel/engine.py. A PQL tree (Row /
Intersect / Union / Difference / Xor, BSI and time-quantum Range) is
canonicalized by plan/signature.py; its leaf planes are gathered once
from the fragments and cached, keyed on the fragments' (incarnation,
generation) fingerprints.

The engine runs over a mesh of N partitions (parallel/mesh.py; `[engine]
mesh-devices`, one per local card by default, one on the CPU): an
(S, W) leaf plane is padded to S_padded = a multiple of N shard slots
and held as ``Blocks``, one contiguous (S_padded / N, W) int32 block per
partition on that partition's device, padding slots zero; a stack is N
(U, S_padded / N, W) blocks. Every entry point launches its kernel on
each partition's block before it reads any result, so partitions on
different cards run at once, and reduces the partials itself (the
reference's psum): counts summed on partition 0's device, per-shard
counts and bitmaps joined in shard order and trimmed, Min/Max folded as
K3's own reduce folds its blocks. There is no fallback to fewer
partitions: a partition that cannot be placed or launched fails the call.

- ``count`` and ``count_batch`` run K1 (``gather_expr_count``) over a
  resident (U, S_padded, W) stack of the batch's distinct leaves, the query's
  expression compiled to a postfix op tape (``lower_tape``; BSI compares
  unroll into per-plane codes). A single Count is the batch of one: Q=1,
  idxs = arange(L).
- ``bitmap`` evaluates the tree with elementwise torch ops (``_lower_ir``)
  and returns a Row whose segments stay on the device; ``bitmap_batch``
  evaluates Q same-signature set-op trees over one stack of the batch's
  distinct leaves (``_batch_eval``), for the micro-batcher.
- ``topn_shard_counts`` / ``topn_counts`` run K2 (``masked_plane_counts``)
  over the stacked candidate rows, with the src tree's plane as the mask.
- ``bsi_val_count`` runs BSI Sum on K2 over the (D+1, S, W) plane stack
  and Min/Max on K3 (``bsi_minmax``).
- ``supports`` is the compile gate: a tree the plan compiler refuses is
  walked shard by shard by the executor.

Around them, the layers of the reference engine, at its semantics and
defaults:
- the result memo (Counts) and the aux memo (TopN matrices, BSI val
  counts), probed with an O(1) write-epoch check before any device work;
- delta refresh: a stale resident plane or stack is refreshed by a
  scatter of the words the fragments' dirty-word journals name, into a
  clone of the cached tensor;
- tiering (tier/): evicted leaf planes demote into a compressed host
  tier and promote back, and a first Count over all-demoted planes is
  answered on the host from the compressed bytes;
- the device-fault ladder (device_health.py): every dispatch runs under
  ``_device_call`` (the `device-dispatch` failpoint, a watchdog,
  classification into breakers, OOM backpressure and one retry), and the
  host evaluators (``host_count``, ``host_topn_shard_counts``, numpy) are
  the ladder's bottom rung. On the card a real fault of a kernel raises
  DeviceKernelFault out of the query; only a CPU-device engine or an
  injected fault is served one rung down.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import failpoints
from ..constants import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD, WORDS_PER_ROW
from ..core.row import Row
from ..errors import PilosaError, QueryError
from ..obs import NOP_SPAN
from ..obs import span as obs_span
from ..ops import bitplane as bp
from ..ops import kernels
from ..plan.signature import CompiledPlan, Leaf, cached_plan, resolve_time_range
from ..pql.ast import Call
from ..tier import TierConfig
from ..tier.manager import TierManager
from . import EngineConfig
from .mesh import engine_mesh, pad_shards
from .device_health import (
    OOM, RUNTIME, DeviceDispatchError, DeviceDispatchTimeout, DeviceKernelFault,
    DevicePlaneHealth, classify_device_error,
)

log = logging.getLogger(__name__)

_BINARY = {
    "Intersect": kernels.OP_AND,
    "Union": kernels.OP_OR,
    "Xor": kernels.OP_XOR,
}
_TORCH_OPS = {
    "Intersect": torch.bitwise_and,
    "Union": torch.bitwise_or,
    "Xor": torch.bitwise_xor,
}


def _lower_ir(ir: tuple) -> Callable:
    """Canonical IR (plan/signature.py) -> torch closure over the tuple of
    (S, W) leaf planes. A k-ary node reduces its k operands in one chained
    pass; a Difference pays ONE complement for its whole subtracting set
    (head AND NOT(OR(tail))); BSI compares run ops/bitplane.py's bit-serial
    programs over their stacked planes."""
    kind = ir[0]
    if kind == "leaf":
        i = ir[1]
        return lambda leaves: leaves[i]
    if kind in _TORCH_OPS:
        subs = [_lower_ir(ch) for ch in ir[1]]
        op = _TORCH_OPS[kind]

        def fn(leaves, subs=subs, op=op):
            out = subs[0](leaves)
            for s in subs[1:]:
                out = op(out, s(leaves))
            return out

        return fn
    if kind == "Difference":
        head = _lower_ir(ir[1])
        tails = [_lower_ir(ch) for ch in ir[2]]
        if not tails:
            return head

        def fn(leaves, head=head, tails=tails):
            mask = tails[0](leaves)
            for t in tails[1:]:
                mask = torch.bitwise_or(mask, t(leaves))
            return torch.bitwise_and(head(leaves), torch.bitwise_not(mask))

        return fn
    if kind == "timerange":
        idxs = ir[1]

        def fn(leaves, idxs=idxs):
            out = leaves[idxs[0]]
            for i in idxs[1:]:
                out = torch.bitwise_or(out, leaves[i])
            return out

        return fn
    if kind == "zero":
        i = ir[1]
        return lambda leaves: torch.zeros_like(leaves[i])
    if kind == "notnull":
        i = ir[1]
        return lambda leaves: leaves[i]
    if kind == "between":
        idxs, depth, lo, hi = ir[1], ir[2], ir[3], ir[4]
        return lambda leaves: bp.bsi_range_between(
            torch.stack([leaves[i] for i in idxs]), depth, lo, hi)
    if kind == "cmp":
        _, op, idxs, depth, base = ir

        def fn(leaves, op=op, idxs=idxs, depth=depth, base=base):
            planes = torch.stack([leaves[i] for i in idxs])
            if op == "eq":
                return bp.bsi_range_eq(planes, depth, base)
            if op == "neq":
                return bp.bsi_range_neq(planes, depth, base)
            if op in ("lt", "lte"):
                return bp.bsi_range_lt(planes, depth, base, op == "lte")
            return bp.bsi_range_gt(planes, depth, base, op == "gte")

        return fn
    raise QueryError(f"unknown plan IR node: {kind!r}")


_INPLACE_OPS = {
    "Intersect": torch.Tensor.bitwise_and_,
    "Union": torch.Tensor.bitwise_or_,
    "Xor": torch.Tensor.bitwise_xor_,
}


def _batch_eval(ir: tuple, gather: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Set-op IR -> one (Q, S, W) tensor for a batch of Q queries.
    ``gather(i)`` returns a new (Q, S, W) tensor holding every query's
    plane at leaf position i. Each node folds its operands into the first
    operand's tensor in place, so a flat tree holds one output and one
    gathered leaf at a time (a nested tree, one more per level), never
    all L gathered leaves."""
    kind = ir[0]
    if kind == "leaf":
        return gather(ir[1])
    if kind == "Difference":
        out = _batch_eval(ir[1], gather)
        for ch in ir[2]:
            out.bitwise_and_(_batch_eval(ch, gather).bitwise_not_())
        return out
    op = _INPLACE_OPS[kind]
    out = _batch_eval(ir[1][0], gather)
    for ch in ir[1][1:]:
        op(out, _batch_eval(ch, gather))
    return out


def _fold(first: Tuple[List[int], int],
          rest: Sequence[Tuple[int, Tuple[List[int], int]]]) -> Tuple[List[int], int]:
    """Fold operands into the first one's value: a lone leaf becomes one
    fused ``OP_ACC | op`` code on the top of the stack; a subtree is
    emitted above it (one level deeper) and combined with the binary op.
    Returns (codes, stack depth needed)."""
    ops, need = list(first[0]), first[1]
    for op, (sub, sub_need) in rest:
        if len(sub) == 1 and sub[0] & 0xFF == kernels.OP_PUSH:
            ops.append((kernels.OP_ACC | op) | (sub[0] & ~0xFF))
        else:
            ops.extend(sub)
            ops.append(op)
            need = max(need, 1 + sub_need)
    return ops, need


def _first_key(sub: Tuple[List[int], int]) -> Tuple[int, bool]:
    """Sethi-Ullman order of a node's operands: the one that needs the
    deepest stack goes first, a subtree before a lone leaf at equal depth
    (a leaf after the first costs no stack, a subtree one level), ties in
    the canonical order."""
    return -sub[1], len(sub[0]) == 1


def _push(slot: int) -> int:
    return kernels.OP_PUSH | (slot << 8)


def _acc(op: int, slot: int) -> int:
    return kernels.OP_ACC | op | (slot << 8)


def _compare_codes(op: str, idxs: Sequence[int], depth: int, base: int) -> List[int]:
    """One BSI compare unrolled into K1 codes, plane by plane, exactly as
    ops/bitplane.py's bsi_range_* walk the planes (reference
    fragment.go:683-800): the predicate's bits, its leading zeros and the
    strict last step are settled here. idxs[i] is the slot of value plane
    i, idxs[depth] that of the not-null row."""
    K = kernels
    notnull = idxs[depth]
    bits = [(base >> i) & 1 for i in range(depth)]
    if op in ("eq", "neq"):
        codes = [_push(notnull)] + [
            _acc(K.OP_AND if bits[i] else K.OP_ANDNOT, idxs[i])
            for i in range(depth - 1, -1, -1)]
        if op == "neq":  # not-null minus eq: ~eq & notnull
            codes.append(_acc(K.OP_NOTAND, notnull))
        return codes
    codes = [K.OP_BSI_PUSH | (notnull << 8)]
    if op in ("lt", "lte"):
        leading_zeros = True
        for i in range(depth - 1, -1, -1):
            if leading_zeros:
                if bits[i] == 0:
                    codes.append(_acc(K.OP_ANDNOT, idxs[i]))
                    continue
                leading_zeros = False
            if i == 0 and op == "lt":
                codes.append(K.OP_BSI_KEEP2 if bits[i] == 0
                             else K.bsi_step(0, K.LT_CLEAR, idxs[0]))
                break
            if bits[i] == 0:
                codes.append(K.bsi_step(0, K.LT_CLEAR, idxs[i]))
            elif i > 0:
                codes.append(K.bsi_step(0, K.LT_KEEP, idxs[i]))
    else:  # gt, gte
        for i in range(depth - 1, -1, -1):
            if i == 0 and op == "gt":
                codes.append(K.OP_BSI_KEEP1 if bits[i] == 1
                             else K.bsi_step(K.GT_CLEAR, 0, idxs[0]))
                break
            if bits[i] == 1:
                codes.append(K.bsi_step(K.GT_CLEAR, 0, idxs[i]))
            elif i > 0:
                codes.append(K.bsi_step(K.GT_KEEP, 0, idxs[i]))
    return codes


def _between_codes(idxs: Sequence[int], depth: int, lo: int, hi: int) -> List[int]:
    """`lo <= value <= hi` unrolled (reference fragment.go:812-851): per
    plane one step carrying the ">=" part (keep1) and the "<=" part
    (keep2)."""
    K = kernels
    codes = [K.OP_BSI_PUSH | (idxs[depth] << 8)]
    for i in range(depth - 1, -1, -1):
        gt = K.GT_CLEAR if (lo >> i) & 1 else (K.GT_KEEP if i > 0 else 0)
        lt = K.LT_CLEAR if not (hi >> i) & 1 else (K.LT_KEEP if i > 0 else 0)
        if gt or lt:
            codes.append(K.bsi_step(gt, lt, idxs[i]))
    return codes


def _emit(node: tuple) -> Tuple[List[int], int]:
    kind = node[0]
    if kind == "leaf":
        return [_push(node[1])], 1
    if kind == "timerange":
        slots = node[1]
        return [_push(slots[0])] + [_acc(kernels.OP_OR, s) for s in slots[1:]], 1
    if kind == "zero":
        return [_push(node[1]), _acc(kernels.OP_ANDNOT, node[1])], 1
    if kind == "notnull":
        return [_push(node[1])], 1
    if kind in ("cmp", "between"):
        codes = (_compare_codes(*node[1:]) if kind == "cmp" else _between_codes(*node[1:]))
        if len(codes) == 1:  # depth 0: the not-null row itself
            codes = [_push(codes[0] >> 8)]
        return codes, 1
    if kind in _BINARY:
        subs = sorted((_emit(ch) for ch in node[1]), key=_first_key)
        return _fold(subs[0], [(_BINARY[kind], t) for t in subs[1:]])
    if kind == "Difference":
        head = _emit(node[1])
        tails = [_emit(ch) for ch in node[2]]
        if not tails:
            return head
        # head & ~t1 & ... & ~tn, deepest operand first: tails before the
        # head are ORed together and the head joins with NOTAND
        # (~tails & head); tails after it join with ANDNOT.
        order = sorted([(True, head)] + [(False, t) for t in tails],
                       key=lambda e: _first_key(e[1]))
        rest, seen_head = [], order[0][0]
        for is_head, sub in order[1:]:
            if is_head:
                rest.append((kernels.OP_NOTAND, sub))
                seen_head = True
            else:
                rest.append((kernels.OP_ANDNOT if seen_head else kernels.OP_OR, sub))
        return _fold(order[0][1], rest)
    raise QueryError(f"unknown plan IR node: {kind!r}")


def lower_tape(ir: tuple) -> Tuple[int, ...]:
    """Canonical set-op IR -> the postfix op tape K1 executes, computing
    the same function as _lower_ir (set identities only; counts are
    exact). A k-ary node folds its operands into an accumulator, leaves
    through fused ops, deepest subtree first, so a tree of n leaves needs
    a stack of at most floor(log2 n) + 1. Raises QueryError only past the
    kernel's limits: 2^23 distinct leaves, or a stack deeper than
    MAX_STACK (2^24 leaves)."""
    ops, need = _emit(ir)
    if need > kernels.MAX_STACK:
        raise QueryError(
            f"query tree nests {need} deep; the CUDA count kernel's "
            f"evaluation stack holds {kernels.MAX_STACK}")
    if max(code >> 8 for code in ops) >= kernels.MAX_SLOTS:
        raise QueryError(
            f"query tree names more than {kernels.MAX_SLOTS} distinct rows")
    return tuple(ops)


class _Lowered:
    """What the engine derives from one plan, cached on the plan's `expr`
    slot (plans are themselves cached on the Call tree)."""

    __slots__ = ("bitmap", "tape")

    def __init__(self, ir: tuple):
        self.bitmap = _lower_ir(ir)
        self.tape = lower_tape(ir)


def _lowered(plan: CompiledPlan) -> _Lowered:
    low = plan.expr
    if low is None:
        low = plan.expr = _Lowered(plan.ir)
    return low


def _pop_elems(a: np.ndarray) -> np.ndarray:
    """Elementwise popcounts of a uint32 array for the host execution
    ladder, returned over the uint16 view (same leading shape, last axis
    doubled) so callers sum over the trailing axis/axes for plane
    popcounts."""
    return np.bitwise_count(a.view(np.uint16))


class Blocks(tuple):
    """A leaf plane (S_padded, W) or a stack (U, S_padded, W) held as one
    contiguous block of S_padded / N shard slots per partition, block p
    on partition p's device (its shard axis is the last but one). Byte
    and element counts cover every block, padding included, as the
    reference's padded planes do."""

    __slots__ = ()

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self)

    def numel(self) -> int:
        return sum(b.numel() for b in self)

    def joined(self, n_shards: Optional[int] = None) -> torch.Tensor:
        """The blocks joined in shard order on block 0's device, trimmed to
        the first `n_shards` slots when given (one block: no copy)."""
        return _join(list(self), n_shards)


def _join(parts: Sequence[torch.Tensor], n_shards: Optional[int] = None) -> torch.Tensor:
    dev = parts[0].device
    out = parts[0] if len(parts) == 1 else torch.cat(
        [t.to(dev) for t in parts], dim=-2)
    if n_shards is not None and n_shards != out.shape[-2]:
        out = out.narrow(-2, 0, n_shards)
    return out


def _settled(t: torch.Tensor) -> torch.Tensor:
    """Wait for the device work that produces `t`: CUDA reports a fault at
    the sync point, not at the launch, so a guarded call that keeps its
    result on the device synchronizes inside the guard."""
    if t.is_cuda:
        with obs_span("device.sync"):
            torch.cuda.synchronize(t.device)
    return t


def _host_shards(parts: Sequence[torch.Tensor], n_shards: int) -> np.ndarray:
    """Per-(row, shard) int32 counts of the partitions, (R, S_padded / N)
    each, joined in shard order on the host and trimmed: (R, S) int64."""
    with obs_span("device.sync"):
        host = [p.cpu().numpy() for p in parts]
    return np.concatenate(host, axis=1)[:, :n_shards].astype(np.int64)


def _host_total(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """The partitions' int64 partials summed, on the host."""
    with obs_span("device.sync"):
        host = [p.cpu().numpy() for p in parts]
    out = host[0]
    for h in host[1:]:
        out = out + h
    return out


def _fold_minmax(parts: Sequence[Tuple[np.ndarray, int]], maximize: bool):
    """The partitions' K3 answers (bits, count) folded as K3's second
    launch folds its blocks: the extreme value among partitions that
    consider a column wins and the counts of those holding it add up; with
    none, bits all 0 (max) or all 1 (min) and count 0, which is what the
    reference's global scan over the whole plane gives."""
    best = None
    for bits, count in parts:
        if count == 0:
            continue
        value = int(sum(int(b) << i for i, b in enumerate(bits)))
        if best is None or (value > best[0] if maximize else value < best[0]):
            best = [value, bits, count]
        elif value == best[0]:
            best[2] += count
    if best is None:
        bits = parts[0][0]
        return (np.zeros_like(bits) if maximize else np.ones_like(bits)), 0
    return best[1], best[2]


class DeviceCount:
    """One Count left on the device: the unsynchronized int64 scalar of
    K1's launches, summed over the partitions on partition 0's device. int() and np.asarray() wait for it and give the count
    (np.asarray of a CUDA tensor alone raises); `tensor` is the scalar."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    def __int__(self) -> int:
        return int(self.tensor.item())

    __index__ = __int__

    def __array__(self, dtype=None, copy=None):
        out = self.tensor.cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return f"DeviceCount({self.tensor!r})"


class ShardedQueryEngine:
    def __init__(self, holder, mesh=None, config: Optional[EngineConfig] = None,
                 device=None, tier_config=None, traffic_fn=None,
                 resilience_config=None):
        """`mesh` lists the partitions' devices (parallel/mesh.py); without
        one, `config.mesh_devices` places them over the local devices of
        `device`'s kind (the holder's device by default)."""
        self.holder = holder
        if config is None:
            # No config (library/test use): honor the env spellings of the
            # reference's [engine] section directly.
            config = EngineConfig(
                delta_max_fraction=float(os.environ.get(
                    "PILOSA_TPU_ENGINE_DELTA_MAX_FRACTION",
                    EngineConfig.delta_max_fraction)),
                gather_workers=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_GATHER_WORKERS",
                    EngineConfig.gather_workers)),
                mesh_devices=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_MESH_DEVICES", 0)),
                leaf_cache_bytes=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_LEAF_CACHE_BYTES", 0)),
                stack_cache_bytes=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_STACK_CACHE_BYTES", 0)),
                memo_entries=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_MEMO_ENTRIES", 0)),
                aux_memo_entries=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_AUX_MEMO_ENTRIES", 0)),
                dispatch_watchdog=float(os.environ.get(
                    "PILOSA_TPU_ENGINE_DISPATCH_WATCHDOG",
                    EngineConfig.dispatch_watchdog)),
                cold_host_count=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_COLD_HOST_COUNT",
                    EngineConfig.cold_host_count)),
                plan_cache=int(os.environ.get(
                    "PILOSA_TPU_ENGINE_PLAN_CACHE",
                    EngineConfig.plan_cache)),
            )
        if mesh is None:
            mesh = engine_mesh(
                config.mesh_devices,
                torch.device(device) if device is not None else holder.device)
        # The partitions' devices; partition 0's is the engine's own: the
        # partial results reduce there, and its kind (card or CPU) decides
        # the fault ladder's rungs.
        self.mesh: List[torch.device] = [torch.device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("an engine mesh needs at least one partition")
        self.device = self.mesh[0]
        if tier_config is None:
            tier_config = TierConfig.from_env()
        # Delta-refresh budget: a stale resident tensor is refreshed by a
        # scattered (indices, values) upload only while the changed 32-bit
        # words stay under this fraction of the tensor; 0 disables deltas.
        self._delta_max_fraction = float(config.delta_max_fraction)
        # Device-plane fault state (device_health.py): every dispatch
        # reports its outcome here, and the executor consults plan()
        # before routing work at the device. The watchdog bounds how long
        # a dispatch may block a serving thread (0 = off).
        self.device_health = DevicePlaneHealth(resilience_config)
        self._watchdog_s = float(config.dispatch_watchdog)
        # Watchdogged dispatches run on their own small pool, NOT the
        # gather pool: an abandoned (wedged) dispatch parks its worker
        # until the runtime answers, and parking gather workers would
        # starve the host gathers the fallback ladder itself serves from.
        # `_watchdog_inflight` counts submitted-but-unfinished dispatches;
        # at the pool bound further dispatches run INLINE unwatchdogged.
        self._watchdog_pool = None
        self._watchdog_inflight = 0
        self._cold_host = bool(int(config.cold_host_count))
        self._plan_cache_enabled = bool(int(config.plan_cache))
        # Leaf sets already answered once by the cold-host path: the
        # second touch promotes normally. Bounded crudely — losing the set
        # only costs one extra host answer per leaf set.
        self._cold_seen: set = set()
        gw = int(config.gather_workers)
        self._gather_workers = gw if gw > 0 else min(8, os.cpu_count() or 1)
        self._gather_pool = None  # lazy ThreadPoolExecutor
        # (index, leaf, shards) -> (fingerprint, (S_padded, W) Blocks)
        self._leaf_cache: Dict[Tuple, Tuple[Tuple, Blocks]] = {}
        self._leaf_bytes = 0
        # (index, leaves, shards) -> (fingerprint, (U, S_padded, W) Blocks)
        self._stack_cache: Dict[Tuple, Tuple[Tuple, Blocks]] = {}
        self._stack_bytes = 0
        # Device-cache budgets (bytes, LRU-evicted). The stacks duplicate
        # the leaf planes they are built from, so both caches are bounded
        # by bytes: 16 GiB each on a card (80 GB H100), 512 MiB on the CPU;
        # [tier] hbm-bytes, when set, is the combined budget split evenly.
        # They count padded bytes over all partitions; every plane splits
        # evenly, so each device holds its partitions' share of them.
        default_budget = (16 << 30) if self.device.type == "cuda" else (1 << 29)
        if tier_config.hbm_bytes > 0:
            default_budget = max(1, int(tier_config.hbm_bytes) // 2)

        def budget(env_name: str, cfg_val: int, default: int) -> int:
            v = os.environ.get(env_name)
            if v is not None:
                return int(v)
            return int(cfg_val) if cfg_val > 0 else default

        self._leaf_budget = budget(
            "PILOSA_LEAF_CACHE_BYTES", config.leaf_cache_bytes, default_budget)
        self._stack_budget = budget(
            "PILOSA_STACK_CACHE_BYTES", config.stack_cache_bytes, default_budget)
        # key -> (Event, building thread); see _gate.
        self._building: Dict[Tuple, Tuple] = {}
        # One lock guards dict + byte-counter state; device work happens
        # outside it.
        self._lock = threading.RLock()
        # Result memo: (index, structure signature, leaves, shards) ->
        # (fingerprint, write epoch, count). A repeat Count whose fragments
        # have not changed is answered with no device work.
        self._memo: Dict[Tuple, Tuple] = {}
        self._memo_budget = budget(
            "PILOSA_MEMO_ENTRIES", config.memo_entries, 8192)
        # Composite-result memo (TopN count matrices, BSI val counts),
        # bounded by entries; shares the memo hit/miss counters.
        self._aux_memo: Dict[Tuple, Tuple[Tuple, object]] = {}
        self._aux_budget = budget(
            "PILOSA_AUX_MEMO_ENTRIES", config.aux_memo_entries, 512)
        self.budgets = {
            "leaf_cache_bytes": self._leaf_budget,
            "stack_cache_bytes": self._stack_budget,
            "memo_entries": self._memo_budget,
            "aux_memo_entries": self._aux_budget,
        }
        self.counters = {
            "leaf_hits": 0, "leaf_misses": 0, "leaf_evictions": 0,
            "stack_hits": 0, "stack_misses": 0, "stack_evictions": 0,
            "memo_hits": 0, "memo_misses": 0,
            "memo_evictions": 0, "aux_evictions": 0,
            # Kernel launches made for queries (counts, TopN count
            # matrices) and elementwise bitmap evaluations; memo hits
            # launch nothing.
            "count_dispatches": 0, "topn_dispatches": 0,
            "bitmap_dispatches": 0,
            # Delta refresh: a stale resident tensor refreshed with a
            # scattered update (delta_bytes of host -> device traffic)
            # instead of a host walk + re-upload (full_refresh_bytes).
            "leaf_delta_hits": 0, "stack_delta_hits": 0,
            "delta_bytes": 0, "full_refresh_bytes": 0,
            # Tiering: a device-cache miss answered by decompressing a
            # demoted plane from the host tier (leaf_tier_hits) instead of
            # a cold container walk (leaf_misses).
            "leaf_tier_hits": 0, "tier_promote_bytes": 0,
            "tier_promote_errors": 0, "tier_demote_errors": 0,
            # _byte_cache_put's oversized-entry policy: admitted alone.
            "oversized_admits": 0,
            # Trees the compile gate refused (walked shard by shard).
            "compile_gate_refusals": 0,
            # The device-fault ladder: host_counts/host_topn are queries
            # answered entirely on the host (degraded ladder),
            # host_cold_counts the compressed-domain path for one-off
            # Counts on demoted planes; oom_backpressure counts budget
            # shrinks, oom_retries dispatches that succeeded after one,
            # oom_batch_splits reduced-batch retries, watchdog_timeouts
            # dispatches the watchdog abandoned, device_dispatch_errors
            # every classified dispatch failure (per kind in
            # device_health.snapshot()), kernel_faults those on the card
            # that were raised out of the query instead (_fault_error).
            "host_counts": 0, "host_topn": 0, "host_cold_counts": 0,
            "oom_backpressure": 0, "oom_retries": 0, "oom_batch_splits": 0,
            "watchdog_timeouts": 0, "device_dispatch_errors": 0,
            "kernel_faults": 0,
        }
        # Tier manager (tier/manager.py): owns the host-RAM + disk tiers
        # below the device caches. Leaf evictions demote through it and
        # cold gathers probe it before paying the container walk.
        self.tier = None
        if tier_config.enabled():
            self.tier = TierManager(self.holder, tier_config, traffic_fn=traffic_fn)
            self.tier.bind(
                promote_fn=self._tier_promote_key,
                headroom_fn=self._hbm_headroom,
                resident_fn=self._tier_resident,
            )

    @property
    def n_devices(self) -> int:
        """The number of partitions (the reference's mesh size)."""
        return len(self.mesh)

    def stack_generation(self, index: str) -> int:
        """O(1) write epoch of an index's resident leaf stacks (bumped by
        every fragment mutation, core/fragment.py WriteEpoch)."""
        idx = self.holder.index(index)
        return -1 if idx is None else idx.write_epoch.value

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    @contextlib.contextmanager
    def memos_off(self):
        """Run a block with the result and aux memos off, as budgets of 0
        would have them: a repeated query takes the kernel path, so the
        block can time it. The entries and budgets come back after it."""
        with self._lock:
            saved = (self._memo, self._aux_memo, self._memo_budget,
                     self._aux_budget)
            self._memo, self._aux_memo = {}, {}
            self._memo_budget = self._aux_budget = 0
        try:
            yield self
        finally:
            with self._lock:
                (self._memo, self._aux_memo, self._memo_budget,
                 self._aux_budget) = saved

    def close(self) -> None:
        """Stop the tier manager, release the host pools, and drop the
        resident tensors (their device memory returns to the caching
        allocator)."""
        if self.tier is not None:
            self.tier.close()
        with self._lock:
            pool, self._gather_pool = self._gather_pool, None
            wpool, self._watchdog_pool = self._watchdog_pool, None
            self._leaf_cache.clear()
            self._stack_cache.clear()
            self._leaf_bytes = self._stack_bytes = 0
        if pool is not None:
            pool.shutdown(wait=False)
        if wpool is not None:
            wpool.shutdown(wait=False)

    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    # ----------------------------------------------------- tier integration
    #
    # The leaf cache is the TOP tier: evicted planes demote into the
    # manager's compressed host tier instead of vanishing, cold gathers
    # probe the manager before paying the container walk, and the
    # manager's prefetch thread re-promotes demoted planes of hot indexes
    # through the hooks below. The manager never calls them while holding
    # its own lock with ours taken.

    def _tier_promote_key(self, key) -> bool:
        """Prefetch hook: make `key` device-resident via the normal gather
        path (which consumes the tier entry and installs the plane)."""
        index, leaf, shards = key
        try:
            self._gather_leaf(index, leaf, shards)
            return True
        except Exception:
            with self._lock:
                self.counters["tier_promote_errors"] += 1
            return False

    def _hbm_headroom(self) -> int:
        # Global bytes are the tightest device's too: every plane splits
        # evenly over the partitions, so each device's share of the budget
        # and of the resident bytes is the same fraction.
        with self._lock:
            return self._leaf_budget - self._leaf_bytes

    def _tier_resident(self, key) -> bool:
        with self._lock:
            return key in self._leaf_cache

    def _demote_keys(self, keys) -> None:
        """Demote freshly-evicted leaf planes into the host tier. Runs
        OUTSIDE the engine lock (demotion takes fragment mutexes)."""
        if not keys or self.tier is None:
            return
        for key in keys:
            try:
                self.tier.demote(key)
            except Exception:
                # The evicted plane simply stays cold (next read regathers
                # from the fragments); the count is the trace.
                with self._lock:
                    self.counters["tier_demote_errors"] += 1

    # ------------------------------------------------------------ caches
    #
    # `_gate` / `_release` dedupe expensive cold builds (host gathers,
    # uploads, restacks) so N concurrent misses on a key do the work once.

    def _gate(self, key, probe: Callable):
        """Return probe()'s non-None value, or None once the caller holds
        the build gate for `key` — the caller then MUST publish a value and
        `_release(key)`, even on failure (_release runs in the building
        thread's finally). Waiters re-probe when the owner releases.
        Ownership is stolen only if the owner is no longer alive, or after
        five minutes of waiting on a wedged one."""
        waited = 0
        while True:
            val = probe()
            if val is not None:
                return val
            with self._lock:
                entry = self._building.get(key)
                if entry is None:
                    self._building[key] = (
                        threading.Event(), threading.current_thread())
                    return None
                ev, owner = entry
            if ev.wait(timeout=10.0):
                continue
            waited += 1
            if waited == 6:
                with self._lock:
                    self.counters["gate_stalls"] = \
                        self.counters.get("gate_stalls", 0) + 1
            if not owner.is_alive() or waited >= 30:
                with self._lock:
                    if self._building.get(key) is entry:
                        self._building[key] = (
                            threading.Event(), threading.current_thread())
                        return None

    def _release(self, key) -> None:
        with self._lock:
            entry = self._building.pop(key, None)
        if entry is not None:
            entry[0].set()

    # ------------------------------------------------------ dispatch guard
    #
    # Every device dispatch runs through _device_call: the `device-
    # dispatch` failpoint fires at exactly this boundary, the optional
    # watchdog bounds how long the serving thread blocks, failures are
    # classified (device_health.classify_device_error) and recorded into
    # the per-signature + plane breakers, and an OOM gets backpressure
    # (shrink budgets, demote through the tier manager) plus ONE same-size
    # retry before the typed error escapes to the executor's ladder.
    # Gather-stage transfers use the lighter _oom_guard. A kernel build
    # failure (kernels.KernelBuildError) is re-raised untouched by both:
    # it is not a device fault and must never be served one rung down.
    # On the card a real fault is raised as DeviceKernelFault, which the
    # ladder does not catch (_fault_error); only a CPU-device engine or an
    # injected failpoint fault goes one rung down. The guarded callable
    # includes the read-back: CUDA reports a fault at the sync point, not
    # at the launch.

    _WATCHDOG_WORKERS = 4

    def _watchdog_done(self, _fut) -> None:
        with self._lock:
            self._watchdog_inflight -= 1

    def _watchdogged(self, fn: Callable, fire: bool = True):
        def run():
            if fire:
                failpoints.fire("device-dispatch")
            return fn()

        if self._watchdog_s <= 0:
            return run()
        with self._lock:
            if self._watchdog_inflight >= self._WATCHDOG_WORKERS:
                # Every watchdog slot is occupied (normally: parked on
                # wedged dispatches). Dispatch inline unwatchdogged;
                # submitting would misread queue delay as a device timeout.
                inline = True
            else:
                if self._watchdog_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._watchdog_pool = ThreadPoolExecutor(
                        max_workers=self._WATCHDOG_WORKERS,
                        thread_name_prefix="pilosa-dispatch",
                    )
                self._watchdog_inflight += 1
                inline = False
                pool = self._watchdog_pool
        if inline:
            return run()
        from concurrent.futures import TimeoutError as FutTimeout

        # The request's context rides along, so the spans of the dispatch
        # land in its trace from the pool thread.
        fut = pool.submit(contextvars.copy_context().run, run)
        fut.add_done_callback(self._watchdog_done)
        try:
            return fut.result(timeout=self._watchdog_s)
        except FutTimeout:
            if fut.cancel():
                # Never started: the timeout measured pool queueing, not
                # the device. Not a fault — dispatch inline.
                return run()
            # Started and wedged: the task cannot be killed. The watchdog
            # frees the SERVING thread; the breaker stops new work from
            # piling onto a wedged device.
            with self._lock:
                self.counters["watchdog_timeouts"] += 1
            raise DeviceDispatchTimeout(
                f"device dispatch exceeded the {self._watchdog_s:.3f}s "
                "watchdog")

    def _fault_error(self, kind: str, health_sig: Optional[Tuple],
                     e: BaseException) -> PilosaError:
        """Record a classified dispatch failure into the breakers and
        return the error to raise: DeviceDispatchError (the ladder's catch
        point) on a CPU-device engine or for an injected fault, else
        DeviceKernelFault — a kernel of the port that fails on the card is
        never answered by the host."""
        self.device_health.record_failure(health_sig, kind)
        if self.device.type != "cuda" or isinstance(e, failpoints.InjectedFault):
            return DeviceDispatchError(kind, health_sig, str(e))
        with self._lock:
            self.counters["kernel_faults"] += 1
        log.error("device dispatch failed on the card (%s), not served "
                  "from a lower rung: %s", kind, e)
        return DeviceKernelFault(kind, health_sig, str(e))

    def route(self, sig: Optional[Tuple] = None) -> str:
        """device_health.plan(sig) for the executor's ladder. An open
        breaker on a card whose kernels faulted for real does not route
        the query down: it raises DeviceKernelFault."""
        r = self.device_health.plan(sig)
        if r != "device" and self.counters["kernel_faults"]:
            raise DeviceKernelFault(
                RUNTIME, sig, "device breaker open after a kernel fault on "
                "the card; the port serves no query from the host for it")
        return r

    def _device_call(self, health_sig: Optional[Tuple], fn: Callable,
                     fire: bool = True):
        """Run one device dispatch under the fault ladder; returns fn()'s
        value. On failure: classify, record into the breakers, re-raise
        as _fault_error says. OOM gets backpressure + one retry first."""
        try:
            result = self._watchdogged(fn, fire=fire)
        except kernels.KernelBuildError:
            raise
        except Exception as e:
            with self._lock:
                self.counters["device_dispatch_errors"] += 1
            kind = classify_device_error(e)
            if kind == OOM:
                self._oom_backpressure()
                try:
                    result = self._watchdogged(fn, fire=fire)
                except kernels.KernelBuildError:
                    raise
                except Exception as e2:
                    raise self._fault_error(
                        classify_device_error(e2), health_sig, e2) from e2
                with self._lock:
                    self.counters["oom_retries"] += 1
                self.device_health.record_success(health_sig)
                return result
            raise self._fault_error(kind, health_sig, e) from e
        self.device_health.record_success(health_sig)
        return result

    def _oom_guard(self, health_sig: Optional[Tuple], fn: Callable):
        """Gather-stage transfer guard (upload, restack, delta scatter): an
        OOM gets backpressure + one retry; any other failure is a device
        fault at transfer time — classified, recorded into the breakers,
        and re-raised as _fault_error says."""
        try:
            return fn()
        except kernels.KernelBuildError:
            raise
        except Exception as e:
            with self._lock:
                self.counters["device_dispatch_errors"] += 1
            kind = classify_device_error(e)
            if kind != OOM:
                raise self._fault_error(kind, health_sig, e) from e
            self._oom_backpressure()
            try:
                return fn()
            except kernels.KernelBuildError:
                raise
            except Exception as e2:
                raise self._fault_error(
                    classify_device_error(e2), health_sig, e2) from e2

    def _oom_backpressure(self) -> None:
        """Memory-pressure response: halve the effective leaf/stack budgets
        (floored at 1 MiB), evict down to them, and demote the evicted
        planes through the tier manager — free real device memory before
        the retry instead of bouncing the OOM to the client. The shrink is
        sticky (the budget stays down for the engine's lifetime)."""
        evicted: List = []
        with self._lock:
            self.counters["oom_backpressure"] += 1
            floor = 1 << 20
            self._leaf_budget = max(self._leaf_budget // 2, floor)
            self._stack_budget = max(self._stack_budget // 2, floor)
            self.budgets["leaf_cache_bytes"] = self._leaf_budget
            self.budgets["stack_cache_bytes"] = self._stack_budget
            while self._leaf_bytes > self._leaf_budget and self._leaf_cache:
                key = next(iter(self._leaf_cache))
                self._leaf_bytes -= self._leaf_cache.pop(key)[1].nbytes
                self.counters["leaf_evictions"] += 1
                evicted.append(key)
            while self._stack_bytes > self._stack_budget and self._stack_cache:
                key = next(iter(self._stack_cache))
                self._stack_bytes -= self._stack_cache.pop(key)[1].nbytes
                self.counters["stack_evictions"] += 1
        for dev in {d for d in self.mesh if d.type == "cuda"}:
            with torch.cuda.device(dev):
                torch.cuda.empty_cache()
        self._demote_keys(evicted)

    def _byte_cache_put(self, cache: Dict, key, entry: Tuple, budget: int,
                        used: int, evict_counter: str = "",
                        evicted: Optional[List] = None) -> int:
        """Insert (fingerprint, tensor) at MRU and evict LRU entries past
        the byte budget; returns the updated used-bytes counter. Caller
        holds self._lock. An entry larger than the whole budget is
        admitted alone (everything else evicts) rather than made
        permanently uncacheable. `evicted` (when a list) collects the
        evicted KEYS so the caller can demote those planes into the tier
        manager after releasing the lock."""
        prev = cache.pop(key, None)
        if prev is not None:
            used -= prev[1].nbytes
        used += entry[1].nbytes
        cache[key] = entry
        if entry[1].nbytes > budget:
            self.counters["oversized_admits"] += 1
        while used > budget and len(cache) > 1:
            old_key = next(iter(cache))
            if old_key == key:
                break
            used -= cache.pop(old_key)[1].nbytes
            if evict_counter:
                self.counters[evict_counter] += 1
            if evicted is not None:
                evicted.append(old_key)
        return used

    def _fingerprint(self, index: str, leaf: Leaf, shards: Tuple[int, ...]) -> Tuple:
        """Per-shard (incarnation, generation) pairs for one leaf — the
        staleness key for every device cache and memo."""
        return tuple(
            -1 if f is None else (f.incarnation, f.generation)
            for f in (
                self.holder.fragment(index, leaf.field, leaf.view, s)
                for s in shards
            )
        )

    def _s_padded(self, n_shards: int) -> int:
        return pad_shards(n_shards, len(self.mesh))

    def _upload(self, buf: np.ndarray) -> Blocks:
        """An (S_padded, W) host plane split into the partitions' blocks,
        each copied to its partition's device."""
        per = buf.shape[0] // len(self.mesh)
        host = buf.view(np.int32)
        return Blocks(torch.from_numpy(host[p * per:(p + 1) * per]).to(dev)
                      for p, dev in enumerate(self.mesh))

    def _gather_leaf(self, index: str, leaf: Leaf,
                     shards: Tuple[int, ...]) -> Blocks:
        """(S_padded, W) int32 plane of one leaf in the partitions' blocks,
        cached until a member fragment's fingerprint moves; a stale entry
        is refreshed by a delta scatter where the journal allows, a
        demoted one promoted from the host tier, anything else gathered
        from the fragments."""
        key = (index, leaf, shards)
        s_padded = self._s_padded(len(shards))
        with obs_span("engine.fingerprint", site="leaf", leaves=1):
            frags = [self.holder.fragment(index, leaf.field, leaf.view, s)
                     for s in shards]
            # Fingerprint BEFORE the read: a write racing the gather leaves
            # the entry conservatively stale, never stale-but-fresh-looking.
            fingerprint = tuple(-1 if f is None else (f.incarnation, f.generation)
                                for f in frags)

        def probe():
            with self._lock:
                cached = self._leaf_cache.get(key)
                if cached is None or cached[0] != fingerprint:
                    return None
                self._leaf_cache[key] = self._leaf_cache.pop(key)  # LRU touch
                self.counters["leaf_hits"] += 1
            if self.tier is not None and self.tier.has_prefetched():
                self.tier.note_hbm_hit(key)
            return cached[1]

        arr = self._gate(("leaf", key), probe)
        if arr is not None:
            return arr
        evicted: List = []
        try:
            # The gather span tags which refresh path ran (delta scatter,
            # tier promote or cold walk), as on the JAX package.
            with obs_span("gather") as sp:
                with self._lock:
                    stale = self._leaf_cache.get(key)
                if stale is not None:
                    arr = self._leaf_delta(key, leaf.row, stale, frags,
                                           fingerprint, evicted)
                    if arr is not None:
                        sp.tag(kind="delta")
                        return arr
                buf = None
                if self.tier is not None:
                    buf = self.tier.promote(key, frags, fingerprint, s_padded)
                tier_hit = buf is not None
                if buf is None:
                    buf = self._host_gather(frags, leaf.row, s_padded)
                if sp is not NOP_SPAN:
                    sp.tag(kind="tier-promote" if tier_hit else "cold",
                           bytes=int(buf.nbytes))
                arr = self._oom_guard(None, lambda: self._upload(buf))
            with self._lock:
                if tier_hit:
                    self.counters["leaf_tier_hits"] += 1
                    self.counters["tier_promote_bytes"] += buf.nbytes
                else:
                    self.counters["leaf_misses"] += 1
                    self.counters["full_refresh_bytes"] += buf.nbytes
                self._leaf_bytes = self._byte_cache_put(
                    self._leaf_cache, key, (fingerprint, arr),
                    self._leaf_budget, self._leaf_bytes, "leaf_evictions",
                    evicted)
        finally:
            self._release(("leaf", key))
            # Evicted planes demote off-lock whichever path installed the
            # fresh entry.
            self._demote_keys(evicted)
        return arr

    def _pool(self):
        with self._lock:
            if self._gather_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._gather_pool = ThreadPoolExecutor(
                    max_workers=self._gather_workers,
                    thread_name_prefix="pilosa-gather",
                )
            return self._gather_pool

    def _host_gather(self, frags, row: int,
                     s_padded: Optional[int] = None) -> np.ndarray:
        """Cold-path host assembly of one leaf's (S, W) uint32 plane
        buffer, zero rows to `s_padded` when given. The per-shard
        container walks are independent pure reads (fragment reads are
        lock-free by design), so they thread-pool."""
        buf = np.zeros((s_padded or len(frags), WORDS_PER_ROW), dtype=np.uint32)
        live = [(i, f) for i, f in enumerate(frags) if f is not None]
        if len(live) > 1 and self._gather_workers > 1:
            def fill(item):
                i, frag = item
                buf[i] = frag.plane_np(row)

            list(self._pool().map(fill, live))
        else:
            for i, frag in live:
                buf[i] = frag.plane_np(row)
        return buf

    # ------------------------------------------------------ delta refresh
    #
    # A write to a resident fragment bumps its generation; without deltas
    # the next query pays a full host container walk over EVERY shard of
    # the leaf plus a full (S, W) re-upload, and a restack of every
    # (U, S, W) stack holding it — O(plane) work for a 1-bit write. The
    # dirty-word journal (core/fragment.py) lets stale members report
    # exactly which 64-bit words changed; while the total stays under
    # delta_max_fraction of the tensor, the refresh is a small (indices,
    # values) upload and one scatter into a copy of the cached tensor.
    #
    # The scatter is functional, as the reference's `.at[].set` is: the
    # refreshed tensor is a clone, so readers that already hold the old
    # tensor keep reading it. Two reference mechanisms have nothing to do
    # here: nothing is compiled per shape (no pow2 padding of the update
    # arrays), and stacks carry no pad rows (no pad-row replication).

    def _collect_updates(self, members, size: int):
        """Shared delta collector for the leaf and stack paths.

        `members`: iterable of (coords, frag, row, old_fp, new_fp) per
        STALE cache member — coords are the member's leading indices in the
        cached tensor ((shard,) for a leaf, (u, shard) for a stack), fps
        are -1 or (incarnation, generation) pairs. `size` is the cached
        tensor's element count (the delta budget base).

        Returns None when only a full regather is safe (missing fragment,
        fragment recreated since the fp was read, journal can't answer,
        budget exceeded), else a list of (coords, col32 indices, uint32
        values) triples — possibly empty, meaning the generation churn came
        from rows outside the cache and zero bytes need to move."""
        out = []
        n32 = 0
        for coords, frag, row, old_fp, new_fp in members:
            if frag is None or old_fp == -1 or new_fp == -1:
                return None
            if old_fp[0] != new_fp[0] or frag.incarnation != new_fp[0]:
                # Different incarnation: the journal's generations are not
                # comparable across it.
                return None
            w = frag.dirty_words_since(row, old_fp[1])
            if w is None:
                return None
            if not len(w):
                continue
            n32 += 2 * len(w)
            if n32 > self._delta_max_fraction * size:
                return None
            cols, vals = self._updates32(w, frag.row_words64(row, w))
            out.append((coords, cols, vals))
        return out

    @staticmethod
    def _updates32(w64: np.ndarray, v64: np.ndarray):
        """Expand 64-bit dirty words into the (col32 indices, uint32
        values) pairs of the device plane layout. The interleave matches
        plane_np's `.view(np.uint32)` on the same host, so the scattered
        words are byte-identical to a regathered plane."""
        cols = np.empty(2 * len(w64), dtype=np.int64)
        cols[0::2] = w64 * 2
        cols[1::2] = w64 * 2 + 1
        return cols, v64.view(np.uint32)

    def _scatter(self, blocks: Blocks, updates) -> Tuple[Blocks, int]:
        """Apply collected updates to a cached leaf or stack: each update
        goes to the block that holds its shard (coords' last member, the
        shard position), which is cloned and scattered into, as the
        reference's functional `.at[].set`; a block no update names is
        kept as it is. Returns (new blocks, host -> device bytes moved)."""
        per = blocks[0].shape[-2]
        by_block: Dict[int, List] = {}
        for co, cols, vals in updates:
            by_block.setdefault(co[-1] // per, []).append(
                (co[:-1] + (co[-1] % per,), cols, vals))
        out, moved = list(blocks), 0
        for p, part in by_block.items():
            index = [self._coords(part, a) for a in range(len(part[0][0]))]
            index.append(np.concatenate([c for _, c, _ in part]))
            vals = np.concatenate([v for _, _, v in part])

            def run(arr=blocks[p], index=index, vals=vals):
                ix = tuple(torch.from_numpy(a).to(arr.device) for a in index)
                new = arr.clone()
                new[ix] = torch.from_numpy(vals.view(np.int32)).to(arr.device)
                return new

            out[p] = self._oom_guard(None, run)
            moved += sum(a.nbytes for a in index) + vals.nbytes
        return Blocks(out), moved

    @staticmethod
    def _coords(updates, axis: int) -> np.ndarray:
        return np.concatenate([np.full(len(c), co[axis], np.int64)
                               for co, c, _ in updates])

    def _leaf_delta(self, key, row: int, stale, frags, fingerprint,
                    evicted: Optional[List] = None):
        """Refresh a stale cached leaf; None = caller must full-regather.
        `evicted` collects evicted keys for demotion."""
        old_fp, arr = stale
        if self._delta_max_fraction <= 0 or len(old_fp) != len(fingerprint):
            return None
        updates = self._collect_updates(
            (((i,), frag, row, old_fp[i], fingerprint[i])
             for i, frag in enumerate(frags)
             if old_fp[i] != fingerprint[i]),
            arr.numel(),
        )
        if updates is None:
            return None
        # Nothing in THIS row changed: republish the same blocks under the
        # fresh fingerprint (zero bytes moved).
        new_arr, moved = self._scatter(arr, updates) if updates else (arr, 0)
        with self._lock:
            self.counters["leaf_delta_hits"] += 1
            self.counters["delta_bytes"] += moved
            self._leaf_bytes = self._byte_cache_put(
                self._leaf_cache, key, (fingerprint, new_arr),
                self._leaf_budget, self._leaf_bytes, "leaf_evictions",
                evicted,
            )
        return new_arr

    def _stack_delta(self, key, index: str, leaves, shards, stale, fp):
        """Refresh a stale stack with one scattered update per block that
        holds a changed shard — no host walk, no member re-gather, no
        restack. None = full rebuild."""
        old_fp, arr = stale
        if self._delta_max_fraction <= 0 or len(old_fp) != len(fp):
            return None
        if any(len(o) != len(n) for o, n in zip(old_fp, fp)):
            return None

        def members():
            for u, leaf in enumerate(leaves):
                if old_fp[u] == fp[u]:
                    continue
                for i, s in enumerate(shards):
                    if old_fp[u][i] == fp[u][i]:
                        continue
                    frag = self.holder.fragment(index, leaf.field, leaf.view, s)
                    yield (u, i), frag, leaf.row, old_fp[u][i], fp[u][i]

        updates = self._collect_updates(members(), arr.numel())
        if updates is None:
            return None
        new_arr, moved = self._scatter(arr, updates) if updates else (arr, 0)
        with self._lock:
            self.counters["stack_delta_hits"] += 1
            self.counters["delta_bytes"] += moved
            self._stack_bytes = self._byte_cache_put(
                self._stack_cache, key, (fp, new_arr),
                self._stack_budget, self._stack_bytes, "stack_evictions",
            )
        return new_arr

    def _leaf_tensor(self, index: str, leaves: Sequence[Leaf],
                     shards: Tuple[int, ...]) -> Tuple[Blocks, ...]:
        return tuple(self._gather_leaf(index, leaf, shards) for leaf in leaves)

    def _stacked_leaf_tensor(self, index: str, leaves: Sequence[Leaf],
                             shards: Tuple[int, ...]) -> Blocks:
        """One resident (U, S_padded, W) stack for a leaf list, in the
        partitions' blocks, refreshed by scattered updates when a member
        fragment moved (the journal allowing), else rebuilt from the leaf
        cache (re-gathering only stale leaves). The whole step runs in
        one `engine.stack` span tagged with its `outcome`."""
        leaves = tuple(leaves)
        if not leaves:
            per = self._s_padded(len(shards)) // len(self.mesh)
            return Blocks(torch.zeros((0, per, WORDS_PER_ROW), dtype=torch.int32,
                                      device=dev) for dev in self.mesh)
        with obs_span("engine.stack") as sp:
            stacked, outcome = self._stack(index, leaves, shards)
            if sp is not NOP_SPAN:
                sp.tag(outcome=outcome)
        return stacked

    def _stack(self, index: str, leaves: Tuple[Leaf, ...],
               shards: Tuple[int, ...]) -> Tuple[Blocks, str]:
        """_stacked_leaf_tensor's stack and how it was had: "hit" (cached
        and fresh), "waited" (another thread's build, taken after waiting
        on the build gate), "delta" (refreshed by a scatter) or "build"."""
        fp = self._fingerprints(index, leaves, shards, "stack")
        key = (index, leaves, shards)
        probes = 0

        def probe():
            nonlocal probes
            probes += 1
            with self._lock:
                cached = self._stack_cache.get(key)
                if cached is not None and cached[0] == fp:
                    self._stack_cache[key] = self._stack_cache.pop(key)  # LRU touch
                    self.counters["stack_hits"] += 1
                    return cached[1]
            return None

        stacked = self._gate(("stack", key), probe)
        if stacked is not None:
            return stacked, "hit" if probes == 1 else "waited"
        try:
            with self._lock:
                stale = self._stack_cache.get(key)
            if stale is not None:
                with obs_span("gather", kind="stack-delta") as sp:
                    stacked = self._stack_delta(key, index, leaves, shards, stale, fp)
                    if sp is not NOP_SPAN:
                        sp.tag(applied=stacked is not None)
                if stacked is not None:
                    return stacked, "delta"
            arrs = self._leaf_tensor(index, leaves, shards)
            stacked = self._oom_guard(None, lambda: Blocks(
                torch.stack([a[p] for a in arrs]) for p in range(len(self.mesh))))
            with self._lock:
                self.counters["stack_misses"] += 1
                self._stack_bytes = self._byte_cache_put(
                    self._stack_cache, key, (fp, stacked), self._stack_budget,
                    self._stack_bytes, "stack_evictions")
        finally:
            self._release(("stack", key))
        return stacked, "build"

    # ----------------------------------------------------------- query memo

    def _epoch_token(self, index: str):
        """(incarnation, value) of the index's write epoch, or -1 when the
        index doesn't exist. The incarnation half keeps a recreated index
        whose fresh epoch climbs back to a stored value from aliasing the
        old index's memoized count."""
        idx = self.holder.index(index)
        if idx is None:
            return -1
        ep = idx.write_epoch
        return (ep.incarnation, ep.value)

    def memo_probe(self, index: str, plan: CompiledPlan,
                   shards: Tuple[int, ...]):
        """(memoized count or None, store token) for a planned call. A hit
        is host-only work (dict lookup + generation check).

        The token freezes the generation fingerprint AT PROBE TIME — before
        the query executes. memo_store(token) must use it, not a fresh
        fingerprint: a write landing during the device round trip bumps
        generations, and stamping the post-write generation onto the
        pre-write count would serve stale results forever."""
        key = (index, plan.sig_tuple, tuple(plan.leaves), shards)
        # O(1) staleness fast path: when the index's write epoch hasn't
        # moved since the entry was stored, nothing in the index changed,
        # so the O(U x S) fingerprint walk below is skipped.
        epoch = self._epoch_token(index)
        with self._lock:
            ent = self._memo.get(key)
            if ent is not None and epoch != -1 and ent[1] == epoch:
                self._memo[key] = self._memo.pop(key)  # LRU touch
                self.counters["memo_hits"] += 1
                return ent[2], (key, ent[0], epoch)
        fp = self._fingerprints(index, plan.leaves, shards, "memo")
        token = (key, fp, epoch)
        with self._lock:
            ent = self._memo.get(key)
            if ent is not None and ent[0] == fp:
                # Epoch moved (a write elsewhere in the index) but these
                # leaves didn't: refresh the stored epoch so the next
                # probe is O(1) again.
                self._memo.pop(key)
                self._memo[key] = (fp, epoch, ent[2])
                self.counters["memo_hits"] += 1
                return ent[2], token
            self.counters["memo_misses"] += 1
        return None, token

    def memo_store(self, token, count: int) -> None:
        key, fp, epoch = token
        with self._lock:
            self._memo.pop(key, None)
            self._memo[key] = (fp, epoch, count)
            while len(self._memo) > self._memo_budget:
                self._memo.pop(next(iter(self._memo)))
                self.counters["memo_evictions"] += 1

    def _aux_probe(self, key, fp):
        """Generation-checked memo for composite results (TopN count
        matrices, BSI val-count outputs). Same probe-time-fingerprint
        discipline as memo_probe; values are small host arrays."""
        with self._lock:
            ent = self._aux_memo.get(key)
            if ent is not None and ent[0] == fp:
                self._aux_memo[key] = self._aux_memo.pop(key)  # LRU touch
                self.counters["memo_hits"] += 1
                return ent[1]
            self.counters["memo_misses"] += 1
        return None

    def _aux_store(self, key, fp, value) -> None:
        with self._lock:
            self._aux_memo.pop(key, None)
            self._aux_memo[key] = (fp, value)
            while len(self._aux_memo) > self._aux_budget:
                self._aux_memo.pop(next(iter(self._aux_memo)))
                self.counters["aux_evictions"] += 1

    def _fingerprints(self, index: str, leaves: Sequence[Leaf],
                      shards: Tuple[int, ...], site: str) -> Tuple:
        """Every leaf's fingerprint: one walk of U x S fragment lookups,
        in one `engine.fingerprint` span tagged with the caller's `site`
        ("memo": a memo probe, "stack": a stack's freshness check)."""
        with obs_span("engine.fingerprint", site=site, leaves=len(leaves)):
            return tuple(self._fingerprint(index, leaf, shards) for leaf in leaves)

    # ------------------------------------------------------ host execution
    #
    # The bottom rung of the degraded ladder and the compressed-domain
    # cold path, one implementation: evaluate a set-op call tree entirely
    # on the host — planes come from the host-tier compressed bytes (via
    # TierManager.promote) when the plane is demoted, or a live container
    # walk otherwise, and popcounts are one vectorized numpy pass. No
    # device work whatsoever, and no kernel: these are numpy.

    def host_supports(self, call: Call) -> bool:
        """True when `call` is answerable by the host evaluator: Row /
        Intersect / Union / Difference / Xor trees and time-quantum
        Ranges. BSI Ranges refuse (their compares are device programs);
        the executor's ladder uses the per-shard walk for those."""
        if call.name == "Row":
            return True
        if call.name in ("Intersect", "Union", "Difference", "Xor"):
            return bool(call.children) and all(
                self.host_supports(ch) for ch in call.children)
        if call.name == "Range" and not call.has_condition_arg():
            return True
        return False

    def _host_plane(self, index: str, leaf: Leaf, shards: Tuple[int, ...],
                    cache: Optional[Dict] = None) -> np.ndarray:
        """(len(shards), W) uint32 plane for one leaf, host memory only:
        tier promotion (compressed decode + journal fold) when demoted,
        live container walk otherwise. `cache` dedupes leaves within one
        query tree."""
        key = (index, leaf, shards)
        if cache is not None and key in cache:
            return cache[key]
        frags = [self.holder.fragment(index, leaf.field, leaf.view, s)
                 for s in shards]
        fp = tuple(-1 if f is None else (f.incarnation, f.generation)
                   for f in frags)
        buf = None
        if self.tier is not None:
            buf = self.tier.promote(key, frags, fp, len(shards))
        if buf is None:
            buf = self._host_gather(frags, leaf.row)
        if cache is not None:
            cache[key] = buf
        return buf

    def _host_eval(self, index: str, call: Call, shards: Tuple[int, ...],
                   cache: Dict) -> np.ndarray:
        """Evaluate a host-supported call tree to its (S, W) plane."""
        if call.name == "Row":
            field_name = call.field_arg()
            row_id, ok = call.uint_arg(field_name)
            if not ok:
                raise QueryError("Row() must specify row")
            return self._host_plane(
                index, Leaf(field_name, VIEW_STANDARD, row_id), shards, cache)
        if call.name in ("Intersect", "Union", "Difference", "Xor"):
            if not call.children:
                raise QueryError(
                    f"empty {call.name} query is currently not supported")
            out = self._host_eval(index, call.children[0], shards, cache)
            op = {
                "Intersect": np.bitwise_and,
                "Union": np.bitwise_or,
                "Xor": np.bitwise_xor,
            }.get(call.name)
            for ch in call.children[1:]:
                rhs = self._host_eval(index, ch, shards, cache)
                if op is None:  # Difference
                    out = np.bitwise_and(out, np.bitwise_not(rhs))
                else:
                    out = op(out, rhs)
            return out
        if call.name == "Range" and not call.has_condition_arg():
            return self._host_time_range(index, call, shards, cache)
        raise QueryError(f"not host-executable: {call.name}")

    def _host_time_range(self, index: str, c: Call, shards: Tuple[int, ...],
                         cache: Dict) -> np.ndarray:
        """Time-quantum Range as a host union over present time views — the
        plan compiler's own view pruning, so the host answer matches the
        device's bit for bit."""
        field_name, row_id, views = resolve_time_range(self.holder, index, c)
        out = None
        for v in views:
            p = self._host_plane(index, Leaf(field_name, v, row_id), shards, cache)
            out = p if out is None else np.bitwise_or(out, p)
        if out is None:
            out = np.zeros((len(shards), WORDS_PER_ROW), dtype=np.uint32)
        return out

    def host_count(self, index: str, call: Call, shards: Sequence[int],
                   plan: Optional[CompiledPlan] = None) -> int:
        """Count(call) answered entirely from host memory — the degraded
        ladder's bottom rung. Shares the generation-checked result memo
        with the device path (the answer is bit-exact)."""
        shards = tuple(shards)
        plan = plan or self.plan(index, call)
        hit, token = self.memo_probe(index, plan, shards)
        if hit is not None:
            return hit
        plane = self._host_eval(index, call, shards, {})
        result = int(_pop_elems(plane).sum())
        with self._lock:
            self.counters["host_counts"] += 1
        self.memo_store(token, result)
        return result

    def host_topn_shard_counts(
        self, index: str, field: str, row_ids: Sequence[int],
        shards: Sequence[int], src_call: Optional[Call] = None,
        need_row_counts: bool = True,
    ):
        """topn_shard_counts with the same result contract, computed from
        host planes with numpy popcounts — the TopN rung of the ladder.
        Unmemoized: this is the degraded path."""
        shards = tuple(shards)
        req = np.asarray(row_ids, dtype=np.int64)
        canon = np.unique(req)
        sel = np.searchsorted(canon, req)
        cache: Dict = {}
        if len(canon):
            planes = np.stack([
                self._host_plane(
                    index, Leaf(field, VIEW_STANDARD, int(r)), shards, cache)
                for r in canon
            ])  # (R, S, W)
        else:
            planes = np.zeros((0, len(shards), WORDS_PER_ROW), np.uint32)
        row_counts = None
        if need_row_counts:
            row_counts = _pop_elems(planes).sum(axis=2, dtype=np.int64)
        inter = src_counts = None
        if src_call is not None:
            src = self._host_eval(index, src_call, shards, cache)  # (S, W)
            src_counts = _pop_elems(src).sum(axis=1, dtype=np.int64)
            masked = np.bitwise_and(planes, src[None, :, :])
            inter = _pop_elems(masked).sum(axis=2, dtype=np.int64)
        with self._lock:
            self.counters["host_topn"] += 1
        return (
            row_counts[sel] if row_counts is not None else None,
            inter[sel] if inter is not None else None,
            src_counts,
        )

    def _cold_host_candidate(self, index: str, call: Call, plan: CompiledPlan,
                             shards: Tuple[int, ...]) -> bool:
        """True when this Count should be answered compressed-domain: the
        tree is host-expressible, every leaf is demoted (none resident on
        the device, all present in the tier), and this exact leaf set has
        not been host-answered before — the second touch promotes
        normally. Unlike the reference, whose Count reads leaf planes, the
        port's Count reads a stack of them: a resident stack of the leaf
        set keeps the Count on the device too."""
        if not self._cold_host or self.tier is None or not plan.leaves:
            return False
        if not self.host_supports(call):
            return False
        keys = [(index, leaf, shards) for leaf in plan.leaves]
        kset = (index, tuple(plan.leaves), shards)
        with self._lock:
            if kset in self._cold_seen or kset in self._stack_cache:
                return False
            if any(k in self._leaf_cache for k in keys):
                return False
        if not all(self.tier.has(k) for k in keys):
            return False
        with self._lock:
            if len(self._cold_seen) >= 4096:
                self._cold_seen.clear()
            self._cold_seen.add(kset)
        return True

    # ----------------------------------------------------------- queries

    def plan(self, index: str, call: Call,
             field_cache: Optional[Dict] = None) -> CompiledPlan:
        """Canonical plan of a set-op tree. Raises (schema errors, empty
        set ops, or QueryError for trees this engine has no program for)."""
        plan = cached_plan(self.holder, index, call, field_cache=field_cache,
                           enabled=self._plan_cache_enabled)
        _lowered(plan)
        return plan

    def count(self, index: str, call: Call, shards: Sequence[int],
              plan: Optional[CompiledPlan] = None) -> int:
        """Count(<set-op tree>) over all shards: the result memo, else the
        compressed-domain host path for a first touch of demoted planes,
        else K1 as a batch of one. `plan` skips re-planning a call the
        compile gate already planned."""
        shards = tuple(shards)
        plan = plan or self.plan(index, call)
        hit, token = self.memo_probe(index, plan, shards)
        if hit is not None:
            return hit
        if self._cold_host_candidate(index, call, plan, shards):
            plane = self._host_eval(index, call, shards, {})
            result = int(_pop_elems(plane).sum())
            with self._lock:
                self.counters["host_cold_counts"] += 1
            self.memo_store(token, result)
            return result
        launch = self._count_launch(index, plan, shards)

        def run():
            total = launch()[0]
            with obs_span("device.sync"):
                return int(total)

        result = self._device_call(plan.sig_tuple, run)
        self.memo_store(token, result)
        return result

    def _count_launch(self, index: str, plan: CompiledPlan,
                      shards: Tuple[int, ...]) -> Callable[[], torch.Tensor]:
        """The plan's leaves stacked on the partitions and K1 over them as
        a batch of one, to run under the fault guard."""
        stacked = self._stacked_leaf_tensor(index, plan.leaves, shards)
        idxs = torch.arange(len(plan.leaves), dtype=torch.int32).reshape(-1, 1)
        tape = _lowered(plan).tape
        self._bump("count_dispatches")
        return lambda: self._k1(stacked, idxs, tape)

    @staticmethod
    def _k1(stacked: Blocks, idxs: torch.Tensor, tape) -> torch.Tensor:
        """K1 launched on every partition's block before any result is
        read, its host work and staging done once for the call
        (kernels.gather_expr_count_blocks); the partial (Q,) int64 counts
        summed on partition 0's device (the reference's psum over the
        shard axis)."""
        parts = kernels.gather_expr_count_blocks(stacked, idxs, tape)
        total = parts[0]
        for part in parts[1:]:
            total = total + part.to(total.device)
        return total

    def count_async(self, index: str, call: Call, shards: Sequence[int],
                    plan: Optional[CompiledPlan] = None) -> DeviceCount:
        """count() without the memo and without waiting: one K1 launch
        under count's fault guard, its int64 device scalar returned before
        the read-back, so a caller can pipeline several queries before it
        blocks."""
        shards = tuple(shards)
        plan = plan or self.plan(index, call)
        launch = self._count_launch(index, plan, shards)
        return DeviceCount(self._device_call(plan.sig_tuple, launch)[0])

    def count_batch(self, index: str, calls: Sequence[Call],
                    shards: Sequence[int], plans=None) -> np.ndarray:
        """Count Q structurally-identical queries; returns (Q,) int64 on
        the host. Queries answered by the result memo skip the device;
        only the misses ride ONE K1 launch. `plans` (aligned 1:1 with
        `calls`) skips re-planning."""
        shards = tuple(shards)
        if plans is None:
            fcache: Dict = {}
            plans = [self.plan(index, c, field_cache=fcache) for c in calls]
        out = np.empty(len(calls), dtype=np.int64)
        miss = []
        tokens = {}
        for i, p in enumerate(plans):
            hit, tokens[i] = self.memo_probe(index, p, shards)
            if hit is None:
                miss.append(i)
            else:
                out[i] = hit
        if miss:
            def read_back(counts):
                with obs_span("device.sync"):
                    return counts.cpu().numpy()

            def run(sub):
                counts = self.count_batch_async(
                    index, [calls[i] for i in sub], shards,
                    plans=[plans[i] for i in sub])
                # The read-back inside the guard: a device fault surfaces
                # at the sync, not at the launch the guard already wrapped.
                # fire=False: the launch already paid the failpoint.
                return self._device_call(
                    plans[sub[0]].sig_tuple, lambda: read_back(counts),
                    fire=False)

            try:
                res = run(miss)
            except (DeviceDispatchError, DeviceKernelFault) as e:
                # Reduced-batch retry, on the device in both cases: the full-size dispatch already got
                # backpressure + one same-size retry inside _device_call;
                # a batch that STILL runs out of memory re-dispatches as two
                # halves before the error is allowed to reach a client.
                if e.kind != OOM or len(miss) < 2:
                    raise
                with self._lock:
                    self.counters["oom_batch_splits"] += 1
                h = len(miss) // 2
                res = np.concatenate([run(miss[:h]), run(miss[h:])])
            for j, i in enumerate(miss):
                out[i] = int(res[j])
                self.memo_store(tokens[i], int(res[j]))
        return out

    def count_batch_async(self, index: str, calls: Sequence[Call],
                          shards: Sequence[int], plans=None) -> torch.Tensor:
        """count_batch without the memo and without waiting for the
        result: the (Q,) int64 device tensor, so a caller can keep several
        batches in flight."""
        shards = tuple(shards)
        if plans is None:
            fcache: Dict = {}
            plans = [self.plan(index, c, field_cache=fcache) for c in calls]
        sig0 = plans[0].signature
        for p in plans[1:]:
            if p.signature != sig0:
                raise QueryError(
                    "count_batch requires structurally identical queries")
        return self._count_batch_setops(index, plans, shards, len(calls))

    @staticmethod
    def _batch_slot_gather(plans, q: int):
        """The batch-assembly prologue (engine.py:1615-1648 of the JAX
        package): leaf-slot dict, per-leaf-position (Q,) slot vectors, and
        within-batch dedup — identical queries compute ONCE and fan back
        out via `inverse`. No power-of-two padding: nothing here is
        compiled per shape. Returns (slots, idxs, inverse, q_deduped)."""
        slots: Dict[Leaf, int] = {}
        for p in plans:
            for leaf in p.leaves:
                slots.setdefault(leaf, len(slots))
        n_pos = len(plans[0].leaves)
        idxs = tuple(
            np.array([slots[p.leaves[j]] for p in plans], dtype=np.int32)
            for j in range(n_pos)
        )
        inverse = None
        if q > 1:
            mat = np.stack(idxs)  # (L, Q)
            uniq, inv = np.unique(mat, axis=1, return_inverse=True)
            if uniq.shape[1] < q:
                idxs = tuple(np.ascontiguousarray(row) for row in uniq)
                inverse = inv.reshape(-1).astype(np.int64)
                q = uniq.shape[1]
        return slots, idxs, inverse, q

    def _count_batch_setops(self, index: str, plans, shards: Tuple[int, ...],
                            q: int) -> torch.Tensor:
        slots, idxs, inverse, _ = self._batch_slot_gather(plans, q)
        stacked = self._stacked_leaf_tensor(index, list(slots), shards)
        idx_t = torch.from_numpy(np.stack(idxs))  # (L, Qd), host
        tape = _lowered(plans[0]).tape

        def launch():
            counts = self._k1(stacked, idx_t, tape)
            if inverse is not None:
                counts = counts[torch.from_numpy(inverse).to(counts.device)]
            return counts

        self._bump("count_dispatches")
        return self._device_call(plans[0].sig_tuple, launch)

    def _per_partition(self, leaves: Sequence[Blocks]):
        """The partitions' argument tuples: partition p's block of every
        leaf, in leaf order."""
        return [tuple(leaf[p] for leaf in leaves) for p in range(len(self.mesh))]

    def bitmap(self, index: str, call: Call, shards: Sequence[int],
               plan: Optional[CompiledPlan] = None) -> Row:
        """Evaluate a set-op tree over all shards; returns a Row whose
        segments stay on partition 0's device (one (W,) plane per shard):
        each partition evaluates its block, and the blocks are joined in
        shard order and trimmed."""
        shards = tuple(shards)
        plan = plan or self.plan(index, call)
        leaves = self._leaf_tensor(index, plan.leaves, shards)
        fn = _lowered(plan).bitmap
        self._bump("bitmap_dispatches")
        planes = self._device_call(plan.sig_tuple, lambda: _settled(_join(
            [fn(part) for part in self._per_partition(leaves)], len(shards))))  # (S, W)
        return Row({shard: planes[i] for i, shard in enumerate(shards)})

    def bitmap_batch(self, index: str, calls: Sequence[Call],
                     shards: Sequence[int], plans=None) -> List[Row]:
        """Evaluate Q same-signature bitmap trees in one device pass, the
        micro-batcher's launch for bitmap dispatches (engine.py:1781-1840
        of the JAX package). The batch's distinct leaves form one
        resident (U, S, W) stack, each leaf position gathers every query's
        plane with a (Q,) slot vector, and the tree folds into one
        (Q, S, W) output (``_batch_eval``); identical queries compute once
        and their Rows share the plane. Trees outside the slot-gather
        shapes (BSI, time ranges) and a batch of one run per call, as
        ``bitmap``. `plans` (aligned 1:1 with `calls`) skips re-planning."""
        shards = tuple(shards)
        if plans is None:
            fcache: Dict = {}
            plans = [self.plan(index, c, field_cache=fcache) for c in calls]
        plan0 = plans[0]
        if len(calls) == 1 or not plan0.setops_only:
            return [self.bitmap(index, c, shards, plan=p)
                    for c, p in zip(calls, plans)]
        for p in plans[1:]:
            if p.signature != plan0.signature:
                raise QueryError(
                    "bitmap_batch requires structurally identical queries")
        n_calls = len(calls)
        slots, idxs, inverse, _ = self._batch_slot_gather(plans, n_calls)
        stacked = self._stacked_leaf_tensor(index, list(slots), shards)
        idx_host = [torch.from_numpy(ix.astype(np.int64)) for ix in idxs]

        def run():
            outs = []
            for block in stacked:
                idx_t = [ix.to(block.device) for ix in idx_host]
                outs.append(_batch_eval(
                    plan0.ir, lambda i, b=block, ix=idx_t: b.index_select(0, ix[i])))
            return _settled(_join(outs, len(shards)))

        self._bump("bitmap_dispatches")
        planes = self._device_call(plan0.sig_tuple, run)  # (Qd, S, W)
        return [
            Row({shard: planes[qi if inverse is None else int(inverse[qi]), i]
                 for i, shard in enumerate(shards)})
            for qi in range(n_calls)
        ]

    def _src_plane(self, index: str, src_call: Call,
                   shards: Tuple[int, ...]) -> Blocks:
        """A TopN source's or BSI filter's plane, in the partitions'
        blocks."""
        plan = self.plan(index, src_call)
        leaves = self._leaf_tensor(index, plan.leaves, shards)
        return self._src_blocks(plan, leaves)

    def _src_blocks(self, plan: CompiledPlan, leaves: Sequence[Blocks]) -> Blocks:
        fn = _lowered(plan).bitmap
        return Blocks(fn(part).contiguous() for part in self._per_partition(leaves))

    def _src_parts(self, index: str, src_call: Optional[Call]):
        """(plan, memo signature, memo leaves) of a TopN source or BSI
        filter; (None, None, None) without one."""
        if src_call is None:
            return None, None, None
        plan = self.plan(index, src_call)
        return plan, plan.sig_tuple, tuple(plan.leaves)

    def topn_shard_counts(
        self, index: str, field: str, row_ids: Sequence[int],
        shards: Sequence[int], src_call: Optional[Call] = None,
        need_row_counts: bool = True,
    ):
        """Per-(row, shard) count matrices with K2 launches, memoized.

        Returns (row_counts, inter_counts, src_counts): the first two are
        (R, S) int64 arrays in the requested row order, src_counts is (S,)
        — popcount of the src bitmap per shard, which the tanimoto
        coefficient needs (fragment.go:1008-1027). inter_counts/src_counts
        are None without a src call; row_counts is None when
        need_row_counts is False. The rows' popcounts memoize under their
        own key too, so a stream of TopNs with varying filters pays the
        unmasked pass at most once."""
        shards = tuple(shards)
        req = np.asarray(row_ids, dtype=np.int64)
        canon = np.unique(req)
        sel = np.searchsorted(canon, req)  # canonical -> requested order
        canon_rows = tuple(int(r) for r in canon)
        leaves = [Leaf(field, VIEW_STANDARD, r) for r in canon_rows]
        plan, src_sig, src_leaves = self._src_parts(index, src_call)
        mkey = ("topn_shard", index, field, canon_rows, shards, src_sig,
                src_leaves, need_row_counts)
        fp = self._fingerprints(index, leaves, shards, "memo")
        if plan is not None:
            fp = fp + self._fingerprints(index, plan.leaves, shards, "memo")

        def answer(value):
            row_counts, inter, src_counts = value
            return (
                row_counts[sel] if row_counts is not None else None,
                inter[sel] if inter is not None else None,
                src_counts,
            )

        hit = self._aux_probe(mkey, fp)
        if hit is not None:
            return answer(hit)
        rows_tensor = self._stacked_leaf_tensor(index, leaves, shards)
        row_counts = None
        if need_row_counts:
            # Probe-time fingerprint discipline: fp was taken BEFORE the
            # gather above; its first len(leaves) entries are exactly the
            # candidate-row fingerprints.
            rows_fp = fp[: len(leaves)]
            rkey = ("topn_rows", index, field, canon_rows, shards)
            row_counts = self._aux_probe(rkey, rows_fp)
            if row_counts is None:
                self._bump("topn_dispatches")
                row_counts = self._device_call(None, lambda: _host_shards(
                    [kernels.masked_plane_counts(b, None) for b in rows_tensor],
                    len(shards)))
                self._aux_store(rkey, rows_fp, row_counts)
        if plan is not None:
            flt_leaves = self._leaf_tensor(index, plan.leaves, shards)

            def run():
                src = self._src_blocks(plan, flt_leaves)  # (S_padded, W)
                inter = [kernels.masked_plane_counts(b, m)
                         for b, m in zip(rows_tensor, src)]
                src_counts = [kernels.masked_plane_counts(m.unsqueeze(0), None)
                              for m in src]
                return (_host_shards(inter, len(shards)),
                        _host_shards(src_counts, len(shards))[0])

            self._bump("topn_dispatches", 2)
            inter, src_counts = self._device_call(None, run)
            value = (row_counts, inter, src_counts)
        else:
            value = (row_counts, None, None)
        self._aux_store(mkey, fp, value)
        return answer(value)

    def topn_counts(
        self, index: str, field: str, row_ids: Sequence[int],
        shards: Sequence[int], src_call: Optional[Call] = None,
    ) -> np.ndarray:
        """Total per-row counts across shards (optionally ∩ src bitmap),
        memoized under canonical row order."""
        shards = tuple(shards)
        req = np.asarray(row_ids, dtype=np.int64)
        canon = np.unique(req)
        sel = np.searchsorted(canon, req)
        canon_rows = tuple(int(r) for r in canon)
        leaves = [Leaf(field, VIEW_STANDARD, r) for r in canon_rows]
        plan, src_sig, src_leaves = self._src_parts(index, src_call)
        mkey = ("topn_total", index, field, canon_rows, shards, src_sig,
                src_leaves)
        fp = self._fingerprints(index, leaves, shards, "memo")
        if plan is not None:
            fp = fp + self._fingerprints(index, plan.leaves, shards, "memo")
        hit = self._aux_probe(mkey, fp)
        if hit is not None:
            return hit[sel]
        rows_tensor = self._stacked_leaf_tensor(index, leaves, shards)
        flt_leaves = (self._leaf_tensor(index, plan.leaves, shards)
                      if plan is not None else None)

        def run():
            src = (self._src_blocks(plan, flt_leaves) if plan is not None
                   else (None,) * len(rows_tensor))
            parts = [kernels.masked_plane_counts(b, m).sum(dim=1, dtype=torch.int64)
                     for b, m in zip(rows_tensor, src)]
            return _host_total(parts)

        self._bump("topn_dispatches")
        value = self._device_call(None, run)
        self._aux_store(mkey, fp, value)
        return value[sel]

    def bsi_val_count(
        self, index: str, field: str, kind: str, bit_depth: int,
        shards: Sequence[int], filter_call: Optional[Call] = None,
    ):
        """BSI Sum/Min/Max over all shards at once (engine.py:2045-2136 of
        the JAX package), memoized.

        kind='sum' returns the (depth+1,) per-plane global counts as int64
        (the caller composes the weighted sum in Python ints): K2 over the
        (D+1, S, W) plane stack masked by the filter, summed over S.
        kind='min'/'max' returns (bits (depth,) int32, count): K3's
        bit-sliced scan over every shard of each partition, the partitions'
        (value, count) pairs folded by _fold_minmax."""
        shards = tuple(shards)
        view = VIEW_BSI_GROUP_PREFIX + field
        leaves = [Leaf(field, view, i) for i in range(bit_depth + 1)]
        plan, fsig, flt_leaf_ids = self._src_parts(index, filter_call)
        mkey = ("bsi", index, field, kind, bit_depth, shards, fsig or (),
                flt_leaf_ids)
        fp = self._fingerprints(index, leaves, shards, "memo")
        if plan is not None:
            fp = fp + self._fingerprints(index, plan.leaves, shards, "memo")
        hit = self._aux_probe(mkey, fp)
        if hit is not None:
            return hit
        planes = self._stacked_leaf_tensor(index, leaves, shards)  # (D+1, S_padded, W)
        flt_leaves = (self._leaf_tensor(index, plan.leaves, shards)
                      if plan is not None else None)

        def run():
            flt = (self._src_blocks(plan, flt_leaves) if plan is not None
                   else (None,) * len(planes))
            if kind == "sum":
                return _host_total([
                    kernels.masked_plane_counts(b, m).sum(dim=1, dtype=torch.int64)
                    for b, m in zip(planes, flt)])  # (D+1,)
            parts = [kernels.bsi_minmax(b, m, maximize=kind == "max")
                     for b, m in zip(planes, flt)]
            with obs_span("device.sync"):
                host = [(bits.cpu().numpy(), int(count)) for bits, count in parts]
            return _fold_minmax(host, kind == "max")

        value = self._device_call(None, run)
        self._aux_store(mkey, fp, value)
        return value

    def supports(self, call: Call, index: Optional[str] = None):
        """The compile gate (engine.py:2138-2163 of the JAX package): the
        tree's plan when the plan compiler lowers it onto the engine, else
        False — the executor then walks the tree shard by shard. The
        compiler alone decides (holder lookups, no device work), so e.g. a
        time Range over a field without a quantum, over no populated
        views or over more than 256 views is refused here and answered by
        the walk. Without `index` (a caller that does not know it yet) the
        check is syntactic (True) and time Ranges are refused, as in the
        JAX package. Refusals are counted: a climbing count on a workload
        that should compile is the signal a gate bug would otherwise bury."""
        try:
            if index is None:
                self._compile_check(call)
                return True
            return self.plan(index, call)
        except Exception:
            # Any planning failure (schema, query and timestamp errors, a
            # lowering fault) means "not on the engine": the walk answers,
            # as on the JAX package.
            with self._lock:
                self.counters["compile_gate_refusals"] += 1
            return False

    def _compile_check(self, call: Call) -> None:
        if call.name == "Row":
            return
        if call.name in ("Intersect", "Union", "Difference", "Xor"):
            if not call.children:
                raise QueryError("empty")
            for ch in call.children:
                self._compile_check(ch)
            return
        if call.name == "Range" and call.has_condition_arg():
            return
        raise QueryError(f"not fast-path: {call.name}")
