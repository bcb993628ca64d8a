"""Single-GPU query engine: resident leaf planes and stacks in device
memory, counted by the hand-written kernels of ops/kernels.py.

The counterpart of pilosa_tpu/parallel/engine.py for one CUDA device (or
the CPU, when the holder was opened with device="cpu"). A PQL tree
(Row / Intersect / Union / Difference / Xor, BSI and time-quantum Range)
is canonicalized by plan/signature.py; its leaf planes are gathered once
from the fragments into (S, W) int32 tensors on the device and cached,
keyed on the fragments' (incarnation, generation) fingerprints, so a
write makes the affected entries stale and the next query simply
re-gathers them.

- ``count`` and ``count_batch`` run K1 (``gather_expr_count``) over a
  resident (U, S, W) stack of the batch's distinct leaves, the query's
  expression compiled to a postfix op tape (``lower_tape``; BSI compares
  unroll into per-plane codes). A single Count is the batch of one: Q=1,
  idxs = arange(L).
- ``bitmap`` evaluates the tree with elementwise torch ops (``_lower_ir``)
  and returns a Row whose segments stay on the device.
- ``topn_shard_counts`` / ``topn_counts`` run K2 (``masked_plane_counts``)
  over the stacked candidate rows, with the src tree's plane as the mask.
- ``bsi_val_count`` runs BSI Sum on K2 over the (D+1, S, W) plane stack
  and Min/Max on K3 (``bsi_minmax``).
- ``supports`` is the compile gate: a tree the plan compiler refuses is
  walked shard by shard by the executor.

Not in this engine (yet): the result memos, delta refresh of stale
entries, tiered demotion, the device-fault ladder, ``bitmap_batch``, and
multi-device meshes.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD, WORDS_PER_ROW
from ..core.row import Row
from ..errors import PilosaError, QueryError
from ..ops import bitplane as bp
from ..ops import kernels
from ..plan.signature import CompiledPlan, Leaf, cached_plan
from ..pql.ast import Call
from . import EngineConfig

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardedQueryEngine:
    def __init__(self, holder, config: Optional[EngineConfig] = None,
                 device=None):
        self.holder = holder
        self.device = torch.device(device) if device is not None else holder.device
        config = config or EngineConfig()
        self._plan_cache_enabled = bool(int(config.plan_cache))
        # Device-cache budgets (bytes, LRU-evicted). The stacks duplicate
        # the leaf planes they are built from, so both caches are bounded
        # by bytes: 16 GiB each on a card (80 GB H100), 512 MiB on the CPU;
        # the JAX package's env spellings override (bench and tests set them).
        default_budget = (16 << 30) if self.device.type == "cuda" else (1 << 29)

        def budget(env_name: str, cfg_val: int) -> int:
            v = os.environ.get(env_name)
            if v is not None:
                return int(v)
            return int(cfg_val) if cfg_val > 0 else default_budget

        self._leaf_budget = budget("PILOSA_LEAF_CACHE_BYTES",
                                   config.leaf_cache_bytes)
        self._stack_budget = budget("PILOSA_STACK_CACHE_BYTES",
                                    config.stack_cache_bytes)
        self.budgets = {"leaf_cache_bytes": self._leaf_budget,
                        "stack_cache_bytes": self._stack_budget}
        # (index, leaf, shards) -> (fingerprint, (S, W) tensor)
        self._leaf_cache: Dict[Tuple, Tuple[Tuple, torch.Tensor]] = {}
        self._leaf_bytes = 0
        # (index, leaves, shards) -> (fingerprint, (U, S, W) tensor)
        self._stack_cache: Dict[Tuple, Tuple[Tuple, torch.Tensor]] = {}
        self._stack_bytes = 0
        self._lock = threading.RLock()
        self.counters = {
            "leaf_hits": 0, "leaf_misses": 0, "leaf_evictions": 0,
            "stack_hits": 0, "stack_misses": 0, "stack_evictions": 0,
            "full_refresh_bytes": 0, "oversized_admits": 0,
            # Kernel launches made for queries (counts, TopN count
            # matrices) and elementwise bitmap evaluations.
            "count_dispatches": 0, "topn_dispatches": 0,
            "bitmap_dispatches": 0,
            # Trees the compile gate refused (walked shard by shard).
            "compile_gate_refusals": 0,
        }

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def close(self) -> None:
        """Drop the resident tensors (their device memory returns to the
        caching allocator)."""
        with self._lock:
            self._leaf_cache.clear()
            self._stack_cache.clear()
            self._leaf_bytes = self._stack_bytes = 0

    # ------------------------------------------------------------ caches

    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _byte_cache_put(self, cache: Dict, key, entry: Tuple, budget: int,
                        used: int, evict_counter: str) -> int:
        """Insert (fingerprint, tensor) at MRU and evict LRU entries past
        the byte budget; returns the updated used-bytes counter. Caller
        holds self._lock. An entry larger than the whole budget is
        admitted alone (everything else evicts) rather than made
        permanently uncacheable."""
        prev = cache.pop(key, None)
        if prev is not None:
            used -= _nbytes(prev[1])
        used += _nbytes(entry[1])
        cache[key] = entry
        if _nbytes(entry[1]) > budget:
            self.counters["oversized_admits"] += 1
        while used > budget and len(cache) > 1:
            old_key = next(iter(cache))
            if old_key == key:
                break
            used -= _nbytes(cache.pop(old_key)[1])
            self.counters[evict_counter] += 1
        return used

    def _fingerprint(self, index: str, leaf: Leaf, shards: Tuple[int, ...]) -> Tuple:
        """Per-shard (incarnation, generation) pairs for one leaf — the
        staleness key for every device cache (engine.py:784-797 of the
        JAX package)."""
        return tuple(
            -1 if f is None else (f.incarnation, f.generation)
            for f in (
                self.holder.fragment(index, leaf.field, leaf.view, s)
                for s in shards
            )
        )

    def _host_gather(self, frags, row: int) -> np.ndarray:
        """Host assembly of one leaf's (S, W) uint32 plane buffer."""
        buf = np.zeros((len(frags), WORDS_PER_ROW), dtype=np.uint32)
        for i, frag in enumerate(frags):
            if frag is not None:
                buf[i] = frag.plane_np(row)
        return buf

    def _gather_leaf(self, index: str, leaf: Leaf,
                     shards: Tuple[int, ...]) -> torch.Tensor:
        """(S, W) int32 plane of one leaf on the device, cached until a
        member fragment's fingerprint moves."""
        key = (index, leaf, shards)
        frags = [self.holder.fragment(index, leaf.field, leaf.view, s)
                 for s in shards]
        # Fingerprint BEFORE the read: a write racing the gather leaves
        # the entry conservatively stale, never stale-but-fresh-looking.
        fp = tuple(-1 if f is None else (f.incarnation, f.generation)
                   for f in frags)
        with self._lock:
            cached = self._leaf_cache.get(key)
            if cached is not None and cached[0] == fp:
                self._leaf_cache[key] = self._leaf_cache.pop(key)  # LRU touch
                self.counters["leaf_hits"] += 1
                return cached[1]
        buf = self._host_gather(frags, leaf.row)
        arr = torch.from_numpy(buf.view(np.int32)).to(self.device)
        with self._lock:
            self.counters["leaf_misses"] += 1
            self.counters["full_refresh_bytes"] += buf.nbytes
            self._leaf_bytes = self._byte_cache_put(
                self._leaf_cache, key, (fp, arr), self._leaf_budget,
                self._leaf_bytes, "leaf_evictions")
        return arr

    def _leaf_tensor(self, index: str, leaves: Sequence[Leaf],
                     shards: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
        return tuple(self._gather_leaf(index, leaf, shards) for leaf in leaves)

    def _stacked_leaf_tensor(self, index: str, leaves: Sequence[Leaf],
                             shards: Tuple[int, ...]) -> torch.Tensor:
        """One resident (U, S, W) tensor for a leaf list, rebuilt (from the
        leaf cache, re-gathering only stale leaves) when a member
        fragment's fingerprint moves."""
        leaves = tuple(leaves)
        fp = tuple(self._fingerprint(index, leaf, shards) for leaf in leaves)
        key = (index, leaves, shards)
        with self._lock:
            cached = self._stack_cache.get(key)
            if cached is not None and cached[0] == fp:
                self._stack_cache[key] = self._stack_cache.pop(key)  # LRU touch
                self.counters["stack_hits"] += 1
                return cached[1]
        if not leaves:
            return torch.zeros((0, len(shards), WORDS_PER_ROW),
                               dtype=torch.int32, device=self.device)
        stacked = torch.stack(self._leaf_tensor(index, leaves, shards))
        with self._lock:
            self.counters["stack_misses"] += 1
            self._stack_bytes = self._byte_cache_put(
                self._stack_cache, key, (fp, stacked), self._stack_budget,
                self._stack_bytes, "stack_evictions")
        return stacked

    # ----------------------------------------------------------- queries

    def plan(self, index: str, call: Call,
             field_cache: Optional[Dict] = None) -> CompiledPlan:
        """Canonical plan of a set-op tree. Raises (schema errors, empty
        set ops, or QueryError for trees this engine has no program for)."""
        plan = cached_plan(self.holder, index, call, field_cache=field_cache,
                           enabled=self._plan_cache_enabled)
        _lowered(plan)
        return plan

    def count(self, index: str, call: Call, shards: Sequence[int]) -> int:
        """Count(<set-op tree>) over all shards: K1 as a batch of one."""
        shards = tuple(shards)
        plan = self.plan(index, call)
        stacked = self._stacked_leaf_tensor(index, plan.leaves, shards)
        idxs = torch.arange(len(plan.leaves), dtype=torch.int32).reshape(-1, 1)
        self._bump("count_dispatches")
        out = kernels.gather_expr_count(stacked, idxs, _lowered(plan).tape)
        return int(out[0])

    def count_batch(self, index: str, calls: Sequence[Call],
                    shards: Sequence[int]) -> np.ndarray:
        """Count Q structurally-identical queries with ONE K1 launch;
        returns (Q,) int64 on the host."""
        return self.count_batch_async(index, calls, shards).cpu().numpy()

    def count_batch_async(self, index: str, calls: Sequence[Call],
                          shards: Sequence[int]) -> torch.Tensor:
        """count_batch without waiting for the result: the (Q,) int64
        device tensor, so a caller can keep several batches in flight."""
        shards = tuple(shards)
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
        self._bump("count_dispatches")
        counts = kernels.gather_expr_count(stacked, idx_t,
                                           _lowered(plans[0]).tape)
        if inverse is not None:
            counts = counts[torch.from_numpy(inverse).to(self.device)]
        return counts

    def bitmap(self, index: str, call: Call, shards: Sequence[int]) -> Row:
        """Evaluate a set-op tree over all shards; returns a Row whose
        segments stay on the device (one (W,) plane per shard)."""
        shards = tuple(shards)
        plan = self.plan(index, call)
        leaves = self._leaf_tensor(index, plan.leaves, shards)
        self._bump("bitmap_dispatches")
        planes = _lowered(plan).bitmap(leaves)  # (S, W)
        return Row({shard: planes[i] for i, shard in enumerate(shards)})

    def _src_plane(self, index: str, src_call: Call,
                   shards: Tuple[int, ...]) -> torch.Tensor:
        plan = self.plan(index, src_call)
        leaves = self._leaf_tensor(index, plan.leaves, shards)
        return _lowered(plan).bitmap(leaves).contiguous()

    def topn_shard_counts(
        self, index: str, field: str, row_ids: Sequence[int],
        shards: Sequence[int], src_call: Optional[Call] = None,
        need_row_counts: bool = True,
    ):
        """Per-(row, shard) count matrices with K2 launches.

        Returns (row_counts, inter_counts, src_counts): the first two are
        (R, S) int64 arrays in the requested row order, src_counts is (S,)
        — popcount of the src bitmap per shard, which the tanimoto
        coefficient needs (fragment.go:1008-1027). inter_counts/src_counts
        are None without a src call; row_counts is None when
        need_row_counts is False."""
        shards = tuple(shards)
        req = np.asarray(row_ids, dtype=np.int64)
        canon = np.unique(req)
        sel = np.searchsorted(canon, req)  # canonical -> requested order
        leaves = [Leaf(field, VIEW_STANDARD, int(r)) for r in canon]
        rows_tensor = self._stacked_leaf_tensor(index, leaves, shards)
        row_counts = inter = src_counts = None
        if need_row_counts:
            self._bump("topn_dispatches")
            row_counts = kernels.masked_plane_counts(rows_tensor, None)
            row_counts = row_counts.cpu().numpy().astype(np.int64)[sel]
        if src_call is not None:
            src = self._src_plane(index, src_call, shards)  # (S, W)
            self._bump("topn_dispatches", 2)
            inter = kernels.masked_plane_counts(rows_tensor, src)
            src_counts = kernels.masked_plane_counts(src.unsqueeze(0), None)[0]
            inter = inter.cpu().numpy().astype(np.int64)[sel]
            src_counts = src_counts.cpu().numpy().astype(np.int64)
        return row_counts, inter, src_counts

    def topn_counts(
        self, index: str, field: str, row_ids: Sequence[int],
        shards: Sequence[int], src_call: Optional[Call] = None,
    ) -> np.ndarray:
        """Total per-row counts across shards (optionally ∩ src bitmap)."""
        rc, inter, _ = self.topn_shard_counts(
            index, field, row_ids, shards, src_call,
            need_row_counts=src_call is None)
        return (inter if src_call is not None else rc).sum(axis=1)

    def bsi_val_count(
        self, index: str, field: str, kind: str, bit_depth: int,
        shards: Sequence[int], filter_call: Optional[Call] = None,
    ):
        """BSI Sum/Min/Max over all shards at once (engine.py:2045-2136 of
        the JAX package, without its result memo).

        kind='sum' returns the (depth+1,) per-plane global counts as int64
        (the caller composes the weighted sum in Python ints): K2 over the
        (D+1, S, W) plane stack masked by the filter, summed over S.
        kind='min'/'max' returns (bits (depth,) int32, count): K3's
        bit-sliced scan over every shard at once."""
        shards = tuple(shards)
        view = VIEW_BSI_GROUP_PREFIX + field
        leaves = [Leaf(field, view, i) for i in range(bit_depth + 1)]
        planes = self._stacked_leaf_tensor(index, leaves, shards)  # (D+1, S, W)
        flt = None
        if filter_call is not None:
            flt = self._src_plane(index, filter_call, shards)
        if kind == "sum":
            counts = kernels.masked_plane_counts(planes, flt)  # (D+1, S)
            return counts.sum(dim=1, dtype=torch.int64).cpu().numpy()
        bits, count = kernels.bsi_minmax(planes, flt, maximize=kind == "max")
        return bits.cpu().numpy(), int(count)

    def supports(self, call: Call, index: str):
        """The compile gate (engine.py:2138-2163 of the JAX package): the
        tree's plan when the plan compiler lowers it onto the engine, else
        False — the executor then walks the tree shard by shard. The
        compiler alone decides (holder lookups, no device work), so e.g. a
        time Range over a field without a quantum, over no populated
        views or over more than 256 views is refused here and answered by
        the walk. Refusals are counted: a climbing count on a workload
        that should compile is the signal a gate bug would otherwise bury."""
        try:
            return self.plan(index, call)
        except (PilosaError, ValueError):  # schema, query and timestamp errors
            self._bump("compile_gate_refusals")
            return False
