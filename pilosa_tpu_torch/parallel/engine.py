"""Single-GPU query engine: resident leaf planes and stacks in device
memory, counted by the hand-written kernels of ops/kernels.py.

The counterpart of pilosa_tpu/parallel/engine.py for one CUDA device (or
the CPU, when the holder was opened with device="cpu"). A PQL set-op tree
(Row / Intersect / Union / Difference / Xor) is canonicalized by
plan/signature.py; its leaf planes are gathered once from the fragments
into (S, W) int32 tensors on the device and cached, keyed on the
fragments' (incarnation, generation) fingerprints, so a write makes the
affected entries stale and the next query simply re-gathers them.

- ``count`` and ``count_batch`` run K1 (``gather_expr_count``) over a
  resident (U, S, W) stack of the batch's distinct leaves, the query's
  expression compiled to a postfix op tape (``lower_tape``). A single
  Count is the batch of one: Q=1, idxs = arange(L).
- ``bitmap`` evaluates the tree with elementwise torch ops (``_lower_ir``)
  and returns a Row whose segments stay on the device.
- ``topn_shard_counts`` / ``topn_counts`` run K2 (``masked_plane_counts``)
  over the stacked candidate rows, with the src tree's plane as the mask.

Not in this engine (yet): the result memos, delta refresh of stale
entries, tiered demotion, the device-fault ladder, BSI and time-range
programs, and multi-device meshes.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import VIEW_STANDARD, WORDS_PER_ROW
from ..core.row import Row
from ..errors import QueryError
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


def _not_ported(kind: str) -> QueryError:
    return QueryError(
        f"{kind} plans are not ported to the PyTorch/CUDA engine yet")


def _lower_ir(ir: tuple) -> Callable:
    """Canonical set-op IR (plan/signature.py) -> torch closure over the
    tuple of (S, W) leaf planes. A k-ary node reduces its k operands in one
    chained pass; a Difference pays ONE complement for its whole
    subtracting set (head AND NOT(OR(tail)))."""
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
    raise _not_ported(kind)


def lower_tape(ir: tuple) -> Tuple[int, ...]:
    """Canonical set-op IR -> the postfix op tape K1 executes. A k-ary
    node becomes its k operands with k-1 binary ops folded left; a
    Difference becomes the head, the tails ORed together, and one ANDNOT
    — the same program _lower_ir builds. Raises QueryError when the tree
    exceeds the kernel's limits (MAX_TAPE ops, MAX_STACK deep); there is
    no fallback for such trees."""
    ops: List[int] = []

    def emit(node: tuple) -> None:
        kind = node[0]
        if kind == "leaf":
            ops.append(kernels.OP_PUSH | (node[1] << 8))
        elif kind in _BINARY:
            emit(node[1][0])
            for ch in node[1][1:]:
                emit(ch)
                ops.append(_BINARY[kind])
        elif kind == "Difference":
            emit(node[1])
            tails = node[2]
            if tails:
                emit(tails[0])
                for ch in tails[1:]:
                    emit(ch)
                    ops.append(kernels.OP_OR)
                ops.append(kernels.OP_ANDNOT)
        else:
            raise _not_ported(kind)

    emit(ir)
    # MAX_TAPE = 2 * MAX_LEAVES: a tape that fits can never name more
    # distinct rows than the kernel's slot table holds.
    if len(ops) > kernels.MAX_TAPE:
        raise QueryError(
            f"query tree needs {len(ops)} tape ops; the CUDA count kernel "
            f"takes at most {kernels.MAX_TAPE}")
    depth = kernels.tape_depth(ops)
    if depth > kernels.MAX_STACK:
        raise QueryError(
            f"query tree nests {depth} deep; the CUDA count kernel's "
            f"evaluation stack holds {kernels.MAX_STACK}")
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
