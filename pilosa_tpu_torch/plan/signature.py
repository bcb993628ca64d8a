"""Canonical query-plan compiler: PQL call tree -> canonical IR + signature.

The device engine compiles one jitted program per query *structure* and
keys every downstream system on that structure's signature: the compiled-
program cache, the result memo, the micro-batcher's coalescing groups,
and the per-signature device breaker (docs/fault-tolerance.md). Before
this module the signature was the raw AST walk order, so two trees that
differ only by commutative operand order — `Intersect(Union(a,b), c)` vs
`Intersect(c, Union(a,b))` — compiled two XLA programs, held two memo
spaces, and could never coalesce into one fused launch.

This module lowers a call tree into a CANONICAL intermediate form:

  - commutative operands (Intersect / Union / Xor) sort into a canonical
    order, so operand shuffles of one expression share one signature;
  - associative chains flatten into k-ary nodes (`Intersect(Intersect(a,
    b), c)` -> `Intersect(a, b, c)`), so the lowered program reduces all
    k operands in ONE pass instead of a pairwise tree (the k-ary
    set-intersection idea of arXiv:1103.2409 applied at plan level);
  - `Difference` normalizes to (head, sorted tail): `a \\ b \\ c` and
    `Difference(a, Union(b, c))` both lower to `head AND NOT(OR(tail))`
    — one complement instead of one per operand;
  - leaf planes dedupe into slots assigned in canonical traversal order,
    so structurally equal trees also share leaf-binding order (and
    therefore the engine's result-memo keys).

The SIGNATURE is the slotted canonical IR itself — a nested tuple of op
kinds, arities, slot ids, and baked predicates (BSI base values, time-
range view sets). It is injective over canonical programs: two
semantically different lowered programs always differ in some node of
the tuple, so they can never collide on a signature; two trees equal up
to commutativity/associativity always canonicalize to the same tuple.
Concrete row ids are DATA (leaf bindings), not structure — they appear
in the leaves list, never in the signature — which is exactly what lets
the batched device program serve any same-shape query with index
vectors as inputs (parallel/engine.py `_count_batch_setops`).

Plans are cached on the Call object itself (`cached_plan`), validated by
the index's write epoch: the executor touches a query's tree once per
dispatch site (support gate, batcher enqueue, host ladder, per-chunk
TopN src compiles), and before this cache each touch re-walked the AST.

Lowering happens in parallel/engine.py from the IR this module emits: to
torch closures for bitmap results, and to the postfix op tape that the
gather-count kernel (ops/kernels.py) executes for counts.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

from .. import failpoints
from ..constants import VIEW_BSI_GROUP_PREFIX, VIEW_STANDARD
from ..errors import BSIGroupNotFoundError, FieldNotFoundError, QueryError
from ..pql.ast import BETWEEN, Call, GT, GTE, LT, LTE, NEQ


@contextlib.contextmanager
def obs_span(name: str, **tags):
    """No-op stand-in for the tracing span of the same name: the port has
    no tracing layer yet, and the call sites stay as they are."""
    yield None


class Leaf(NamedTuple):
    """A fragment row that must be materialized on device. NamedTuple,
    not frozen dataclass: Leaf construction/hash/eq run per call on the
    batch-serving hot path (slot dicts, cache keys)."""

    field: str
    view: str
    row: int


# IR node kinds (first element of every IR tuple). The commutative ops
# keep their PQL names so signatures stay readable in traces and breaker
# snapshots; the BSI/time kinds are plan-internal.
NARY_OPS = ("Intersect", "Union", "Xor")
SETOP_KINDS = frozenset(("leaf",) + NARY_OPS + ("Difference",))


class PlanStats:
    """Module-wide plan-compiler counters, surfaced as the `plan` group
    of /debug/vars (pilint R4: observable wholesale via snapshot())."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {
            # Canonical lowerings actually performed vs answered from the
            # on-Call cache. cache_hits >> builds on the serving path is
            # the satellite fix working (one build per query, not one per
            # dispatch site / shard batch / TopN chunk).
            "plan_builds": 0, "plan_cache_hits": 0,
            # Canonicalization effect: nodes whose operands were
            # reordered into canonical order, and nested same-op /
            # Difference-tail nodes merged into a k-ary parent. Nonzero
            # reorders on a workload prove shuffled spellings are
            # landing on shared programs.
            "plan_reorders": 0, "plan_flattens": 0,
        }

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)


STATS = PlanStats()


def snapshot() -> dict:
    """The `plan` counter group (handler /debug/vars, diagnostics)."""
    return STATS.snapshot()


class CompiledPlan:
    """One canonical lowering of a call tree for one index.

    signature: single-entry list holding the slotted canonical IR tuple
        (list for compatibility with the historical `comp.signature`
        surface — every consumer does `tuple(comp.signature)`).
    leaves: canonical-order Leaf list; slot i in the IR is leaves[i].
    ir: slotted canonical IR (nested tuples; see module docstring).
    setops_only: True when every node is a set-op over standard-view
        leaves — the shapes the batched gather program can serve.
    expr: lowered jnp closure cache slot, owned by parallel/engine.py
        (None until the engine first lowers this plan; benign race).
    """

    __slots__ = ("index", "ir", "leaves", "signature", "sig_tuple",
                 "setops_only", "expr")

    def __init__(self, index: str, ir: tuple, leaves: List[Leaf],
                 setops_only: bool):
        self.index = index
        self.ir = ir
        self.leaves = leaves
        self.signature = [ir]
        self.sig_tuple = (ir,)
        self.setops_only = setops_only
        self.expr = None


class _Builder:
    """AST -> concrete canonical IR -> slotted IR + leaf slots."""

    def __init__(self, holder, index: str, field_cache: Optional[Dict]):
        self.holder = holder
        self.index = index
        self._field_cache = field_cache
        self.reorders = 0
        self.flattens = 0

    # -------------------------------------------------- concrete IR
    #
    # Concrete nodes carry leaf identities (field, view, row) so the
    # canonical sort is a pure function of the subtree INCLUDING its
    # data bindings: ties between equal-structure siblings break on row
    # ids, making the leaf-binding order deterministic too (shared
    # memo/stack keys for shuffled spellings of one query).

    def _field_exists(self, field_name: str) -> bool:
        fc = self._field_cache
        if fc is not None:
            ok = fc.get(field_name)
            if ok is None:
                ok = self.holder.field(self.index, field_name) is not None
                fc[field_name] = ok
            return ok
        return self.holder.field(self.index, field_name) is not None

    def concrete(self, c: Call) -> tuple:
        if c.name == "Row":
            field_name = c.field_arg()
            if not self._field_exists(field_name):
                raise FieldNotFoundError(field_name)
            row_id, ok = c.uint_arg(field_name)
            if not ok:
                raise QueryError("Row() must specify row")
            return ("leaf", field_name, VIEW_STANDARD, row_id)
        if c.name in NARY_OPS:
            if not c.children:
                raise QueryError(
                    f"empty {c.name} query is currently not supported")
            kids: List[tuple] = []
            for ch in c.children:
                sub = self.concrete(ch)
                if sub[0] == c.name:
                    # Associative chain: merge the child's operands into
                    # this node (k-ary flattening).
                    kids.extend(sub[1])
                    self.flattens += 1
                else:
                    kids.append(sub)
            ordered = sorted(kids, key=repr)
            if ordered != kids:
                self.reorders += 1
            return (c.name, tuple(ordered))
        if c.name == "Difference":
            if not c.children:
                raise QueryError(
                    "empty Difference query is currently not supported")
            head = self.concrete(c.children[0])
            tail: List[tuple] = []

            def absorb(node: tuple) -> None:
                # A Union in subtracting position is the same program as
                # its flattened operands: a \\ (b U c) == a \\ b \\ c.
                if node[0] == "Union":
                    tail.extend(node[1])
                    self.flattens += 1
                else:
                    tail.append(node)

            if head[0] == "Difference":
                # (a \\ b...) \\ c... == a \\ b... \\ c...
                inner_head, inner_tail = head[1], head[2]
                tail.extend(inner_tail)
                head = inner_head
                self.flattens += 1
            for ch in c.children[1:]:
                absorb(self.concrete(ch))
            ordered = sorted(tail, key=repr)
            if ordered != tail:
                self.reorders += 1
            return ("Difference", head, tuple(ordered))
        if c.name == "Range" and c.has_condition_arg():
            return self._concrete_bsi(c)
        if c.name == "Range":
            return self._concrete_time_range(c)
        raise QueryError(f"not fast-path compilable: {c.name}")

    def _concrete_time_range(self, c: Call) -> tuple:
        field_name, row_id, views = resolve_time_range(
            self.holder, self.index, c)
        if not views:
            raise QueryError("Range() covers no populated views")
        if len(views) > 256:
            raise QueryError("Range() spans too many views for the fast path")
        return ("timerange", field_name, tuple(views), row_id)

    def _concrete_bsi(self, c: Call) -> tuple:
        (field_name, cond), = c.args.items()
        fld = self.holder.field(self.index, field_name)
        if fld is None:
            raise FieldNotFoundError(field_name)
        bsig = fld.bsi_group(field_name)
        if bsig is None:
            raise BSIGroupNotFoundError(field_name)
        depth = bsig.bit_depth()
        view = VIEW_BSI_GROUP_PREFIX + field_name

        if cond.op == NEQ and cond.value is None:
            return ("notnull", field_name, view, depth)

        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise QueryError(
                    "Range(): BETWEEN condition requires exactly two "
                    "integer values")
            lo, hi, out_of_range = bsig.base_value_between(*predicates)
            if out_of_range:
                return ("zero", field_name, view, depth)
            if predicates[0] <= bsig.min and predicates[1] >= bsig.max:
                return ("notnull", field_name, view, depth)
            return ("between", field_name, view, depth, lo, hi)

        value = cond.value
        if not isinstance(value, int) or isinstance(value, bool):
            raise QueryError("Range(): conditions only support integer values")
        base, out_of_range = bsig.base_value(cond.op, value)
        if out_of_range and cond.op != NEQ:
            return ("zero", field_name, view, depth)
        if (
            (cond.op == LT and value > bsig.max)
            or (cond.op == LTE and value >= bsig.max)
            or (cond.op == GT and value < bsig.min)
            or (cond.op == GTE and value <= bsig.min)
            or (out_of_range and cond.op == NEQ)
        ):
            return ("notnull", field_name, view, depth)
        return ("cmp", cond.op, field_name, view, depth, base)

    # --------------------------------------------------- slotted IR

    def slotted(self, node: tuple, leaves: List[Leaf],
                slots: Dict[Leaf, int]) -> tuple:
        def slot(leaf: Leaf) -> int:
            i = slots.get(leaf)
            if i is None:
                i = len(leaves)
                leaves.append(leaf)
                slots[leaf] = i
            return i

        kind = node[0]
        if kind == "leaf":
            return ("leaf", slot(Leaf(node[1], node[2], node[3])))
        if kind in NARY_OPS:
            return (kind, tuple(
                self.slotted(ch, leaves, slots) for ch in node[1]))
        if kind == "Difference":
            return ("Difference",
                    self.slotted(node[1], leaves, slots),
                    tuple(self.slotted(ch, leaves, slots)
                          for ch in node[2]))
        if kind == "timerange":
            _, field, views, row = node
            return ("timerange", tuple(
                slot(Leaf(field, v, row)) for v in views))
        # BSI kinds register every bit plane (rows 0..depth) like the
        # historical compiler did, keeping memo/fingerprint coverage —
        # and therefore staleness semantics — identical even for the
        # constant-folded zero/notnull programs.
        if kind == "cmp":
            _, op, field, view, depth, base = node
            idxs = tuple(slot(Leaf(field, view, i)) for i in range(depth + 1))
            return ("cmp", op, idxs, depth, base)
        if kind == "between":
            _, field, view, depth, lo, hi = node
            idxs = tuple(slot(Leaf(field, view, i)) for i in range(depth + 1))
            return ("between", idxs, depth, lo, hi)
        # zero / notnull
        _, field, view, depth = node
        idxs = tuple(slot(Leaf(field, view, i)) for i in range(depth + 1))
        if kind == "zero":
            return ("zero", idxs[0])
        return ("notnull", idxs[depth])


def _setops_only(ir: tuple) -> bool:
    kind = ir[0]
    if kind not in SETOP_KINDS:
        return False
    if kind == "leaf":
        return True
    if kind == "Difference":
        return _setops_only(ir[1]) and all(_setops_only(ch) for ch in ir[2])
    return all(_setops_only(ch) for ch in ir[1])


def resolve_time_range(holder, index: str, c: Call):
    """(field_name, row_id, present views) for a time-quantum Range call
    — THE one implementation of the argument parsing and present-view
    pruning, shared by the canonical lowering and the host evaluator.
    The degraded host answer must match the compiled program bit for
    bit, so the view set they union over cannot be allowed to diverge."""
    from ..timeq import parse_timestamp, views_by_time_range

    field_name = c.field_arg()
    fld = holder.field(index, field_name)
    if fld is None:
        raise FieldNotFoundError(field_name)
    row_id, ok = c.uint_arg(field_name)
    if not ok:
        raise QueryError("Range() must specify row")
    start = c.args.get("_start")
    end = c.args.get("_end")
    if not isinstance(start, str) or not isinstance(end, str):
        raise QueryError("Range() start/end time required")
    q = fld.time_quantum()
    if not q:
        raise QueryError("Range() field has no time quantum")
    views = views_by_time_range(
        VIEW_STANDARD, parse_timestamp(start), parse_timestamp(end), q
    )
    # Prune to views that exist in the field: an hour-quantum range
    # over years enumerates tens of thousands of view names, and a
    # leaf per ABSENT view would materialize a zero plane per shard
    # (the per-shard fallback just skips missing fragments). Present
    # views bound the work to actual data.
    return field_name, row_id, [v for v in views if fld.view(v) is not None]


def build_plan(holder, index: str, call: Call,
               field_cache: Optional[Dict] = None) -> CompiledPlan:
    """Lower `call` into its canonical plan for `index`. Raises QueryError
    (or a schema error) when the tree is not fast-path compilable — the
    engine's support gate turns that into the per-shard fallback."""
    failpoints.fire("plan-lower")
    with obs_span("plan.compile"):
        b = _Builder(holder, index, field_cache)
        concrete = b.concrete(call)
        leaves: List[Leaf] = []
        slots: Dict[Leaf, int] = {}
        ir = b.slotted(concrete, leaves, slots)
        plan = CompiledPlan(index, ir, leaves, _setops_only(ir))
    STATS.inc("plan_builds")
    if b.reorders:
        STATS.inc("plan_reorders", b.reorders)
    if b.flattens:
        STATS.inc("plan_flattens", b.flattens)
    return plan


def _epoch_token(holder, index: str) -> Optional[Tuple]:
    idx = holder.index(index)
    if idx is None:
        return None
    ep = idx.write_epoch
    return (index, ep.incarnation, ep.value)


def cached_plan(holder, index: str, call: Call,
                field_cache: Optional[Dict] = None,
                enabled: bool = True) -> CompiledPlan:
    """build_plan with a single-slot cache on the Call object, valid
    while the index's write epoch stands still. The executor touches one
    query's tree at several dispatch sites (support gate, micro-batcher
    enqueue, host-ladder compile, per-chunk TopN src compile) and used
    to re-walk the AST at each; within one query execution these are all
    cache hits now. The epoch token keys the entry: a write anywhere in
    the index (which can create time views or stretch a BSI range, both
    of which change the lowering) invalidates it — conservative but
    O(1), matching the engine memo's epoch fast path."""
    if enabled:
        token = _epoch_token(holder, index)
        cached = getattr(call, "_plan_cache", None)
        if (cached is not None and token is not None
                and cached[0] == token):
            STATS.inc("plan_cache_hits")
            return cached[1]
    plan = build_plan(holder, index, call, field_cache=field_cache)
    if enabled and token is not None:
        # Benign publication race: concurrent builders of the same Call
        # produce equivalent plans; last write wins.
        call._plan_cache = (token, plan)
    return plan
