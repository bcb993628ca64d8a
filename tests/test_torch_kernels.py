"""The port's kernel module against the JAX package.

On the CPU the wrappers of pilosa_tpu_torch.ops.kernels take their plain
twins; those are held here, exactly, against

- the Pallas kernel batched_gather_expr_count (interpret mode on the CPU,
  as tests/test_pallas.py runs it) on that file's four cases,
- pilosa_tpu.parallel.engine._lower_ir for random canonical set-op trees
  lowered by the port's lower_tape,
- the jnp popcount reductions of the JAX engine's TopN programs.

The CUDA kernels themselves are held against the twins on a card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel.engine import _lower_ir as jax_lower_ir
from pilosa_tpu_torch.errors import QueryError
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.engine import _lower_ir as torch_lower_ir
from pilosa_tpu_torch.parallel.engine import lower_tape
from pilosa_tpu_torch.ops.bitplane import popcount_words
from tests.test_torch_cuda import (BIG_TREES, HOIST_IR, balanced, leaf, random_ir,
                                  random_mixed_ir, shared_idxs)

PUSH, AND, OR, XOR, ANDNOT, NOTAND = (kernels.OP_PUSH, kernels.OP_AND, kernels.OP_OR,
                                      kernels.OP_XOR, kernels.OP_ANDNOT, kernels.OP_NOTAND)


def push(slot: int) -> int:
    return PUSH | (slot << 8)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def idx_tensor(idxs) -> torch.Tensor:
    return torch.from_numpy(np.stack(idxs).astype(np.int32))


# ------------------------------------------- K1 twin vs the Pallas kernel

AND_TAPE = [push(0), push(1), AND]


def jax_and(planes):
    return jnp.bitwise_and(planes[0], planes[1])


def run_both(stacked, idxs, expr, tape):
    want = np.asarray(pk.batched_gather_expr_count(jnp.asarray(stacked), idxs, expr))
    got = kernels.gather_expr_count(t32(stacked), idx_tensor(idxs), tape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_twin_two_leaves():
    rng = np.random.default_rng(5)
    u, s, w, q = 5, 3, 256, 7
    stacked = rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)
    idxs = tuple(rng.integers(0, u, q).astype(np.int32) for _ in range(2))
    run_both(stacked, idxs, jax_and, AND_TAPE)


def test_k1_twin_three_leaves():
    rng = np.random.default_rng(6)
    u, s, w, q = 4, 2, 128, 5
    stacked = rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)
    idxs = tuple(rng.integers(0, u, q).astype(np.int32) for _ in range(3))

    def expr(planes):
        return jnp.bitwise_or(
            jnp.bitwise_and(planes[0], planes[1]),
            jnp.bitwise_and(planes[2], jnp.bitwise_not(planes[0])),
        )

    # (p0 & p1) | (p2 & ~p0) as a postfix tape (slot 0 pushed twice).
    tape = [push(0), push(1), AND, push(2), push(0), ANDNOT, OR]
    run_both(stacked, idxs, expr, tape)


def test_k1_twin_w_chunked(monkeypatch):
    """The Pallas kernel's W-chunked grid (tiny VMEM budget) and the twin
    agree; the CUDA kernel has no such chunking knob."""
    monkeypatch.setattr(pk, "_GATHER_VMEM_BUDGET", 2 * 2 * 4 * 256 * 4 // 2)
    rng = np.random.default_rng(7)
    u, s, w, q = 6, 4, 1024, 5
    stacked = rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)
    idxs = tuple(rng.integers(0, u, q).astype(np.int32) for _ in range(2))
    run_both(stacked, idxs, jax_and, AND_TAPE)


def test_k1_twin_wide_shard_axis():
    rng = np.random.default_rng(8)
    u, s, w, q = 4, 256, 256, 6
    stacked = rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)
    idxs = tuple(rng.integers(0, u, q).astype(np.int32) for _ in range(2))
    run_both(stacked, idxs, jax_and, AND_TAPE)


# ------------------------------------------ lower_tape vs jax _lower_ir


def n_leaf_nodes(ir) -> int:
    if ir[0] == "leaf":
        return 1
    if ir[0] == "Difference":
        return n_leaf_nodes(ir[1]) + sum(n_leaf_nodes(t) for t in ir[2])
    return sum(n_leaf_nodes(ch) for ch in ir[1])


def assert_tape_counts_like_jax(ir, n_leaves, s=2, w=128, seed=0):
    """lower_tape's tape through the K1 twin counts what the JAX engine's
    _lower_ir program counts, the torch bitmap closure equals it bit for
    bit, and the tape's stack stays within floor(log2 n) + 1."""
    rng = np.random.default_rng(seed)
    leaves = rng.integers(0, 1 << 32, (n_leaves, s, w), dtype=np.uint32)
    jplane = np.asarray(jax_lower_ir(ir)(tuple(jnp.asarray(x) for x in leaves)))
    want = int(np.bitwise_count(jplane).sum())
    tape = lower_tape(ir)
    assert kernels.tape_depth(tape) <= n_leaf_nodes(ir).bit_length()
    idxs = torch.arange(n_leaves, dtype=torch.int32).reshape(-1, 1)
    got = kernels.gather_expr_count(t32(leaves), idxs, tape)
    assert int(got[0]) == want
    tplane = torch_lower_ir(ir)(tuple(t32(x) for x in leaves))
    np.testing.assert_array_equal(tplane.numpy().view(np.uint32), jplane)


@pytest.mark.parametrize("n_leaves,depth,max_kids", [(6, 3, 3), (12, 5, 5), (30, 7, 6)])
@pytest.mark.parametrize("seed", range(12))
def test_lower_tape_matches_jax_lower_ir(seed, n_leaves, depth, max_kids):
    rng = np.random.default_rng(100 + seed)
    ir = random_ir(rng, n_leaves, depth, max_kids)
    assert_tape_counts_like_jax(ir, n_leaves, seed=seed)


def test_lower_tape_shapes():
    P = lambda s: PUSH | (s << 8)  # noqa: E731
    ACC = lambda op, s: kernels.OP_ACC | op | (s << 8)  # noqa: E731
    assert lower_tape(leaf(3)) == (P(3),)
    # A k-ary node over leaves folds into the top of the stack: no push.
    assert lower_tape(("Intersect", (leaf(0), leaf(1), leaf(2)))) == (
        P(0), ACC(AND, 1), ACC(AND, 2))
    # Difference: head, then one fused ANDNOT per tail.
    assert lower_tape(("Difference", leaf(0), (leaf(1), leaf(2), leaf(3)))) == (
        P(0), ACC(ANDNOT, 1), ACC(ANDNOT, 2), ACC(ANDNOT, 3))
    assert lower_tape(("Difference", leaf(0), ())) == (P(0),)
    # A subtree goes before a lone leaf: the tails' union first, then the
    # head with NOTAND (~tails & head).
    assert lower_tape(("Difference", leaf(0), (("Union", (leaf(1), leaf(2))), leaf(3)))) == (
        P(1), ACC(OR, 2), ACC(NOTAND, 0), ACC(ANDNOT, 3))
    # The deeper operand first: one push for the second subtree only.
    two = ("Union", (("Intersect", (leaf(0), leaf(1))), ("Xor", (leaf(2), leaf(3)))))
    assert lower_tape(two) == (P(0), ACC(AND, 1), P(2), ACC(XOR, 3), OR)
    assert kernels.tape_depth(lower_tape(two)) == 2


def test_lower_tape_limits_raise():
    """No tree raises for its size below 2^23 distinct rows; past the
    kernel's slot field, and for a node kind no plan compiler emits, it
    does."""
    with pytest.raises(QueryError, match="distinct rows"):
        lower_tape(("Union", (leaf(0), leaf(kernels.MAX_SLOTS))))
    with pytest.raises(QueryError, match="unknown plan IR node"):
        lower_tape(("GroupBy", (0, 1)))
    wide = ("Union", tuple(leaf(i) for i in range(1 << 16)))
    tape = lower_tape(wide)
    assert len(tape) == 1 << 16 and kernels.tape_depth(tape) == 1


@pytest.mark.parametrize("name", sorted(BIG_TREES))
def test_trees_past_the_old_limits_count_like_jax(name):
    ir, n_leaves = BIG_TREES[name]
    assert_tape_counts_like_jax(ir, n_leaves, s=1, seed=len(name))


@pytest.mark.parametrize("name", sorted(BIG_TREES))
def test_trees_past_the_old_limits_match_pallas(name):
    """The same trees batched (Q=3 queries over a larger stack) through
    the Pallas kernel in interpret mode and through K1's twin."""
    ir, n_leaves = BIG_TREES[name]
    rng = np.random.default_rng(7 + len(name))
    u, s, w, q = n_leaves + 4, 1, 128, 3
    stacked = rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)
    idxs = tuple(rng.permutation(u)[:q].astype(np.int32) if j % 2 else
                 rng.integers(0, u, q).astype(np.int32) for j in range(n_leaves))
    run_both(stacked, idxs, jax_lower_ir(ir), lower_tape(ir))


def test_balanced_tree_depth_is_log2_plus_one():
    for n in (2, 3, 8, 17, 64, 1000):
        tape = lower_tape(balanced(0, n))
        assert kernels.tape_depth(tape) <= n.bit_length()
    # Fused leaf ops save the bottom level: 2-leaf nodes push nothing.
    assert kernels.tape_depth(lower_tape(balanced(0, 64))) == 6


# ------------------------------------------------- K1 variant selection


def test_k1_plan_serving_shape_is_staged():
    # U=128, S=256, W=32768, L=2, Q=256: 126 distinct slots, 3 stages.
    assert kernels.k1_plan(126, 256) == ("staged", 3)


def test_k1_plan_single_query_streams():
    assert kernels.k1_plan(2, 1) == ("streaming", 0)
    assert kernels.k1_plan(1, 1) == ("streaming", 0)


def test_k1_plan_past_the_ring_streams():
    cap = kernels.RING_BYTES // (2 * kernels.RING_SLOT_BYTES)
    assert cap == 227
    assert kernels.k1_plan(cap, 256) == ("staged", 2)
    assert kernels.k1_plan(cap + 1, 256) == ("streaming", 0)
    assert kernels.k1_plan(8, 2) == ("staged", kernels.RING_MAX_STAGES)


def test_k1_tiles_remap_slots_per_tile():
    rng = np.random.default_rng(3)
    q = kernels.Q_TILE * 2 + 5
    idx = rng.integers(0, 40, (3, q)).astype(np.int32)
    urows, qpos = kernels.k1_tiles(idx)
    assert len(urows) == 3 and qpos.shape == (q, 3)
    for t, rows in enumerate(urows):
        sl = slice(t * kernels.Q_TILE, (t + 1) * kernels.Q_TILE)
        np.testing.assert_array_equal(rows, np.unique(idx[:, sl]))
        np.testing.assert_array_equal(rows[qpos[sl]].T, idx[:, sl])


# --------------------------------------------- K2 twin vs jnp reductions


@pytest.mark.parametrize("masked", [False, True])
def test_k2_twin_matches_jax_topn_reductions(masked):
    rng = np.random.default_rng(9)
    r, s, w = 7, 3, 512
    stack = rng.integers(0, 1 << 32, (r, s, w), dtype=np.uint32)
    stack[0, 0, :] = 0xFFFFFFFF
    src = rng.integers(0, 1 << 32, (s, w), dtype=np.uint32)
    js = jnp.asarray(stack)
    if masked:
        # engine.py:1950-1953: AND with src, popcount, sum over W.
        masked_j = jnp.bitwise_and(js, jnp.asarray(src)[None, :, :])
        want = jnp.sum(jax.lax.population_count(masked_j).astype(jnp.int32), axis=2)
        got = kernels.masked_plane_counts(t32(stack), t32(src))
    else:
        # engine.py:1925-1927: per-(row, shard) popcount.
        want = jnp.sum(jax.lax.population_count(js).astype(jnp.int32), axis=2)
        got = kernels.masked_plane_counts(t32(stack), None)
    assert got.dtype == torch.int32 and tuple(got.shape) == (r, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- wrapper contract (CPU)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    before_l = dict(kernels.LAUNCHES)
    before_p = dict(kernels.PLAIN_CALLS)
    stack = torch.zeros((2, 1, 64), dtype=torch.int32)
    kernels.masked_plane_counts(stack, None)
    kernels.gather_expr_count(stack, torch.zeros((1, 1), dtype=torch.int32),
                              [push(0)])
    assert kernels.LAUNCHES == before_l
    assert kernels.PLAIN_CALLS["masked_plane_counts"] == before_p["masked_plane_counts"] + 1
    assert kernels.PLAIN_CALLS["gather_expr_count"] == before_p["gather_expr_count"] + 1


@pytest.mark.parametrize("q", [1, 3, 300])
def test_k1_blocks_equal_the_sum_of_per_block_launches(q):
    """gather_expr_count_blocks over N blocks (the same slots over their
    own shards) gives each block's gather_expr_count, on the CPU twin;
    their sum is the count over the joined stack. On the CPU nothing is
    staged."""
    rng = np.random.default_rng(q)
    blocks = [t32(rng.integers(0, 1 << 32, size=(6, s, 64), dtype=np.uint64))
              for s in (2, 2, 1)]
    idxs = torch.from_numpy(rng.integers(0, 6, size=(3, q)).astype(np.int32))
    tape = [push(0), push(1), AND, push(2) | (kernels.OP_ACC | XOR)]
    staged = dict(kernels.STAGED)
    got = kernels.gather_expr_count_blocks(blocks, idxs, tape)
    assert kernels.STAGED == staged
    assert len(got) == 3
    for block, part in zip(blocks, got):
        assert torch.equal(part, kernels.gather_expr_count(block, idxs, tape))
    whole = kernels.gather_expr_count(torch.cat(blocks, dim=1), idxs, tape)
    assert torch.equal(got[0] + got[1] + got[2], whole)
    with pytest.raises(ValueError, match="U, W"):
        kernels.gather_expr_count_blocks([blocks[0], blocks[1][:4].contiguous()], idxs, tape)
    with pytest.raises(ValueError, match="U, W"):
        kernels.gather_expr_count_blocks([blocks[0], blocks[1][:, :, :32].contiguous()],
                                         idxs, tape)


def test_wrappers_check_their_inputs():
    good = torch.zeros((2, 3, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kernels.masked_plane_counts(good.to(torch.int64), None)
    with pytest.raises(ValueError, match="mask"):
        kernels.masked_plane_counts(good, torch.zeros((3, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.masked_plane_counts(good.transpose(1, 2), None)
    idxs = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="idxs"):
        kernels.gather_expr_count(good, idxs.to(torch.int64), AND_TAPE)
    with pytest.raises(ValueError, match="slot"):
        kernels.gather_expr_count(good, idxs, [push(0), push(2), AND])
    with pytest.raises(ValueError, match="values"):
        kernels.gather_expr_count(good, idxs, [push(0), push(1)])
    with pytest.raises(ValueError, match="lie in"):
        kernels.gather_expr_count(good, idxs + 2, AND_TAPE)


# ------------------------------------------- K1's BSI codes vs pilosa_tpu


def bsi_want(op, planes, depth, *pred):
    """The JAX package's bit-serial compare on the same numpy planes."""
    from pilosa_tpu.ops import bitplane as jbp

    p = jnp.asarray(planes)
    if op == "between":
        return np.asarray(jbp.bsi_range_between(p, depth, *pred))
    if op in ("lt", "lte"):
        return np.asarray(jbp.bsi_range_lt(p, depth, pred[0], op == "lte"))
    if op in ("gt", "gte"):
        return np.asarray(jbp.bsi_range_gt(p, depth, pred[0], op == "gte"))
    return np.asarray(getattr(jbp, f"bsi_range_{op}")(p, depth, pred[0]))


def predicates(depth: int):
    """Leading zeros, all ones, single bits, both values of bit 0, and a
    few seeded values, within `depth` bits."""
    top = (1 << depth) - 1
    rng = np.random.default_rng(depth)
    fixed = {0, 1, top, top - 1, 1 << (depth - 1), top >> 1, 0b1010101 & top}
    return sorted(fixed | {int(x) for x in rng.integers(0, top, 3, endpoint=True)})


def bsi_ir(op, depth, *pred):
    idxs = tuple(range(depth + 1))
    if op == "between":
        return ("between", idxs, depth, *pred)
    return ("cmp", op, idxs, depth, pred[0])


def tape_popcount_and_plane(ir, planes):
    """K1's twin count of the tape, and the tape's plane by _eval_tape."""
    tape = lower_tape(ir)
    idxs = torch.arange(planes.shape[0], dtype=torch.int32).reshape(-1, 1)
    count = int(kernels.gather_expr_count(t32(planes), idxs, tape)[0])
    plane = kernels._eval_tape(tape, lambda s: t32(planes[s]))
    return count, plane.numpy().view(np.uint32), tape


@pytest.mark.parametrize("op", ["eq", "neq", "lt", "lte", "gt", "gte"])
@pytest.mark.parametrize("depth", [1, 3, 17, 40])
def test_bsi_compare_tape_matches_jax(op, depth):
    """Each compare, unrolled into K1 codes, computes pilosa_tpu's
    bsi_range_* bit for bit, for every predicate shape."""
    rng = np.random.default_rng(depth * 7 + len(op))
    planes = rng.integers(0, 1 << 32, (depth + 1, 2, 64), dtype=np.uint32)
    for base in predicates(depth):
        want = bsi_want(op, planes, depth, base)
        count, plane, tape = tape_popcount_and_plane(bsi_ir(op, depth, base), planes)
        np.testing.assert_array_equal(plane, want, err_msg=f"{op} {base}")
        assert count == int(np.bitwise_count(want).sum())
        # One code per plane at most, plus the push (and neq's NOTAND).
        assert len(tape) <= depth + 2 and kernels.tape_depth(tape) == 1


@pytest.mark.parametrize("depth", [1, 3, 17, 40])
def test_bsi_between_tape_matches_jax(depth):
    rng = np.random.default_rng(500 + depth)
    planes = rng.integers(0, 1 << 32, (depth + 1, 2, 64), dtype=np.uint32)
    preds = predicates(depth)
    for lo in preds:
        for hi in preds[::2]:
            want = bsi_want("between", planes, depth, lo, hi)
            count, plane, tape = tape_popcount_and_plane(
                bsi_ir("between", depth, lo, hi), planes)
            np.testing.assert_array_equal(plane, want, err_msg=f"{lo} {hi}")
            assert count == int(np.bitwise_count(want).sum())
            assert len(tape) <= depth + 1


BSI_TREES = {
    "Intersect(Row, lt)": (("Intersect", (leaf(0), ("cmp", "lt", tuple(range(1, 19)), 17, 70000))), 19),
    "Union(gt, between)": (("Union", (("cmp", "gt", tuple(range(6)), 5, 9),
                                      ("between", tuple(range(6)), 5, 3, 20))), 6),
    "Difference(Row, neq, timerange)": (
        ("Difference", leaf(0), (("cmp", "neq", (1, 2, 3, 4), 3, 5),
                                 ("timerange", (5, 6, 7)))), 8),
    "Xor(zero, notnull, eq)": (("Xor", (("zero", 0), ("notnull", 3),
                                        ("cmp", "eq", (0, 1, 2, 3), 3, 6))), 4),
    "two compares of one field": (("Intersect", (("cmp", "gte", (0, 1, 2, 3), 3, 2),
                                                 ("cmp", "lte", (0, 1, 2, 3), 3, 6))), 4),
}


@pytest.mark.parametrize("name", sorted(BSI_TREES))
def test_bsi_trees_count_like_jax(name):
    """Compares nested in set-op trees (and time ranges, zero, notnull):
    the tape counts what the JAX engine's _lower_ir program counts, and
    the torch bitmap closure equals that program bit for bit."""
    ir, n_leaves = BSI_TREES[name]
    rng = np.random.default_rng(len(name))
    leaves = rng.integers(0, 1 << 32, (n_leaves, 3, 128), dtype=np.uint32)
    jplane = np.asarray(jax_lower_ir(ir)(tuple(jnp.asarray(x) for x in leaves)))
    tape = lower_tape(ir)
    idxs = torch.arange(n_leaves, dtype=torch.int32).reshape(-1, 1)
    assert int(kernels.gather_expr_count(t32(leaves), idxs, tape)[0]) == int(
        np.bitwise_count(jplane).sum())
    tplane = torch_lower_ir(ir)(tuple(t32(x) for x in leaves))
    np.testing.assert_array_equal(tplane.numpy().view(np.uint32), jplane)
    assert kernels.tape_depth(tape) <= 2


def test_bsi_tape_shapes():
    """The host settles the predicate: leading zeros are fused ANDNOTs, a
    strict compare ends on its early `return keep`, depth 0 is the
    not-null row alone."""
    K = kernels
    P = lambda s: PUSH | (s << 8)  # noqa: E731
    ACC = lambda op, s: K.OP_ACC | op | (s << 8)  # noqa: E731
    B = K.OP_BSI_PUSH | (3 << 8)
    # v < 0b010 over 3 bits: bit 2 leading zero, bit 1 keeps, bit 0 strict.
    assert lower_tape(("cmp", "lt", (0, 1, 2, 3), 3, 2)) == (
        B, ACC(ANDNOT, 2), K.bsi_step(0, K.LT_KEEP, 1), K.OP_BSI_KEEP2)
    # v > 0b101, strict: bit 0 is 1, so the answer is keep1.
    assert lower_tape(("cmp", "gt", (0, 1, 2, 3), 3, 5)) == (
        B, K.bsi_step(K.GT_CLEAR, 0, 2), K.bsi_step(K.GT_KEEP, 0, 1), K.OP_BSI_KEEP1)
    assert lower_tape(("cmp", "eq", (0, 1, 2, 3), 3, 5)) == (
        P(3), ACC(AND, 2), ACC(ANDNOT, 1), ACC(AND, 0))
    assert lower_tape(("cmp", "neq", (0, 1), 1, 0)) == (P(1), ACC(ANDNOT, 0), ACC(NOTAND, 1))
    assert lower_tape(("between", (0, 1, 2), 2, 1, 2)) == (
        K.OP_BSI_PUSH | (2 << 8), K.bsi_step(K.GT_KEEP, K.LT_KEEP, 1),
        K.bsi_step(K.GT_CLEAR, K.LT_CLEAR, 0))
    assert lower_tape(("cmp", "lt", (0,), 0, 0)) == (P(0),)
    assert lower_tape(("timerange", (4, 2, 9))) == (P(4), ACC(OR, 2), ACC(OR, 9))
    assert lower_tape(("zero", 1)) == (P(1), ACC(ANDNOT, 1))
    assert lower_tape(("notnull", 7)) == (P(7),)
    assert not kernels.has_bsi(lower_tape(("cmp", "eq", (0, 1), 1, 1)))
    assert kernels.has_bsi(lower_tape(("cmp", "gte", (0, 1), 1, 1)))


@pytest.mark.parametrize("tape,match", [
    ([kernels.bsi_step(kernels.GT_KEEP, 0, 0)], "underflows"),
    ([push(0), kernels.bsi_step(kernels.GT_KEEP, 0, 1)], "outside a compare"),
    ([push(0), kernels.OP_BSI_KEEP1], "outside a compare"),
    ([kernels.OP_BSI_PUSH, kernels.OP_BSI_KEEP2, kernels.bsi_step(0, kernels.LT_CLEAR, 1)],
     "outside a compare"),
    ([kernels.OP_BSI_PUSH, push(1), AND, kernels.OP_BSI_KEEP1], "outside a compare"),
    ([kernels.OP_BSI_PUSH, kernels.OP_BSI_KEEP1 | (1 << 8)], "carries a slot"),
    ([kernels.OP_BSI_PUSH, kernels.OP_BSI_STEP | 3], "unknown tape op"),
    ([kernels.OP_BSI_PUSH, kernels.OP_BSI_STEP | (3 << 2)], "unknown tape op"),
    ([kernels.OP_BSI_PUSH, 0x22], "unknown tape op"),
    ([kernels.OP_BSI_PUSH | (1 << 8), kernels.OP_BSI_PUSH], "leaves 2 values"),
])
def test_malformed_bsi_tapes_are_refused(tape, match):
    """tape_depth, and so K1's input check, refuse malformed BSI code runs
    before any kernel could read them."""
    with pytest.raises(ValueError, match=match):
        kernels.tape_depth(tape)
    stack = torch.zeros((2, 1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        kernels.gather_expr_count(stack, torch.zeros((2, 1), dtype=torch.int32), tape)


def test_bsi_steps_name_checked_slots():
    stack = torch.zeros((3, 1, 64), dtype=torch.int32)
    idxs = torch.zeros((2, 1), dtype=torch.int32)
    for tape in ([kernels.OP_BSI_PUSH | (2 << 8)],
                 [kernels.OP_BSI_PUSH, kernels.bsi_step(kernels.GT_CLEAR, 0, 2)]):
        with pytest.raises(ValueError, match="slot 2 of 2"):
            kernels.gather_expr_count(stack, idxs, tape)


# ------------------------------------- K1's hoisted spans (host plan)


def emulate_staged(stacked, idxs, tape, variant=None):
    """(counts, staging): the staged kernel's answer as it reads K1's
    staging buffer, whole planes standing in for a chunk: per tile, a
    stage of H synthetic rows then the tile's staged rows; each hoist
    program over the stage into its synthetic row; each query's tape
    through its qpos row."""
    st = kernels._K1Staging(idxs, list(tape), variant)
    assert st.variant == "staged"
    buf, h = st.host, st.n_hoist
    q_tape = [int(c) for c in buf[:st.n_tape]]
    base = st.hoists_at + h + 1
    offs = buf[st.hoists_at:base]
    programs = [[int(c) for c in buf[base + offs[i]:base + offs[i + 1]]] for i in range(h)]
    assert base + (offs[-1] if h else -1) == st.tiles_at
    tiles = buf[st.tiles_at:st.tiles_at + 2 * st.n_tiles].reshape(-1, 2)
    qpos = buf[st.qpos_at:].reshape(st.q, st.n_leaves)
    assert 2 <= st.stages <= kernels.RING_MAX_STAGES
    assert st.stages * (h + st.max_distinct) * kernels.RING_SLOT_BYTES <= kernels.RING_BYTES
    out = []
    for t, (off, nu) in enumerate(tiles):
        urows = buf[st.urows_at + off:st.urows_at + off + nu]
        rows = [None] * h + [stacked[int(r)] for r in urows]
        for i, prog in enumerate(programs):
            # Programs read staged rows only, never a synthetic one.
            assert all(h <= c >> 8 < h + nu for c in prog if kernels.reads_slot(c))
            # A code that reads no slot points at the first staged row,
            # which no thread writes while the programs run.
            assert all(c >> 8 == h for c in prog if not kernels.reads_slot(c))
            rows[i] = kernels._eval_tape(prog, lambda r: rows[r])
        for q in range(t * kernels.Q_TILE, min(st.q, (t + 1) * kernels.Q_TILE)):
            assert qpos[q].max() < h + nu
            plane = kernels._eval_tape(q_tape, lambda j: rows[int(qpos[q, j])])
            out.append(int(popcount_words(plane).sum()))
    return out, st


def assert_split_holds(stacked, idxs, tape):
    """k1_split's query tape over the programs' planes equals _eval_tape
    of the tape, query by query; neither is deeper than the tape; and the
    staging buffer, read as the kernel reads it, counts what the twin
    counts. Returns (query tape, programs)."""
    idx = idxs.numpy()
    n_leaves = idx.shape[0]
    invariant = (idx == idx[:, :1]).all(axis=1)
    q_tape, programs = kernels.k1_split(tape, invariant)
    depth = kernels.tape_depth(tape)
    assert kernels.tape_depth(q_tape) <= depth
    for prog in programs:
        assert kernels.tape_depth(prog) <= depth
        assert sum(kernels.reads_slot(c) for c in prog) >= 2
        assert all(invariant[c >> 8] for c in prog if kernels.reads_slot(c))
    hoisted = [kernels._eval_tape(p, lambda j: stacked[int(idx[j, 0])]) for p in programs]
    for q in range(idx.shape[1]):
        want = kernels._eval_tape(tape, lambda j: stacked[int(idx[j, q])])
        got = kernels._eval_tape(
            q_tape, lambda j: stacked[int(idx[j, q])] if j < n_leaves else hoisted[j - n_leaves])
        assert torch.equal(got, want), q
    if kernels.k1_ring_stages(max(len(r) for r in kernels.k1_tiles(idx)[0])) >= 2:
        counts, _ = emulate_staged(stacked, idxs, tape, "staged")
        assert counts == kernels.gather_expr_count_plain(stacked, idxs, tape).tolist()
    return q_tape, programs


@pytest.mark.parametrize("seed", range(40))
def test_k1_split_equals_the_tape(seed):
    """Random trees of set-ops, compares (every kind), with a random half
    of their leaf positions shared by every query, over 1-3 tiles."""
    rng = np.random.default_rng(seed)
    n_leaves, u = 10, 24
    stacked = t32(rng.integers(0, 1 << 32, (u, 2, 64), dtype=np.uint32))
    tape = list(lower_tape(random_mixed_ir(rng, n_leaves, depth=4)))
    shared = [j for j in range(n_leaves) if rng.random() < 0.6]
    q = int(rng.choice([2, 9, 300, 600]))
    assert_split_holds(stacked, shared_idxs(rng, n_leaves, q, u, shared), tape)


P_ = lambda s: PUSH | (s << 8)  # noqa: E731
A_ = lambda op, s: kernels.OP_ACC | op | (s << 8)  # noqa: E731

# (tape, leaf positions shared by every query, want: query tape and the
# number of codes of each program). L is the number of leaf positions,
# so L + h is program h's synthetic row.
SPLIT_CASES = {
    "one compare": (
        lower_tape(("Intersect", (leaf(18), ("cmp", "gt", tuple(range(18)), 17, 61234)))),
        range(18), lambda L: [P_(L), A_(AND, 18)], [18]),
    "two compares": (
        lower_tape(("Intersect", (leaf(6), ("cmp", "gt", tuple(range(6)), 5, 9),
                                  ("cmp", "lt", tuple(range(6)), 5, 27)))),
        range(6), lambda L: [P_(L), A_(AND, 6)], None),
    "between": (
        lower_tape(("Intersect", (leaf(6), ("between", tuple(range(6)), 5, 3, 20)))),
        range(6), lambda L: [P_(L), A_(AND, 6)], [6]),
    "shared Union beside a row": (
        lower_tape(("Intersect", (leaf(3), ("Union", (leaf(0), leaf(1), leaf(2)))))),
        range(3), lambda L: [P_(L), A_(AND, 3)], [3]),
    "shared Union under a per-query push": (
        [P_(0), P_(1), A_(OR, 2), AND], (1, 2), lambda L: [P_(0), A_(AND, L)], [2]),
    "spans under per-query pushes": (
        lower_tape(("Xor", (("Intersect", (leaf(0), ("Union", (leaf(1), leaf(2))))),
                            ("Intersect", (leaf(3), ("cmp", "gte", tuple(range(4, 10)), 5, 7)))))),
        (1, 2) + tuple(range(4, 10)),
        lambda L: [P_(L), A_(AND, 0), P_(L + 1), A_(AND, 3), XOR], [2, 6]),
    "whole tape shared": (
        lower_tape(("Difference", ("cmp", "lte", tuple(range(6)), 5, 12), (leaf(6),))),
        range(7), lambda L: [P_(L)], None),
    "a lone shared leaf": (
        lower_tape(("Intersect", (leaf(0), leaf(1)))), (0,), lambda L: None, []),
    "nothing shared": (
        lower_tape(("Intersect", (leaf(0), ("cmp", "gt", tuple(range(1, 7)), 5, 9)))),
        (), lambda L: None, []),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_k1_split_cases(name):
    tape, shared, want_tape, want_lens = SPLIT_CASES[name]
    tape = list(tape)
    n_leaves = 1 + max(c >> 8 for c in tape if kernels.reads_slot(c))
    rng = np.random.default_rng(len(name))
    u = n_leaves + 40
    stacked = t32(rng.integers(0, 1 << 32, (u, 2, 128), dtype=np.uint32))
    idxs = shared_idxs(rng, n_leaves, 300, u, shared)
    q_tape, programs = assert_split_holds(stacked, idxs, tape)
    want = want_tape(n_leaves)
    assert q_tape == (tape if want is None else want)
    if want_lens is not None:
        assert [len(p) for p in programs] == want_lens
    else:
        assert len(programs) == 1
    staging = kernels._K1Staging(idxs, tape, None)
    assert staging.n_hoist == len(programs)
    assert staging.bsi == kernels.has_bsi(q_tape)


def today_staging_buffer(idxs, tape):
    """The staged buffer as K1 built it before hoisting: tape | tiles |
    urows | qpos."""
    urows, qpos = kernels.k1_tiles(idxs.numpy())
    sizes = [len(r) for r in urows]
    tiles = np.stack([np.cumsum([0] + sizes[:-1]), sizes], axis=1).astype(np.int32)
    return np.concatenate([np.asarray(tape, dtype=np.int32), tiles.ravel(), *urows,
                           qpos.ravel()])


@pytest.mark.parametrize("case", ["serving", "lone shared leaf", "unshared compare",
                                  "no room for the synthetic row"])
def test_k1_staging_without_hoists_is_byte_equal(case):
    """A launch with nothing to hoist builds the buffer, variant, ring
    and instantiation it built before hoisting existed."""
    rng = np.random.default_rng(5)
    if case == "serving":  # 256 distinct 2-leaf Counts over 128 rows
        a, b = np.divmod(rng.permutation(128 * 127)[:256], 127)
        idx = np.stack([a, (a + 1 + b) % 128]).astype(np.int32)
        tape = list(lower_tape(("Intersect", (leaf(0), leaf(1)))))
    elif case == "lone shared leaf":
        idx = shared_idxs(rng, 2, 40, 64, (0,)).numpy()
        tape = list(lower_tape(("Intersect", (leaf(0), leaf(1)))))
    elif case == "unshared compare":
        idx = shared_idxs(rng, 7, 40, 64, (0, 1, 2)).numpy()
        tape = list(lower_tape(HOIST_IR))
    else:  # 227 distinct slots fill two stages; a synthetic row would not fit
        idx = np.empty((7, 256), dtype=np.int32)
        idx[:6] = np.arange(6)[:, None]
        idx[6] = np.resize(np.arange(6, 227), 256)
        tape = list(lower_tape(HOIST_IR))
    idxs = torch.from_numpy(idx)
    st = kernels._K1Staging(idxs, tape, None)
    assert (st.variant, st.n_hoist) == ("staged", 0)
    distinct = max(len(r) for r in kernels.k1_tiles(idx)[0])
    assert st.stages == kernels.k1_plan(distinct, idx.shape[1])[1]
    assert st.bsi == kernels.has_bsi(tape)
    want = today_staging_buffer(idxs, tape)
    assert st.host.dtype == want.dtype and st.host.tobytes() == want.tobytes()


@pytest.mark.parametrize("distinct,hoisted,stages", [(40, 1, 4), (56, 1, 3), (112, 1, 2),
                                                     (113, 1, 3), (226, 1, 2), (227, 0, 2)])
def test_k1_ring_counts_the_synthetic_rows(distinct, hoisted, stages):
    """A stage holds H + nu rows. A hoisted launch with a set-op query tape
    sizes its ring for two blocks an SM while two stages fit that way (to
    113 rows), then for one; where the synthetic row would leave fewer
    than two stages, the launch goes unhoisted."""
    idx = np.empty((7, 256), dtype=np.int32)
    idx[:6] = np.arange(6)[:, None]
    idx[6] = np.resize(np.arange(6, distinct), 256)
    st = kernels._K1Staging(torch.from_numpy(idx), list(lower_tape(HOIST_IR)), None)
    assert (st.variant, st.n_hoist, st.stages) == ("staged", hoisted, stages)
    ring = st.stages * (st.n_hoist + distinct) * kernels.RING_SLOT_BYTES
    assert ring <= kernels.RING_BYTES
    if hoisted and distinct <= 112:
        assert 2 * (ring + kernels.BLOCK_RESERVED_BYTES) <= kernels.SM_SHARED_BYTES


def test_k1_hoisted_bsi_query_tape_keeps_one_block_rings():
    """A query tape that still holds a compare runs the BSI instantiation
    (one block an SM): its ring takes the one-block stages."""
    tape = list(lower_tape(("Intersect", (("Union", (leaf(0), leaf(1))),
                                          ("cmp", "gt", tuple(range(2, 8)), 5, 9)))))
    idxs = shared_idxs(np.random.default_rng(8), 8, 40, 60, (0, 1))
    st = kernels._K1Staging(idxs, tape, None)
    rows = st.n_hoist + st.max_distinct
    assert (st.n_hoist, st.bsi) == (1, True)
    assert st.stages == kernels.k1_ring_stages(rows) > kernels.k1_hoist_stages(rows)


def test_k1_bsi_batch_shape_is_hoisted():
    """chip_smoke's count_batch shape: the depth-17 compare becomes one
    18-code program (BSI codes), each query `PUSH h, ACC_AND row` (set-op
    codes only), 82 staged rows and one synthetic row in two stages, so
    two blocks share an SM."""
    q, d = 64, 17
    idx = np.concatenate([np.repeat(np.arange(d + 1)[:, None], q, axis=1),
                          (d + 1 + np.arange(q))[None]]).astype(np.int32)
    tape = list(lower_tape(("Intersect", (leaf(d + 1), ("cmp", "gt", tuple(range(d + 1)),
                                                         d, 61234)))))
    st = kernels._K1Staging(torch.from_numpy(idx), tape, None)
    assert (st.variant, st.stages, st.n_hoist, st.max_distinct) == ("staged", 2, 1, 82)
    assert (st.bsi, st.n_tape, st.n_leaves) == (False, 2, d + 3)
    assert list(st.host[:2]) == [P_(d + 2), A_(AND, d + 1)]
    program = st.host[st.hoists_at + 2:st.tiles_at]
    assert len(program) == d + 1 and kernels.has_bsi(program)
    # Leaves shared by every query of a streaming launch are not hoisted.
    assert kernels._K1Staging(torch.from_numpy(idx), tape, "streaming").n_hoist == 0


# ------------------------------------------------ K3's twin vs pilosa_tpu


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("depth,masked", [(0, False), (1, True), (5, False), (5, True),
                                          (17, True), (40, False)])
def test_k3_twin_matches_jax_bsi_scan(maximize, depth, masked):
    """bsi_minmax's twin over a (D+1, S, W) stack equals pilosa_tpu's
    bsi_max / bsi_min run on the same planes flattened over the shards
    (the global scan of the JAX engine's bsi_val_count)."""
    from pilosa_tpu.ops import bitplane as jbp

    rng = np.random.default_rng(depth * 2 + masked)
    s, w = 3, 96
    planes = rng.integers(0, 1 << 32, (depth + 1, s, w), dtype=np.uint32)
    # Sparse value planes, so the scan's steps keep narrowing.
    planes[:depth] &= rng.integers(0, 1 << 32, (depth, s, w), dtype=np.uint32)
    mask = rng.integers(0, 1 << 32, (s, w), dtype=np.uint32) if masked else None
    fn = jbp.bsi_max if maximize else jbp.bsi_min
    jbits, jcount = fn(jnp.asarray(planes.reshape(depth + 1, -1)), depth,
                       None if mask is None else jnp.asarray(mask.reshape(-1)))
    bits, count = kernels.bsi_minmax(t32(planes), None if mask is None else t32(mask), maximize)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (depth,)
    assert bits.tolist() == np.asarray(jbits).tolist()
    assert int(count) == int(jcount) > 0


@pytest.mark.parametrize("maximize", [False, True])
def test_k3_twin_empty_filter(maximize):
    """Nothing considered: bits all 0 for max, all 1 for min, count 0."""
    planes = torch.full((6, 2, 32), -1, dtype=torch.int32)
    bits, count = kernels.bsi_minmax(planes, torch.zeros((2, 32), dtype=torch.int32), maximize)
    assert bits.tolist() == [int(not maximize)] * 5 and int(count) == 0


def test_k3_wrapper_checks_and_counts():
    before = dict(kernels.PLAIN_CALLS)
    kernels.bsi_minmax(torch.zeros((3, 1, 64), dtype=torch.int32))
    assert kernels.PLAIN_CALLS["bsi_minmax"] == before["bsi_minmax"] + 1
    with pytest.raises(ValueError, match="1..64 planes"):
        kernels.bsi_minmax(torch.zeros((65, 1, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="mask"):
        kernels.bsi_minmax(torch.zeros((3, 2, 64), dtype=torch.int32),
                           torch.zeros((1, 64), dtype=torch.int32))
