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
from tests.test_torch_cuda import random_ir

PUSH, AND, OR, XOR, ANDNOT = (kernels.OP_PUSH, kernels.OP_AND, kernels.OP_OR,
                              kernels.OP_XOR, kernels.OP_ANDNOT)


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


@pytest.mark.parametrize("seed", range(12))
def test_lower_tape_matches_jax_lower_ir(seed):
    rng = np.random.default_rng(100 + seed)
    n_leaves, s, w = 6, 2, 128
    ir = random_ir(rng, n_leaves, depth=3)
    leaves = rng.integers(0, 1 << 32, (n_leaves, s, w), dtype=np.uint32)
    jplane = np.asarray(jax_lower_ir(ir)(tuple(jnp.asarray(x) for x in leaves)))
    want = int(np.bitwise_count(jplane).sum())
    tape = lower_tape(ir)
    idxs = torch.arange(n_leaves, dtype=torch.int32).reshape(-1, 1)
    got = kernels.gather_expr_count(t32(leaves), idxs, tape)
    assert int(got[0]) == want
    # The torch closure the engine uses for bitmaps agrees bit for bit.
    tplane = torch_lower_ir(ir)(tuple(t32(x) for x in leaves))
    np.testing.assert_array_equal(tplane.numpy().view(np.uint32), jplane)


def test_lower_tape_shapes():
    leaf = lambda i: ("leaf", i)  # noqa: E731
    assert lower_tape(leaf(3)) == (push(3),)
    assert lower_tape(("Intersect", (leaf(0), leaf(1), leaf(2)))) == (
        push(0), push(1), AND, push(2), AND)
    # Difference: head, tails ORed together, ONE ANDNOT.
    assert lower_tape(("Difference", leaf(0), (leaf(1), leaf(2), leaf(3)))) == (
        push(0), push(1), push(2), OR, push(3), OR, ANDNOT)
    assert lower_tape(("Difference", leaf(0), ())) == (push(0),)


def test_lower_tape_limits_raise():
    leaf = lambda i: ("leaf", i)  # noqa: E731
    deep = leaf(0)
    for i in range(1, kernels.MAX_STACK + 1):
        deep = ("Union", (leaf(i % 4), deep))  # right-nested: depth grows
    with pytest.raises(QueryError, match="evaluation stack"):
        lower_tape(deep)
    wide = ("Union", tuple(leaf(i % 4) for i in range(kernels.MAX_TAPE)))
    with pytest.raises(QueryError, match="tape ops"):
        lower_tape(wide)
    # 32 distinct rows (the kernel's slot table) still fit the tape.
    assert len(lower_tape(
        ("Union", tuple(leaf(i) for i in range(kernels.MAX_LEAVES))))) == 63
    with pytest.raises(QueryError, match="not ported"):
        lower_tape(("timerange", (0, 1)))


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
