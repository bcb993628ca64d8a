"""pilosa_tpu_torch on a CUDA card: the kernels against their plain twins,
the executor on the card against the same executor on the CPU, and
servers and static clusters of nodes on the card.

Every test here needs a card (the CUDA kernels have no CPU mode), is
marked `cuda`, and skips where torch.cuda.is_available() is false. The
file imports neither jax nor pilosa_tpu, so it also runs where those are
not installed:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import pilosa_tpu_torch
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.parallel.engine import lower_tape

pytestmark = pytest.mark.cuda


def random_ir(rng, n_leaves: int, depth: int, max_kids: int = 3):
    """A random canonical set-op IR tree over slots < n_leaves, each node
    with at most max_kids operands."""
    if depth == 0 or rng.random() < 0.3:
        return ("leaf", int(rng.integers(n_leaves)))
    kind = rng.choice(["Intersect", "Union", "Xor", "Difference"])
    if kind == "Difference":
        head = random_ir(rng, n_leaves, depth - 1, max_kids)
        tails = tuple(random_ir(rng, n_leaves, depth - 1, max_kids)
                      for _ in range(int(rng.integers(0, max_kids))))
        return ("Difference", head, tails)
    kids = tuple(random_ir(rng, n_leaves, depth - 1, max_kids)
                 for _ in range(int(rng.integers(2, max_kids + 1))))
    return (str(kind), kids)


def leaf(i):
    return ("leaf", i)


def balanced(lo, hi, kinds=("Intersect", "Union", "Xor")):
    """A balanced binary tree over leaves lo..hi-1, the worst case for the
    stack."""
    if hi - lo == 1:
        return leaf(lo)
    mid = (lo + hi) // 2
    kind = kinds[(hi - lo) % len(kinds)]
    return (kind, (balanced(lo, mid, kinds), balanced(mid, hi, kinds)))


def chain(depth: int):
    """A chain nested `depth` deep, every kind on the way, each level
    adding one leaf on one side or the other."""
    node = leaf(0)
    kinds = ("Intersect", "Union", "Xor", "Difference")
    for i in range(1, depth + 1):
        kind = kinds[i % 4]
        if kind == "Difference":
            node = (("Difference", node, (leaf(i),)) if i % 8 else
                    ("Difference", leaf(i), (node,)))
        else:
            node = (kind, (leaf(i), node) if i % 3 else (node, leaf(i)))
    return node


BIG_TREES = {
    "union_300": (("Union", tuple(leaf(i) for i in range(300))), 300),
    "chain_40": (chain(40), 41),
    "difference_50_tails": (
        ("Difference", leaf(0), tuple(
            leaf(i) if i % 5 else ("Intersect", (leaf(i), leaf(i - 1)))
            for i in range(1, 51))), 51),
    "rows_40": (("Xor", tuple(("Intersect", tuple(leaf(5 * g + k) for k in range(5)))
                              if g % 2 else ("Union", tuple(leaf(5 * g + k) for k in range(5)))
                              for g in range(8))), 40),
    "balanced_64": (balanced(0, 64), 64),
}


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


VARIANTS = ("staged", "streaming")


def k1_on_card(stacked, idxs, tape, variant=None):
    """K1 (one variant, or the one k1_plan picks) against its twin,
    exactly; returns the variant that launched."""
    before = dict(kernels.LAUNCHES)
    got = kernels.gather_expr_count(stacked, idxs, tape, variant=variant)
    want = kernels.gather_expr_count_plain(stacked, idxs, tape)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["gather_expr_count"] == before["gather_expr_count"] + 1
    ran = [v for v in VARIANTS if kernels.LAUNCHES[f"gather_expr_count_{v}"]
           == before[f"gather_expr_count_{v}"] + 1]
    assert len(ran) == 1 and (variant is None or ran == [variant])
    return ran[0]


def rand_stack(rng, shape, device):
    return t32(rng.integers(0, 1 << 32, shape, dtype=np.uint32)).to(device)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ir_seed", [0, 1, 2, 3])
def test_k1_kernel_matches_twin_on_card(cuda_device, ir_seed, variant):
    rng = np.random.default_rng(200 + ir_seed)
    u, s, w, q = 12, 5, 1024, 9
    ir = random_ir(rng, 4, depth=3)
    stacked = rand_stack(rng, (u, s, w), cuda_device)
    idxs = torch.from_numpy(rng.integers(0, u, (4, q)).astype(np.int32))
    k1_on_card(stacked, idxs, lower_tape(ir), variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(6, 5, 36), (9, 7, 1028), (3, 1, 4), (5, 3, 32768)])
def test_k1_ragged_tails_on_card(cuda_device, variant, shape):
    """S*W/4 a multiple of neither chunk (32 uint4 staged, 2048 streaming)."""
    rng = np.random.default_rng(sum(shape))
    u, s, w = shape
    stacked = rand_stack(rng, shape, cuda_device)
    tape = lower_tape(("Difference", ("Union", (leaf(0), leaf(1))), (leaf(2),)))
    idxs = torch.from_numpy(rng.integers(0, u, (3, 11)).astype(np.int32))
    k1_on_card(stacked, idxs, tape, variant)


@pytest.mark.parametrize("distinct", [227, 228])
def test_k1_ring_capacity_on_card(cuda_device, distinct):
    """227 distinct slots fill a two-stage ring exactly and are staged;
    228 stream, and naming the staged variant for them raises."""
    rng = np.random.default_rng(distinct)
    q = 256
    stacked = rand_stack(rng, (distinct + 3, 2, 256), cuda_device)
    first = np.resize(np.arange(distinct), q)
    second = rng.integers(0, distinct, q)
    idxs = torch.from_numpy(np.stack([first, second]).astype(np.int32))
    tape = lower_tape(("Xor", (leaf(0), leaf(1))))
    assert kernels.k1_tiles(idxs.numpy())[0][0].size == distinct
    want = "staged" if distinct <= 227 else "streaming"
    assert k1_on_card(stacked, idxs, tape) == want
    k1_on_card(stacked, idxs, tape, "streaming")
    if want == "staged":
        k1_on_card(stacked, idxs, tape, "staged")
    else:
        with pytest.raises(ValueError, match="ring"):
            kernels.gather_expr_count(stacked, idxs, tape, variant="staged")


@pytest.mark.parametrize("variant", VARIANTS)
def test_k1_many_queries_on_card(cuda_device, variant):
    """Q = 5000: 20 query tiles in the staged variant."""
    rng = np.random.default_rng(5000)
    u, q = 64, 5000
    stacked = rand_stack(rng, (u, 2, 1024), cuda_device)
    ir = ("Intersect", (leaf(0), ("Union", (leaf(1), leaf(2)))))
    idxs = torch.from_numpy(rng.integers(0, u, (3, q)).astype(np.int32))
    k1_on_card(stacked, idxs, lower_tape(ir), variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(BIG_TREES))
def test_k1_trees_past_the_old_limits_on_card(cuda_device, variant, name):
    """Trees past the old tape limits (more than 64 ops, 8 deep, 32 rows),
    Q = 4 over 48 stack rows so the staged ring holds every slot."""
    ir, n_leaves = BIG_TREES[name]
    rng = np.random.default_rng(len(name))
    stacked = rand_stack(rng, (48, 3, 512), cuda_device)
    idxs = torch.from_numpy(rng.integers(0, 48, (n_leaves, 4)).astype(np.int32))
    k1_on_card(stacked, idxs, lower_tape(ir), variant)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(40, 3, 2048), (1, 1, 32768), (33, 2, 4)])
def test_k2_kernel_matches_twin_on_card(cuda_device, masked, shape):
    rng = np.random.default_rng(300)
    r, s, w = shape
    stack = t32(rng.integers(0, 1 << 32, (r, s, w), dtype=np.uint32)).to(cuda_device)
    mask = (t32(rng.integers(0, 1 << 32, (s, w), dtype=np.uint32)).to(cuda_device)
            if masked else None)
    got = kernels.masked_plane_counts(stack, mask)
    want = kernels.masked_plane_counts_plain(stack, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cuda_tensor_without_kernel_library_raises(cuda_device, monkeypatch):
    """A CUDA tensor must reach the kernel or raise — never the twin."""

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(kernels, "load", no_library)
    plain = dict(kernels.PLAIN_CALLS)
    stack = torch.zeros((2, 1, 64), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="unavailable"):
        kernels.masked_plane_counts(stack, None)
    with pytest.raises(RuntimeError, match="unavailable"):
        kernels.gather_expr_count(stack, torch.zeros((1, 1), dtype=torch.int32), [0])
    assert kernels.PLAIN_CALLS == plain


QUERIES = [
    "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Difference(Union(Row(f=0), Row(f=2)), Row(f=3), Xor(Row(f=1), Row(f=4))))",
    "Row(f=2)",
    "TopN(f, n=3)",
    "TopN(f, Row(f=0), n=3)",
    f"Set({SHARD_WIDTH + 9}, f=0)",
    "Count(Intersect(Row(f=0), Row(f=1)))",
    "Count(Row(f=0))",
]


def test_executor_on_card_matches_cpu(cuda_device):
    """Holder() with no device lands on the card; its answers equal the
    same executor's on the CPU, and only kernels (no twins) ran."""
    holders = [pilosa_tpu_torch.Holder(None), pilosa_tpu_torch.Holder(None, device="cpu")]
    assert holders[0].device.type == "cuda"
    for h in holders:
        h.open()
        fld = h.create_index("i").create_field("f")
        r = np.random.default_rng(401)
        for row in range(5):
            cols = r.choice(2 * SHARD_WIDTH, 3000, replace=False)
            fld.import_bits([row] * len(cols), [int(c) for c in cols])
    exs = [pilosa_tpu_torch.Executor(h) for h in holders]

    def norm(x):
        if isinstance(x, pilosa_tpu_torch.Row):
            return x.columns().tolist()
        if isinstance(x, list):
            return [(p.id, p.count) for p in x]
        return x

    before = dict(kernels.LAUNCHES)
    for q in QUERIES:
        kernels.PLAIN_CALLS.update({k: 0 for k in kernels.PLAIN_CALLS})
        on_card = [norm(x) for x in exs[0].execute("i", q)]
        assert kernels.PLAIN_CALLS == {k: 0 for k in kernels.PLAIN_CALLS}, q
        assert on_card == [norm(x) for x in exs[1].execute("i", q)], q
    assert kernels.LAUNCHES["gather_expr_count"] > before["gather_expr_count"]
    assert kernels.LAUNCHES["masked_plane_counts"] > before["masked_plane_counts"]
    for ex, h in zip(exs, holders):
        ex.close()
        h.close()


def test_count_async_on_card_equals_count(cuda_device):
    """engine.count_async leaves K1's int64 scalar on the card; int() and
    np.asarray() wait for it and give count's answer."""
    h = pilosa_tpu_torch.Holder(None)
    h.open()
    fld = h.create_index("i").create_field("f")
    r = np.random.default_rng(402)
    for row in range(2):
        cols = r.choice(2 * SHARD_WIDTH, 5000, replace=False)
        fld.import_bits([row] * len(cols), [int(c) for c in cols])
    ex = pilosa_tpu_torch.Executor(h)
    eng = ex.engine
    from pilosa_tpu_torch.pql.parser import parse

    call = parse("Intersect(Row(f=0), Row(f=1))").calls[0]
    before = kernels.LAUNCHES["gather_expr_count"]
    got = eng.count_async("i", call, [0, 1])
    assert got.tensor.is_cuda and got.tensor.dtype == torch.int64
    assert kernels.LAUNCHES["gather_expr_count"] == before + 1
    with eng.memos_off():
        assert int(np.asarray(got)) == int(got) == eng.count("i", call, [0, 1])
    ex.close()
    h.close()


# ------------------------------------------------ K1 BSI codes, K3


def bsi_ir(op, depth, *pred, lo=0):
    """A compare over leaf positions lo..lo + depth (the last the not-null
    row)."""
    idxs = tuple(range(lo, lo + depth + 1))
    if op == "between":
        return ("between", idxs, depth, *pred)
    return ("cmp", op, idxs, depth, pred[0])


BSI_CASES = [
    # (op, depth, predicate...): leading zeros, strict i == 0 both ways,
    # all ones, depth 1 and a deep field.
    ("lt", 17, 5), ("lt", 17, 4), ("lte", 17, 100000), ("gt", 17, 65536), ("gt", 17, 6),
    ("gte", 17, 0), ("eq", 17, 12345), ("neq", 17, 12345), ("between", 17, 1000, 90000),
    ("lt", 1, 1), ("gt", 1, 0), ("between", 1, 0, 1), ("eq", 1, 1),
    ("lt", 40, (1 << 39) + 3), ("gt", 40, 123456789), ("between", 40, 77, (1 << 38) - 1),
]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", BSI_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k1_bsi_codes_on_card(cuda_device, variant, case):
    """Each compare alone (engine.count's Q=1 over slots 0..D) and nested
    in a batch of queries over a wider stack, against the twin."""
    op, depth, *pred = case
    rng = np.random.default_rng(depth + sum(pred) % 1000)
    n = depth + 1
    stacked = rand_stack(rng, (n + 6, 3, 1028), cuda_device)
    tape = lower_tape(("Intersect", (leaf(n), bsi_ir(op, depth, *pred))))
    one = torch.arange(n + 1, dtype=torch.int32).reshape(-1, 1)
    k1_on_card(stacked, one, tape, "streaming")
    idxs = torch.from_numpy(rng.integers(0, n + 6, (n + 1, 9)).astype(np.int32))
    k1_on_card(stacked, idxs, tape, variant)


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("shape,masked", [((18, 5, 1028), True), ((18, 256, 4096), False),
                                          ((1, 2, 36), True), ((41, 3, 32768), True),
                                          ((6, 1, 4), False)])
def test_k3_kernel_matches_twin_on_card(cuda_device, maximize, shape, masked):
    """Min and max, with and without a filter, ragged tails (S*W not a
    multiple of the block's 4096 words), depth 0 and 40."""
    rng = np.random.default_rng(sum(shape) + masked)
    planes = rand_stack(rng, shape, cuda_device)
    d1 = shape[0]
    planes[:d1 - 1] &= rand_stack(rng, (d1 - 1,) + shape[1:], cuda_device)
    mask = rand_stack(rng, shape[1:], cuda_device) if masked else None
    before = kernels.LAUNCHES["bsi_minmax"]
    bits, count = kernels.bsi_minmax(planes, mask, maximize)
    wbits, wcount = kernels.bsi_minmax_plain(planes, mask, maximize)
    torch.cuda.synchronize()
    assert torch.equal(bits, wbits) and int(count) == int(wcount) > 0
    assert kernels.LAUNCHES["bsi_minmax"] == before + 1


@pytest.mark.parametrize("maximize", [False, True])
def test_k3_empty_filter_on_card(cuda_device, maximize):
    planes = torch.full((9, 4, 1024), -1, dtype=torch.int32, device=cuda_device)
    bits, count = kernels.bsi_minmax(planes, torch.zeros_like(planes[0]), maximize)
    torch.cuda.synchronize()
    assert bits.tolist() == [int(not maximize)] * 8 and int(count) == 0


# ------------------------------------- K1's hoisted spans (staged variant)


def random_mixed_ir(rng, n_leaves: int, depth: int, max_kids: int = 3, root: bool = True):
    """random_ir with BSI compares (every kind, over consecutive leaf
    positions, the last one the not-null row) among the operands; the
    root is a set-op."""
    r = rng.random()
    if depth == 0 or (r < 0.35 and not root):
        if r < 0.15 and n_leaves >= 3:
            d = int(rng.integers(1, min(6, n_leaves)))
            lo = int(rng.integers(0, n_leaves - d))
            op = str(rng.choice(["lt", "lte", "gt", "gte", "eq", "neq", "between"]))
            top = (1 << d) - 1
            if op == "between":
                a, b = sorted(int(x) for x in rng.integers(0, top, 2, endpoint=True))
                return bsi_ir(op, d, a, b, lo=lo)
            return bsi_ir(op, d, int(rng.integers(0, top, endpoint=True)), lo=lo)
        return ("leaf", int(rng.integers(n_leaves)))
    kind = rng.choice(["Intersect", "Union", "Xor", "Difference"])
    if kind == "Difference":
        head = random_mixed_ir(rng, n_leaves, depth - 1, max_kids, False)
        tails = tuple(random_mixed_ir(rng, n_leaves, depth - 1, max_kids, False)
                      for _ in range(int(rng.integers(0, max_kids))))
        return ("Difference", head, tails)
    kids = tuple(random_mixed_ir(rng, n_leaves, depth - 1, max_kids, False)
                 for _ in range(int(rng.integers(2, max_kids + 1))))
    return (str(kind), kids)


def shared_idxs(rng, n_leaves: int, q: int, u: int, shared) -> torch.Tensor:
    """(L, q) slot ids below u: the positions in `shared` name one slot
    for every query (drawn once each), the others a slot per query."""
    idx = rng.integers(0, u, (n_leaves, q)).astype(np.int32)
    for j in shared:
        idx[j] = rng.integers(0, u)
    return torch.from_numpy(idx)


def n_hoisted(idxs, tape, variant=None) -> int:
    """Hoist programs of K1's host plan for this launch."""
    return kernels._K1Staging(idxs, list(tape), variant).n_hoist


# Count(Intersect(Row, Range(v > x))) as count_batch gives it: a depth-5
# compare over positions 0..5 shared by every query, position 6 a row each.
HOIST_IR = ("Intersect", (leaf(6), ("cmp", "gt", tuple(range(6)), 5, 19)))


@pytest.mark.parametrize("shape", [(30, 5, 36), (30, 7, 1028), (30, 1, 4), (30, 3, 32768)])
def test_k1_hoisted_ragged_tails_on_card(cuda_device, shape):
    """The hoisted launch where S*W/4 is no multiple of the 32-uint4
    chunk: the programs run over the stale words past the plane's end,
    which no query counts."""
    rng = np.random.default_rng(7 + sum(shape))
    stacked = rand_stack(rng, shape, cuda_device)
    tape = lower_tape(HOIST_IR)
    idxs = shared_idxs(rng, 7, 11, shape[0], range(6))
    assert n_hoisted(idxs, tape) == 1
    assert k1_on_card(stacked, idxs, tape) == "staged"


def test_k1_hoisted_two_tiles_on_card(cuda_device):
    """Q = 600: three query tiles, each staging its own rows after the
    shared ones, one query tape for all of them."""
    rng = np.random.default_rng(600)
    stacked = rand_stack(rng, (90, 2, 2048), cuda_device)
    ir = ("Intersect", (leaf(18), ("cmp", "lte", tuple(range(18)), 17, 70000)))
    tape = lower_tape(ir)
    idxs = shared_idxs(rng, 19, 600, 90, range(18))
    assert n_hoisted(idxs, tape) == 1
    assert k1_on_card(stacked, idxs, tape) == "staged"


@pytest.mark.parametrize("case", BSI_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k1_hoisted_compares_on_card(cuda_device, case):
    """Every compare kind hoisted whole, strict compares ending on their
    keep, leading zeros and `between` included, beside a row per query (a
    compare that lowers to its not-null row alone has nothing to hoist)."""
    op, depth, *pred = case
    rng = np.random.default_rng(depth + sum(pred) % 977)
    n = depth + 1
    stacked = rand_stack(rng, (n + 12, 3, 1028), cuda_device)
    tape = lower_tape(("Intersect", (leaf(n), bsi_ir(op, depth, *pred))))
    idxs = shared_idxs(rng, n + 1, 9, n + 12, range(n))
    assert n_hoisted(idxs, tape) == (len(tape) > 2)
    assert k1_on_card(stacked, idxs, tape, "staged") == "staged"


@pytest.mark.parametrize("seed", range(8))
def test_k1_hoisted_spans_beside_nested_pushes_on_card(cuda_device, seed):
    """Random trees of set-ops and compares with some positions shared:
    spans hoisted whole, as fold prefixes and under per-query pushes."""
    rng = np.random.default_rng(900 + seed)
    n_leaves, u = 10, 24
    stacked = rand_stack(rng, (u, 3, 1028), cuda_device)
    for _ in range(50):
        tape = lower_tape(random_mixed_ir(rng, n_leaves, depth=4))
        shared = [j for j in range(n_leaves) if rng.random() < 0.6]
        idxs = shared_idxs(rng, n_leaves, 13, u, shared)
        if n_hoisted(idxs, tape):
            break
    assert n_hoisted(idxs, tape)
    assert k1_on_card(stacked, idxs, tape, "staged") == "staged"
    # A shared Union under a per-query push, and a shared fold prefix.
    push = lambda s: kernels.OP_PUSH | s << 8  # noqa: E731
    acc = lambda op, s: kernels.OP_ACC | op | s << 8  # noqa: E731
    for tape in ([push(0), push(1), acc(kernels.OP_OR, 2), kernels.OP_AND],
                 [push(1), acc(kernels.OP_XOR, 2), acc(kernels.OP_AND, 0)]):
        idxs = shared_idxs(rng, 3, 13, u, (1, 2))
        assert n_hoisted(idxs, tape) == 1
        assert k1_on_card(stacked, idxs, tape, "staged") == "staged"


def test_k1_hoisted_blocks_on_card(cuda_device):
    """gather_expr_count_blocks with hoisting: one plan and one staging
    copy per device for the call, each block's counts equal the twin."""
    rng = np.random.default_rng(31)
    devs = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(3)]
    blocks = [rand_stack(rng, (30, 2, 1024), d) for d in devs]
    tape = lower_tape(HOIST_IR)
    idxs = shared_idxs(rng, 7, 40, 30, range(6))
    assert n_hoisted(idxs, tape) == 1
    torch.cuda.synchronize()
    staged, launches = dict(kernels.STAGED), dict(kernels.LAUNCHES)
    got = kernels.gather_expr_count_blocks(blocks, idxs, tape)
    torch.cuda.synchronize()
    assert kernels.STAGED["gather_expr_count"] - staged["gather_expr_count"] == len(set(devs))
    assert kernels.LAUNCHES["gather_expr_count_staged"] \
        - launches["gather_expr_count_staged"] == 3
    for block, part in zip(blocks, got):
        assert torch.equal(part.cpu(), kernels.gather_expr_count_plain(block.cpu(), idxs, tape))


@pytest.mark.parametrize("distinct", [112, 113, 226, 227])
def test_k1_hoisted_ring_at_its_limit_on_card(cuda_device, distinct):
    """112 distinct slots and one synthetic row fill two-stage rings of
    two blocks an SM, 113 take one block's ring; 226 fill a one-block
    two-stage ring exactly and are hoisted; at 227 the synthetic row does
    not fit, so the launch is staged without hoisting."""
    rng = np.random.default_rng(distinct)
    q, u = 256, distinct + 4
    stacked = rand_stack(rng, (u, 2, 256), cuda_device)
    tape = lower_tape(HOIST_IR)
    idx = np.empty((7, q), dtype=np.int32)
    idx[:6] = np.arange(6)[:, None]
    idx[6] = np.resize(np.arange(6, distinct), q)
    idxs = torch.from_numpy(idx)
    assert kernels.k1_tiles(idx)[0][0].size == distinct
    assert n_hoisted(idxs, tape) == (distinct < 227)
    assert k1_on_card(stacked, idxs, tape) == "staged"


BSI_QUERIES = [
    "Sum(field=v)", "Min(field=v)", "Max(field=v)", "Sum(Row(f=1), field=v)",
    "Min(Row(f=1), field=v)", "Max(Row(f=99), field=v)",
    "Count(Range(v > 100))", "Count(Range(v >< [-50, 400]))", "Range(v == 7)",
    "Count(Intersect(Row(f=0), Range(v < 0)))", "TopN(f, Range(v > 0), n=3)",
    "Count(Range(t=1, 2018-01-02T00:00, 2018-01-09T00:00))",
    "SetValue(col=3, v=-200)", "Min(field=v)", "Count(Range(v == -200))",
    "Set(5, t=1, 2018-01-03T00:00)", "Count(Range(t=1, 2018-01-02T00:00, 2018-01-09T00:00))",
]


def test_bsi_executor_on_card_matches_cpu(cuda_device):
    """Sum/Min/Max, BSI and time Ranges and their writes: the card's
    answers equal the CPU's, only kernels ran, K3 among them."""
    from datetime import datetime, timedelta

    from pilosa_tpu_torch.core.field import FieldOptions

    holders = [pilosa_tpu_torch.Holder(None), pilosa_tpu_torch.Holder(None, device="cpu")]
    for h in holders:
        h.open()
        idx = h.create_index("i")
        r = np.random.default_rng(402)
        f = idx.create_field("f")
        for row in range(3):
            cols = r.choice(2 * SHARD_WIDTH, 3000, replace=False)
            f.import_bits([row] * len(cols), [int(c) for c in cols])
        v = idx.create_field("v", FieldOptions(type="int", min=-300, max=900))
        cols = r.choice(2 * SHARD_WIDTH, 5000, replace=False)
        v.import_value([int(c) for c in cols], [int(x) for x in r.integers(-300, 900, 5000)])
        t = idx.create_field("t", FieldOptions(type="time", time_quantum="YMD"))
        cols = r.choice(2 * SHARD_WIDTH, 600, replace=False)
        t.import_bits([1] * 600, [int(c) for c in cols],
                      [datetime(2018, 1, 1) + timedelta(days=i % 20) for i in range(600)])
    exs = [pilosa_tpu_torch.Executor(h) for h in holders]

    def norm(x):
        if isinstance(x, pilosa_tpu_torch.Row):
            return x.columns().tolist()
        if isinstance(x, list):
            return [(p.id, p.count) for p in x]
        if hasattr(x, "val"):
            return (x.val, x.count)
        return x

    before = dict(kernels.LAUNCHES)
    for q in BSI_QUERIES:
        kernels.PLAIN_CALLS.update({k: 0 for k in kernels.PLAIN_CALLS})
        on_card = [norm(x) for x in exs[0].execute("i", q)]
        assert kernels.PLAIN_CALLS == {k: 0 for k in kernels.PLAIN_CALLS}, q
        assert on_card == [norm(x) for x in exs[1].execute("i", q)], q
    for k in ("gather_expr_count", "masked_plane_counts", "bsi_minmax"):
        assert kernels.LAUNCHES[k] > before[k], k
    assert exs[0].engine.snapshot()["compile_gate_refusals"] == 0
    for ex, h in zip(exs, holders):
        ex.close()
        h.close()


# ------------------------- delta refresh, OOM and build failures on the card


def _planted_card_holder(n_rows=6, n_shards=3):
    h = pilosa_tpu_torch.Holder(None)
    h.open()
    fld = h.create_index("i").create_field("f")
    r = np.random.default_rng(403)
    for row in range(n_rows):
        cols = r.choice(n_shards * SHARD_WIDTH, 4000, replace=False)
        fld.import_bits([row] * len(cols), [int(c) for c in cols])
    return h, fld


def test_delta_scatter_on_card_equals_rebuilt_stack(cuda_device):
    """A one-bit Set and a cleared bit on resident leaves refresh the CUDA
    stack by a scatter into a clone; it equals a stack rebuilt from the
    host planes by a fresh engine, and no full refresh ran."""
    from pilosa_tpu_torch.parallel.engine import Leaf, ShardedQueryEngine

    h, fld = _planted_card_holder()
    shards = (0, 1, 2)
    leaves = [Leaf("f", "standard", r) for r in range(6)]
    eng = ShardedQueryEngine(h)
    fresh = None
    try:
        # The engine's one partition: its block is the whole stack.
        old = eng._stacked_leaf_tensor("i", leaves, shards).joined()
        assert old.is_cuda
        kept = old.clone()
        base = eng.snapshot()
        assert fld.set_bit(2, SHARD_WIDTH + 12345)
        plane = h.fragment("i", "f", "standard", 2).plane_np(4)
        first = int(np.flatnonzero(np.unpackbits(plane.view(np.uint8),
                                                 bitorder="little"))[0])
        assert fld.clear_bit(4, 2 * SHARD_WIDTH + first)
        new = eng._stacked_leaf_tensor("i", leaves, shards).joined()
        snap = eng.snapshot()
        assert snap["stack_delta_hits"] == base["stack_delta_hits"] + 1
        assert snap["full_refresh_bytes"] == base["full_refresh_bytes"]
        assert 0 < snap["delta_bytes"] - base["delta_bytes"] <= 1024
        # Functional: a reader holding the old tensor still reads it.
        assert torch.equal(old, kept) and not torch.equal(old, new)
        fresh = ShardedQueryEngine(h)
        rebuilt = fresh._stacked_leaf_tensor("i", leaves, shards).joined()
        torch.cuda.synchronize()
        assert torch.equal(new, rebuilt)
        host = np.stack([[h.fragment("i", "f", "standard", s).plane_np(leaf.row)
                          for s in shards] for leaf in leaves])
        assert torch.equal(new.cpu(), t32(host))
    finally:
        eng.close()
        if fresh is not None:
            fresh.close()
        h.close()


def test_cuda_oom_classifies_oom(cuda_device):
    """A real allocation past the card's memory raises
    torch.cuda.OutOfMemoryError, which classifies as `oom`; through the
    engine's dispatch guard it gets backpressure and one retry, then
    escapes as DeviceKernelFault, which no rung of the ladder catches."""
    from pilosa_tpu_torch.parallel.device_health import (DeviceDispatchError,
                                                          DeviceKernelFault,
                                                          classify_device_error)
    from pilosa_tpu_torch.parallel.engine import ShardedQueryEngine

    total = torch.cuda.mem_get_info()[1]
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(total + (1 << 30), dtype=torch.uint8, device=cuda_device)
    assert classify_device_error(ei.value) == "oom"
    h, _ = _planted_card_holder(n_rows=1, n_shards=1)
    eng = ShardedQueryEngine(h)
    try:
        with pytest.raises(DeviceKernelFault) as de:
            eng._device_call(None, lambda: torch.empty(
                total + (1 << 30), dtype=torch.uint8, device=cuda_device))
        assert de.value.kind == "oom"
        assert not isinstance(de.value, DeviceDispatchError)
        snap = eng.snapshot()
        assert snap["oom_backpressure"] == 1 and snap["oom_retries"] == 0
        assert snap["kernel_faults"] == 1
        assert eng.device_health.snapshot()["failures_oom"] == 1
    finally:
        eng.close()
        h.close()
        torch.cuda.empty_cache()


def test_build_failure_raises_through_engine(cuda_device, monkeypatch, tmp_path):
    """nvcc missing and no library built: the first launch raises
    KernelBuildError out of Executor.execute; it is not answered on the
    host or by the per-shard walk, and device_dispatch_errors stays 0."""
    h, _ = _planted_card_holder(n_rows=2, n_shards=2)
    ex = pilosa_tpu_torch.Executor(h)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(kernels, "_lib", None)
    try:
        for q in ("Count(Intersect(Row(f=0), Row(f=1)))", "TopN(f, Row(f=0), n=2)"):
            with pytest.raises(kernels.KernelBuildError):
                ex.execute("i", q)
        snap = ex.engine.snapshot()
        assert snap["device_dispatch_errors"] == 0
        assert snap["host_counts"] == snap["host_topn"] == 0
        assert ex.engine.device_health.plane_state() == "closed"
        assert ex.engine.device_health.snapshot()["dispatch_failures"] == 0
    finally:
        ex.close()
        h.close()


@pytest.mark.parametrize("q", [
    "Count(Intersect(Row(f=0), Row(f=1)))", "TopN(f, Row(f=0), n=2)"],
    ids=["count", "topn"])
def test_kernel_launch_fault_raises_out_of_execute(cuda_device, monkeypatch, q):
    """A kernel of the port that fails on the card (a planted launch
    error) is classified and recorded into the breakers, then raised out
    of Executor.execute: never answered by the host rung. Once the plane
    breaker is open, the next query raises too instead of going to the
    host."""
    from pilosa_tpu_torch.parallel.device_health import (DeviceKernelFault,
                                                          ResilienceConfig)

    h, _ = _planted_card_holder(n_rows=2, n_shards=2)
    ex = pilosa_tpu_torch.Executor(
        h, resilience_config=ResilienceConfig(device_breaker_failures=1))
    kernels.load()

    def planted(name, err):
        raise RuntimeError(f"{name} kernel launch failed: cudaError 700")

    monkeypatch.setattr(kernels, "_check_launch", planted)
    try:
        with pytest.raises(DeviceKernelFault) as fe:
            ex.execute("i", q)
        assert fe.value.kind == "runtime"
        assert ex.engine.device_health.plane_state() == "open"
        with pytest.raises(DeviceKernelFault):
            ex.execute("i", "Count(Union(Row(f=0), Row(f=1)))")
        snap = ex.engine.snapshot()
        assert snap["host_counts"] == snap["host_topn"] == 0
        assert snap["kernel_faults"] == 1 and snap["device_dispatch_errors"] == 1
        assert ex.engine.device_health.snapshot()["failures_runtime"] == 1
    finally:
        ex.close()
        h.close()


def test_server_on_card_coalesces_concurrent_counts(cuda_device):
    """An in-process Server on the card: 8 concurrent clients' distinct
    Counts over HTTP equal the CPU executor's answers, the micro-batcher
    coalesces them (its window held open until the group fills), and K1
    launches fewer times than there are queries; bitmap_batch planes on
    the card equal per-call bitmaps."""
    import http.client
    import json
    import threading

    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.server.server import Server

    n = 8
    srv = Server(data_dir=None, port=0, cache_flush_interval=0, executor_workers=0)
    srv.open()
    cpu_h = pilosa_tpu_torch.Holder(None, device="cpu")
    cpu_h.open()
    try:
        for h in (srv.holder, cpu_h):
            fld = h.create_index_if_not_exists("i").create_field_if_not_exists("f")
            r = np.random.default_rng(405)
            for row in range(n + 1):
                cols = r.choice(3 * SHARD_WIDTH, 4000, replace=False)
                fld.import_bits([row] * len(cols), [int(c) for c in cols])
        cpu_ex = pilosa_tpu_torch.Executor(cpu_h)
        qs = [f"Count(Intersect(Row(f={a}), Row(f={a + 1})))" for a in range(n)]
        want = [cpu_ex.execute("i", q)[0] for q in qs]
        eng = srv.executor.engine
        batcher = srv.batcher
        batcher.batch_max = n
        batcher.depth_fn = lambda: n
        batcher.wait_window = lambda group, w: group.full.wait(timeout=30)
        got = [None] * n
        barrier = threading.Barrier(n)

        def client(i):
            conn = http.client.HTTPConnection("localhost", srv.port, timeout=60)
            barrier.wait(timeout=30)
            conn.request("POST", "/index/i/query", body=qs[i].encode())
            got[i] = json.loads(conn.getresponse().read())["results"][0]
            conn.close()

        kernels.reset_counters()
        with eng.memos_off():
            threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        torch.cuda.synchronize()
        assert got == want
        assert batcher.snapshot()["coalesced"] > 0
        assert 0 < kernels.LAUNCHES["gather_expr_count"] < n
        assert not any(kernels.PLAIN_CALLS.values())
        calls = [parse(f"Union(Row(f={a}), Row(f={a + 1}))").calls[0] for a in range(n)]
        rows = eng.bitmap_batch("i", calls, [0, 1, 2])
        for c, row in zip(calls, rows):
            assert row.segments[0].is_cuda
            assert row.columns().tolist() == eng.bitmap("i", c, [0, 1, 2]).columns().tolist()
        cpu_ex.close()
    finally:
        srv.close()
        cpu_h.close()



def test_two_card_nodes_answer_across_each_other(cuda_device):
    """Two Server nodes on the card in one static cluster (replica_n = 1):
    a Count and a Row whose shards lie on both nodes, asked of each node,
    equal a CPU executor over the same bits. The peer's Row segments come
    off the wire on the host and are merged on the card."""
    _two_card_nodes(mux=False)


def test_two_card_nodes_over_the_mux(cuda_device):
    """The same with `[transport] enabled` on both nodes: the peer's
    answers come over the mux, are decoded as over HTTP and merged on the
    card."""
    _two_card_nodes(mux=True)


def _two_card_nodes(mux):
    import http.client
    import json
    import socket

    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.server.mux import TransportConfig
    from pilosa_tpu_torch.server.server import Server

    off = 2000
    ports = []
    while len(ports) < 2:
        sk = socket.socket()
        sk.bind(("localhost", 0))
        p = sk.getsockname()[1]
        sk.close()
        if p + off > 65000 or p in ports:
            continue
        probe = socket.socket()
        try:
            probe.bind(("localhost", p + off))  # the mux listener's port
        except OSError:
            continue
        finally:
            probe.close()
        ports.append(p)
    hosts = [f"localhost:{p}" for p in ports]
    tc = TransportConfig(enabled=True, port_offset=off) if mux else None
    nodes = [Server(data_dir=None, port=p, cluster_hosts=hosts, hasher=ModHasher(),
                    cache_flush_interval=0, anti_entropy_interval=0,
                    member_monitor_interval=0, executor_workers=0,
                    transport_config=tc).open()
             for p in ports]
    cpu_h = pilosa_tpu_torch.Holder(None, device="cpu")
    cpu_h.open()

    def post(port, path, body):
        conn = http.client.HTTPConnection("localhost", port, timeout=60)
        conn.request("POST", path, body=body.encode())
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    try:
        assert post(ports[0], "/index/i", "{}")[0] == 200
        assert post(ports[0], "/index/i/field/f", "{}")[0] == 200
        fld = cpu_h.create_index("i").create_field("f")
        r = np.random.default_rng(411)
        for row in (1, 2):
            cols = sorted(int(c) for c in r.choice(4 * SHARD_WIDTH, 300, replace=False))
            fld.import_bits([row] * len(cols), cols)
            pql = " ".join(f"Set({c}, f={row})" for c in cols)
            assert post(ports[0], "/index/i/query", pql)[0] == 200
        owners = {nodes[0].cluster.shard_nodes("i", s)[0].id for s in range(4)}
        assert owners == set(hosts)
        cpu_ex = pilosa_tpu_torch.Executor(cpu_h)
        want_count = cpu_ex.execute("i", "Count(Intersect(Row(f=1), Row(f=2)))")[0]
        want_cols = cpu_ex.execute("i", "Union(Row(f=1), Row(f=2))")[0].columns().tolist()
        kernels.reset_counters()
        for port in ports:
            assert post(port, "/index/i/query", "Count(Intersect(Row(f=1), Row(f=2)))") == (
                200, {"results": [want_count]})
            status, body = post(port, "/index/i/query", "Union(Row(f=1), Row(f=2))")
            assert status == 200 and body["results"][0]["columns"] == want_cols
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gather_expr_count"] > 0
        assert not any(kernels.PLAIN_CALLS.values())
        # The executor's own reduce: a peer's Row lands on this node's card.
        row = nodes[0].executor.execute("i", "Union(Row(f=1), Row(f=2))")[0]
        assert row.columns().tolist() == want_cols
        assert all(seg.is_cuda for seg in row.segments.values())
        for n in nodes:
            st = n.transport_stats.snapshot()
            assert (st["requests_mux"] > 0) == mux and st["requests_http"] == 0, st
        cpu_ex.close()
    finally:
        for n in nodes:
            n.close()
        cpu_h.close()


def test_k1_staged_concurrent_rings_of_different_sizes(cuda_device):
    """Threads launching K1 staged with different ring sizes at once (the
    server's concurrent groups): the kernel's shared-memory limit is one
    process-wide attribute, and no launch may find it lowered under it.
    Every result equals the twin."""
    import threading

    rng = np.random.default_rng(409)
    tape = lower_tape(("Intersect", (leaf(0), leaf(1))))
    cases = []
    for u in (2, 16, 64, 200):
        stacked = rand_stack(rng, (u, 4, 4096), cuda_device)
        idxs = torch.from_numpy(rng.integers(0, u, (2, 8), dtype=np.int32))
        cases.append((stacked, idxs, kernels.gather_expr_count_plain(stacked, idxs, tape)))
    errors = []
    barrier = threading.Barrier(len(cases))

    def run(stacked, idxs, want):
        stream = torch.cuda.Stream()
        barrier.wait(timeout=30)
        try:
            with torch.cuda.stream(stream):
                for _ in range(50):
                    got = kernels.gather_expr_count(stacked, idxs, tape, variant="staged")
                    stream.synchronize()
                    assert torch.equal(got, want)
        except BaseException as e:  # handed back to the test thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert errors == []


def test_cli_cluster_on_the_card(cuda_device, tmp_path):
    """`python -m pilosa_tpu_torch.cli server` with --cluster-hosts and
    --cluster-replicas, two processes on the card (no --device): a write
    through one node lands on both replicas and each node's Count over
    shards that cross the nodes is right."""
    import http.client
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    socks = [socket.socket() for _ in range(2)]
    for sk in socks:
        sk.bind(("localhost", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    hosts = ",".join(f"localhost:{p}" for p in ports)

    def post(port, path, body):
        conn = http.client.HTTPConnection("localhost", port, timeout=120)
        conn.request("POST", path, body=body.encode())
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    def peer_state(port, other):
        conn = http.client.HTTPConnection("localhost", port, timeout=30)
        conn.request("GET", "/debug/vars")
        got = json.loads(conn.getresponse().read())
        conn.close()
        return got["resilience"]["peers"].get(f"localhost:{other}", {}).get("state")

    procs = []
    try:
        for p in ports:
            proc = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir",
                 str(tmp_path / f"n{p}"), "--bind", f"localhost:{p}", "--cluster-hosts",
                 hosts, "--cluster-replicas", "2"],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append(proc)
            for line in proc.stdout:
                if "listening on" in line:
                    break
            else:
                raise AssertionError("server did not start")
        # Write only once each node sees the other up: at write-consistency
        # `one` a copy hinted to a replica held down is not applied yet
        # (docs/durability.md, "Write-path consistency"), so that replica's
        # first read could be stale. A peer is up while its breaker is
        # closed or was never opened; "up" must hold for longer than one
        # member-probe round (2 s), so that a probe made before the second
        # node listened cannot still hold it down.
        deadline, up_since = time.monotonic() + 60, None
        while True:
            up = all(peer_state(a, b) in (None, "closed")
                     for a, b in ((ports[0], ports[1]), (ports[1], ports[0])))
            now = time.monotonic()
            up_since = (up_since or now) if up else None
            if up_since is not None and now - up_since >= 2.5:
                break
            assert now < deadline, "the nodes never saw each other up"
            time.sleep(0.1)
        assert post(ports[0], "/index/i", "{}")[0] == 200
        assert post(ports[0], "/index/i/field/f", "{}")[0] == 200
        cols = [1, SHARD_WIDTH + 2, 2 * SHARD_WIDTH + 3, 5 * SHARD_WIDTH + 4]
        pql = " ".join(f"Set({c}, f=3)" for c in cols)
        assert post(ports[0], "/index/i/query", pql)[0] == 200
        for p in ports:
            assert post(p, "/index/i/query", "Count(Row(f=3))") == (200, {"results": [4]})
            status, got = post(p, "/index/i/query", "Row(f=3)")
            assert status == 200 and got["results"][0]["columns"] == cols
            status, got = post(p, "/index/i/query?remote=true",
                               '{"query": "Count(Row(f=3))", "shards": [0, 1, 2, 5]}')
            assert status == 200 and got["results"][0]["value"] == 4, got
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)


def _collective_pod(h):
    """A one-process, one-node collective backend over `h`
    (`[collective] single-process`): the barrier is a no-op and the
    reduce is the rank's own result."""
    from types import SimpleNamespace

    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.logger import NopLogger
    from pilosa_tpu_torch.parallel import CollectiveConfig
    from pilosa_tpu_torch.parallel.collective import CollectiveBackend

    node = Node(id="n0", process_idx=0)
    server = SimpleNamespace(holder=h, logger=NopLogger(), client=None,
                             cluster=Cluster(node=node, nodes=[node], replica_n=1))
    return CollectiveBackend(server, CollectiveConfig(single_process=1)), server


def test_collective_plane_on_card_matches_cpu(cuda_device):
    """The collective plane's three programs on the card (K1, K2, K3 over
    the rank's block) equal the same backend on a CPU holder of the same
    planes, launch the kernels and never a twin; a planted launch error
    inside an entry raises DeviceKernelFault out of Executor.execute."""
    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.parallel.device_health import DeviceKernelFault
    from pilosa_tpu_torch.pql.parser import parse

    pods = []
    for device in ("cuda", "cpu"):
        h = pilosa_tpu_torch.Holder(None, device=device)
        h.open()
        idx = h.create_index("i")
        fld = idx.create_field("f")
        v = idx.create_field("v", FieldOptions(type="int", min=-5, max=900))
        r = np.random.default_rng(417)
        for row in range(4):
            cols = r.choice(3 * SHARD_WIDTH, 5000, replace=False)
            fld.import_bits([row] * len(cols), [int(c) for c in cols])
        for col, val in zip(r.choice(3 * SHARD_WIDTH, 800, replace=False),
                            r.integers(-5, 900, 800)):
            v.set_value(int(col), int(val))
        pods.append((h, *_collective_pod(h)))
    depth = pods[0][0].field("i", "v").bsi_group("v").bit_depth()

    def call(q):
        return parse(q).calls[0].children[0]

    batch = [f"Count(Difference(Row(f={a}), Range(v != 7)))" for a in (0, 1, 3)]
    answers = []
    for h, backend, _ in pods:
        before = dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)
        got = [backend.count_batch("i", [call(q) for q in batch]),
               backend.topn_counts("i", "f", [3, 0, 2], call("Count(Row(f=1))")).tolist()]
        for kind in ("sum", "min", "max"):
            for flt in (None, call("Count(Row(f=2))")):
                out = backend.bsi_val_count("i", "v", kind, depth, flt)
                got.append(out.tolist() if kind == "sum" else (out[0].tolist(), out[1]))
        answers.append(got)
        if h.device.type == "cuda":
            torch.cuda.synchronize()
            for k in ("gather_expr_count", "masked_plane_counts", "bsi_minmax"):
                assert kernels.LAUNCHES[k] > before[0][k], k
                assert kernels.PLAIN_CALLS[k] == before[1][k], k
    assert answers[0] == answers[1]

    h, backend, server = pods[0]
    ex = pilosa_tpu_torch.Executor(h, cluster=server.cluster)
    ex.collective = backend
    server.executor = ex

    def planted(name, err):
        raise RuntimeError(f"{name} kernel launch failed: cudaError 700")

    mp = pytest.MonkeyPatch()
    mp.setattr(kernels, "_check_launch", planted)
    try:
        with pytest.raises(DeviceKernelFault) as fe:
            ex.execute("i", "Count(Intersect(Row(f=0), Row(f=1)))")
        assert fe.value.kind == "runtime"
        assert backend.fallbacks == {}
    finally:
        mp.undo()
        ex.close()
        for h, backend, _ in pods:
            backend.close()
            h.close()


def test_point_in_time_planes_on_card_count_through_k2(cuda_device, tmp_path):
    """A point-in-time read on a CUDA server: the historical fragments
    are built on the card, a PIT Count counts their planes through K2
    (equal to its twin), the live engine launches no K1 for it, and the
    answers equal a replay of the writes up to each position."""
    from pilosa_tpu_torch.cdc import CdcConfig
    from pilosa_tpu_torch.ops import bitplane as bp
    from pilosa_tpu_torch.server.server import Server

    s = Server(data_dir=str(tmp_path / "pit"), cache_flush_interval=0,
               cdc_config=CdcConfig(enabled=True, standing_interval=0))
    s.holder.open()
    try:
        s.api.create_index("i")
        s.api.create_field("i", "f")
        r = np.random.default_rng(17)
        state = {1: set(), 2: set()}
        checkpoints = {}
        for k in range(200):
            row, col = int(r.integers(1, 3)), int(r.integers(0, 3 * SHARD_WIDTH))
            if k % 5 == 4 and state[row]:
                col = sorted(state[row])[0]
                s.api.query("i", f"Clear({col}, f={row})")
                state[row].discard(col)
            else:
                s.api.query("i", f"Set({col}, f={row})")
                state[row].add(col)
            if k % 50 == 49:
                checkpoints[s.cdc.log("i").last_pos] = (set(state[1]), set(state[2]))
        s.api.query("i", "Count(Row(f=1))")  # the live engine is built
        torch.cuda.synchronize()
        kernels.reset_counters()
        launches = dict(kernels.LAUNCHES)
        for pos, (one, two) in checkpoints.items():
            got = s.api.query("i", "Count(Intersect(Row(f=1), Row(f=2)))",
                              at_position=pos)
            assert got == [len(one & two)]
            assert s.api.query("i", "Count(Row(f=1))", at_position=pos) == [len(one)]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["masked_plane_counts"] > launches["masked_plane_counts"]
        assert kernels.LAUNCHES["gather_expr_count"] == launches["gather_expr_count"]
        assert not any(kernels.PLAIN_CALLS.values())
        pos = max(checkpoints)
        hist = s.cdc.historical_fragment("i", "f", "standard", 0, pos)
        plane = hist.plane(1)
        assert plane.is_cuda
        stack = plane.reshape(1, 1, -1)
        assert torch.equal(kernels.masked_plane_counts(stack, None),
                           kernels.masked_plane_counts_plain(stack, None))
        assert int(bp.popcount(plane)) == len([c for c in checkpoints[pos][0]
                                               if c < SHARD_WIDTH])
    finally:
        s.cdc.close()
        s.holder.close()


def test_count_after_migrate_install_on_card(cuda_device):
    """A fragment replaced wholesale by a migration image (and then by
    catch-up ops) on a CUDA holder: the next Count regathers and launches
    K1 over the new planes, never a delta of the old ones, and equals
    numpy."""
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.storage.bitmap import encode_op, OP_ADD

    h = pilosa_tpu_torch.Holder(None)
    h.open()
    ex = pilosa_tpu_torch.Executor(h)
    try:
        fld = h.create_index("i").create_field("f")
        r = np.random.default_rng(23)
        cols = {row: set(int(c) for c in r.choice(2 * SHARD_WIDTH, 500, replace=False))
                for row in (1, 2)}
        for row, cs in cols.items():
            fld.import_bits([row] * len(cs), sorted(cs))
        q = "Count(Intersect(Row(f=1), Row(f=2)))"
        assert ex.execute("i", q) == [len(cols[1] & cols[2])]
        # The image another node would ship: shard 0 with other bits.
        src = Fragment(None, "i", "f", "standard", 0)
        src.open()
        new0 = {row: set(int(c) for c in r.choice(SHARD_WIDTH, 400, replace=False))
                for row in (1, 2)}
        for row, cs in new0.items():
            for c in cs:
                src.set_bit(row, c)
        frag = h.fragment("i", "f", "standard", 0)
        frag.migrate_install(src.storage.to_bytes())
        extra = int(r.integers(0, SHARD_WIDTH))
        frag.migrate_apply_ops(encode_op(OP_ADD, 1 * SHARD_WIDTH + extra)
                               + encode_op(OP_ADD, 2 * SHARD_WIDTH + extra))
        frag.migrate_seal()
        for row in (1, 2):
            cols[row] = {c for c in cols[row] if c >= SHARD_WIDTH} | new0[row] | {extra}
        kernels.reset_counters()
        eng = ex.engine
        before = eng.snapshot()
        assert ex.execute("i", q) == [len(cols[1] & cols[2])]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gather_expr_count"] >= 1
        assert not any(kernels.PLAIN_CALLS.values())
        after = eng.snapshot()
        assert after["memo_hits"] == before["memo_hits"]
        assert after["full_refresh_bytes"] > before["full_refresh_bytes"]
    finally:
        ex.close()
        h.close()


# ------------------------------------------- one node over several partitions


def _partition_reads(eng, shards):
    """Every engine entry point of the read path over the planted holder:
    Counts (single, async, batched with a duplicate), a bitmap and a
    batch of them, TopN with and without a filter, Sum/Min/Max with and
    without one."""
    from pilosa_tpu_torch.pql.parser import parse

    def call(q):
        return parse(q).calls[0]

    pairs = [(0, 1), (2, 3), (0, 1), (4, 5)]
    batch = [call(f"Intersect(Row(f={a}), Row(f={b}))") for a, b in pairs]
    flt = call("Row(f=2)")
    depth = eng.holder.index("i").field("v").bsi_group("v").bit_depth()
    with eng.memos_off():
        out = {
            "count": eng.count("i", batch[0], shards),
            "async": int(eng.count_async("i", batch[1], shards)),
            "batch": eng.count_batch("i", batch, shards).tolist(),
            "bitmap": eng.bitmap("i", call("Union(Row(f=1), Row(f=3))"),
                                 shards).columns().tolist(),
            "bitmap_batch": [r.columns().tolist()
                             for r in eng.bitmap_batch("i", batch[:2], shards)],
            "topn": eng.topn_counts("i", "f", list(range(6)), shards).tolist(),
            "topn_f": eng.topn_counts("i", "f", list(range(6)), shards, flt).tolist(),
            "shard_counts": [None if a is None else a.tolist() for a in eng.topn_shard_counts(
                "i", "f", [5, 0, 3], shards, flt)],
        }
        for kind in ("sum", "min", "max"):
            for f in (None, flt):
                got = eng.bsi_val_count("i", "v", kind, depth, shards, f)
                out[(kind, f is None)] = (got.tolist() if kind == "sum"
                                          else (got[0].tolist(), got[1]))
    return out


def _partition_holder():
    """_planted_card_holder's field f over 5 shards (not a multiple of 4)
    and an int field v whose maximum sits in shards 0 and 4 (a tie across
    partitions)."""
    from pilosa_tpu_torch.core.field import FieldOptions

    h, _ = _planted_card_holder(n_rows=6, n_shards=5)
    v = h.index("i").create_field("v", FieldOptions(type="int", min=0, max=1000))
    rng = np.random.default_rng(4)
    cols = np.unique(rng.integers(0, 5 * SHARD_WIDTH, 3000))
    vals = rng.integers(0, 900, len(cols))
    cols = np.concatenate([cols, [7, 4 * SHARD_WIDTH + 9]])
    vals = np.concatenate([vals, [1000, 1000]])
    v.import_value(cols.tolist(), vals.tolist())
    return h


def _launches(fn):
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    return {k: kernels.LAUNCHES[k] - before[k] for k in before}


@pytest.mark.parametrize("placement", ["one_card", "per_card"])
def test_partitioned_engine_on_card_equals_one_partition(cuda_device, placement):
    """An engine of 4 partitions on the card (all on cuda:0, or one per
    card where the host has several) answers every entry point as the
    one-partition engine does; K1, K2 and K3 launch once per partition
    per device call, each block on its partition's device; a Set
    refreshes only the written shard's block."""
    from pilosa_tpu_torch.parallel.engine import Leaf, ShardedQueryEngine
    from pilosa_tpu_torch.parallel.mesh import engine_mesh
    from pilosa_tpu_torch.pql.parser import parse

    n_cards = torch.cuda.device_count()
    if placement == "per_card" and n_cards < 2:
        pytest.skip("needs two or more cards")
    mesh = (["cuda:0"] * 4 if placement == "one_card"
            else engine_mesh(4, "cuda"))
    h = _partition_holder()
    shards = tuple(range(5))
    one = ShardedQueryEngine(h, mesh=["cuda:0"])
    four = ShardedQueryEngine(h, mesh=mesh)
    try:
        assert _partition_reads(four, shards) == _partition_reads(one, shards)
        stack = four._stacked_leaf_tensor("i", [Leaf("f", "standard", r) for r in range(6)],
                                          shards)
        assert [b.device for b in stack] == four.mesh == [torch.device(d) for d in mesh]
        assert all(b.shape == (6, 2, stack[0].shape[2]) for b in stack)
        call = parse("Intersect(Row(f=0), Row(f=1))").calls[0]
        depth = h.index("i").field("v").bsi_group("v").bit_depth()
        with four.memos_off():
            n1 = _launches(lambda: four.count("i", call, shards))
            n2 = _launches(lambda: four.count_batch("i", [call, call], shards))
            n3 = _launches(lambda: four.topn_counts("i", "f", [0, 1, 2], shards))
            n4 = _launches(lambda: four.bsi_val_count("i", "v", "max", depth, shards))
        assert n1["gather_expr_count"] == n2["gather_expr_count"] == 4, (n1, n2)
        assert n3["masked_plane_counts"] == 4 and n4["bsi_minmax"] == 4, (n3, n4)
        before = four._stacked_leaf_tensor("i", [Leaf("f", "standard", r) for r in range(6)],
                                           shards)
        base = four.snapshot()
        plane = h.fragment("i", "f", "standard", 3).plane_np(1)
        col = int(np.flatnonzero(np.unpackbits(plane.view(np.uint8), bitorder="little") == 0)[0])
        assert h.index("i").field("f").set_bit(1, 3 * SHARD_WIDTH + col)
        after = four._stacked_leaf_tensor("i", [Leaf("f", "standard", r) for r in range(6)],
                                          shards)
        assert [p for p in range(4) if after[p] is not before[p]] == [1]
        assert four.snapshot()["full_refresh_bytes"] == base["full_refresh_bytes"]
        assert four.count("i", call, shards) == one.count("i", call, shards)
    finally:
        four.close()
        one.close()
        h.close()


def test_kernels_launch_on_a_second_card(cuda_device):
    """K1 (both variants), K2 and K3 on tensors of cuda:1 while cuda:0 is
    the current device: each wrapper makes the tensor's device current for
    its launch, and the answers equal the twins."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(9)
    stacked = rand_stack(rng, (6, 4, 1024), dev)
    idxs = torch.tensor([[0, 2, 4], [1, 3, 5]], dtype=torch.int32)
    tape = lower_tape(("Intersect", (leaf(0), leaf(1))))
    with torch.cuda.device(0):
        for variant in VARIANTS:
            got = kernels.gather_expr_count(stacked, idxs, tape, variant=variant)
            assert got.device == dev
            assert torch.equal(got, kernels.gather_expr_count_plain(stacked, idxs, tape))
        mask = stacked[0]
        assert torch.equal(kernels.masked_plane_counts(stacked, mask),
                           kernels.masked_plane_counts_plain(stacked, mask))
        bits, count = kernels.bsi_minmax(stacked, mask, True)
        pbits, pcount = kernels.bsi_minmax_plain(stacked, mask, True)
        assert torch.equal(bits, pbits) and int(count) == int(pcount)


@pytest.mark.parametrize("variant", VARIANTS)
def test_k1_blocks_stage_once_per_device(cuda_device, variant):
    """gather_expr_count_blocks over 4 blocks on the card copies its one
    staging buffer once per distinct device per call (once here; once per
    card where the blocks spread over several), launches K1 once per
    block, and each block's counts equal the twin; an engine of 4
    partitions on cuda:0 stages once per Count and answers as one
    partition does."""
    from pilosa_tpu_torch.parallel.engine import ShardedQueryEngine
    from pilosa_tpu_torch.pql.parser import parse

    rng = np.random.default_rng(12)
    devs = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(4)]
    blocks = [rand_stack(rng, (6, 2, 1024), d) for d in devs]
    idxs = torch.from_numpy(rng.integers(0, 6, size=(2, 40)).astype(np.int32))
    tape = lower_tape(("Intersect", (leaf(0), leaf(1))))
    torch.cuda.synchronize()
    staged, launches = dict(kernels.STAGED), dict(kernels.LAUNCHES)
    got = kernels.gather_expr_count_blocks(blocks, idxs, tape, variant=variant)
    torch.cuda.synchronize()
    assert kernels.STAGED["gather_expr_count"] - staged["gather_expr_count"] == len(set(devs))
    assert kernels.LAUNCHES[f"gather_expr_count_{variant}"] \
        - launches[f"gather_expr_count_{variant}"] == 4
    for block, part in zip(blocks, got):
        assert part.device == block.device
        assert torch.equal(part.cpu(), kernels.gather_expr_count_plain(block.cpu(), idxs, tape))

    h = _partition_holder()
    shards = tuple(range(5))
    one = ShardedQueryEngine(h, mesh=["cuda:0"])
    four = ShardedQueryEngine(h, mesh=["cuda:0"] * 4)
    try:
        call = parse("Intersect(Row(f=0), Row(f=1))").calls[0]
        with four.memos_off(), one.memos_off():
            want = one.count("i", call, shards)
            four.count("i", call, shards)  # leaves resident
            torch.cuda.synchronize()
            staged = kernels.STAGED["gather_expr_count"]
            n = _launches(lambda: four.count("i", call, shards))
            assert four.count("i", call, shards) == want
        assert n["gather_expr_count"] == 4
        assert kernels.STAGED["gather_expr_count"] - staged == 2  # two Counts, one copy each
    finally:
        four.close()
        one.close()
        h.close()


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _NeverDone:
    """A reduce's work that never completes, as a peer that never comes
    leaves it."""

    def __init__(self, work):
        self.work = work

    def is_completed(self):
        return False

    def wait(self, *a):
        raise AssertionError("waited on a reduce that never completes")


def test_a_one_rank_nccl_reduce_group_fails_and_re_forms(cuda_device):
    """The port's ReduceGroup on NCCL, world 1, on a store of its own:
    the payload is reduced and gathered on the card; a reduce that never
    completes times out, aborts the communicator and raises ReduceFailed
    (the process lives on); the group of generation 1 forms and reduces."""
    from pilosa_tpu_torch.parallel import distributed as dist

    store = torch.distributed.TCPStore("localhost", _free_port(), 1, True)
    dev = torch.device("cuda", 0)
    group = dist.ReduceGroup(store, "nccl", 0, 1, dev, timeout_ms=500)
    payload = torch.arange(257, dtype=torch.int64, device=dev)
    got = group.all_reduce_sum(payload.clone())
    assert got.device == dev and torch.equal(got, payload)
    rows = group.all_gather(payload)
    assert rows.device == dev and torch.equal(rows, payload[None])
    real = group._complete
    group._complete = lambda work, timeout_ms=None: real(_NeverDone(work), timeout_ms)
    with pytest.raises(dist.ReduceFailed, match="did not complete within 500 ms"):
        group.all_reduce_sum(payload.clone())
    assert group.failed is not None
    again = group.reform(1)
    assert again.generation == 1 and again.backend == "nccl"
    assert torch.equal(again.all_reduce_sum(payload.clone()), payload)
    again.abort()


NCCL_JOB = r"""
import sys, time
import torch

coordinator, rank = sys.argv[1], int(sys.argv[2])
from pilosa_tpu_torch.parallel import distributed as dist

dev = torch.device("cuda", rank)
assert dist.initialize(coordinator, 2, rank, timeout_ms=2000, reduce_device=dev)
assert dist.reduce_backend() == "nccl" and dist.group_error() is None, dist.group_error()
x = torch.full((257,), rank + 1, dtype=torch.int64, device=dev)
got = dist.all_reduce_sum(x.clone())
assert got.device == dev and got.tolist() == [3] * 257
rows = dist.all_gather(x[:4].clone())
assert rows.device == dev and rows.tolist() == [[1] * 4, [2] * 4]
t_arrive = time.monotonic()  # where the plane's barrier would be
if rank == 1:
    time.sleep(3.0)  # past the group's timeout: rank 0's reduce fails
try:
    dist.all_reduce_sum(x.clone())
    # The late rank's reduce may complete against rank 0's aborted
    # communicator; the plane discards it (check_late), as here.
    dist.check_late(time.monotonic() - t_arrive)
    raise AssertionError(f"rank {rank} kept a reduce its peer gave up on")
except dist.ReduceFailed as e:
    failed_s = time.monotonic() - t_arrive
store = dist.connect_store()
deadline = time.monotonic() + 10
while store.get(dist.GENERATION_KEY) != b"1":  # rank 0 advanced it
    assert time.monotonic() < deadline
    time.sleep(0.05)
dist.regroup(1)
assert dist.group_generation() == 1
assert dist.all_reduce_sum(x.clone()).tolist() == [3] * 257
dist.shutdown()
print(f"NCCL_OK rank={rank} failed_after={failed_s:.2f}")
"""


def test_a_two_rank_nccl_job_reduces_fails_and_re_forms(cuda_device, tmp_path):
    """Two ranks, one card each: the rule picks NCCL; the reduce and the
    gather run on the cards; rank 1 stalls one reduce past the timeout:
    rank 0's reduce fails without ending the process, rank 1's late one
    fails or is discarded, and both re-form at generation 1 and reduce
    again."""
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    path = tmp_path / "nccl_job.py"
    path.write_text(NCCL_JOB)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    coordinator = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(path), coordinator, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for rc, out, err in outs:
        assert rc == 0 and "NCCL_OK" in out, f"rc={rc}\n{out}\n{err[-3000:]}"
