"""pilosa_tpu_torch on a CUDA card: the kernels against their plain twins,
and the executor on the card against the same executor on the CPU.

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


# ------------------------------------------------ K1 BSI codes, K3


def bsi_ir(op, depth, *pred):
    idxs = tuple(range(depth + 1))
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
        old = eng._stacked_leaf_tensor("i", leaves, shards)
        assert old.is_cuda
        kept = old.clone()
        base = eng.snapshot()
        assert fld.set_bit(2, SHARD_WIDTH + 12345)
        plane = h.fragment("i", "f", "standard", 2).plane_np(4)
        first = int(np.flatnonzero(np.unpackbits(plane.view(np.uint8),
                                                 bitorder="little"))[0])
        assert fld.clear_bit(4, 2 * SHARD_WIDTH + first)
        new = eng._stacked_leaf_tensor("i", leaves, shards)
        snap = eng.snapshot()
        assert snap["stack_delta_hits"] == base["stack_delta_hits"] + 1
        assert snap["full_refresh_bytes"] == base["full_refresh_bytes"]
        assert 0 < snap["delta_bytes"] - base["delta_bytes"] <= 1024
        # Functional: a reader holding the old tensor still reads it.
        assert torch.equal(old, kept) and not torch.equal(old, new)
        fresh = ShardedQueryEngine(h)
        rebuilt = fresh._stacked_leaf_tensor("i", leaves, shards)
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
