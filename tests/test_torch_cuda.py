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


def random_ir(rng, n_leaves: int, depth: int):
    """A random canonical set-op IR tree over slots < n_leaves."""
    if depth == 0 or rng.random() < 0.3:
        return ("leaf", int(rng.integers(n_leaves)))
    kind = rng.choice(["Intersect", "Union", "Xor", "Difference"])
    if kind == "Difference":
        head = random_ir(rng, n_leaves, depth - 1)
        tails = tuple(random_ir(rng, n_leaves, depth - 1)
                      for _ in range(int(rng.integers(0, 3))))
        return ("Difference", head, tails)
    kids = tuple(random_ir(rng, n_leaves, depth - 1)
                 for _ in range(int(rng.integers(2, 4))))
    return (str(kind), kids)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("ir_seed", [0, 1, 2, 3])
def test_k1_kernel_matches_twin_on_card(cuda_device, ir_seed):
    rng = np.random.default_rng(200 + ir_seed)
    u, s, w, q = 12, 5, 1024, 9
    ir = random_ir(rng, 4, depth=3)
    tape = lower_tape(ir)
    stacked = t32(rng.integers(0, 1 << 32, (u, s, w), dtype=np.uint32)).to(cuda_device)
    idxs = torch.from_numpy(rng.integers(0, u, (4, q)).astype(np.int32))
    launched = kernels.LAUNCHES["gather_expr_count"]
    got = kernels.gather_expr_count(stacked, idxs, tape)
    want = kernels.gather_expr_count_plain(stacked, idxs, tape)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["gather_expr_count"] == launched + 1


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
