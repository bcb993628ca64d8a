"""The cases of tests/test_btree_containers.py, run against the port on the CPU.

B+tree container store tests: mapping semantics vs a dict oracle, and
the full Bitmap test surface running on the B-tree backend (model:
reference enterprise/ btree tests + containers_test.go)."""

import random

import numpy as np
import pytest

from pilosa_tpu_torch.storage import bitmap as bm
from pilosa_tpu_torch.storage.btree_containers import BTreeContainers


def test_btree_vs_dict_oracle():
    rng = random.Random(3)
    tree = BTreeContainers()
    oracle = {}
    for step in range(20000):
        key = rng.randrange(0, 2000)
        op = rng.random()
        if op < 0.6:
            tree[key] = key * 2
            oracle[key] = key * 2
        elif op < 0.8 and oracle:
            k = rng.choice(list(oracle))
            del tree[k]
            del oracle[k]
        else:
            assert (key in tree) == (key in oracle)
            if key in oracle:
                assert tree[key] == oracle[key]
    assert len(tree) == len(oracle)
    assert list(tree) == sorted(oracle)  # in-order iteration
    assert dict(tree.items()) == oracle


def test_btree_ordered_iteration_large():
    tree = BTreeContainers()
    keys = list(range(0, 100000, 7))
    random.Random(1).shuffle(keys)
    for k in keys:
        tree[k] = k
    assert list(tree) == sorted(keys)
    assert tree.last() == (sorted(keys)[-1], sorted(keys)[-1])
    from_5000 = list(tree.iterate_from(5000))
    assert from_5000[0][0] >= 5000


def test_btree_get_missing():
    tree = BTreeContainers()
    tree[5] = "x"
    with pytest.raises(KeyError):
        tree[6]
    with pytest.raises(KeyError):
        del tree[6]
    assert tree.get(6) is None
    assert tree.pop(5) == "x"
    assert len(tree) == 0


@pytest.fixture
def btree_backend():
    bm.set_container_factory(BTreeContainers)
    yield
    bm.set_container_factory(dict)


def test_bitmap_on_btree_backend(btree_backend):
    rng = random.Random(9)
    vals = sorted(rng.sample(range(1 << 22), 5000))
    b = bm.Bitmap(vals)
    assert isinstance(b.containers.store, BTreeContainers)
    assert list(b.slice()) == vals
    # Serialization round-trip through the B-tree backend.
    b2 = bm.Bitmap.from_bytes(b.to_bytes())
    assert b == b2
    # Set algebra.
    other = bm.Bitmap(vals[::2])
    assert b.intersection_count(other) == len(vals[::2])
    assert set(b.difference(other).slice().tolist()) == set(vals[1::2])
    # Mutation + clone keeps the backend.
    c = b.clone()
    assert isinstance(c.containers.store, BTreeContainers)
    assert c.remove(vals[0])
    assert not c.contains(vals[0])
    assert b.contains(vals[0])


def test_fragment_on_btree_backend(btree_backend, tmp_path):
    from pilosa_tpu_torch.core.fragment import Fragment

    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0)
    f.open()
    f.set_bit(1, 10)
    f.set_bit(1, 20)
    f.set_bit(2, 10)
    assert list(f.row(1).columns()) == [10, 20]
    f.close()
    f2 = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 0)
    f2.open()
    assert list(f2.row(1).columns()) == [10, 20]
    f2.close()
