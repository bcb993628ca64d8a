"""The port's TranslateStore (a copy of pilosa_tpu/translate.py) against
the JAX package's: a `keys/` directory written by either package opens in
the other with the same ids, and the replication log (read_from /
apply_log) is byte-compatible both ways."""

import numpy as np
import pytest

from pilosa_tpu.translate import TranslateStore as JStore
from pilosa_tpu_torch.translate import TranslateStore as TStore


def keys(seed, n):
    rng = np.random.default_rng(seed)
    return [f"u{int(x)}" for x in rng.permutation(10 * n)[:n]]


@pytest.mark.parametrize("writer, reader", [(JStore, TStore), (TStore, JStore)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_keys_directory_opens_in_the_other_package(tmp_path, writer, reader):
    cols, rows = keys(1, 300), keys(2, 40)
    w = writer(str(tmp_path / "keys")).open()
    col_ids = w.translate_columns_to_uint64("i", cols)
    row_ids = w.translate_rows_to_uint64("i", "f", rows)
    other_ids = w.translate_rows_to_uint64("i", "g", rows[:5])
    w.close()
    r = reader(str(tmp_path / "keys")).open()
    try:
        assert r.translate_columns_to_uint64("i", cols) == col_ids
        assert r.translate_rows_to_uint64("i", "f", rows) == row_ids
        assert r.translate_rows_to_uint64("i", "g", rows[:5]) == other_ids
        assert r.translate_columns_to_string("i", col_ids) == cols
        assert r.translate_rows_to_string("i", "f", row_ids) == rows
        # New keys continue the same id sequence in both packages.
        w2 = writer(str(tmp_path / "keys")).open()
        try:
            assert (r.translate_columns_to_uint64("i", ["new-key"])
                    == w2.translate_columns_to_uint64("i", ["new-key"]))
        finally:
            w2.close()
    finally:
        r.close()


def test_same_keys_same_ids_and_bytes(tmp_path):
    """The same key sequence gives the same ids and the same log bytes."""
    stores = [cls(str(tmp_path / name)).open() for cls, name in ((JStore, "j"), (TStore, "t"))]
    try:
        ids = []
        for st in stores:
            a = st.translate_columns_to_uint64("i", keys(3, 200))
            b = st.translate_rows_to_uint64("i", "f", keys(4, 30))
            c = st.translate_columns_to_uint64("other", keys(5, 10))
            ids.append((a, b, c))
        assert ids[0] == ids[1]
        assert stores[0].size() == stores[1].size()
        assert stores[0].read_from(0) == stores[1].read_from(0)
    finally:
        for st in stores:
            st.close()


@pytest.mark.parametrize("src, dst", [(JStore, TStore), (TStore, JStore)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_replication_log_applies_across_packages(tmp_path, src, dst):
    a = src(str(tmp_path / "a")).open()
    b = dst(str(tmp_path / "b"), read_only=True).open()
    try:
        ids = a.translate_columns_to_uint64("i", keys(6, 50))
        b.apply_log(a.read_from(0))
        assert b.translate_columns_to_string("i", ids) == keys(6, 50)
    finally:
        a.close()
        b.close()


def test_in_memory_store_matches():
    j, t = JStore(None).open(), TStore(None).open()
    try:
        ks = keys(7, 100)
        assert j.translate_columns_to_uint64("i", ks) == t.translate_columns_to_uint64("i", ks)
        assert (j.translate_rows_to_uint64("i", "f", ks[:9])
                == t.translate_rows_to_uint64("i", "f", ks[:9]))
    finally:
        j.close()
        t.close()
