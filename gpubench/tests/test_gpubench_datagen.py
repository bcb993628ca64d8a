"""The seeded generators repeat exactly, and the holder gets the
containers roaring would choose."""

import numpy as np
import pytest
import torch

from gpubench import datagen, load, spec


def _cfg(name, columns):
    cfg = spec.config(name)
    cfg["columns_total"] = columns
    return cfg


@pytest.mark.parametrize("name", ["taxi-1b"])
def test_the_same_seed_makes_the_same_columns_and_another_seed_others(name):
    n = (2 << 20) + 12345
    a = datagen.Columns(_cfg(name, n), 2 ** 31 + 5, "cpu", shards_per_block=2)
    b = datagen.Columns(_cfg(name, n), 2 ** 31 + 5, "cpu", shards_per_block=2)
    c = datagen.Columns(_cfg(name, n), 2 ** 31 + 6, "cpu", shards_per_block=2)
    for (s0, nb, na, ca), (_, _, nbb, cb), (_, _, _, cc) in zip(
            a.iter_blocks(), b.iter_blocks(), c.iter_blocks()):
        assert na == nbb == min(n, (s0 + nb) << 20) - (s0 << 20)
        for f in ca:
            assert torch.equal(ca[f], cb[f]), f
        assert any(not torch.equal(ca[f], cc[f]) for f in ca)


def test_the_taxi_skews_are_the_configured_ones():
    cols = datagen.Columns(_cfg("taxi-1b", 4 << 20), 1, "cpu", shards_per_block=4)
    _, _, n, c = next(cols.iter_blocks())
    pc = np.bincount(c["passenger_count"].numpy(), minlength=10) / n
    assert abs(pc[1] - 0.70) < 0.002 and abs(pc[2] - 0.14) < 0.002
    assert abs(float(c["dist_miles"].double().mean()) - 2.9) < 0.02
    # Green cabs only from 2013: none before, 11.6% of 2015's rides.
    green = c["cab_type"] == 1
    assert not bool((green & (c["pickup_year"] < 2013)).any())
    in_2015 = c["pickup_year"] == 2015
    assert abs(float(green[in_2015].double().mean()) - 0.116) < 0.005
    # Only the loaded fields' history is made; the others are declared.
    assert set(c) == set(cols.loaded) and len(cols.fields) == 18
    ta = c["total_amount"]
    assert int(ta.min()) >= 0 and int(ta.max()) <= 131071


def test_pack_bits_is_the_holders_little_endian_layout():
    mask = torch.zeros(128, dtype=torch.bool)
    mask[[0, 3, 63, 64, 127]] = True
    words = load.pack_bits(mask).numpy().view(np.uint64)
    assert words.tolist() == [(1 << 0) | (1 << 3) | (1 << 63), 1 | (1 << 63)]


def test_the_loader_chooses_arrays_up_to_4096_bits_and_bitmaps_above():
    from pilosa_tpu_torch.core.holder import Holder

    cfg = _cfg("taxi-1b", (1 << 20) + 1000)
    cfg["loaded_fields"] = ["passenger_count"]
    cols = datagen.Columns(cfg, 9, "cpu", shards_per_block=2)
    h = Holder(None, device="cpu")
    h.open()
    try:
        load.Loader(h, cols).load()
        # Every declared field is in the index; only the loaded one holds bits.
        assert set(h.index("taxi").fields) >= {f["name"] for f in cols.fields}
        _, _, n, c = next(cols.iter_blocks())
        v = c["passenger_count"].numpy()
        for shard in (0, 1):
            frag = h.fragment("taxi", "passenger_count", "standard", shard)
            for row in range(10):
                lo, hi = shard << 20, min(n, (shard + 1) << 20)
                cols_of_row = np.flatnonzero(v[lo:hi] == row)
                plane = frag.plane_np(row).view(np.uint64)
                bits = np.unpackbits(plane.view(np.uint8), bitorder="little")
                assert np.array_equal(np.flatnonzero(bits), cols_of_row), (shard, row)
                for ci in range(16):
                    cont = frag.storage.containers.get(row * 16 + ci)
                    k = int(((cols_of_row >> 16) == ci).sum())
                    if k == 0:
                        assert cont is None
                    else:
                        assert cont.n == k
                        assert (cont.arr is not None) == (k <= 4096)
    finally:
        h.close()
