"""The yardstick of the kernels: the bytes each launch has to move, counted
as the port's kernel table counts them (each input plane read once, each
output written once), and the card's published peak.

K1 `gather_expr_count_blocks`: each block (U, S, W) int32 is read once
for every distinct slot the launch names: distinct slots x S x W x 4
bytes (the serving shape, 126 slots x 256 x 32768 x 4 = 4.228 GB).
K2 `masked_plane_counts`: the stack (R, S, W) and the mask (S, W) read
once, the (R, S) int32 counts written: (R + 1) x S x W x 4 + R x S x 4
(a TopN chunk of 64 rows over 256 shards, 2.18 GB).
K3 `bsi_minmax`: the (D + 1, S, W) planes and the mask read once:
(D + 2) x S x W x 4 (depth 17 over 256 shards, 637.5 MB)."""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3): 3.35 TB/s at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(distinct_slots: int, shards: int, words: int) -> int:
    return distinct_slots * shards * words * 4


def k2_bytes(rows: int, shards: int, words: int, masked: bool) -> int:
    return (rows + int(masked)) * shards * words * 4 + rows * shards * 4


def k3_bytes(depth: int, shards: int, words: int, masked: bool) -> int:
    return (depth + 1 + int(masked)) * shards * words * 4


def roofline_pct(nbytes: float, device_s: float):
    """100 x the least time the bytes need at the peak over the time the
    kernels took; None where no kernel time was measured."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
