"""Shard partitions of one node's engine over its local devices.

The counterpart of pilosa_tpu/parallel/mesh.py. The reference lays the
shards of a node out along a 1-D 'shards' mesh axis and runs its kernel
once per device under shard_map, with one psum to reduce the counts. Here
a mesh is a list of torch devices, one per partition: the engine holds
every (S_padded, W) leaf plane as one contiguous (S_padded / N, W) block
per partition, launches each kernel once per partition, and reduces the
partial results itself (parallel/engine.py).

A list may name a device more than once: N partitions on one card (or on
the CPU) are the port's counterpart of the reference's virtual CPU
devices, which torch does not have. `engine_mesh(n)` places N partitions
round-robin over the local devices, so on a host with at least N cards
it is the reference's placement and on one card it is N partitions there;
a process given one card by name ("cuda:r") keeps all N on it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

SHARD_AXIS = "shards"


def local_devices(device=None) -> List[torch.device]:
    """This process's devices of `device`'s kind: every card for "cuda",
    the one card a device such as "cuda:2" names (a process given a card
    keeps its partitions there: a rank of a collective job on a host of
    several cards must not spread over the other ranks' cards), or the
    CPU alone."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda":
        return [torch.device(dev.type)]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run the engine on the CPU")
    if dev.index is not None:
        if dev.index >= n:
            raise RuntimeError(f"device {dev} requested; the host has {n} cards")
        return [dev]
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(devices: Optional[Sequence] = None,
                 device=None) -> List[torch.device]:
    """One partition per device of `devices`, or, when none are named, per
    local device of `device`'s kind (every card by default; the CPU once
    with device="cpu"). Local, not global: the per-node engine is entered
    by this process alone (see the reference's default_mesh)."""
    if devices is None:
        return local_devices(device)
    return [torch.device(d) for d in devices]


def engine_mesh(mesh_devices: int, device=None) -> List[torch.device]:
    """The partitions of `[engine] mesh-devices`: 0 gives one per local
    device of `device`'s kind, N > 0 gives N placed round-robin over them
    (partition p on local device p mod count)."""
    local = local_devices(device)
    n = int(mesh_devices)
    if n < 0:
        raise ValueError(f"engine mesh-devices must be >= 0, got {n}")
    if n == 0:
        return local
    return [local[p % len(local)] for p in range(n)]


def pad_shards(n_shards: int, n_devices: int) -> int:
    """Number of shard slots after padding to a partition multiple."""
    if n_shards % n_devices == 0:
        return n_shards
    return ((n_shards // n_devices) + 1) * n_devices


def device_for_shard(shard_index: int, n_shards_padded: int, n_devices: int) -> int:
    """Block placement: contiguous runs of shards per partition."""
    per = n_shards_padded // n_devices
    return shard_index // per
