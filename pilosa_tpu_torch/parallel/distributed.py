"""Multi-process collective execution: a torch.distributed job over gloo.

The counterpart of pilosa_tpu/parallel/distributed.py. The reference
joins every host process to one `jax.distributed` job and reduces over a
global device mesh with XLA-inserted collectives. Here every server
process joins one `torch.distributed` process group; each rank owns one
device and the shard planes its node serves, runs the port's hand
kernels (ops/kernels.py) over its own block, and the ranks combine their
results with one host reduce.

Why gloo: every reduce of the collective plane carries at most a few
hundred int64 values (Q counts, R TopN counts, D+1 Sum planes, or one
(bits, count) per rank), so each rank copies its small result to the
host and reduces it there. NCCL would need one card per rank and refuses
two ranks on one device, which is how the plane runs on a one-card
machine. An NCCL group for ranks that each own a card is later work
(ROADMAP).

There is no counterpart of the reference's `global_mesh` or
`make_global_planes`: the process group is the mesh, and a rank's block
of shard planes is a plain (k, W) tensor on its own device.

The rendezvous is one `TCPStore` at the coordinator address (rank 0
hosts it). The process group keeps its keys under one prefix; the
collective plane's sequence counter and barriers (parallel/collective.py)
use the same store under prefixes of their own, each through a client
connection of its own (a TCPStore client serves one request at a time,
and a barrier's blocking wait would hold it).

Single-process use (tests, one-node clusters) needs no group:
initialize() returns False when there is one process or no coordinator,
and the helpers below work on the local block alone.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

import torch

from ..ops import kernels

DEFAULT_TIMEOUT_MS = 10000
BARRIER_PREFIX = "pilosa-collective/barrier"
_LOOPBACK = ("localhost", "127.0.0.1", "::1")


class BarrierAborted(RuntimeError):
    """A named barrier was decided `abort`: some rank did not arrive
    within the timeout, so no rank may enter the reduce that follows."""


class _Job:
    """The joined job: the coordinator address, this rank, the world size
    and the rendezvous store (rank 0 hosts it)."""

    def __init__(self, host: str, port: int, rank: int, world_size: int,
                 timeout_ms: int, store):
        self.host = host
        self.port = port
        self.rank = rank
        self.world_size = world_size
        self.timeout_ms = timeout_ms
        self.store = store


_job: Optional[_Job] = None
_job_lock = threading.Lock()


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    return host.strip("[]") or "localhost", int(port)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_ms: Optional[int] = None) -> bool:
    """Join (or skip joining) a multi-process torch.distributed job.

    The arguments fall back to the reference's variables,
    PILOSA_JAX_COORDINATOR (host:port), PILOSA_JAX_NUM_PROCESSES and
    PILOSA_JAX_PROCESS_ID: the names are pilosa_tpu's, kept so that one
    deployment's environment drives either package. Rank 0 hosts a
    TCPStore at the coordinator address; every rank then joins the gloo
    group on it, with `timeout_ms` (default DEFAULT_TIMEOUT_MS) as the
    group's timeout. A coordinator on a loopback host puts every rank on
    this machine, so gloo binds to `lo` unless GLOO_SOCKET_IFNAME says
    otherwise. Returns True when a multi-process group is up (also when
    this process had joined it already), False with no group when there
    is one process or no coordinator."""
    global _job
    coordinator_address = coordinator_address or os.environ.get(
        "PILOSA_JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PILOSA_JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PILOSA_JAX_PROCESS_ID", "0"))
    if not coordinator_address or num_processes <= 1:
        return False
    timeout_ms = int(timeout_ms or DEFAULT_TIMEOUT_MS)
    import torch.distributed as dist

    with _job_lock:
        if _job is not None:
            return True
        host, port = _split_address(coordinator_address)
        if host in _LOOPBACK:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        timeout = datetime.timedelta(milliseconds=timeout_ms)
        # The rendezvous waits for every rank; a slow start is not a
        # fault, so it gets at least a minute. Then the group forms with
        # the plane's timeout, every rank present.
        join = max(timeout, datetime.timedelta(seconds=60))
        store = dist.TCPStore(host, port, num_processes, process_id == 0,
                              timeout=join, wait_for_workers=False)
        store.add("pilosa-join", 1)
        deadline = time.monotonic() + join.total_seconds()
        while store.add("pilosa-join", 0) < num_processes:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"torch.distributed job at {coordinator_address}: "
                    f"{store.add('pilosa-join', 0)} of {num_processes} "
                    f"ranks joined within {join.total_seconds():.0f} s")
            time.sleep(0.02)  # pilint: allow-blocking(the one join of the job; a second caller waits for it)
        dist.init_process_group(
            "gloo", store=dist.PrefixStore("pilosa-pg", store),
            rank=process_id, world_size=num_processes, timeout=timeout)
        store.set_timeout(timeout)
        _job = _Job(host, port, process_id, num_processes, timeout_ms, store)
    return True


def process_count() -> int:
    """Ranks in the joined job; 1 outside one."""
    return _job.world_size if _job is not None else 1


def process_index() -> int:
    """This process's rank; 0 outside a job."""
    return _job.rank if _job is not None else 0


def connect_store():
    """A new client connection to the job's rendezvous store, or None
    outside a job: each user that blocks on the store (the barrier's
    wait) or is called from many threads gets its own."""
    if _job is None:
        return None
    import torch.distributed as dist

    return dist.TCPStore(
        _job.host, _job.port, _job.world_size, False,
        timeout=datetime.timedelta(milliseconds=_job.timeout_ms))


def barrier(store, name: str, world_size: int, timeout_ms: int) -> None:
    """A named barrier over `store` whose outcome is ONE atomic decision
    for every rank, the counterpart of the jax.distributed runtime's
    wait_at_barrier. Each rank adds itself to `<name>/arrived`; the rank
    that completes the count, and any rank whose wait for the decision
    times out, both compare-and-set `<name>/done` from empty to `ok` or
    `abort`, so whichever comes first decides for all. A rank that
    arrives after an abort reads it and raises without waiting. Raises
    BarrierAborted unless the decision is `ok`."""
    key = f"{BARRIER_PREFIX}/{name}"
    done = f"{key}/done"
    if store.add(f"{key}/arrived", 1) >= world_size:
        outcome = store.compare_set(done, "", "ok")
    else:
        try:
            store.wait([done], datetime.timedelta(milliseconds=timeout_ms))
            outcome = store.get(done)
        except RuntimeError:  # DistStoreError: the wait timed out
            outcome = store.compare_set(done, "", "abort")
    if outcome != b"ok":
        raise BarrierAborted(
            f"barrier {name} aborted: not every rank arrived within "
            f"{timeout_ms} ms")


def forget_barrier(store, name: str) -> None:
    """Delete a decided barrier's keys. A rank still to arrive at it
    then waits out its timeout and decides `abort` alone, so only a
    barrier every rank is long past may be forgotten."""
    key = f"{BARRIER_PREFIX}/{name}"
    store.delete_key(f"{key}/arrived")
    store.delete_key(f"{key}/done")


def all_reduce_sum(values: torch.Tensor) -> torch.Tensor:
    """Sum a small int64 host tensor over every rank (in place, and
    returned); the tensor itself outside a job."""
    if _job is not None:
        import torch.distributed as dist

        dist.all_reduce(values, op=dist.ReduceOp.SUM)
    return values


def all_gather(values: torch.Tensor) -> torch.Tensor:
    """(world_size, *values.shape): every rank's small host tensor, in
    rank order; values[None] outside a job."""
    if _job is None:
        return values.unsqueeze(0)
    import torch.distributed as dist

    out = [torch.empty_like(values) for _ in range(_job.world_size)]
    dist.all_gather(out, values)
    return torch.stack(out)


def process_shard_slots(n_shards: int) -> tuple:
    """(global_padded, lo, hi): this rank's contiguous slot range after
    padding the shard axis to a multiple of the world size, one device
    per rank (the reference pads to the global device count)."""
    n = process_count()
    padded = -(-n_shards // n) * n
    per = padded // n
    lo = process_index() * per
    return padded, lo, lo + per


_ONE_LEAF = (kernels.OP_PUSH,)
_AND = (kernels.OP_PUSH, (kernels.OP_ACC | kernels.OP_AND) | 1 << 8)


def _k1_total(planes, tape) -> int:
    """K1 over this rank's stacked (L, k, W) block, then one int64
    all_reduce(SUM) of the count."""
    idxs = torch.arange(planes.shape[0], dtype=torch.int32).reshape(-1, 1)
    local = kernels.gather_expr_count(planes.contiguous(), idxs, tape)
    return int(all_reduce_sum(local.cpu())[0])


def global_count(planes: torch.Tensor) -> int:
    """Popcount-sum over every rank's (k, W) int32 block of shard planes:
    K1 with a one-leaf tape over the local block, then one int64
    all_reduce(SUM). Counts are int64, so the reference's 15-bit split
    sum has no counterpart."""
    return _k1_total(planes.unsqueeze(0), _ONE_LEAF)


def global_and_count(planes_a: torch.Tensor, planes_b: torch.Tensor) -> int:
    """Count(Intersect) over every rank's blocks: K1 with a two-leaf AND
    tape over the local pair, then one int64 all_reduce(SUM)."""
    return _k1_total(torch.stack([planes_a, planes_b]), _AND)
