"""Multi-process collective execution: a torch.distributed job whose
reduce group runs on NCCL or gloo.

The counterpart of pilosa_tpu/parallel/distributed.py. The reference
joins every host process to one `jax.distributed` job and reduces over a
global device mesh with XLA-inserted collectives. Here every server
process joins one job; each rank holds the shard planes its node serves
over its own partitions (its engine's `[engine] mesh-devices`,
parallel/mesh.py), runs the port's hand kernels (ops/kernels.py) once
per partition, folds the partitions' results on partition 0's device
(the rank's reduce device), and the ranks combine them with one reduce
of their `ReduceGroup`.

The reduce backend is chosen per job, with no setting (`pick_backend`):
at join every rank publishes its reduce device's identity (the card's
UUID, or "cpu") to the store, and every rank reads the same set.

- **NCCL** when every rank's reduce device is a CUDA card that no other
  rank's is: the result stays on the card, NCCL reduces it there, and
  the reduced tensor is copied to the host once.
- **gloo** otherwise: a CPU rank, or ranks that share a card (NCCL
  refuses two ranks on one device, which is how the plane runs on a
  one-card machine). Each rank copies its small result to the host and
  gloo reduces it there.

A job that the rule sends to NCCL and that cannot form its NCCL group
is not served on gloo: the group's error is kept (`group_error`) and the
collective plane stays off.

A `ReduceGroup` is built under a store prefix of its own,
`pilosa-pg/<generation>`. A reduce that fails (the group's timeout ran
out, or the communicator reported an error) aborts the group (a gloo
group is not reusable after a timeout; an NCCL communicator is aborted
rather than left to the watchdog, which would end the process) and
advances the job's generation in the store (`pilosa-pg/generation`,
one compare-and-set per failed generation, before the abort). A reduce
that completes past the timeout after the rank's barrier is discarded
when the generation has moved (`check_late`): on NCCL a late rank can
complete against a peer's aborted communicator. The collective plane's
barrier carries the generation the last arriving rank read, so every
rank that passes it re-forms at that generation (`regroup`) before the
reduce that follows, in the same order.

The job's mesh is every rank's partitions in rank order, d_local of them
per rank: `global_mesh` gives this rank's partition devices, and
`make_global_planes` splits this rank's (k, W) block of shard planes
(k a multiple of d_local) into one block of k / d_local slots per
partition, as the reference's global mesh shards its (S_padded, W)
arrays over the devices of every process.

The rendezvous is one `TCPStore` at the coordinator address (rank 0
hosts it). The reduce groups keep their keys under their prefixes; the
collective plane's sequence counter and barriers (parallel/collective.py)
use the same store under prefixes of their own, each through a client
connection of its own (a TCPStore client serves one request at a time,
and a barrier's blocking wait would hold it).

Single-process use (tests, one-node clusters) needs no group:
initialize() returns False when there is one process or no coordinator,
and the helpers below work on the local block alone.
"""

from __future__ import annotations

import atexit
import datetime
import os
import threading
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import kernels
from .engine import Blocks
from .mesh import engine_mesh

DEFAULT_TIMEOUT_MS = 10000
# The least time a reduce group gets to form: every rank is present, but
# an NCCL communicator's set-up takes seconds, and a rank that never comes
# must not hang the others.
FORM_TIMEOUT_MS = 30000
BARRIER_PREFIX = "pilosa-collective/barrier"
GROUP_PREFIX = "pilosa-pg"
GENERATION_KEY = f"{GROUP_PREFIX}/generation"
DEVICE_KEY = f"{GROUP_PREFIX}/device"
_LOOPBACK = ("localhost", "127.0.0.1", "::1")
# An NCCL collective that fails or times out must raise in the caller
# with its communicator aborted: the watchdog must never end the server
# (by default it tears the process down), nor its heartbeat monitor, nor
# write dumps. Set before an NCCL group is built, when torch reads them.
_NCCL_ENV = {
    "TORCH_NCCL_ASYNC_ERROR_HANDLING": "2",  # CleanUpOnly: abort, do not kill
    "TORCH_NCCL_BLOCKING_WAIT": "0",
    "TORCH_NCCL_ENABLE_MONITORING": "0",
    "TORCH_NCCL_DUMP_ON_TIMEOUT": "0",
}


class BarrierAborted(RuntimeError):
    """A named barrier was decided `abort`: some rank did not arrive
    within the timeout, so no rank may enter the reduce that follows."""


class ReduceFailed(RuntimeError):
    """A reduce of the group failed, or the group could not form. The
    group is aborted; the job re-forms it at the next generation."""


def device_identity(device) -> str:
    """What a rank publishes of its reduce device: "cuda/<the card's
    UUID>", or "cpu" for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return f"cuda/{torch.cuda.get_device_properties(device).uuid}"


def pick_backend(identities: Sequence[str]) -> str:
    """The reduce backend of a job whose ranks' reduce devices have these
    identities (device_identity, in rank order): "nccl" when every one is
    a CUDA card that no other rank's is, "gloo" otherwise (a CPU rank, or
    two ranks on one card, which NCCL refuses)."""
    ids = list(identities)
    if all(i != "cpu" for i in ids) and len(set(ids)) == len(ids):
        return "nccl"
    return "gloo"


class ReduceGroup:
    """One process group of every rank of a job, built under the store
    prefix `pilosa-pg/<generation>`: gloo over host tensors, or NCCL over
    tensors on `device` (the rank's reduce device). Forming it includes
    one reduce that checks every rank is there (for NCCL it also sets the
    communicator up, so the first entry does not pay for it), bounded by
    `form_timeout_ms`. Every later reduce is bounded by `timeout_ms`; one
    that fails aborts the group and raises ReduceFailed, and the group
    serves nothing more: `reform` builds the next generation's."""

    def __init__(self, store, backend: str, rank: int, world_size: int, device,
                 timeout_ms: int, generation: int = 0,
                 form_timeout_ms: Optional[int] = None):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown reduce backend {backend!r}")
        self.backend = backend
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device) if backend == "nccl" else torch.device("cpu")
        self.timeout_ms = int(timeout_ms)
        self.generation = int(generation)
        self.form_timeout_ms = int(form_timeout_ms or max(self.timeout_ms, FORM_TIMEOUT_MS))
        self.failed: Optional[str] = None
        self._store = store
        self._pg = None
        self._form()

    def _build(self):
        import torch.distributed as dist

        prefix = dist.PrefixStore(f"{GROUP_PREFIX}/{self.generation}", self._store)
        timeout = datetime.timedelta(milliseconds=self.form_timeout_ms)
        if self.backend == "gloo":
            return dist.ProcessGroupGloo(prefix, self.rank, self.world_size, timeout)
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
        os.environ.update(_NCCL_ENV)
        torch.cuda.set_device(self.device)
        opts = dist.ProcessGroupNCCL.Options()
        # The group's own timeout (its watchdog's) lies past the reduce
        # timeout this class waits for, so that this class aborts first.
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(prefix, self.rank, self.world_size, opts)
        if hasattr(pg, "eager_connect_single_device"):
            pg.eager_connect_single_device(self.device)
        return pg

    def _form(self) -> None:
        """Build the group and reduce a one over it, in a thread of its
        own bounded by form_timeout_ms (a peer that never comes must not
        hang this rank)."""
        box: dict = {}

        def form():
            try:
                if self.backend == "nccl":
                    torch.cuda.set_device(self.device)
                self._pg = self._build()
                one = torch.ones(1, dtype=torch.int64, device=self.device)
                self._complete(self._pg.allreduce([one]), self.form_timeout_ms)
                box["world"] = int(one.item())
                if self.backend == "gloo":
                    # gloo's own operations time out from now on: a wait
                    # that gave up alone would leave the operation running
                    # and a late peer's reduce succeeding against it.
                    self._pg._set_default_timeout(
                        datetime.timedelta(milliseconds=self.timeout_ms))
            except BaseException as e:  # raised in the caller below
                box["error"] = e

        t = threading.Thread(target=form, name="reduce-group-form", daemon=True)
        t.start()
        t.join(self.form_timeout_ms / 1000.0 + 5.0)
        err = box.get("error")
        if t.is_alive():
            err = TimeoutError(f"not formed within {self.form_timeout_ms} ms")
        elif err is None and box.get("world") != self.world_size:
            err = RuntimeError(f"{box.get('world')} of {self.world_size} ranks reduced")
        if err is not None:
            self.abort(str(err))
            raise ReduceFailed(f"{self.backend} reduce group of generation "
                               f"{self.generation} did not form: {err}") from err

    def _complete(self, work, timeout_ms: Optional[int] = None) -> None:
        """Wait for `work` within the timeout, raising what it raised.
        A gloo operation is bounded by the group's own timeout; an NCCL
        work completes on the card, so its completion is polled."""
        timeout_ms = self.timeout_ms if timeout_ms is None else timeout_ms
        if self.backend == "gloo":
            work.wait()
            return
        deadline = time.monotonic() + timeout_ms / 1000.0
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise TimeoutError(f"the reduce did not complete within {timeout_ms} ms")
            time.sleep(0.00005)  # pilint: allow-blocking(the runner thread waits for the card's reduce)
        work.wait()  # raises what the communicator reported

    def _run(self, start) -> None:
        if self._pg is None or self.failed is not None:
            raise ReduceFailed(f"the {self.backend} reduce group of generation "
                               f"{self.generation} failed: {self.failed}")
        try:
            self._complete(start(self._pg))
        except Exception as e:
            self._fail(str(e))
            raise ReduceFailed(f"{self.backend} reduce of generation {self.generation} "
                               f"failed: {e}") from e

    def _fail(self, reason: str) -> None:
        """Advance the job's generation past this group's (one
        compare-and-set, so that ranks failing in one generation agree on
        the next), then abort the group. In that order: a peer whose late
        reduce completes checks the generation (check_late) and discards
        what it read once this rank may have aborted its buffers."""
        try:
            self._store.compare_set(GENERATION_KEY, str(self.generation),
                                    str(self.generation + 1))
        except RuntimeError:  # the store is unreachable: the barrier aborts too
            pass
        self.abort(reason)

    def check_late(self, elapsed_s: float) -> None:
        """After a reduce that completed `elapsed_s` after this rank
        arrived at its entry's barrier. A peer starts its reduce's timeout
        no earlier than that arrival, so before the timeout no peer can
        have given up; past it (with a tenth's margin) a peer may have,
        and an NCCL reduce can complete late against what its aborted
        communicator left behind. Then the generation has moved past this
        group's: the result is discarded, the group aborted, and
        ReduceFailed raised."""
        if elapsed_s * 1000.0 < 0.9 * self.timeout_ms:
            return
        if int(self._store.get(GENERATION_KEY)) != self.generation:
            self.abort("a peer gave up on the reduce")
            raise ReduceFailed(f"{self.backend} reduce of generation {self.generation} "
                               f"completed {elapsed_s:.2f} s after the barrier, after a "
                               f"peer had given up on it")

    def all_reduce_sum(self, values: torch.Tensor) -> torch.Tensor:
        """Sum `values` (on this group's device) over every rank, in
        place; returned."""
        self._run(lambda pg: pg.allreduce([values]))
        return values

    def all_gather(self, values: torch.Tensor) -> torch.Tensor:
        """(world_size, *values.shape) on this group's device: every
        rank's `values`, in rank order."""
        if self.backend == "nccl":
            out = torch.empty((self.world_size,) + tuple(values.shape),
                              dtype=values.dtype, device=values.device)
            self._run(lambda pg: pg._allgather_base(out, values.contiguous()))
            return out
        out = [torch.empty_like(values) for _ in range(self.world_size)]
        self._run(lambda pg: pg.allgather([out], [values]))
        return torch.stack(out)

    def abort(self, reason: str = "closed") -> None:
        """Drop the group: its communicator is aborted (a pending reduce
        of a peer ends), and it serves nothing more."""
        self.failed = self.failed or reason
        pg, self._pg = self._pg, None
        if pg is not None:
            try:
                pg.abort()
            except Exception:  # pilint: allow-swallow(a backend without abort: dropping it closes it)
                pass

    def reform(self, generation: int) -> "ReduceGroup":
        """This group aborted and the group of `generation` formed in its
        place: the same ranks, backend, device and timeouts."""
        self.abort("re-formed")
        return ReduceGroup(self._store, self.backend, self.rank, self.world_size,
                           self.device, self.timeout_ms, generation,
                           self.form_timeout_ms)


class _Job:
    """The joined job: the coordinator address, this rank, the world size,
    the rendezvous store (rank 0 hosts it), the reduce backend and device,
    and the current reduce group (None when it could not form: `error`
    says why)."""

    def __init__(self, host: str, port: int, rank: int, world_size: int,
                 timeout_ms: int, store, backend: str, device: torch.device):
        self.host = host
        self.port = port
        self.rank = rank
        self.world_size = world_size
        self.timeout_ms = timeout_ms
        self.store = store
        self.backend = backend
        self.device = device
        self.group: Optional[ReduceGroup] = None
        self.generation = 0
        self.error: Optional[str] = None
        # The groups' store client, used by one thread at a time (the
        # join, then the collective runner).
        self.group_store = None


_job: Optional[_Job] = None
_job_lock = threading.Lock()


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    return host.strip("[]") or "localhost", int(port)


def _client(host: str, port: int, world_size: int, timeout_ms: int):
    import torch.distributed as dist

    return dist.TCPStore(host, port, world_size, False,
                         timeout=datetime.timedelta(milliseconds=timeout_ms))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_ms: Optional[int] = None,
               reduce_device=None) -> bool:
    """Join (or skip joining) a multi-process torch.distributed job.

    The arguments fall back to the reference's variables,
    PILOSA_JAX_COORDINATOR (host:port), PILOSA_JAX_NUM_PROCESSES and
    PILOSA_JAX_PROCESS_ID: the names are pilosa_tpu's, kept so that one
    deployment's environment drives either package. Rank 0 hosts a
    TCPStore at the coordinator address. Every rank publishes the
    identity of its `reduce_device` (partition 0 of its collective
    partitions; the CPU when None), reads every rank's, picks the
    backend (pick_backend) and forms the reduce group of generation 0
    with `timeout_ms` (default DEFAULT_TIMEOUT_MS) as its timeout. A
    group that cannot form leaves the job joined with `group_error` set.
    A coordinator on a loopback host puts every rank on this machine, so
    gloo and NCCL's bootstrap bind to `lo` unless GLOO_SOCKET_IFNAME and
    NCCL_SOCKET_IFNAME say otherwise. Returns
    True when a multi-process job is joined (also when this process had
    joined it already), False with no job when there is one process or
    no coordinator."""
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
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        timeout = datetime.timedelta(milliseconds=timeout_ms)
        # The rendezvous waits for every rank; a slow start is not a
        # fault, so it gets at least a minute. Then the group forms, every
        # rank present.
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
        device = torch.device(reduce_device if reduce_device is not None else "cpu")
        store.set(f"{DEVICE_KEY}/{process_id}", device_identity(device))
        backend = pick_backend([store.get(f"{DEVICE_KEY}/{r}").decode()
                                for r in range(num_processes)])
        store.compare_set(GENERATION_KEY, "", "0")
        store.set_timeout(timeout)
        job = _Job(host, port, process_id, num_processes, timeout_ms, store,
                   backend, device)
        job.group_store = _client(host, port, num_processes,
                                  max(timeout_ms, FORM_TIMEOUT_MS))
        try:
            job.group = ReduceGroup(job.group_store, backend, process_id,
                                    num_processes, device, timeout_ms, 0)
        except ReduceFailed as e:
            job.error = str(e)
        _job = job
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """Leave the job: the reduce group aborted and the job forgotten.
    Every rank calls it before exit (a group left to the interpreter's
    exit can abort the process after the work is done)."""
    global _job
    with _job_lock:
        job, _job = _job, None
    if job is not None and job.group is not None:
        job.group.abort("shut down")


def process_count() -> int:
    """Ranks in the joined job; 1 outside one."""
    return _job.world_size if _job is not None else 1


def process_index() -> int:
    """This process's rank; 0 outside a job."""
    return _job.rank if _job is not None else 0


def reduce_backend() -> Optional[str]:
    """The job's reduce backend, "gloo" or "nccl"; None outside a job."""
    return _job.backend if _job is not None else None


def reduce_group() -> Optional[ReduceGroup]:
    """The job's current reduce group; None outside a job, or when it
    could not form."""
    return _job.group if _job is not None else None


def group_generation() -> int:
    """The generation of the job's current reduce group; 0 outside a
    job."""
    return _job.generation if _job is not None else 0


def group_error() -> Optional[str]:
    """Why the job has no reduce group (it, or its re-formation, did not
    form); None while it has one, and outside a job."""
    return _job.error if _job is not None else None


def regroup(generation: int) -> ReduceGroup:
    """Re-form the job's reduce group at `generation` (the one read at a
    barrier every rank passed). Raises ReduceFailed when it does not
    form; the job then has no group, and `group_error` says why."""
    job = _job
    if job is None:
        raise ReduceFailed("not in a job")
    old, job.group = job.group, None
    try:
        if old is not None:
            group = old.reform(generation)
        else:
            group = ReduceGroup(job.group_store, job.backend, job.rank, job.world_size,
                                job.device, job.timeout_ms, generation)
    except ReduceFailed as e:
        job.error = str(e)
        raise
    job.group, job.generation, job.error = group, generation, None
    return group


def _reduce(values: torch.Tensor, op: str) -> torch.Tensor:
    """One `op` of the job's group over `values`, moved to the group's
    device, the result returned on `values`' device. A failed reduce has
    advanced the job's generation past the group's when it raises
    ReduceFailed (ReduceGroup._fail)."""
    job = _job
    group = job.group
    if group is None:
        raise ReduceFailed(f"no reduce group: {job.error}")
    return getattr(group, op)(values.to(group.device)).to(values.device)


def check_late(elapsed_s: float) -> None:
    """The job's group's check_late (nothing outside a job, or with no
    group): raises ReduceFailed when a reduce that completed `elapsed_s`
    after this rank arrived at the barrier may have raced a peer's
    abort."""
    group = _job.group if _job is not None else None
    if group is not None:
        group.check_late(elapsed_s)


def connect_store():
    """A new client connection to the job's rendezvous store, or None
    outside a job: each user that blocks on the store (the barrier's
    wait) or is called from many threads gets its own."""
    if _job is None:
        return None
    return _client(_job.host, _job.port, _job.world_size, _job.timeout_ms)


def barrier(store, name: str, world_size: int, timeout_ms: int,
            generation_key: Optional[str] = None) -> Optional[int]:
    """A named barrier over `store` whose outcome is ONE atomic decision
    for every rank, the counterpart of the jax.distributed runtime's
    wait_at_barrier. Each rank adds itself to `<name>/arrived`; the rank
    that completes the count, and any rank whose wait for the decision
    times out, both compare-and-set `<name>/done` from empty to `ok` or
    `abort`, so whichever comes first decides for all. A rank that
    arrives after an abort reads it and raises without waiting. Raises
    BarrierAborted unless the decision is `ok`. With `generation_key`,
    the completing rank reads it, after every rank arrived, and the
    decision carries it (`ok/<g>`): every rank returns the same g."""
    key = f"{BARRIER_PREFIX}/{name}"
    done = f"{key}/done"
    if store.add(f"{key}/arrived", 1) >= world_size:
        ok = "ok"
        if generation_key is not None:
            ok = f"ok/{int(store.get(generation_key))}"
        outcome = store.compare_set(done, "", ok)
    else:
        try:
            store.wait([done], datetime.timedelta(milliseconds=timeout_ms))
            outcome = store.get(done)
        except RuntimeError:  # DistStoreError: the wait timed out
            outcome = store.compare_set(done, "", "abort")
    if not outcome.startswith(b"ok"):
        raise BarrierAborted(
            f"barrier {name} aborted: not every rank arrived within "
            f"{timeout_ms} ms")
    generation = outcome.partition(b"/")[2]
    return int(generation) if generation else None


def forget_barrier(store, name: str) -> None:
    """Delete a decided barrier's keys. A rank still to arrive at it
    then waits out its timeout and decides `abort` alone, so only a
    barrier every rank is long past may be forgotten."""
    key = f"{BARRIER_PREFIX}/{name}"
    store.delete_key(f"{key}/arrived")
    store.delete_key(f"{key}/done")


def all_reduce_sum(values: torch.Tensor) -> torch.Tensor:
    """Sum a small int64 tensor over every rank through the job's reduce
    group (returned on `values`' device); the tensor itself outside a
    job. Raises ReduceFailed when the reduce fails."""
    if _job is None:
        return values
    return _reduce(values, "all_reduce_sum")


def all_gather(values: torch.Tensor) -> torch.Tensor:
    """(world_size, *values.shape): every rank's small tensor, in rank
    order, on `values`' device; values[None] outside a job. Raises
    ReduceFailed when the gather fails."""
    if _job is None:
        return values.unsqueeze(0)
    return _reduce(values, "all_gather")


def global_mesh(limit: Optional[int] = None, device=None) -> List[torch.device]:
    """This rank's share of the job's mesh: the devices of its partitions,
    `limit` of them placed over the local devices of `device`'s kind as
    parallel/mesh.py engine_mesh places an engine's (0 or None: one per
    local device; a device naming a card keeps them all on that card).
    The counterpart of the reference's global_mesh(limit); the ranks'
    meshes in rank order make the job's."""
    return engine_mesh(int(limit or 0), device)


def make_global_planes(local_planes: Union[np.ndarray, torch.Tensor],
                       mesh: Sequence) -> Blocks:
    """This rank's (k, W) block of shard planes (or an (L, k, W) stack of
    them; uint32 or int32) split into len(mesh) blocks of k / d_local
    slots along the shard axis, block p uploaded to mesh[p]: slot s lives
    in partition s // (k / d_local). `local_planes` must be exactly this
    rank's padded slot range (process_shard_slots)."""
    if isinstance(local_planes, np.ndarray):
        local_planes = torch.from_numpy(np.ascontiguousarray(local_planes).view(np.int32))
    d_local = len(mesh)
    k = local_planes.shape[-2]
    if k % d_local:
        raise ValueError(f"{k} slots do not split over {d_local} partitions")
    per = k // d_local
    return Blocks(local_planes.narrow(-2, p * per, per).contiguous().to(dev)
                  for p, dev in enumerate(mesh))


def process_shard_slots(n_shards: int, d_local: int = 1) -> tuple:
    """(global_padded, lo, hi): this rank's contiguous slot range after
    padding the shard axis to a multiple of the job's partition count,
    world size x d_local (the reference pads to the global device count).
    Block placement, as the reference's: rank r holds d_local runs of
    global_padded / (world x d_local) slots."""
    n = process_count() * int(d_local)
    padded = -(-n_shards // n) * n
    per = padded // process_count()
    lo = process_index() * per
    return padded, lo, lo + per


_ONE_LEAF = (kernels.OP_PUSH,)
_AND = (kernels.OP_PUSH, (kernels.OP_ACC | kernels.OP_AND) | 1 << 8)


def _blocks(planes) -> Blocks:
    return planes if isinstance(planes, Blocks) else Blocks([planes])


def _k1_total(stacks: Sequence[torch.Tensor], tape) -> int:
    """K1 over this rank's (L, k_p, W) stack of each partition, the
    partitions' counts summed on partition 0's device, then one int64
    all_reduce(SUM) of the count."""
    idxs = torch.arange(stacks[0].shape[0], dtype=torch.int32).reshape(-1, 1)
    parts = kernels.gather_expr_count_blocks(stacks, idxs, tape)
    local = parts[0]
    for part in parts[1:]:
        local = local + part.to(local.device)
    return int(all_reduce_sum(local.cpu())[0])


def global_count(planes: Union[torch.Tensor, Blocks]) -> int:
    """Popcount-sum over every rank's (k, W) int32 block of shard planes
    (a tensor, or Blocks over its partitions): K1 with a one-leaf tape per
    partition, then one int64 all_reduce(SUM). Counts are int64, so the
    reference's 15-bit split sum has no counterpart."""
    return _k1_total([b.unsqueeze(0).contiguous() for b in _blocks(planes)], _ONE_LEAF)


def global_and_count(planes_a: Union[torch.Tensor, Blocks],
                     planes_b: Union[torch.Tensor, Blocks]) -> int:
    """Count(Intersect) over every rank's blocks: K1 with a two-leaf AND
    tape over each partition's pair, then one int64 all_reduce(SUM)."""
    return _k1_total([torch.stack([a, b]) for a, b in
                      zip(_blocks(planes_a), _blocks(planes_b))], _AND)
