"""Single-GPU query engine: device-tensor caches and the batched kernels."""

from __future__ import annotations

from dataclasses import dataclass


# Counterpart of pilosa_tpu/parallel/__init__.py's EngineConfig, with the
# same fields, defaults and env spellings (PILOSA_TPU_ENGINE_*, read by the
# engine when no config is passed), but for gather_workers (below).
@dataclass
class EngineConfig:
    """Device-cache, memo, refresh and fault knobs for ShardedQueryEngine.

    delta_max_fraction: a stale resident plane/stack is refreshed by a
        small scattered update (indices + values host -> device) only
        while the changed 32-bit words stay under this fraction of the
        tensor; past it the full regather path wins. 0 disables the
        delta path.
    delta_journal_ops: per-fragment dirty-word journal bound
        (core/fragment.py); overflow falls back to full regather. The
        engine does not read it: the server copies it into
        ``Holder(delta_journal_ops=...)``.
    gather_workers: threads for the cold-path per-shard host container
        walks (1 = serial, the default; 0 = auto-size to the CPU count, at
        most 8). The reference defaults to 0. The port defaults to serial
        because its container walk holds the GIL: on the pool each plane
        took 4-5x longer than serially on the H100's host (PERF.md).
    mesh_devices: the reference's engine mesh width. The port's engine
        runs on one device, and a server refuses a value above 1: one
        process over several devices is a difference by design (several
        devices serve as ranks of the collective plane instead).
    leaf_cache_bytes, stack_cache_bytes, memo_entries, aux_memo_entries:
        cache bounds (0 = auto). Auto means: the env override
        (PILOSA_LEAF_CACHE_BYTES / PILOSA_STACK_CACHE_BYTES /
        PILOSA_MEMO_ENTRIES / PILOSA_AUX_MEMO_ENTRIES) if set, else the
        [tier] hbm-bytes split (byte budgets only), else the platform
        default. A nonzero config value loses only to the env variable.
    dispatch_watchdog: seconds a device dispatch may block before the
        watchdog frees the serving thread and the failure is classified
        `timeout` into the device breakers (0 disables).
    cold_host_count: 1 answers a one-off Count whose leaves are ALL
        demoted to the host tier directly from the compressed bytes on
        the host; the second touch of the same leaf set promotes. 0
        disables.
    plan_cache: 1 caches each Call tree's canonical plan (signature +
        leaf slots + lowered expression, plan/signature.py) on the Call
        object, keyed by the index's write epoch. 0 recompiles every time.
    """

    delta_max_fraction: float = 0.25
    delta_journal_ops: int = 4096
    gather_workers: int = 1
    mesh_devices: int = 0
    leaf_cache_bytes: int = 0
    stack_cache_bytes: int = 0
    memo_entries: int = 0
    aux_memo_entries: int = 0
    dispatch_watchdog: float = 0.0
    cold_host_count: int = 1
    plan_cache: int = 1


# The [collective] config section: the same fields and defaults as the
# reference's, so one TOML file loads in both packages. The server hands
# it to the collective plane (parallel/collective.py).
@dataclass
class CollectiveConfig:
    """Multi-process collective serving plane knobs
    (parallel/collective.py).

    enabled: 0 turns the collective rung off entirely (every full-index
        query takes the HTTP fan-out).
    single_process: 1 lets a one-process job with a one-node cluster
        serve through the collective plane (the barrier is a no-op).
        Default 0: multi-node clusters must span a torch.distributed job.
    timeout_ms: barrier timeout, and the process group's timeout
        (PILOSA_COLLECTIVE_TIMEOUT_MS overrides it when no config is
        given).
    leaf_budget_bytes: resident (k, W) block budget per process, leaves
        and stacks each; LRU past it, evicted planes demote through the
        tier manager (PILOSA_COLLECTIVE_LEAF_BYTES).
    delta_max_fraction: a stale resident block refreshes by a scatter of
        the dirty words while they stay under this fraction of it; 0
        disables deltas.
    """

    enabled: int = 1
    single_process: int = 0
    timeout_ms: int = 10000
    leaf_budget_bytes: int = 1 << 28
    delta_max_fraction: float = 0.25
