"""Single-GPU query engine: device-tensor caches and the batched kernels."""

from __future__ import annotations

from dataclasses import dataclass


# Counterpart of pilosa_tpu/parallel/__init__.py's EngineConfig, holding
# only the knobs this engine reads. The delta-refresh, memo, tiering,
# device-fault and collective knobs come with the slices that read them.
@dataclass
class EngineConfig:
    """Device-cache knobs for ShardedQueryEngine.

    leaf_cache_bytes, stack_cache_bytes: cache budgets (0 = auto: the
        PILOSA_LEAF_CACHE_BYTES / PILOSA_STACK_CACHE_BYTES env override if
        set, else the platform default).
    plan_cache: 1 caches each Call tree's canonical plan (signature + leaf
        slots + lowered expression, plan/signature.py) on the Call object,
        keyed by the index's write epoch. 0 recompiles every time.
    """

    leaf_cache_bytes: int = 0
    stack_cache_bytes: int = 0
    plan_cache: int = 1
