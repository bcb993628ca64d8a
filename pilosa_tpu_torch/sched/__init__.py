"""Query scheduler: admission control, deadlines, cross-query micro-batching.

The serving stack's missing middle layer: the engine already batches the
shards of ONE query into a single device program, but every HTTP request
used to drive the device independently — N concurrent queries over the
same resident leaf stack launched N separate XLA dispatches and contended
unboundedly for HBM and the compile gate. This package gives every query a
lifecycle (admit -> wait -> coalesce -> execute -> split):

  - deadline.py   per-request time budget, carried through ExecOptions into
                  the executor's map/reduce and the remote fan-out headers;
  - scheduler.py  bounded admission queue with per-class concurrency limits
                  (interactive vs. import traffic) and 429 load shedding;
  - batcher.py    micro-batcher coalescing compatible count dispatches into
                  one fused engine launch within an adaptive ~0.5-2 ms
                  window, splitting results back per caller;
  - qos.py        per-tenant token buckets charged the query's MEASURED
                  cost from its trace spans, with SLO-classed shedding
                  (batch sheds first, interactive past a hard cap).
"""

from .deadline import Deadline, DeadlineExceededError
from .scheduler import (
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    QueryScheduler,
    QueueFullError,
    SchedulerConfig,
)
from .batcher import MicroBatcher
from .qos import QosConfig, TenantBudgetError, TenantLedger

__all__ = [
    "CLASS_BATCH",
    "CLASS_INTERACTIVE",
    "Deadline",
    "DeadlineExceededError",
    "MicroBatcher",
    "QosConfig",
    "QueryScheduler",
    "QueueFullError",
    "SchedulerConfig",
    "TenantBudgetError",
    "TenantLedger",
]
