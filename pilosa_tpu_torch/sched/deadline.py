"""Per-request time budgets (the context.Context deadline analog).

A Deadline is created at admission from the request's X-Pilosa-Deadline
header (or the configured default) and rides ExecOptions through the
executor, so every layer that is about to spend device time or a network
round trip can ask "is this query still worth finishing?". Checks are
placed BEFORE dispatches, not inside them: an expired query stops
consuming device time at the next boundary instead of pinning a handler
thread until its work drains.

Remote fan-out propagates the REMAINING budget (not the original one) in
the forwarded request's header, so a peer never works past the
coordinator's own cutoff.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..errors import PilosaError


class DeadlineExceededError(PilosaError):
    """The query's time budget ran out before it finished."""


class Deadline:
    """Monotonic-clock expiry for one request.

    `clock` is injectable for deterministic tests (tests/conftest.py
    fake_clock); production uses time.monotonic.
    """

    __slots__ = ("expires_at", "budget", "_clock")

    def __init__(self, budget_s: float, clock: Callable[[], float] = time.monotonic):
        self.budget = float(budget_s)
        self._clock = clock
        self.expires_at = clock() + self.budget

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, where: str = "") -> None:
        """Raise DeadlineExceededError when the budget is spent."""
        if self.expired():
            suffix = f" at {where}" if where else ""
            raise DeadlineExceededError(
                f"query deadline exceeded{suffix} "
                f"(budget {self.budget:.3f}s)"
            )

    @staticmethod
    def from_header(value: Optional[str],
                    default_s: float = 0.0,
                    clock: Callable[[], float] = time.monotonic,
                    ) -> Optional["Deadline"]:
        """Deadline from an X-Pilosa-Deadline header (remaining seconds).

        A malformed header falls back to the default rather than erroring:
        the budget is advisory control-plane metadata, and rejecting the
        query over it would turn a client bug into an outage. Non-finite
        values count as malformed — a 'nan' timeout poisons semaphore
        waits into busy-spins, and 'inf' is just "no deadline" said
        confusingly. '0' (and negatives) mean an already-spent budget:
        coordinators forward max(remaining, 0), so zero MUST read as
        expired or an exhausted fan-out would grant peers fresh time.
        Returns None when neither the header nor the default specifies a
        budget.
        """
        import math

        budget = None
        if value:
            try:
                budget = float(value)
            except ValueError:
                budget = None
            if budget is not None and not math.isfinite(budget):
                budget = None
        if budget is None:
            budget = default_s if default_s and default_s > 0 else None
        if budget is None:
            return None
        return Deadline(budget, clock=clock)
