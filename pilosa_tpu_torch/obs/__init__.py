"""Per-query tracing, slow-query log, and Prometheus exposition.

The third observability leg next to /debug/vars (process-wide counters)
and /debug/profile (whole-process torch.profiler captures of CPU and
CUDA activity, every span shown as a range while one runs): a sampling
per-request trace recorder threaded through the serving path. A trace
starts at handler ingress (or is adopted from the X-Pilosa-Trace header
a coordinator stamped), accumulates named stage spans — parse,
sched.wait, batch.hold, executor.fanout, gather, device.dispatch and
inside it engine.fingerprint, engine.stack, k1.stage and device.sync,
tier.promote, remote:<peer>, reduce, and gc.pause for a collection that
stopped the request's thread — and lands in a bounded ring served by
GET /debug/traces. Remote hops return the peer's own stage summary in a
size-bounded X-Pilosa-Trace-Summary response header, spliced as child
spans so a fan-out query yields ONE tree across nodes.

On top of the recorder: a slow-query log (over-threshold queries logged
once with their full stage breakdown), per-stage log-bucketed latency
histograms, and GET /metrics — a Prometheus text exposition of the
/debug/vars counter groups plus the stage histograms.

Importable without torch (config.py imports ObsConfig at CLI startup;
the profiler ranges are handed in by the capture), and the disabled
path costs one conditional per stage: obs.span() returns a shared
no-op singleton when no trace is active on the calling thread.

See docs/observability.md for the full surface, and README.md beside
this file for what only the port records and exposes.
"""

from __future__ import annotations

from dataclasses import dataclass

from .trace import (
    NOP_SPAN,
    GcHook,
    Span,
    Trace,
    TraceRecorder,
    activate,
    current,
    deactivate,
    profile_ranges,
    record,
    span,
)


@dataclass
class ObsConfig:
    """[obs] knobs (TOML + PILOSA_TPU_OBS_* env + CLI flags).

    sample_rate: fraction of ingress queries traced (0 disables local
        sampling entirely; forwarded sub-queries whose coordinator sampled
        them are still adopted, so cross-node splicing keeps working).
    ring_size: completed traces retained for GET /debug/traces.
    slow_query_ms: queries slower than this are logged once with their
        full stage breakdown and counted (`slow_queries`); 0 disables.
    """

    sample_rate: float = 1.0
    ring_size: int = 256
    slow_query_ms: float = 0.0

    def validate(self) -> "ObsConfig":
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"[obs] sample-rate must be in [0, 1], got {self.sample_rate}")
        if self.ring_size < 0:
            raise ValueError(
                f"[obs] ring-size must be >= 0, got {self.ring_size}")
        if self.slow_query_ms < 0:
            raise ValueError(
                f"[obs] slow-query-ms must be >= 0, got {self.slow_query_ms}")
        return self


__all__ = [
    "NOP_SPAN",
    "GcHook",
    "ObsConfig",
    "Span",
    "Trace",
    "TraceRecorder",
    "activate",
    "current",
    "deactivate",
    "profile_ranges",
    "record",
    "span",
]
