"""Ingest-path knobs: the [ingest] config section.

Same pattern as [storage]/StorageConfig and [scheduler]/SchedulerConfig —
the section IS the dataclass the layer it governs consumes (server/api.py's
parallel shard fan-out), so knob names and defaults have one source of
truth. stdlib-only so CLI startup stays light. See docs/ingest.md.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IngestConfig:
    # Max shard batches of one import applied/forwarded concurrently
    # across the executor's worker pool (key-mode imports re-group by
    # shard; multi-node forwards batch per node). <= 1 keeps the serial
    # path. The pool itself is the executor's — this only caps how much
    # of it one import may occupy.
    import_workers: int = 8

    def validate(self) -> "IngestConfig":
        if self.import_workers < 1:
            raise ValueError("ingest.import-workers must be >= 1")
        return self
