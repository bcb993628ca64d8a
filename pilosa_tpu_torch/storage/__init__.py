"""Storage backends: roaring bitmap persistence + durability policy."""

from __future__ import annotations

from dataclasses import dataclass

FSYNC_NEVER = "never"
FSYNC_BATCH = "batch"
FSYNC_ALWAYS = "always"
FSYNC_MODES = (FSYNC_NEVER, FSYNC_BATCH, FSYNC_ALWAYS)


# The [storage] config section IS this dataclass (same pattern as
# [scheduler]/SchedulerConfig): one source of truth for knob names and
# defaults. Threaded Holder -> Index -> Field -> View -> Fragment, like the
# per-index write epoch.
@dataclass
class StorageConfig:
    """Durability policy for the fragment WAL + snapshot path.

    fsync:
      never   flush to the OS page cache only (survives process kill -9,
              loses acknowledged writes on machine power loss)
      batch   fsync the WAL every `fsync_batch_ops` appends and at every
              snapshot/close boundary — bounded loss window, near-`never`
              throughput (the default)
      always  fsync after every op append — zero acknowledged-write loss,
              pays a disk flush per write
    Snapshots fsync the temp file before rename and the directory after,
    in every mode except `never`.
    """

    fsync: str = FSYNC_BATCH
    fsync_batch_ops: int = 64
    # Snapshot trigger policy (amortized ingest): rewrite a fragment's
    # storage file when its op-log bytes exceed snapshot_ratio x the
    # container-section bytes of the last snapshot (floored at
    # SNAPSHOT_MIN_BASE so a fresh fragment doesn't snapshot per batch).
    # Each rewrite grows the base geometrically, so total snapshot I/O
    # stays O(data ingested / ratio) — write cost proportional to the
    # batch, not the fragment. 0 disables the byte trigger (op-count and
    # explicit flushes still apply).
    snapshot_ratio: float = 0.5
    # Background sweep cadence (seconds): fragments carrying ANY un-
    # snapshotted WAL bytes older than this get snapshotted even below
    # the ratio, bounding replay time after a crash. 0 disables the sweep.
    snapshot_interval: float = 300.0

    # Ratio-trigger floor (bytes): below this base size the byte trigger
    # compares against the floor, not the (tiny) file.
    SNAPSHOT_MIN_BASE = 1 << 20

    def validate(self) -> "StorageConfig":
        if self.fsync not in FSYNC_MODES:
            raise ValueError(
                f"storage.fsync must be one of {FSYNC_MODES}, got {self.fsync!r}"
            )
        if self.fsync_batch_ops < 1:
            raise ValueError("storage.fsync-batch-ops must be >= 1")
        if self.snapshot_ratio < 0:
            raise ValueError("storage.snapshot-ratio must be >= 0")
        if self.snapshot_interval < 0:
            raise ValueError("storage.snapshot-interval must be >= 0")
        return self
