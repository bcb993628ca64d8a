"""CDC: the WAL as a product — change streams, point-in-time reads, and
standing queries.

The fragment WAL is already the single source of truth for every
mutation, and its op codec (storage/bitmap.py point + OP_BULK records)
already rides three wire formats byte-identically: the fragment file
tail, the rebalance catch-up stream, and the hinted-handoff log. This
package adds a fourth consumer — external ones:

  stream     every WAL append is stamped with a monotonically increasing
             per-index CDC position (persisted; survives the background-
             snapshot WAL splice and restart, because the change log is
             its own append-only file, never spliced). GET /cdc/stream
             serves framed op records tagged (position, shard, field,
             view) from any retained cursor, long-polling at the head.

  bootstrap  a cursor older than retention gets a typed 410
             (errors.CdcGoneError) and re-seeds via GET /cdc/bootstrap:
             compressed roaring fragment images plus the position each
             was cut at — the rebalance begin/catch-up machinery,
             generalized. Replay overlap is harmless: op records apply
             idempotently (core/fragment.migrate_apply_ops contract).

  time travel  a query carrying X-Pilosa-At-Position executes against
             fragments materialized as base image + op replay to the
             requested position (cdc/pit.py), bit-exact with a fragment
             that simply stopped writing there.

  standing queries  POST /cdc/standing registers a read expression,
             canonicalized through plan/ so respellings dedupe; the
             index write epoch tells the evaluator exactly which
             results went stale, and only those re-evaluate and re-push
             (cdc/standing.py).

See docs/cdc.md. This package is jax-free (pilint R2): config.py imports
CdcConfig at CLI startup, and the log/PIT paths run on numpy + stdlib.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CdcConfig:
    """The `[cdc]` config section (TOML + env + CLI, config.py).
    See docs/cdc.md for how the knobs interact."""

    # Master switch. Off by default: change capture costs one framed log
    # append per WAL record, and most deployments don't consume streams.
    enabled: bool = False
    # Retention bounds for each per-index change log. Exceeding either
    # folds the oldest records into the point-in-time base images and
    # drops them from the log; a cursor behind the fold gets a 410 and
    # re-seeds from /cdc/bootstrap. 0 disables that bound.
    retention_bytes: int = 64 << 20
    retention_ops: int = 1 << 20
    # How long GET /cdc/stream blocks at the log head waiting for new
    # records before answering empty (long-poll bound, seconds).
    poll_timeout: float = 10.0
    # Standing-query evaluator cadence (seconds between staleness
    # sweeps); 0 disables the background evaluator (tests drive
    # evaluate_once() by hand).
    standing_interval: float = 1.0
    # Bounded LRU of materialized historical fragments (entries, not
    # bytes): repeated at-position reads of the same (fragment,
    # position) skip the base-image + replay rebuild.
    pit_cache: int = 32

    def validate(self) -> "CdcConfig":
        # The CLI flag arrives as {0,1}; normalize so to_toml round-trips.
        self.enabled = bool(self.enabled)
        if self.retention_bytes < 0:
            raise ValueError("cdc.retention-bytes must be >= 0")
        if self.retention_ops < 0:
            raise ValueError("cdc.retention-ops must be >= 0")
        if self.poll_timeout < 0:
            raise ValueError("cdc.poll-timeout must be >= 0")
        if self.standing_interval < 0:
            raise ValueError("cdc.standing-interval must be >= 0")
        if self.pit_cache < 1:
            raise ValueError("cdc.pit-cache must be >= 1")
        return self


def __getattr__(name):
    # Lazy re-exports keep `from pilosa_tpu.cdc import CdcConfig` (the
    # config.py import at CLI startup) from paying for numpy-touching
    # submodules.
    if name == "CdcManager":
        from .manager import CdcManager

        return CdcManager
    if name in ("CdcRecord", "decode_cdc_records", "encode_cdc_record"):
        from . import log as _log

        return getattr(_log, name)
    raise AttributeError(name)
