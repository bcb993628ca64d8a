"""Geo replication: follower clusters tailing the leader's CDC stream.

The WAN story for ROADMAP item 3 (edge reads near the traffic, writes
funneled home), assembled from parts that already exist:

  feed       the leader's per-index change stream (GET /cdc/stream,
             cdc/log.py): position-dense, incarnation-fenced, resumable
             from any retained cursor, with roaring base images
             (GET /cdc/bootstrap) for cold starts and 410 recovery.

  tail       geo/tail.py long-polls the stream per index through a
             durable checkpointed cursor and applies records through
             the idempotent anti-entropy merge path
             (Fragment.apply_hint_positions) — as durable as a direct
             write, so cursor + applied state survive follower SIGKILL
             with at-worst idempotent re-application.

  staleness  reads on a follower may carry `X-Pilosa-Max-Staleness: <s>`
             and are answered locally when the replication lag is
             within bound, else refused with a typed 409
             (errors.StaleReadError) carrying the current lag so the
             client can fail over to the leader. Lag derives from CDC
             positions + LEADER-stamped record times against the
             leader-reported head time — never a follower wall clock,
             so cross-cluster clock skew cancels out.

  promotion  leader loss triggers operator-initiated (POST /geo/promote)
             or probe-driven promotion with a fencing geo epoch that
             mirrors the routing-epoch machinery (max-merge
             authoritative, +1 on local promotion): the promoted
             follower bumps the epoch, the deposed leader's writes are
             refused with a typed 409 (errors.StaleGeoEpochError) and
             it demotes + re-tails; an aborted promotion fully reverts.

See docs/geo-replication.md. This package is jax-free (pilint R2):
config.py imports GeoConfig at CLI startup, and the tail/apply paths
run on numpy + stdlib through the holder's existing write machinery.
"""

from __future__ import annotations

from dataclasses import dataclass

_ROLES = ("none", "leader", "follower")


@dataclass
class GeoConfig:
    """The `[geo]` config section (TOML + env + CLI, config.py).
    See docs/geo-replication.md for how the knobs interact."""

    # Cluster role: "none" (default, no geo machinery), "leader" (serves
    # the CDC feed and accepts a demote handshake after losing a
    # fencing race), or "follower" (tails `leader`, refuses writes,
    # serves bounded-staleness reads).
    role: str = "none"
    # Leader cluster URL a follower tails (host:port or http://...).
    # Required when role = "follower".
    leader: str = ""
    # Per-link breaker backoff after a failed leader contact: starts
    # here and doubles per consecutive failure up to backoff-max, then
    # resets on the first success (seconds).
    backoff: float = 0.5
    backoff_max: float = 30.0
    # Probe-driven promotion: when enabled, a follower that fails this
    # many CONSECUTIVE leader contacts promotes itself (bumping the geo
    # epoch) instead of waiting for an operator's POST /geo/promote.
    # Off by default — auto-promotion on a mere partition risks a
    # deposed-but-alive leader serving writes until the fence lands.
    probe_promote: bool = False
    probe_failures: int = 6

    def validate(self) -> "GeoConfig":
        self.probe_promote = bool(self.probe_promote)
        if self.role not in _ROLES:
            raise ValueError(
                f"geo.role must be one of {', '.join(_ROLES)}; got "
                f"{self.role!r}")
        if self.role == "follower" and not self.leader:
            raise ValueError("geo.leader is required when geo.role is "
                             "'follower'")
        if self.backoff <= 0:
            raise ValueError("geo.backoff must be > 0")
        if self.backoff_max < self.backoff:
            raise ValueError("geo.backoff-max must be >= geo.backoff")
        if self.probe_failures < 1:
            raise ValueError("geo.probe-failures must be >= 1")
        return self


def __getattr__(name):
    # Lazy re-export keeps `from pilosa_tpu.geo import GeoConfig` (the
    # config.py import at CLI startup) from paying for the manager's
    # numpy-touching dependency chain.
    if name == "GeoManager":
        from .manager import GeoManager

        return GeoManager
    if name == "GeoTailer":
        from .tail import GeoTailer

        return GeoTailer
    raise AttributeError(name)
