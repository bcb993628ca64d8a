"""Error catalog, mirroring the reference's public errors (pilosa.go:26-147)."""

import re


class PilosaError(Exception):
    """Base class for all framework errors."""

    message = "error"

    def __str__(self):
        detail = ", ".join(str(a) for a in self.args)
        return f"{self.message}: {detail}" if detail else self.message


class IndexExistsError(PilosaError):
    message = "index already exists"


class IndexNotFoundError(PilosaError):
    message = "index not found"


class FieldExistsError(PilosaError):
    message = "field already exists"


class FieldNotFoundError(PilosaError):
    message = "field not found"


class BSIGroupNotFoundError(PilosaError):
    message = "bsigroup not found"


class BSIGroupExistsError(PilosaError):
    message = "bsigroup already exists"


class InvalidBSIGroupTypeError(PilosaError):
    message = "invalid bsigroup type"


class InvalidBSIGroupRangeError(PilosaError):
    message = "invalid bsigroup range"


class InvalidViewError(PilosaError):
    message = "invalid view"


class InvalidCacheTypeError(PilosaError):
    message = "invalid cache type"


class InvalidFieldTypeError(PilosaError):
    message = "invalid field type"


class InvalidTimeQuantumError(PilosaError):
    message = "invalid time quantum"


class FragmentNotFoundError(PilosaError):
    message = "fragment not found"


class QueryError(PilosaError):
    message = "query error"


class TooManyWritesError(PilosaError):
    message = "too many writes"


class ClusterDoesNotOwnShardError(PilosaError):
    message = "node does not own shard"


class NodeIDNotExistsError(PilosaError):
    message = "node id does not exist"


class ColumnRowOutOfRangeError(PilosaError):
    message = "column or row out of range"


class TranslateStoreReadOnlyError(PilosaError):
    message = "translate store is read-only"


class ShardMovedError(PilosaError):
    """A write reached a fragment whose shard cut over to a new owner
    during a live rebalance (cluster/rebalance.py). Maps to HTTP 409;
    callers re-route on refreshed placement instead of retrying the
    same node."""

    message = "shard migrated to a new owner"


class StaleRoutingEpochError(PilosaError):
    """A forwarded request was stamped with a routing epoch older than
    the receiver's and touches shards the receiver no longer serves.
    Maps to HTTP 409: one re-route on refreshed placement — never an
    empty answer from a moved/GC'd shard, never a retry storm."""

    message = "stale routing epoch"


class WriteConsistencyError(PilosaError):
    """A write fan-out applied on fewer owners than the configured
    `[replication] write-consistency` level requires (applied == 0 is the
    degenerate total-owner-loss case). Maps to HTTP 503 — RETRYABLE: the
    cluster is degraded, not the request malformed, so clients and load
    balancers should back off and retry rather than fail the write. There
    is no rollback: the owners that applied keep the write, hints were
    enqueued for the missed owners before this raised, and a client retry
    re-applies idempotent set/clear ops."""

    message = "write consistency not met"

    def __init__(self, *args, level=None, required=None, applied=None):
        super().__init__(*args)
        self.level = level
        self.required = required
        self.applied = applied


class CdcGoneError(PilosaError):
    """A CDC cursor (stream resume point, point-in-time position, or
    bootstrap baseline) fell behind retention, or presents the
    incarnation of a deleted+recreated index whose positions restarted.
    Maps to HTTP 410 GONE — NOT retryable at the same cursor: the
    consumer must re-bootstrap from a fragment snapshot
    (GET /cdc/bootstrap) and resume from the position it was cut at."""

    message = "cdc position gone"

    def __init__(self, *args, first=None, last=None, incarnation=None):
        super().__init__(*args)
        self.first = first              # oldest retained position, when known
        self.last = last                # newest assigned position, when known
        self.incarnation = incarnation  # the log's current incarnation


class StaleReadError(PilosaError):
    """A read carried `X-Pilosa-Max-Staleness: <s>` to a geo follower
    whose replication lag exceeds the bound (pilosa_tpu/geo/,
    docs/geo-replication.md). Maps to HTTP 409 with the CURRENT lag in
    the payload so the client can decide: relax the bound and re-read
    here, or fail over to the leader. On a non-geo (single-cluster) node
    the header is a documented no-op — local reads are never stale."""

    message = "read staleness bound exceeded"

    def __init__(self, *args, lag=None, bound=None, position=None):
        super().__init__(*args)
        self.lag = lag            # current replication lag, seconds
        self.bound = bound        # the request's max-staleness bound
        self.position = position  # last applied CDC position, when known


class StaleGeoEpochError(PilosaError):
    """A write (or a promotion/demotion handshake) presented a geo epoch
    at or below a cluster that has already been fenced past it — the
    deposed-leader case: a follower promoted under a higher geo epoch,
    so the old leader's writes must be refused, never merged. Maps to
    HTTP 409; the deposed cluster demotes and re-tails the new leader
    (mirrors StaleRoutingEpochError, whose max-merge epoch machinery the
    geo epoch reuses)."""

    message = "stale geo epoch"

    def __init__(self, *args, epoch=None, current=None):
        super().__init__(*args)
        self.epoch = epoch      # the epoch the request presented, when known
        self.current = current  # this cluster's geo epoch


class CorruptFragmentError(PilosaError, ValueError):
    """On-disk fragment/bitmap data failed validation (bad cookie, bogus
    container payload, checksum-failing op record). Carries where the file
    stopped being trustworthy so quarantine/repair tooling can report it.

    Subclasses ValueError because that's what storage parsing historically
    raised — callers (and tests) matching ValueError keep working while new
    callers can catch the typed error and distinguish data corruption from
    programming errors.
    """

    message = "corrupt fragment data"

    def __init__(self, *args, path=None, offset=None):
        super().__init__(*args)
        self.path = path  # file the bad bytes came from, when known
        self.offset = offset  # byte offset of the offending record, when known


# Name validation (reference: pilosa.go validateName, ^[a-z][a-z0-9_-]{0,63}$).
_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


def validate_name(name: str) -> None:
    if not _NAME_RE.match(name or ""):
        raise PilosaError(f"invalid index or field name: {name!r}")
