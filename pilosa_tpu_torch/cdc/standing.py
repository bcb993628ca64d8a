"""Standing queries: registered read expressions re-evaluated and
re-pushed only when their index actually changed.

POST /cdc/standing registers a read-only PQL expression (Count / TopN /
Row and friends). The expression is canonicalized through plan/ —
respelled argument order and commutative operand order produce the SAME
registration (one evaluation serves them all). Staleness detection is
the index write epoch (core/fragment.WriteEpoch, bumped by every
mutation in the index and by schema drops): the evaluator sweep
compares each registration's last-evaluated epoch token against the
live one and re-executes ONLY the stale ones; of those, only results
that actually CHANGED re-push to long-poll waiters (a write to an
unrelated row re-evaluates but does not wake consumers).

Per-registration counters (evals / pushes / stale) feed the `cdc`
/debug/vars group, so "evaluator churn without pushes" is observable.

Jax-free (pilint R2).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Dict, Optional, Tuple

from ..errors import PilosaError, QueryError
from ..obs import span as obs_span


class StandingQueryError(QueryError):
    pass


def _canonical_sig(holder, index: str, call) -> tuple:
    """Canonical identity of a read expression. Bitmap subtrees go
    through plan/'s slotted canonical IR (cached_plan), which absorbs
    commutative reordering and flattening; wrapper calls (Count, TopN)
    keep their name + sorted args around canonicalized children. Falls
    back to the Call's own sorted-args string form for shapes the plan
    builder refuses (still dedupes respelled argument order)."""
    from ..plan.signature import cached_plan

    try:
        return ("plan",) + cached_plan(holder, index, call,
                                       enabled=False).sig_tuple
    except PilosaError:
        pass
    kids = tuple(_canonical_sig(holder, index, ch) for ch in call.children)
    args = tuple((k, repr(call.args[k])) for k in call.keys())
    return ("call", call.name, args, kids)


class StandingQuery:
    def __init__(self, sid: str, index: str, pql: str, call, sig: tuple):
        self.id = sid
        self.index = index
        self.pql = pql
        self.call = call
        self.sig = sig
        # Epoch token at the last evaluation; None = never evaluated.
        self.last_epoch: Optional[Tuple[int, int]] = None
        # json.dumps of the serialized result — the change detector.
        self.last_result: Optional[str] = None
        self.version = 0
        self.evals = 0
        self.pushes = 0
        self.stale = 0
        self.error: Optional[str] = None
        self.cond = threading.Condition()

    def to_dict(self) -> dict:
        d = {
            "id": self.id,
            "index": self.index,
            "pql": self.pql,
            "version": self.version,
            "evals": self.evals,
            "pushes": self.pushes,
            "stale": self.stale,
        }
        if self.last_result is not None:
            d["result"] = json.loads(self.last_result)
        if self.error is not None:
            d["error"] = self.error
        return d


class StandingRegistry:
    def __init__(self, manager):
        self.manager = manager
        self._mu = threading.Lock()
        self._by_id: Dict[str, StandingQuery] = {}
        self._by_sig: Dict[Tuple[str, tuple], str] = {}
        self.closed = False

    # ------------------------------------------------------------ registry

    def register(self, index: str, pql: str) -> Tuple[StandingQuery, bool]:
        """Returns (query, created). A respelling of an existing
        registration returns the existing one (created=False)."""
        from ..errors import IndexNotFoundError
        from ..pql import parser as pql_parser

        holder = self.manager.holder
        if holder is None or holder.index(index) is None:
            raise IndexNotFoundError(index)
        q = pql_parser.parse(pql)
        if len(q.calls) != 1:
            raise StandingQueryError(
                "standing queries register exactly one call")
        call = q.calls[0]
        if q.write_calls():
            raise StandingQueryError(
                f"standing queries must be read-only, got {call.name}()")
        sig = _canonical_sig(holder, index, call)
        sid = hashlib.blake2b(
            repr((index, sig)).encode(), digest_size=8).hexdigest()
        with self._mu:
            if self.closed:
                raise StandingQueryError("cdc manager is closed")
            got = self._by_sig.get((index, sig))
            if got is not None:
                return self._by_id[got], False
            sq = StandingQuery(sid, index, pql, call, sig)
            self._by_id[sid] = sq
            self._by_sig[(index, sig)] = sid
            return sq, True

    def get(self, sid: str) -> StandingQuery:
        with self._mu:
            sq = self._by_id.get(sid)
        if sq is None:
            raise StandingQueryError(f"no standing query {sid!r}")
        return sq

    def delete(self, sid: str) -> None:
        with self._mu:
            sq = self._by_id.pop(sid, None)
            if sq is not None:
                self._by_sig.pop((sq.index, sq.sig), None)
        if sq is None:
            raise StandingQueryError(f"no standing query {sid!r}")
        with sq.cond:
            sq.cond.notify_all()

    def list(self) -> list:
        with self._mu:
            sqs = sorted(self._by_id.values(), key=lambda s: s.id)
        return [sq.to_dict() for sq in sqs]

    def close(self) -> None:
        with self._mu:
            self.closed = True
            sqs = list(self._by_id.values())
        for sq in sqs:
            with sq.cond:
                sq.cond.notify_all()

    # ----------------------------------------------------------- evaluator

    def _epoch_token(self, index: str) -> Optional[Tuple[int, int]]:
        holder = self.manager.holder
        idx = holder.index(index) if holder else None
        if idx is None:
            return None
        ep = idx.write_epoch
        # incarnation distinguishes a recreated index whose fresh counter
        # climbed back to an old value (same rule as the plan cache).
        return (ep.incarnation, ep.value)

    def evaluate_once(self) -> int:
        """One staleness sweep: re-execute every registration whose index
        epoch moved since its last evaluation (or that never ran), push
        (version bump + long-poll wake) only those whose RESULT changed.
        Returns the number of evaluations performed."""
        from ..pql.ast import Query

        with self._mu:
            sqs = list(self._by_id.values())
        evaluated = 0
        for sq in sqs:
            token = self._epoch_token(sq.index)
            if token is None:
                continue  # index gone; a recreate gets a fresh token
            if sq.last_epoch == token and sq.error is None:
                continue  # provably unchanged: skip without executing
            if sq.last_epoch is not None and sq.last_epoch != token:
                sq.stale += 1
            with obs_span("cdc.standing-eval", index=sq.index, id=sq.id):
                # Token read BEFORE executing: a write landing mid-
                # evaluation bumps the live epoch past this token, so the
                # next sweep re-evaluates — results never stick stale.
                try:
                    results = self.manager.executor.execute(
                        sq.index, Query(calls=[sq.call]))
                except PilosaError as e:
                    sq.error = str(e)
                    sq.last_epoch = token
                    continue
            from ..server.api import serialize_result

            evaluated += 1
            sq.evals += 1
            sq.error = None
            sq.last_epoch = token
            encoded = json.dumps(serialize_result(results[0]), sort_keys=True)
            if encoded != sq.last_result:
                with sq.cond:
                    sq.last_result = encoded
                    sq.version += 1
                    sq.pushes += 1
                    sq.cond.notify_all()
        return evaluated

    def poll(self, sid: str, after_version: int,
             timeout: float) -> dict:
        """Long-poll one registration: returns as soon as its version
        exceeds `after_version` (or immediately if it already does),
        else after `timeout` seconds with the current state."""
        sq = self.get(sid)
        deadline = time.monotonic() + max(0.0, timeout)
        with sq.cond:
            while sq.version <= after_version and not self.closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # pilint: allow-blocking(long-poll wait point: releases the registration lock while parked; pushes wake it)
                sq.cond.wait(remaining)
        return sq.to_dict()

    def snapshot(self) -> dict:
        with self._mu:
            sqs = list(self._by_id.values())
        return {
            "registered": len(sqs),
            "evals": sum(s.evals for s in sqs),
            "pushes": sum(s.pushes for s in sqs),
            "stale": sum(s.stale for s in sqs),
        }
