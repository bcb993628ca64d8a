"""pmux — the multiplexed binary internal transport (docs/transport.md).

Every node-to-node hop used to pay stdlib ``http.client`` setup plus
per-request ``X-Pilosa-*`` string headers. This module replaces that
with ONE persistent connection per peer pair carrying length-prefixed,
crc-guarded frames with stream-id multiplexing:

- N concurrent requests to a peer share one socket; responses come
  back out of order, matched by stream id.
- Concurrent sends combine: whichever thread holds the write lock
  drains everything queued behind it in a single ``sendall`` (a
  writev-style batch), so an executor fan-out to a peer leaves in one
  syscall.
- The cross-cutting metadata (epoch, deadline, trace id, tenant,
  consistency, cluster key) rides as fixed binary meta fields, not
  re-stamped string headers. Payload slots are opaque bytes — the
  existing codecs (WAL/hint op records, plane/fragment bytes, wire.py
  query results) pass through verbatim.
- The server side feeds frames straight into ``Handler.dispatch``, so
  every route, the 409 stale-epoch gate, deadline budgets, and tenant
  admission behave identically on both transports.
- A failed version/key handshake demotes the peer (breaker-style
  backoff) and the caller falls back to HTTP, so mixed or
  mux-disabled clusters keep serving.

The module is import-light and jax-free (pilint R2): config.py imports
``TransportConfig`` from here at CLI startup.

Frame grammar (all integers network byte order)::

    header  := length:u32 stream_id:u32 kind:u8 flags:u8 meta_len:u16 crc:u32
    frame   := header meta[meta_len] payload[length - meta_len]
    meta    := nfields:u8 (field_id:u8 field_len:u16 field_bytes)*

``crc`` is zlib.crc32 over meta+payload. ``flags`` is reserved (0).
"""

import hmac
import json
import logging
import socket
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from urllib.parse import parse_qs

from .. import failpoints
from ..errors import PilosaError

logger = logging.getLogger("pilosa.mux")

# Protocol version spoken by this build. A peer that answers HELLO with
# a different version is demoted to HTTP — never "best effort" framing.
MUX_VERSION = 1

# Magic payload on HELLO so a stray TCP client can't make the server
# block parsing garbage as frames.
_MAGIC = b"PMUX"

_HEADER = struct.Struct("!IIBBHI")  # length, stream_id, kind, flags, meta_len, crc
HEADER_LEN = _HEADER.size

# Frame kinds.
KIND_HELLO = 1
KIND_HELLO_ACK = 2
KIND_CALL = 3
KIND_RESP = 4

# Meta field ids. Fixed fields replace the per-request X-Pilosa-*
# string headers (client.py used to re-stamp five of them per hop);
# anything else rides M_HEADERS as a JSON dict so no route loses
# information when it flips transports.
M_METHOD = 1
M_PATH = 2  # path?query, exactly as it would appear in the HTTP request line
M_CONTENT_TYPE = 3
M_ACCEPT = 4
M_DEADLINE = 5
M_EPOCH = 6
M_TRACE = 7
M_TENANT = 8
M_CONSISTENCY = 9
M_STATUS = 10
M_HEADERS = 11
M_VERSION = 12
M_KEY = 13
M_NODE = 14
M_ERROR = 15

# Fixed-field <-> header-name map, shared by both directions so the
# translation cannot drift between client and server.
_FIXED_REQ_FIELDS = (
    (M_DEADLINE, "x-pilosa-deadline"),
    (M_EPOCH, "x-pilosa-epoch"),
    (M_TRACE, "x-pilosa-trace"),
    (M_TENANT, "x-pilosa-tenant"),
    (M_CONSISTENCY, "x-pilosa-consistency"),
)


class MuxError(PilosaError):
    """A mux request failed. Unless it is a MuxUnsent, the frame may
    have been in flight (the combining writer can flush a caller's
    frame in an earlier chunk before a later chunk's sendall fails),
    so callers surface it exactly like an HTTP socket error and NEVER
    silently replay a non-idempotent call on it."""


class MuxUnsent(MuxError):
    """The failure happened strictly BEFORE the frame was enqueued to
    the writer: no byte of it was ever handed to a sendall, so the
    peer provably never saw the call. This is the only MuxError a
    non-idempotent request may be silently retried on — the exact
    analogue of the HTTP client's fresh-connection rule."""


class MuxFrameTooLarge(MuxUnsent):
    """The frame exceeds frame-max-bytes (or a meta field exceeds the
    64 KiB field cap). Raised before anything is enqueued; the
    connection stays healthy and the caller routes around the mux."""


class MuxProtocolError(MuxError):
    """The byte stream violated the frame grammar (torn frame, bad
    crc, oversized length, unexpected kind). The connection that
    produced it is unconditionally torn down — framing is lost — but
    other peers' connections are untouched."""


class MuxClosed(MuxError):
    """Clean EOF at a frame boundary (peer closed the connection)."""


class MuxUnavailable(PilosaError):
    """The mux path cannot carry this request (disabled, peer demoted,
    handshake failed, inflight cap full, oversized frame). The caller
    falls back to plain HTTP; this is routing, not an error."""


def split_host_port(netloc):
    """Split ``host:port`` / ``[v6]:port`` / bare host into
    ``(host, port_or_None)``.

    This is THE internal host:port splitter — the protobuf envelope
    codec and the mux dialer both use it so bracketed and bare-colon
    IPv6 forms parse one way everywhere.

    - ``[2001:db8::1]:10101`` -> ("2001:db8::1", 10101)
    - ``[2001:db8::1]``       -> ("2001:db8::1", None)
    - ``localhost:10101``     -> ("localhost", 10101)
    - ``::1`` (bare IPv6)     -> ("::1", None)
    - ``localhost``           -> ("localhost", None)
    """
    if netloc.startswith("["):
        end = netloc.find("]")
        if end < 0:
            raise ValueError(f"unclosed bracket in netloc: {netloc!r}")
        host = netloc[1:end]
        rest = netloc[end + 1:]
        if not rest:
            return host, None
        if not rest.startswith(":"):
            raise ValueError(f"junk after bracketed host in netloc: {netloc!r}")
        return host, int(rest[1:])
    if netloc.count(":") == 1:
        host, _, port = netloc.rpartition(":")
        return host, int(port)
    # Zero colons (plain host) or 2+ colons (bare IPv6 literal).
    return netloc, None


# --------------------------------------------------------------- config


@dataclass
class TransportConfig:
    """[transport] config section (docs/transport.md)."""

    enabled: bool = False
    port_offset: int = 1000
    max_frames_inflight: int = 64
    frame_max_bytes: int = 64 * 1024 * 1024
    handshake_timeout: float = 2.0

    def validate(self):
        if self.port_offset <= 0 or self.port_offset > 60000:
            raise ValueError(
                "transport.port-offset must be in (0, 60000], got "
                f"{self.port_offset}"
            )
        if self.max_frames_inflight < 1:
            raise ValueError(
                "transport.max-frames-inflight must be >= 1, got "
                f"{self.max_frames_inflight}"
            )
        if self.frame_max_bytes < 4096:
            raise ValueError(
                "transport.frame-max-bytes must be >= 4096, got "
                f"{self.frame_max_bytes}"
            )
        if self.handshake_timeout <= 0:
            raise ValueError(
                "transport.handshake-timeout must be > 0, got "
                f"{self.handshake_timeout}"
            )
        return self


# ---------------------------------------------------------------- stats


class TransportStats:
    """Thread-safe transport counters, surfaced as the ``transport``
    group in /debug/vars and aggregated by diagnostics.gather()."""

    _FIELDS = (
        "connects", "reconnects", "accepts", "handshake_fallbacks",
        "frames_sent", "frames_received", "bytes_sent", "bytes_received",
        "batched_frames", "protocol_errors", "requests_mux",
        "requests_http",
    )

    def __init__(self):
        self._mu = threading.Lock()
        self._c = {f: 0 for f in self._FIELDS}
        self._inflight_hwm = 0

    def bump(self, field, n=1):
        with self._mu:
            self._c[field] += n

    def note_inflight(self, n):
        with self._mu:
            if n > self._inflight_hwm:
                self._inflight_hwm = n

    def snapshot(self):
        with self._mu:
            out = dict(self._c)
            out["inflight_hwm"] = self._inflight_hwm
        return out


# ---------------------------------------------------------- frame codec


def encode_meta(fields):
    """fields: dict {field_id: bytes} -> meta bytes."""
    parts = [struct.pack("!B", len(fields))]
    for fid, val in fields.items():
        if len(val) > 0xFFFF:
            raise MuxFrameTooLarge(
                f"meta field {fid} too large ({len(val)} bytes)"
            )
        parts.append(struct.pack("!BH", fid, len(val)))
        parts.append(val)
    return b"".join(parts)


def decode_meta(data):
    """meta bytes -> dict {field_id: bytes}; raises MuxProtocolError."""
    try:
        (n,) = struct.unpack_from("!B", data, 0)
        off = 1
        fields = {}
        for _ in range(n):
            fid, flen = struct.unpack_from("!BH", data, off)
            off += 3
            if off + flen > len(data):
                raise MuxProtocolError("torn frame: meta field overruns meta block")
            fields[fid] = data[off:off + flen]
            off += flen
        if off != len(data):
            raise MuxProtocolError("torn frame: trailing bytes after meta fields")
        return fields
    except struct.error as e:
        raise MuxProtocolError(f"torn frame: truncated meta block: {e}") from e


def encode_frame(kind, stream_id, meta_fields, payload):
    meta = encode_meta(meta_fields)
    body = meta + payload
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return _HEADER.pack(len(body), stream_id, kind, 0, len(meta), crc) + body


class _FrameIO:
    """Framing over one socket: combining writes, exact reads.

    The write side is the writev-style batcher: frames queued while
    another thread is flushing ride that thread's single ``sendall``.
    """

    def __init__(self, sock, frame_max_bytes, stats=None):
        self.sock = sock
        self.frame_max = frame_max_bytes
        self.stats = stats
        self._wmu = threading.Lock()
        self._wbuf = []
        self._flushing = False
        self._werr = None

    # -- write side

    def send_frame(self, kind, stream_id, meta_fields, payload):
        data = encode_frame(kind, stream_id, meta_fields, payload)
        if len(data) - HEADER_LEN > self.frame_max:
            raise MuxFrameTooLarge(
                f"frame of {len(data) - HEADER_LEN} bytes exceeds "
                f"frame-max-bytes={self.frame_max}"
            )
        with self._wmu:
            if self._werr is not None:
                # The frame was never enqueued: provably unsent.
                raise MuxUnsent(f"connection already failed: {self._werr}")
            self._wbuf.append(data)
            if self._flushing:
                # Another thread is mid-flush; it will pick this frame
                # up in its next combined sendall (and count it there,
                # once that sendall succeeds).
                if self.stats:
                    self.stats.bump("batched_frames")
                return
            self._flushing = True
        try:
            while True:
                with self._wmu:
                    if not self._wbuf:
                        self._flushing = False
                        return
                    frames, self._wbuf = self._wbuf, []
                chunk = b"".join(frames)
                self.sock.sendall(chunk)
                # Counted only after the sendall that carried them
                # succeeded — a failed flush must not inflate the wire
                # counters the bench reads.
                if self.stats:
                    self.stats.bump("frames_sent", len(frames))
                    self.stats.bump("bytes_sent", len(chunk))
        except OSError as e:
            with self._wmu:
                self._werr = e
                self._flushing = False
                self._wbuf = []
            # NOT MuxUnsent: this thread's own frame may have gone out
            # in an earlier successful chunk of this flush loop, so the
            # peer may already be dispatching it.
            raise MuxError(f"frame send failed: {e}") from e

    # -- read side

    def _read_exact(self, n, what):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                if not buf and what == "frame header":
                    # EOF exactly on a frame boundary: clean close.
                    raise MuxClosed("connection closed by peer")
                raise MuxProtocolError(
                    f"torn frame: EOF after {len(buf)}/{n} bytes of {what}"
                )
            buf += chunk
        return buf

    def read_frame(self):
        """-> (kind, stream_id, meta_fields, payload).

        Raises MuxClosed on clean EOF, MuxProtocolError on a torn
        frame / bad crc / oversized length, OSError on socket faults.
        """
        hdr = self._read_exact(HEADER_LEN, "frame header")
        length, stream_id, kind, _flags, meta_len, crc = _HEADER.unpack(hdr)
        if length > self.frame_max:
            raise MuxProtocolError(
                f"frame length {length} exceeds frame-max-bytes={self.frame_max}"
            )
        if meta_len > length:
            raise MuxProtocolError(
                f"meta_len {meta_len} exceeds frame length {length}"
            )
        body = self._read_exact(length, "frame body") if length else b""
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise MuxProtocolError("crc mismatch on frame body")
        meta = decode_meta(body[:meta_len])
        if self.stats:
            self.stats.bump("frames_received")
            self.stats.bump("bytes_received", HEADER_LEN + length)
        return kind, stream_id, meta, body[meta_len:]

    def close(self):
        # Shut the socket down before closing it: a close() alone does not
        # end a connection whose reader thread is blocked in recv(), so
        # the peer would never see it end.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _req_meta(method, target, content_type, accept, headers):
    """Build CALL meta from an HTTP-shaped request. Known X-Pilosa-*
    headers become fixed binary fields; the rest ride one JSON blob."""
    fields = {
        M_METHOD: method.encode("ascii"),
        M_PATH: target.encode("utf-8"),
    }
    if content_type:
        fields[M_CONTENT_TYPE] = content_type.encode("latin-1")
    if accept:
        fields[M_ACCEPT] = accept.encode("latin-1")
    rest = {}
    if headers:
        lowered = {k.lower(): v for k, v in headers.items()}
        for fid, hname in _FIXED_REQ_FIELDS:
            v = lowered.pop(hname, None)
            if v is not None:
                fields[fid] = str(v).encode("latin-1")
        lowered.pop("content-type", None)
        lowered.pop("accept", None)
        if lowered:
            rest = lowered
    if rest:
        fields[M_HEADERS] = json.dumps(rest).encode("utf-8")
    return fields


def _meta_to_headers(meta, key):
    """Reverse of _req_meta on the server side: reconstruct the
    lowercased header dict Handler.dispatch expects. The connection
    handshake is the auth boundary, so the cluster key is stamped
    back in as if the peer had sent the header."""
    headers = {}
    if M_HEADERS in meta:
        try:
            extras = json.loads(meta[M_HEADERS].decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise MuxProtocolError(f"bad M_HEADERS json: {e}") from e
        for k, v in extras.items():
            headers[str(k).lower()] = str(v)
    for fid, hname in _FIXED_REQ_FIELDS:
        if fid in meta:
            headers[hname] = meta[fid].decode("latin-1")
    if M_CONTENT_TYPE in meta:
        headers["content-type"] = meta[M_CONTENT_TYPE].decode("latin-1")
    if M_ACCEPT in meta:
        headers["accept"] = meta[M_ACCEPT].decode("latin-1")
    if key:
        headers["x-pilosa-key"] = key
    return headers


# ----------------------------------------------------------- client side


class _Waiter:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result = None


class _ClientConn:
    """One handshaken client connection to a peer. Waiters are keyed
    by stream id; a dedicated daemon reader thread demultiplexes
    responses. Any protocol/socket fault fails every pending waiter
    and tears this connection down — other peers are untouched."""

    def __init__(self, netloc, sock, config, stats):
        self.netloc = netloc
        self.config = config
        self.stats = stats
        self.io = _FrameIO(sock, config.frame_max_bytes, stats)
        self.closed = False
        self._mu = threading.Lock()
        self._next_sid = 1
        self._waiters = {}
        self._reader = threading.Thread(
            target=self._read_loop, name=f"mux-reader:{netloc}", daemon=True
        )

    def start(self):
        self._reader.start()

    def send_call(self, meta_fields, payload):
        """Register a waiter and enqueue the CALL frame. Raises
        MuxUnavailable when the inflight cap is full (caller falls
        back to HTTP), MuxError when the connection is dead."""
        with self._mu:
            if self.closed:
                # Nothing was built, let alone enqueued.
                raise MuxUnsent("connection closed")
            if len(self._waiters) >= self.config.max_frames_inflight:
                raise MuxUnavailable(
                    f"{len(self._waiters)} frames inflight to {self.netloc} "
                    "(max-frames-inflight reached)"
                )
            sid = self._next_sid
            self._next_sid += 1
            waiter = _Waiter()
            self._waiters[sid] = waiter
            if self.stats:
                self.stats.note_inflight(len(self._waiters))
        try:
            self.io.send_frame(KIND_CALL, sid, meta_fields, payload)
        except MuxError as e:
            with self._mu:
                self._waiters.pop(sid, None)
            if not isinstance(e, MuxUnsent):
                # A flush failure kills the socket for everyone: frames
                # other threads enqueued behind the failing chunk were
                # dropped, so fail their waiters now instead of letting
                # them hang until the reader notices the dead socket.
                self._teardown(
                    MuxError(f"mux send to {self.netloc} failed: {e}"))
            raise
        return sid, waiter

    def abandon(self, sid):
        with self._mu:
            self._waiters.pop(sid, None)

    def _read_loop(self):
        err = None
        try:
            while True:
                kind, sid, meta, payload = self.io.read_frame()
                failpoints.fire("mux-frame-recv", target=self.netloc)
                if kind != KIND_RESP:
                    raise MuxProtocolError(
                        f"unexpected frame kind {kind} from {self.netloc}"
                    )
                with self._mu:
                    waiter = self._waiters.pop(sid, None)
                if waiter is None:
                    continue  # abandoned (caller timed out); drop it
                waiter.result = (kind, meta, payload)
                waiter.event.set()
        except MuxClosed as e:
            err = MuxError(f"mux connection to {self.netloc} closed: {e}")
        except MuxProtocolError as e:
            if self.stats:
                self.stats.bump("protocol_errors")
            err = e
        except OSError as e:
            err = MuxError(f"mux recv from {self.netloc} failed: {e}")
        self._teardown(err)

    def _teardown(self, err):
        with self._mu:
            if self.closed:
                return
            self.closed = True
            waiters = list(self._waiters.values())
            self._waiters.clear()
        self.io.close()
        for w in waiters:
            w.result = err or MuxError("connection torn down")
            w.event.set()

    def close(self):
        self._teardown(MuxError("transport closed"))


class MuxTransport:
    """Client half of pmux: per-peer persistent connections with
    handshake, demotion, and HTTP fallback signalling.

    ``request`` either returns ``(status, data, resp_headers)``,
    raises MuxUnavailable (caller should use HTTP), or raises
    MuxError/MuxProtocolError (a real transport failure — caller
    surfaces it exactly like an HTTP socket error so breakers, retry
    budgets, and hedging see the same evidence)."""

    # A failed handshake demotes the peer for this long before the
    # next mux attempt (breaker-style backoff; HTTP keeps serving).
    DEMOTE_S = 5.0

    def __init__(self, config, key=None, node_uri=None, timeout=30.0,
                 stats=None, clock=time.monotonic):
        self.config = config
        self.key = key or ""
        self.node_uri = node_uri or ""
        self.timeout = timeout
        self.stats = stats or TransportStats()
        self.clock = clock
        self._mu = threading.Lock()
        self._conns = {}
        self._dial_locks = {}
        self._demoted_until = {}
        self._closed = False

    # -- connection management

    def _conn(self, netloc):
        with self._mu:
            if self._closed:
                raise MuxUnavailable("transport closed")
            conn = self._conns.get(netloc)
            if conn is not None and not conn.closed:
                return conn
            until = self._demoted_until.get(netloc, 0.0)
            if self.clock() < until:
                raise MuxUnavailable(
                    f"peer {netloc} demoted to HTTP for "
                    f"{until - self.clock():.1f}s more"
                )
            lock = self._dial_locks.setdefault(netloc, threading.Lock())
        with lock:
            with self._mu:
                # Re-check under the dial lock: while this thread waited,
                # another may have dialed (reuse its connection), failed
                # and demoted the peer (honor the backoff instead of
                # immediately re-dialing a down peer), or closed the
                # whole transport.
                if self._closed:
                    raise MuxUnavailable("transport closed")
                conn = self._conns.get(netloc)
                if conn is not None and not conn.closed:
                    return conn
                had_prior = conn is not None
                until = self._demoted_until.get(netloc, 0.0)
                if self.clock() < until:
                    raise MuxUnavailable(
                        f"peer {netloc} demoted to HTTP for "
                        f"{until - self.clock():.1f}s more"
                    )
            conn = self._dial(netloc, had_prior)
            with self._mu:
                if self._closed:
                    conn.close()
                    raise MuxUnavailable("transport closed")
                self._conns[netloc] = conn
            return conn

    def _dial(self, netloc, had_prior):
        """Dial + version/key handshake. Any failure demotes the peer
        and raises MuxUnavailable so the request rides HTTP."""
        try:
            failpoints.fire("mux-handshake", target=netloc)
            host, port = split_host_port(netloc)
            if port is None:
                raise MuxError(f"netloc {netloc!r} has no port")
            # Only the per-NETLOC dial lock is held here: it exists to
            # serialize concurrent dials to the SAME peer; the registry
            # lock is never held across the dial.
            # pilint: allow-blocking(per-netloc dial lock serializes same-peer dials only)
            sock = socket.create_connection(
                (host, port + self.config.port_offset),
                timeout=self.config.handshake_timeout,
            )
        except (OSError, ValueError, MuxError) as e:
            self._demote(netloc, e)
            raise MuxUnavailable(f"mux dial to {netloc} failed: {e}") from e
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            io = _FrameIO(sock, self.config.frame_max_bytes, self.stats)
            hello = {
                M_VERSION: str(MUX_VERSION).encode("ascii"),
                # utf-8 on BOTH sides (the server compares the raw meta
                # bytes against key.encode()): unlike HTTP headers the
                # meta slot is binary-clean, so a non-latin-1 cluster
                # key must not be mangled into a guaranteed mismatch.
                M_KEY: self.key.encode("utf-8"),
            }
            if self.node_uri:
                hello[M_NODE] = self.node_uri.encode("utf-8")
            io.send_frame(KIND_HELLO, 0, hello, _MAGIC)
            kind, _sid, meta, _payload = io.read_frame()
            if kind != KIND_HELLO_ACK:
                raise MuxError(f"expected HELLO_ACK, got frame kind {kind}")
            if M_ERROR in meta:
                raise MuxError(
                    f"peer rejected handshake: "
                    f"{meta[M_ERROR].decode('utf-8', 'replace')}"
                )
            peer_ver = int(meta.get(M_VERSION, b"0"))
            if peer_ver != MUX_VERSION:
                raise MuxError(
                    f"version mismatch: peer speaks {peer_ver}, "
                    f"we speak {MUX_VERSION}"
                )
            sock.settimeout(None)
        except (OSError, MuxError, ValueError) as e:
            try:
                sock.close()
            except OSError:
                pass
            self._demote(netloc, e)
            raise MuxUnavailable(
                f"mux handshake with {netloc} failed: {e}"
            ) from e
        conn = _ClientConn(netloc, sock, self.config, self.stats)
        conn.io = io  # keep the handshake's framer (shares write state)
        conn.start()
        self.stats.bump("reconnects" if had_prior else "connects")
        with self._mu:
            self._demoted_until.pop(netloc, None)
        return conn

    def _demote(self, netloc, err):
        self.stats.bump("handshake_fallbacks")
        with self._mu:
            self._demoted_until[netloc] = self.clock() + self.DEMOTE_S
        logger.info("mux: demoting %s to HTTP for %.1fs: %s",
                    netloc, self.DEMOTE_S, err)

    # -- request path

    def request(self, method, netloc, target, body=b"",
                content_type=None, accept=None, headers=None,
                idempotent=False):
        """One multiplexed request/response over the peer connection.

        ``idempotent=True`` marks a call whose replay is harmless even
        though its method is POST (e.g. PQL forwards: every WRITE_CALL
        has value semantics), widening the retry-over-HTTP escape for
        undeliverable responses beyond GET/HEAD.

        -> (status:int, data:bytes, resp_headers:dict lowercased)
        """
        if not self.config.enabled:
            raise MuxUnavailable("transport disabled")
        body = body or b""
        meta_fields = _req_meta(method, target, content_type, accept, headers)
        approx = len(body) + sum(len(v) + 3 for v in meta_fields.values()) + 1
        if approx > self.config.frame_max_bytes:
            # Oversized payloads (e.g. a giant migration chunk with a
            # small frame-max-bytes) ride HTTP rather than failing.
            raise MuxUnavailable(
                f"{approx}-byte request exceeds frame-max-bytes="
                f"{self.config.frame_max_bytes}"
            )
        waiter = None
        for attempt in (0, 1):
            try:
                # Chaos parity: per-peer client-send scoping keeps
                # injecting faults when the transport flips to mux,
                # and mux-frame-send is the mux-specific hook. Both
                # fire before the frame is enqueued, so a failure
                # here is provably-unsent and one silent redial
                # mirrors the HTTP fresh-connection retry.
                failpoints.fire("client-send", target=netloc)
                failpoints.fire("mux-frame-send", target=netloc)
                conn = self._conn(netloc)
                _sid, waiter = conn.send_call(meta_fields, body)
                break
            except MuxUnavailable:
                raise
            except MuxFrameTooLarge as e:
                # The approx guard above under-counted; nothing was
                # enqueued, so routing the request over HTTP is safe.
                raise MuxUnavailable(str(e)) from e
            except (MuxUnsent, OSError) as e:
                # Provably unsent — the failure happened before any
                # byte of the frame was handed to a sendall (failpoint,
                # dial, dead-connection pre-check) — so ONE silent
                # redial is safe for ANY method: the exact HTTP
                # fresh-connection rule (client.py retry policy).
                if attempt == 0:
                    continue
                if isinstance(e, MuxError):
                    raise
                raise MuxError(f"mux send to {netloc} failed: {e}") from e
            except MuxError:
                # NOT provably unsent: the combining writer may have
                # flushed this frame in an earlier chunk before a later
                # chunk failed, so the peer may already be dispatching
                # the call. Mirror the HTTP pooled-connection policy —
                # surface the error, never silently replay a
                # possibly-dispatched (non-idempotent) call; upper
                # layers own non-idempotent recovery.
                raise
        if not waiter.event.wait(self.timeout):
            conn.abandon(_sid)
            # Slow is not torn: the connection stays up; only this
            # stream gives up (its eventual response is dropped).
            raise MuxError(
                f"mux response from {netloc} timed out after {self.timeout}s"
            )
        res = waiter.result
        if isinstance(res, Exception):
            raise res
        _kind, meta, payload = res
        if M_ERROR in meta:
            # The server dispatched the call but could not carry the
            # response over mux (it exceeded frame-max-bytes). Only
            # idempotent methods may transparently replay over HTTP —
            # the call DID run, so a non-idempotent replay could
            # double-apply; those surface the error status below.
            reason = meta[M_ERROR].decode("utf-8", "replace")
            if idempotent or method.upper() in ("GET", "HEAD"):
                raise MuxUnavailable(
                    f"peer {netloc} could not answer over mux "
                    f"({reason}); retrying over HTTP"
                )
        self.stats.bump("requests_mux")
        try:
            status = int(meta.get(M_STATUS, b"0"))
        except ValueError as e:
            raise MuxProtocolError(f"bad RESP status from {netloc}: {e}") from e
        rheaders = {}
        if M_HEADERS in meta:
            try:
                extras = json.loads(meta[M_HEADERS].decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise MuxProtocolError(
                    f"bad RESP headers from {netloc}: {e}"
                ) from e
            for k, v in extras.items():
                rheaders[str(k).lower()] = str(v)
        if M_CONTENT_TYPE in meta:
            rheaders["content-type"] = meta[M_CONTENT_TYPE].decode("latin-1")
        return status, payload, rheaders

    def snapshot(self):
        with self._mu:
            conns = {n: (not c.closed) for n, c in self._conns.items()}
            demoted = {
                n: round(max(0.0, t - self.clock()), 2)
                for n, t in self._demoted_until.items()
                if t > self.clock()
            }
        out = self.stats.snapshot()
        out["peers_connected"] = sum(1 for up in conns.values() if up)
        out["peers_demoted"] = len(demoted)
        return out

    def close(self):
        with self._mu:
            self._closed = True
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()


# ----------------------------------------------------------- server side


class MuxServer:
    """Server half of pmux: listens on http_port + port-offset,
    handshakes each connection (version + cluster key), and feeds CALL
    frames into Handler.dispatch on a bounded worker pool. Responses
    share the connection's combining writer, so concurrent responses
    to one peer also batch into single sends."""

    def __init__(self, handler, config, key=None, stats=None):
        self.handler = handler
        self.config = config
        self.key = key or ""
        self.stats = stats or TransportStats()
        self.port = None
        self._sock = None
        self._pool = None
        self._stop = threading.Event()
        self._accept_thread = None
        self._mu = threading.Lock()
        self._conns = set()

    def open(self, host, http_port):
        port = http_port + self.config.port_offset
        try:
            self._sock = socket.create_server(
                (host, port), backlog=64, reuse_port=False
            )
        except OSError as e:
            # Bind failure is survivable: peers that try mux get a
            # refused handshake and demote themselves to HTTP.
            logger.warning("mux: cannot listen on %s:%d (%s); "
                           "peers will fall back to HTTP", host, port, e)
            self._sock = None
            return
        self.port = port
        self._pool = ThreadPoolExecutor(
            max_workers=min(16, self.config.max_frames_inflight),
            thread_name_prefix="mux-srv",
        )
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"mux-accept:{port}", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(sock,),
                name="mux-conn", daemon=True,
            )
            t.start()

    def _serve_conn(self, sock):
        io = _FrameIO(sock, self.config.frame_max_bytes, self.stats)
        peer = None
        with self._mu:
            self._conns.add(io)
        try:
            sock.settimeout(self.config.handshake_timeout)
            kind, _sid, meta, payload = io.read_frame()
            if kind != KIND_HELLO or payload != _MAGIC:
                return  # not a pmux peer; drop silently
            peer_ver = int(meta.get(M_VERSION, b"0"))
            offered = meta.get(M_KEY, b"")
            peer = meta.get(M_NODE, b"").decode("utf-8") or None
            if peer_ver != MUX_VERSION:
                io.send_frame(KIND_HELLO_ACK, 0, {
                    M_VERSION: str(MUX_VERSION).encode("ascii"),
                    M_ERROR: b"version mismatch",
                }, b"")
                return
            # compare_digest on BYTES (handler.py does the same for the
            # HTTP header): the str overload raises TypeError on
            # non-ASCII input, which would crash the connection thread
            # instead of rejecting the handshake.
            if not hmac.compare_digest(offered, self.key.encode("utf-8")):
                io.send_frame(KIND_HELLO_ACK, 0, {
                    M_VERSION: str(MUX_VERSION).encode("ascii"),
                    M_ERROR: b"cluster key mismatch",
                }, b"")
                return
            io.send_frame(KIND_HELLO_ACK, 0, {
                M_VERSION: str(MUX_VERSION).encode("ascii"),
            }, b"")
            self.stats.bump("accepts")
            sock.settimeout(None)
            while not self._stop.is_set():
                kind, sid, meta, payload = io.read_frame()
                failpoints.fire("mux-frame-recv", target=peer)
                if kind != KIND_CALL:
                    raise MuxProtocolError(f"unexpected frame kind {kind}")
                self._pool.submit(self._handle_call, io, sid, meta, payload)
        except MuxClosed:
            pass
        except MuxProtocolError as e:
            self.stats.bump("protocol_errors")
            logger.info("mux: tearing down connection from %s: %s", peer, e)
        except (MuxError, OSError, ValueError) as e:
            # MuxError covers a failed HELLO_ACK send — without it the
            # connection thread would die with an unhandled traceback.
            logger.info("mux: connection from %s failed: %s", peer, e)
        finally:
            with self._mu:
                self._conns.discard(io)
            io.close()

    def _handle_call(self, io, sid, meta, payload):
        try:
            method = meta.get(M_METHOD, b"GET").decode("ascii")
            target = meta.get(M_PATH, b"/").decode("utf-8")
            headers = _meta_to_headers(meta, self.key)
            path, _, qs = target.partition("?")
            # Same normalization as the HTTP server (handler.py): a
            # trailing slash must not 404 on one transport only.
            path = path.rstrip("/") or "/"
            query = parse_qs(qs) if qs else {}
            result = self.handler.dispatch(
                method, path, query, payload, headers=headers
            )
            if isinstance(result, tuple):
                status, ctype, body = result[0], result[1], result[2]
                extra = result[3] if len(result) > 3 else {}
            else:
                status, ctype = 200, "application/json"
                body = json.dumps(result).encode("utf-8")
                extra = {}
            if isinstance(body, str):
                body = body.encode("utf-8")
        except Exception as e:  # mirror the HTTP server's 500-on-unhandled
            logger.exception("mux: unhandled error dispatching %s",
                             meta.get(M_PATH, b"?"))
            status, ctype = 500, "application/json"
            body = json.dumps({"error": str(e)}).encode("utf-8")
            extra = {}
        resp_meta = {
            M_STATUS: str(status).encode("ascii"),
            M_CONTENT_TYPE: (ctype or "application/octet-stream").encode("latin-1"),
        }
        if extra:
            resp_meta[M_HEADERS] = json.dumps(
                {str(k).lower(): str(v) for k, v in extra.items()}
            ).encode("utf-8")
        try:
            io.send_frame(KIND_RESP, sid, resp_meta, body or b"")
        except MuxFrameTooLarge as e:
            # The response doesn't fit a frame (frame-max-bytes or the
            # 64 KiB meta-field cap). Nothing was enqueued and the
            # connection is healthy, so answer with a SMALL error RESP:
            # the client fails fast (or, for idempotent calls, retries
            # over HTTP) instead of hanging its waiter until timeout
            # and feeding the breaker a phantom transport fault.
            err = json.dumps(
                {"error": f"mux response undeliverable: {e}"}
            ).encode("utf-8")
            try:
                io.send_frame(KIND_RESP, sid, {
                    M_STATUS: b"500",
                    M_CONTENT_TYPE: b"application/json",
                    M_ERROR: b"resp-too-large",
                }, err)
            except MuxError as e2:
                logger.info("mux: error response send failed: %s", e2)
        except MuxError as e:
            logger.info("mux: response send failed (peer gone?): %s", e)

    def snapshot(self):
        with self._mu:
            open_conns = len(self._conns)
        out = {"listening": self.port is not None, "port": self.port,
               "open_conns": open_conns}
        return out

    def close(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        with self._mu:
            conns = list(self._conns)
        for io in conns:
            io.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
