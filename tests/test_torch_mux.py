"""The cases of tests/test_mux.py, run against the port on the CPU.

pmux internal transport tests (docs/transport.md).

Four tiers:
  - pure units: the host:port splitter the envelope codec shares, the
    meta/frame codec, TransportConfig validation;
  - framing over a socketpair: torn frames at EVERY boundary (header,
    mid-payload, crc) surface as typed MuxProtocolError, clean EOF as
    MuxClosed, and the combining writer really batches;
  - client/server halves over real sockets: multiplexed out-of-order
    responses, handshake rejection (version/key), demotion + fallback
    signalling, per-peer teardown isolation, and the three mux
    failpoints (mux-handshake / mux-frame-send / mux-frame-recv);
  - full 3-node clusters: serving entirely over mux, a mixed
    mux/HTTP cluster riding handshake fallback, and the seed-pinned
    chaos twin of the FAULT schedule with the transport enabled.
"""

import json
import socket
import struct
import threading
import time
import urllib.request

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cluster.hash import ModHasher
from pilosa_tpu_torch.cluster.health import ResilienceConfig
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.server.client import InternalClient
from pilosa_tpu_torch.server.mux import (
    HEADER_LEN,
    KIND_CALL,
    KIND_HELLO_ACK,
    KIND_RESP,
    M_EPOCH,
    M_HEADERS,
    M_METHOD,
    M_PATH,
    M_STATUS,
    M_VERSION,
    MUX_VERSION,
    MuxClosed,
    MuxError,
    MuxFrameTooLarge,
    MuxProtocolError,
    MuxUnavailable,
    MuxUnsent,
    MuxServer,
    MuxTransport,
    TransportConfig,
    TransportStats,
    _FrameIO,
    _Waiter,
    _meta_to_headers,
    _req_meta,
    decode_meta,
    encode_frame,
    encode_meta,
    split_host_port,
)
from pilosa_tpu_torch.server.server import Server as _Server

from .conftest import FakeClock
from .test_torch_chaos import _run_chaos, free_port


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


# Fake peers listen directly on a free port P and advertise netloc
# localhost:(P - OFF), so the transport's (port + offset) dial lands on
# the listener. The netloc port itself is never bound.
OFF = 7


def _cfg(**kw):
    base = dict(enabled=True, port_offset=OFF, max_frames_inflight=64,
                frame_max_bytes=1 << 20, handshake_timeout=2.0)
    base.update(kw)
    return TransportConfig(**base).validate()


# ------------------------------------------------------------------ units


def test_split_host_port_ipv6():
    """The shared splitter (mux dialer + protobuf envelope codec — one
    parse, not three) handles every internal netloc shape."""
    assert split_host_port("[2001:db8::1]:10101") == ("2001:db8::1", 10101)
    assert split_host_port("[::1]") == ("::1", None)
    assert split_host_port("localhost:10101") == ("localhost", 10101)
    assert split_host_port("::1") == ("::1", None)
    assert split_host_port("2001:db8::1") == ("2001:db8::1", None)
    assert split_host_port("localhost") == ("localhost", None)
    with pytest.raises(ValueError):
        split_host_port("[::1:10101")  # unclosed bracket
    with pytest.raises(ValueError):
        split_host_port("[::1]x:1")  # junk between bracket and colon
    with pytest.raises(ValueError):
        split_host_port("host:notaport")


def test_meta_codec_roundtrip():
    fields = {M_METHOD: b"POST", M_PATH: b"/index/t/query?remote=true",
              M_EPOCH: b"7", M_HEADERS: b"", M_STATUS: b"200"}
    assert decode_meta(encode_meta(fields)) == fields
    assert decode_meta(encode_meta({})) == {}


def test_meta_codec_rejects_torn_blocks():
    good = encode_meta({M_METHOD: b"GET", M_PATH: b"/status"})
    with pytest.raises(MuxProtocolError):
        decode_meta(good[:-1])  # field overruns the block
    with pytest.raises(MuxProtocolError):
        decode_meta(good + b"\x00")  # trailing bytes after last field
    with pytest.raises(MuxProtocolError):
        decode_meta(struct.pack("!B", 2) + struct.pack("!BH", 1, 1))


def test_req_meta_headers_roundtrip():
    """Known X-Pilosa-* headers become fixed binary fields; the rest
    ride the JSON blob; the server side reconstructs the exact header
    dict Handler.dispatch expects, with the handshake key stamped in."""
    meta = _req_meta(
        "POST", "/index/t/query?remote=true", "application/json", "x-wire",
        headers={"X-Pilosa-Epoch": "9", "X-Pilosa-Trace": "abc",
                 "X-Pilosa-Deadline": "1.5", "X-Custom": "z"},
    )
    assert meta[M_EPOCH] == b"9"
    assert json.loads(meta[M_HEADERS]) == {"x-custom": "z"}
    headers = _meta_to_headers(meta, "sekrit")
    assert headers["x-pilosa-epoch"] == "9"
    assert headers["x-pilosa-trace"] == "abc"
    assert headers["x-pilosa-deadline"] == "1.5"
    assert headers["x-custom"] == "z"
    assert headers["x-pilosa-key"] == "sekrit"
    assert headers["content-type"] == "application/json"
    assert headers["accept"] == "x-wire"


def test_transport_config_validation():
    with pytest.raises(ValueError, match="port-offset"):
        TransportConfig(port_offset=0).validate()
    with pytest.raises(ValueError, match="max-frames-inflight"):
        TransportConfig(max_frames_inflight=0).validate()
    with pytest.raises(ValueError, match="frame-max-bytes"):
        TransportConfig(frame_max_bytes=1).validate()
    with pytest.raises(ValueError, match="handshake-timeout"):
        TransportConfig(handshake_timeout=0).validate()
    TransportConfig().validate()  # defaults are valid


# ------------------------------------------------- framing over socketpair


def _pair(frame_max=1 << 20):
    a, b = socket.socketpair()
    return _FrameIO(a, frame_max), _FrameIO(b, frame_max), a, b


def test_frame_roundtrip_over_socketpair():
    wio, rio, _, _ = _pair()
    try:
        meta = {M_METHOD: b"POST", M_PATH: b"/x"}
        wio.send_frame(KIND_CALL, 42, meta, b"payload-bytes")
        kind, sid, got_meta, payload = rio.read_frame()
        assert (kind, sid, got_meta, payload) == (
            KIND_CALL, 42, meta, b"payload-bytes")
    finally:
        wio.close()
        rio.close()


def test_clean_eof_is_mux_closed():
    wio, rio, _, _ = _pair()
    wio.close()
    try:
        with pytest.raises(MuxClosed):
            rio.read_frame()
    finally:
        rio.close()


def test_torn_frame_every_boundary():
    """EOF inside the header, inside the payload, and a corrupted crc
    each raise the TYPED protocol error naming the boundary."""
    frame = encode_frame(KIND_RESP, 1, {M_STATUS: b"200"}, b"0123456789")

    # 1. torn inside the fixed header
    wio, rio, a, _ = _pair()
    a.sendall(frame[:HEADER_LEN - 3])
    wio.close()
    with pytest.raises(MuxProtocolError, match="frame header"):
        rio.read_frame()
    rio.close()

    # 2. torn mid-payload (full header, partial body)
    wio, rio, a, _ = _pair()
    a.sendall(frame[:HEADER_LEN + 4])
    wio.close()
    with pytest.raises(MuxProtocolError, match="frame body"):
        rio.read_frame()
    rio.close()

    # 3. crc corruption (whole frame arrives, last payload byte flipped)
    wio, rio, a, _ = _pair()
    a.sendall(frame[:-1] + bytes([frame[-1] ^ 0xFF]))
    wio.close()
    with pytest.raises(MuxProtocolError, match="crc mismatch"):
        rio.read_frame()
    rio.close()

    # 4. header lies: length over frame-max-bytes
    wio, rio, a, _ = _pair(frame_max=4096)
    hdr = struct.pack("!IIBBHI", 1 << 20, 1, KIND_RESP, 0, 0, 0)
    a.sendall(hdr)
    with pytest.raises(MuxProtocolError, match="frame-max-bytes"):
        rio.read_frame()
    wio.close()
    rio.close()

    # 5. header lies: meta_len exceeds frame length
    wio, rio, a, _ = _pair()
    hdr = struct.pack("!IIBBHI", 4, 1, KIND_RESP, 0, 9, 0)
    a.sendall(hdr + b"abcd")
    with pytest.raises(MuxProtocolError, match="meta_len"):
        rio.read_frame()
    wio.close()
    rio.close()


def test_combining_writer_batches_queued_frames():
    """Frames queued while another thread is inside sendall ride that
    thread's NEXT combined send — the writev-style fan-out batch."""

    class GateSock:
        def __init__(self):
            self.sends = []
            self.entered = threading.Event()
            self.release = threading.Event()
            self.first = True

        def sendall(self, data):
            self.sends.append(bytes(data))
            if self.first:
                self.first = False
                self.entered.set()
                assert self.release.wait(5.0)

        def close(self):
            pass

    gate = GateSock()
    io = _FrameIO(gate, 1 << 20)
    f1 = encode_frame(KIND_CALL, 1, {}, b"one")
    f2 = encode_frame(KIND_CALL, 2, {}, b"two")
    f3 = encode_frame(KIND_CALL, 3, {}, b"three")

    t = threading.Thread(
        target=io.send_frame, args=(KIND_CALL, 1, {}, b"one"), daemon=True)
    t.start()
    assert gate.entered.wait(5.0)
    # Flusher is parked inside sendall: these two only enqueue.
    io.send_frame(KIND_CALL, 2, {}, b"two")
    io.send_frame(KIND_CALL, 3, {}, b"three")
    gate.release.set()
    t.join(5.0)
    assert not t.is_alive()
    assert gate.sends == [f1, f2 + f3], "queued frames did not combine"


def test_flush_failure_is_maybe_sent_then_unsent():
    """A sendall fault surfaces as plain MuxError (the frame may have
    ridden an earlier chunk — NOT safe to replay); once the writer is
    dead, subsequent sends never enqueue and are typed MuxUnsent."""
    a, b = socket.socketpair()
    io = _FrameIO(a, 1 << 20)
    a.close()  # next sendall raises
    with pytest.raises(MuxError) as ei:
        io.send_frame(KIND_CALL, 1, {M_METHOD: b"GET"}, b"x")
    assert not isinstance(ei.value, MuxUnsent)
    with pytest.raises(MuxUnsent, match="connection already failed"):
        io.send_frame(KIND_CALL, 2, {M_METHOD: b"GET"}, b"x")
    b.close()


def test_send_stats_only_bumped_on_successful_flush():
    """frames_sent/bytes_sent count only frames whose sendall succeeded
    — a failed flush must not inflate the wire counters."""
    stats = TransportStats()
    a, b = socket.socketpair()
    io = _FrameIO(a, 1 << 20, stats)
    io.send_frame(KIND_CALL, 1, {M_METHOD: b"GET"}, b"x")
    assert stats.snapshot()["frames_sent"] == 1
    sent_bytes = stats.snapshot()["bytes_sent"]
    a.close()
    with pytest.raises(MuxError):
        io.send_frame(KIND_CALL, 2, {M_METHOD: b"GET"}, b"x")
    snap = stats.snapshot()
    assert snap["frames_sent"] == 1 and snap["bytes_sent"] == sent_bytes
    b.close()


def test_oversized_frame_is_typed_before_enqueue():
    a, b = socket.socketpair()
    io = _FrameIO(a, 4096)
    with pytest.raises(MuxFrameTooLarge):
        io.send_frame(KIND_CALL, 1, {}, b"x" * 8192)
    # Connection stays healthy: a normal frame still goes out.
    io.send_frame(KIND_CALL, 2, {}, b"ok")
    a.close()
    b.close()


# --------------------------------------------- send-phase retry policy


class _ScriptedConn:
    """Stub _ClientConn: raises the scripted errors, then answers 200."""

    closed = False

    def __init__(self, errs):
        self.errs = list(errs)
        self.calls = 0

    def send_call(self, meta_fields, payload):
        self.calls += 1
        if self.errs:
            raise self.errs.pop(0)
        w = _Waiter()
        w.result = (KIND_RESP, {M_STATUS: b"200"}, b"ok")
        w.event.set()
        return 1, w

    def abandon(self, sid):
        pass


def test_maybe_sent_failure_is_never_silently_retried(monkeypatch):
    """The high-stakes rule: a MuxError raised AFTER the frame may have
    hit the wire (combining-writer flush fault) must surface without a
    redial — a replayed POST could double-apply a hint/cluster op the
    peer already dispatched (mirrors the HTTP non-GET policy)."""
    tr = MuxTransport(_cfg(), timeout=1.0)
    conn = _ScriptedConn([MuxError("frame send failed: injected")])
    monkeypatch.setattr(tr, "_conn", lambda netloc: conn)
    try:
        with pytest.raises(MuxError):
            tr.request("POST", "localhost:1", "/internal/hints", body=b"op")
        assert conn.calls == 1, "maybe-sent POST was silently replayed"
    finally:
        tr.close()


def test_unsent_failure_gets_single_silent_redial(monkeypatch):
    """MuxUnsent (pre-enqueue failure) is provably unsent: one silent
    retry for ANY method, the HTTP fresh-connection parity."""
    tr = MuxTransport(_cfg(), timeout=1.0)
    conn = _ScriptedConn([MuxUnsent("connection closed")])
    monkeypatch.setattr(tr, "_conn", lambda netloc: conn)
    try:
        status, data, _ = tr.request(
            "POST", "localhost:1", "/internal/hints", body=b"op")
        assert (status, data, conn.calls) == (200, b"ok", 2)
        # A persistently-unsent failure still surfaces after the one
        # retry.
        conn.errs = [MuxUnsent("connection closed")] * 2
        with pytest.raises(MuxUnsent):
            tr.request("POST", "localhost:1", "/internal/hints", body=b"op")
    finally:
        tr.close()


def test_frame_too_large_from_send_falls_back_to_http(monkeypatch):
    """When the pre-send size guard under-counts, the typed
    MuxFrameTooLarge (nothing enqueued) converts to MuxUnavailable so
    the request safely rides HTTP instead of failing."""
    tr = MuxTransport(_cfg(), timeout=1.0)
    conn = _ScriptedConn([MuxFrameTooLarge("frame of 9999 bytes exceeds")])
    monkeypatch.setattr(tr, "_conn", lambda netloc: conn)
    try:
        with pytest.raises(MuxUnavailable):
            tr.request("POST", "localhost:1", "/import", body=b"op")
        assert conn.calls == 1
    finally:
        tr.close()


# ------------------------------------- client/server halves, real sockets


class FakePeer:
    """Accepts mux connections, answers the handshake, then hands each
    connection's framer to `script`. Used to put the CLIENT half under
    misbehaving peers (torn frames, held responses, wrong versions)
    that a real MuxServer would never emit."""

    def __init__(self, script=None, ack_meta=None):
        self.sock = socket.create_server(("localhost", 0), backlog=4)
        self.port = self.sock.getsockname()[1]
        self.netloc = f"localhost:{self.port - OFF}"
        self.script = script
        self.ack_meta = ack_meta
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        io = _FrameIO(conn, 1 << 20)
        try:
            io.read_frame()  # HELLO
            ack = self.ack_meta or {
                M_VERSION: str(MUX_VERSION).encode("ascii")}
            io.send_frame(KIND_HELLO_ACK, 0, ack, b"")
            if self.script is not None:
                self.script(io)
        except (MuxError, OSError):
            pass
        finally:
            io.close()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _echo_script(io):
    while True:
        kind, sid, meta, payload = io.read_frame()
        io.send_frame(KIND_RESP, sid, {M_STATUS: b"200"}, payload)


def test_torn_resp_tears_down_only_that_peer():
    """A torn RESP from peer B fails B's pending streams with the typed
    protocol error and tears down B's ONE connection; peer A's live
    connection is untouched and keeps serving."""

    def torn_script(io):
        io.read_frame()  # the pending CALL
        frame = encode_frame(KIND_RESP, 1, {M_STATUS: b"200"}, b"x")
        io.sock.sendall(frame[:-1] + bytes([frame[-1] ^ 0xFF]))  # bad crc

    a, b = FakePeer(_echo_script), FakePeer(torn_script)
    tr = MuxTransport(_cfg(), timeout=10.0)
    try:
        assert tr.request("GET", a.netloc, "/s")[0:2] == (200, b"")
        conn_a = tr._conns[a.netloc]
        with pytest.raises(MuxProtocolError, match="crc mismatch"):
            tr.request("GET", b.netloc, "/s")
        assert tr.stats.snapshot()["protocol_errors"] == 1
        assert tr._conns[b.netloc].closed
        # Peer A: same connection object, still serving.
        assert tr.request("GET", a.netloc, "/s", body=b"hi")[1] == b"hi"
        assert tr._conns[a.netloc] is conn_a and not conn_a.closed
    finally:
        tr.close()
        a.close()
        b.close()


def test_pending_streams_fail_typed_on_teardown():
    """Streams parked in waiters when the connection dies get the typed
    error — nobody blocks for the full request timeout."""
    hold = threading.Event()

    def hold_then_die(io):
        io.read_frame()
        hold.wait(5.0)
        io.sock.sendall(b"\x00" * 5)  # partial header, then close

    p = FakePeer(hold_then_die)
    tr = MuxTransport(_cfg(), timeout=30.0)
    errs = []

    def call():
        try:
            tr.request("GET", p.netloc, "/s")
        except MuxError as e:
            errs.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while p.netloc not in tr._conns and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)  # let the CALL reach the peer
        hold.set()
        t.join(5.0)
        assert not t.is_alive(), "waiter did not fail on teardown"
        assert len(errs) == 1 and isinstance(errs[0], MuxProtocolError)
    finally:
        tr.close()
        p.close()


def test_handshake_version_mismatch_demotes_with_backoff():
    clock = FakeClock()
    p = FakePeer(ack_meta={M_VERSION: b"99"})
    tr = MuxTransport(_cfg(), timeout=5.0, clock=clock.time)
    try:
        with pytest.raises(MuxUnavailable, match="version mismatch"):
            tr.request("GET", p.netloc, "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 1
        # Inside the demotion window: immediate MuxUnavailable, no dial.
        with pytest.raises(MuxUnavailable, match="demoted"):
            tr.request("GET", p.netloc, "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 1
        # Past the window the transport really re-dials (the peer still
        # speaks the wrong version, so the handshake fails AGAIN rather
        # than short-circuiting on the expired demotion entry).
        clock.advance(MuxTransport.DEMOTE_S + 0.1)
        with pytest.raises(MuxUnavailable, match="version mismatch"):
            tr.request("GET", p.netloc, "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 2
    finally:
        tr.close()
        p.close()


def test_handshake_key_mismatch_rejected_by_real_server():
    srv, netloc = _real_mux_server(key="right-key")
    tr = MuxTransport(_cfg(), key="wrong-key", timeout=5.0)
    try:
        with pytest.raises(MuxUnavailable, match="cluster key mismatch"):
            tr.request("GET", netloc, "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 1
    finally:
        tr.close()
        srv.close()


def test_nothing_listening_falls_back():
    tr = MuxTransport(_cfg(), timeout=2.0)
    port = free_port()
    try:
        with pytest.raises(MuxUnavailable):
            tr.request("GET", f"localhost:{port - OFF}", "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 1
    finally:
        tr.close()


def test_disabled_transport_is_unavailable():
    tr = MuxTransport(_cfg(enabled=False))
    try:
        with pytest.raises(MuxUnavailable, match="disabled"):
            tr.request("GET", "localhost:1", "/s")
    finally:
        tr.close()


def test_oversized_request_rides_http():
    tr = MuxTransport(_cfg(frame_max_bytes=4096))
    try:
        with pytest.raises(MuxUnavailable, match="frame-max-bytes"):
            tr.request("POST", "localhost:1", "/import", body=b"x" * 8192)
    finally:
        tr.close()


class FakeHandler:
    """Just enough of Handler.dispatch for transport-level tests."""

    def __init__(self):
        self.calls = []
        self.gate = None  # Event: when set on self, /slow waits on it

    def dispatch(self, method, path, query, body, headers=None):
        self.calls.append((method, path, query, body, dict(headers or {})))
        if path == "/slow" and self.gate is not None:
            assert self.gate.wait(10.0)
        if path == "/boom":
            raise RuntimeError("kapow")
        if path == "/big":
            return (200, "application/octet-stream", b"x" * 8192)
        if path == "/echo":
            return (200, "application/octet-stream", body, {"X-Extra": "1"})
        return (200, "application/json",
                json.dumps({"path": path}).encode("utf-8"))


def _real_mux_server(key="", config=None, handler=None):
    """MuxServer on a free port; returns (server, advertised netloc)."""
    config = config or _cfg()
    handler = handler or FakeHandler()
    for _ in range(16):
        port = free_port()
        srv = MuxServer(handler, config, key=key)
        srv.open("localhost", port - OFF)
        if srv.port is not None:
            return srv, f"localhost:{port - OFF}"
        srv.close()
    raise RuntimeError("could not bind a mux listener")


def test_mux_request_end_to_end():
    """CALL meta reconstructs the full HTTP-shaped request on the server
    (method, path, query, body, headers incl. the handshake key) and
    RESP carries status, content-type, and extra headers back."""
    h = FakeHandler()
    srv, netloc = _real_mux_server(key="k1", handler=h)
    tr = MuxTransport(_cfg(), key="k1", timeout=10.0)
    try:
        status, data, rheaders = tr.request(
            "POST", netloc, "/echo?x=1&x=2&y=z", body=b"abc",
            content_type="application/octet-stream", accept="x-wire",
            headers={"X-Pilosa-Epoch": "7", "X-Custom": "v"})
        assert (status, data) == (200, b"abc")
        assert rheaders["x-extra"] == "1"
        assert rheaders["content-type"] == "application/octet-stream"
        method, path, query, body, headers = h.calls[0]
        assert (method, path, body) == ("POST", "/echo", b"abc")
        assert query == {"x": ["1", "2"], "y": ["z"]}
        assert headers["x-pilosa-epoch"] == "7"
        assert headers["x-custom"] == "v"
        assert headers["x-pilosa-key"] == "k1"
        # Unhandled handler exception -> 500 + JSON error, like HTTP.
        status, data, _ = tr.request("GET", netloc, "/boom")
        assert status == 500 and b"kapow" in data
    finally:
        tr.close()
        srv.close()


def test_trailing_slash_path_normalized_like_http():
    """The mux server applies the HTTP server's path normalization, so
    an internal URL with a trailing slash routes identically on both
    transports."""
    h = FakeHandler()
    srv, netloc = _real_mux_server(handler=h)
    tr = MuxTransport(_cfg(), timeout=5.0)
    try:
        status, data, _ = tr.request("GET", netloc, "/echo/?x=1")
        assert status == 200
        _, path, query, _, _ = h.calls[0]
        assert path == "/echo"
        assert query == {"x": ["1"]}
    finally:
        tr.close()
        srv.close()


def test_oversized_response_fails_fast_not_timeout():
    """A response bigger than frame-max-bytes must not hang the waiter
    until timeout: the server answers with a small error RESP. A GET
    (idempotent) transparently falls back to HTTP (MuxUnavailable); a
    POST surfaces a fast 500 — the call DID run, so replaying it is
    not safe."""
    cfg = _cfg(frame_max_bytes=4096)
    h = FakeHandler()
    srv, netloc = _real_mux_server(handler=h, config=cfg)
    tr = MuxTransport(_cfg(frame_max_bytes=4096), timeout=30.0)
    try:
        start = time.monotonic()
        with pytest.raises(MuxUnavailable, match="retrying over HTTP"):
            tr.request("GET", netloc, "/big")
        status, data, _ = tr.request("POST", netloc, "/big", body=b"go")
        assert status == 500 and b"undeliverable" in data
        # A POST whose replay is harmless (PQL query forward) opts into
        # the same HTTP escape via the idempotent hint.
        with pytest.raises(MuxUnavailable, match="retrying over HTTP"):
            tr.request("POST", netloc, "/big", body=b"go", idempotent=True)
        assert time.monotonic() - start < 10.0, "waiter hung until timeout"
        # The connection survived: a fitting response still serves.
        assert tr.request("GET", netloc, "/fast")[0] == 200
    finally:
        tr.close()
        srv.close()


def test_non_ascii_cluster_key_handshake():
    """The key rides the binary meta slot as utf-8 and the server
    compares BYTES: a non-ASCII key handshakes fine (no TypeError
    crashing the connection thread), and a mismatch is a clean
    rejection + demotion."""
    srv, netloc = _real_mux_server(key="clé-秘密")
    tr = MuxTransport(_cfg(), key="clé-秘密", timeout=5.0)
    tr2 = MuxTransport(_cfg(), key="clé-秘密-wrong", timeout=5.0)
    try:
        assert tr.request("GET", netloc, "/s")[0] == 200
        with pytest.raises(MuxUnavailable, match="key mismatch"):
            tr2.request("GET", netloc, "/s")
        assert tr2.stats.snapshot()["handshake_fallbacks"] == 1
    finally:
        tr.close()
        tr2.close()
        srv.close()


def test_demotion_honored_after_waiting_on_dial_lock():
    """A thread parked on the per-netloc dial lock while another
    thread's dial fails must honor the fresh demotion instead of
    immediately re-dialing the down peer (breaker-style backoff)."""
    clock = FakeClock()
    tr = MuxTransport(_cfg(), timeout=1.0, clock=clock)
    dials = []

    def fake_dial(netloc, had_prior):
        dials.append(netloc)
        raise MuxUnavailable("should not dial")

    tr._dial = fake_dial
    netloc = "peer:1"
    lock = tr._dial_locks.setdefault(netloc, threading.Lock())
    result = {}

    def go():
        try:
            tr._conn(netloc)
        except Exception as e:  # noqa: BLE001 - recording for assert
            result["e"] = e

    lock.acquire()
    try:
        t = threading.Thread(target=go, daemon=True)
        t.start()
        # Let the worker pass the pre-lock checks and park on the lock.
        time.sleep(0.2)  # pilint: allow-blocking(the test holds the dial lock on purpose)
        # Another thread's dial "failed": the peer is now demoted.
        with tr._mu:
            tr._demoted_until[netloc] = clock() + 5.0
    finally:
        lock.release()
    t.join(5.0)
    assert isinstance(result.get("e"), MuxUnavailable)
    assert "demoted" in str(result["e"])
    assert dials == [], "re-dialed a freshly-demoted peer"
    tr.close()


def test_multiplexed_out_of_order_responses_share_one_socket():
    """A slow and a fast request share the connection; the fast response
    overtakes the slow one and each lands on its own waiter."""
    h = FakeHandler()
    h.gate = threading.Event()
    srv, netloc = _real_mux_server(handler=h)
    tr = MuxTransport(_cfg(), timeout=10.0)
    slow_result = {}

    def slow_call():
        slow_result["r"] = tr.request("GET", netloc, "/slow")

    t = threading.Thread(target=slow_call, daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 5.0
        while not any(c[1] == "/slow" for c in h.calls):
            assert time.monotonic() < deadline, "slow call never arrived"
            time.sleep(0.01)
        # Fast request completes while /slow is parked server-side.
        assert tr.request("GET", netloc, "/fast")[0] == 200
        assert "r" not in slow_result
        h.gate.set()
        t.join(5.0)
        assert slow_result["r"][0] == 200
        snap = tr.stats.snapshot()
        assert snap["connects"] == 1, "requests did not share one socket"
        assert snap["requests_mux"] == 2
        assert snap["inflight_hwm"] >= 2
    finally:
        h.gate.set()
        tr.close()
        srv.close()


def test_inflight_cap_signals_http_fallback():
    h = FakeHandler()
    h.gate = threading.Event()
    srv, netloc = _real_mux_server(
        handler=h, config=_cfg(max_frames_inflight=1))
    tr = MuxTransport(_cfg(max_frames_inflight=1), timeout=10.0)
    t = threading.Thread(
        target=lambda: tr.request("GET", netloc, "/slow"), daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 5.0
        while not any(c[1] == "/slow" for c in h.calls):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(MuxUnavailable, match="max-frames-inflight"):
            tr.request("GET", netloc, "/fast")
    finally:
        h.gate.set()
        t.join(5.0)
        tr.close()
        srv.close()


# ----------------------------------------------------------- failpoints


def test_mux_handshake_failpoint_demotes():
    srv, netloc = _real_mux_server()
    tr = MuxTransport(_cfg(), timeout=5.0)
    try:
        failpoints.configure(f"mux-handshake@{netloc}", "drop")
        with pytest.raises(MuxUnavailable):
            tr.request("GET", netloc, "/s")
        assert tr.stats.snapshot()["handshake_fallbacks"] == 1
        assert failpoints.hits(f"mux-handshake@{netloc}") == 1
    finally:
        failpoints.reset()
        tr.close()
        srv.close()


def test_mux_frame_send_failpoint_single_retry_parity():
    """A provably-unsent send fault is retried silently ONCE (the HTTP
    fresh-connection parity); a persistent fault surfaces typed."""
    srv, netloc = _real_mux_server()
    tr = MuxTransport(_cfg(), timeout=5.0)
    try:
        # count=1: first attempt dropped, silent retry succeeds.
        failpoints.configure(f"mux-frame-send@{netloc}", "drop", count=1)
        assert tr.request("GET", netloc, "/s")[0] == 200
        assert failpoints.hits(f"mux-frame-send@{netloc}") == 2
        # Unlimited drop: both attempts fail -> typed MuxError, which the
        # client surfaces as status-0 ClientError (breaker evidence).
        failpoints.configure(f"mux-frame-send@{netloc}", "drop")
        with pytest.raises(MuxError):
            tr.request("GET", netloc, "/s")
    finally:
        failpoints.reset()
        tr.close()
        srv.close()


def test_mux_frame_recv_failpoint_tears_down_and_reconnects():
    srv, netloc = _real_mux_server()
    tr = MuxTransport(_cfg(), timeout=5.0)
    try:
        assert tr.request("GET", netloc, "/s")[0] == 200
        failpoints.configure(f"mux-frame-recv@{netloc}", "drop", count=1)
        with pytest.raises(MuxError):
            tr.request("GET", netloc, "/s")
        failpoints.reset()
        # Next request re-dials transparently.
        assert tr.request("GET", netloc, "/s")[0] == 200
        snap = tr.stats.snapshot()
        assert snap["connects"] == 1 and snap["reconnects"] == 1
    finally:
        failpoints.reset()
        tr.close()
        srv.close()


def test_client_send_failpoint_scopes_per_peer_over_mux():
    """The chaos schedule's per-peer client-send scoping keeps working
    when the transport flips to mux: peer A's link drops, peer B's
    serves — exactly the HTTP targeting contract."""
    srv_a, netloc_a = _real_mux_server()
    srv_b, netloc_b = _real_mux_server()
    tr = MuxTransport(_cfg(), timeout=5.0)
    try:
        failpoints.configure(f"client-send@{netloc_a}", "drop")
        with pytest.raises(MuxError):
            tr.request("GET", netloc_a, "/s")
        assert tr.request("GET", netloc_b, "/s")[0] == 200
    finally:
        failpoints.reset()
        tr.close()
        srv_a.close()
        srv_b.close()


# ------------------------------------------------------- 3-node clusters


MUX_OFF = 2000


def free_port_pair():
    """A free HTTP port whose mux twin (port + MUX_OFF) is also free."""
    for _ in range(64):
        p = free_port()
        if p + MUX_OFF > 65000:
            continue
        try:
            probe = socket.socket()
            probe.bind(("localhost", p + MUX_OFF))
            probe.close()
        except OSError:
            continue
        return p
    raise RuntimeError("no free http+mux port pair")


def _mk_cluster(tmp_path, enabled_nodes, clock=None):
    ports = [free_port_pair() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        tc = (TransportConfig(enabled=True, port_offset=MUX_OFF)
              if i in enabled_nodes else None)
        s = Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=2,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,
            member_monitor_interval=0,
            executor_workers=0,
            transport_config=tc,
            resilience_config=ResilienceConfig(
                breaker_backoff=0.2, breaker_backoff_max=1.0,
                retry_budget=50.0, retry_refill=1.0,
            ),
        )
        s.open()
        if clock is not None:
            s.cluster.health.clock = clock
        servers.append(s)
    return servers, hosts


def _close_cluster(servers):
    failpoints.reset()
    for s in servers:
        try:
            s.close()
        except Exception:
            pass


def _get_json(host, path):
    with urllib.request.urlopen(f"http://{host}{path}") as r:
        return json.loads(r.read())


def _fanout_shards(s0, index="t"):
    """Three shards that FORCE a remote hop from s0: placement is
    port-dependent (ModHasher over node ids), so fixed shard numbers
    sometimes land every shard on the coordinator and the executor
    legitimately serves without any remote: hop."""
    locals_, remotes = [], []
    for sh in range(48):
        owners = s0.cluster.shard_nodes(index, sh)
        if any(o.id == s0.node.id for o in owners):
            locals_.append(sh)
        else:
            remotes.append(sh)
        if locals_ and len(remotes) >= 2:
            return [locals_[0]] + remotes[:2]
    raise AssertionError(f"no fan-out mix in 48 shards: "
                         f"local={locals_[:3]} remote={remotes[:3]}")


def test_cluster_serves_entirely_over_mux(tmp_path):
    """3 mux nodes: every internal hop rides pmux (requests_http stays
    0), /debug/vars grows the transport group, and the coordinator's
    remote spans are tagged transport=mux."""
    servers, hosts = _mk_cluster(tmp_path, enabled_nodes={0, 1, 2})
    try:
        c = InternalClient()
        h0 = hosts[0]
        c.ensure_index(h0, "t")
        c.ensure_field(h0, "t", "f")
        time.sleep(0.05)
        # One bit per chosen shard: at least two are remote to node0,
        # so the Count MUST fan out over mux.
        for sh in _fanout_shards(servers[0]):
            c.query(h0, "t", f"Set({sh * SHARD_WIDTH + 5}, f=1)")
        assert c.query(h0, "t", "Count(Row(f=1))")["results"] == [3]

        snap = servers[0].transport_stats.snapshot()
        assert snap["requests_mux"] > 0
        assert snap["requests_http"] == 0, "an internal hop fell back"
        assert snap["connects"] >= 1
        assert sum(s.transport_stats.snapshot()["accepts"]
                   for s in servers[1:]) >= 1

        dv = _get_json(h0, "/debug/vars")
        assert dv["transport"]["enabled"] is True
        assert dv["transport"]["requests_mux"] == snap["requests_mux"]
        assert dv["transport"]["server"]["listening"] is True

        traces = _get_json(h0, "/debug/traces?index=t")["traces"]
        hop_tags = [sp.get("tags", {}) for t in traces for sp in t["spans"]
                    if sp["name"].startswith("remote:")]
        assert hop_tags, f"no remote hop was traced: {traces!r}"
        assert all(tags.get("transport") == "mux" for tags in hop_tags), \
            hop_tags
    finally:
        _close_cluster(servers)


def test_mixed_cluster_serves_via_handshake_fallback(tmp_path):
    """Only the coordinator speaks mux; its peers are mux-disabled. The
    refused handshakes demote per-peer and every hop serves over HTTP —
    a mixed cluster never stops answering."""
    servers, hosts = _mk_cluster(tmp_path, enabled_nodes={0})
    try:
        c = InternalClient()
        h0 = hosts[0]
        c.ensure_index(h0, "t")
        c.ensure_field(h0, "t", "f")
        time.sleep(0.05)
        for sh in _fanout_shards(servers[0]):
            c.query(h0, "t", f"Set({sh * SHARD_WIDTH + 5}, f=1)")
        assert c.query(h0, "t", "Count(Row(f=1))")["results"] == [3]

        snap = servers[0].transport_stats.snapshot()
        assert snap["handshake_fallbacks"] >= 1, "no fallback was exercised"
        assert snap["requests_http"] >= 1
        assert snap["requests_mux"] == 0
        # The spans carry the fallback transport.
        traces = _get_json(h0, "/debug/traces?index=t")["traces"]
        hop_tags = [sp.get("tags", {}) for t in traces for sp in t["spans"]
                    if sp["name"].startswith("remote:")]
        assert hop_tags and all(
            tags.get("transport") == "http" for tags in hop_tags)
    finally:
        _close_cluster(servers)


@pytest.mark.chaos
def test_chaos_smoke_over_mux(tmp_path):
    """Seed-pinned twin of the FAULT chaos smoke with pmux carrying the
    internal hops: same invariant (correct result or typed error, then
    full convergence), same pinned seed, same fault schedule riding the
    per-peer client-send scoping."""
    clock = FakeClock()
    servers, hosts = _mk_cluster(tmp_path, enabled_nodes={0, 1, 2},
                                 clock=clock)
    try:
        ok, _err = _run_chaos(servers, hosts, clock, seed=1207,
                              rounds=4, queries_per_round=5)
        assert ok > 0
        # Proof the schedule actually rode pmux, not a silent fallback.
        assert any(s.transport_stats.snapshot()["requests_mux"] > 0
                   for s in servers)
    finally:
        _close_cluster(servers)
