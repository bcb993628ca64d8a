"""The cases of tests/test_envelope.py, run against the port on the CPU.

Private-plane protobuf envelope: round-trips + reference wire pinning.

The golden byte strings are hand-derived from the REFERENCE schema
(reference internal/private.proto field numbers and
reference broadcast.go:52-69 type-byte order), not from our
generated code — so a regression in either the .proto port or the
type-byte table fails against independently-computed bytes.
"""

import json

import pytest

from pilosa_tpu_torch.server.proto import envelope as env


def Server(*args, **kw):
    """The port's server on the CPU."""
    from pilosa_tpu_torch.server.server import Server as _Server

    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


ROUND_TRIP_CASES = [
    {"type": "create-shard", "index": "i", "shard": 7, "field": "f"},
    {"type": "create-index", "index": "i", "options": {"keys": True}},
    {"type": "delete-index", "index": "i"},
    {
        "type": "create-field", "index": "i", "field": "f",
        "options": {"type": "int", "cacheType": "", "cacheSize": 0,
                    "min": -10, "max": 100, "timeQuantum": "", "keys": False},
    },
    {"type": "delete-field", "index": "i", "field": "f"},
    {"type": "create-view", "index": "i", "field": "f", "view": "standard"},
    {"type": "delete-view", "index": "i", "field": "f", "view": "v2"},
    {
        "type": "cluster-status", "state": "NORMAL",
        "nodes": [
            {"id": "node0", "uri": "h0:101", "isCoordinator": True},
            {"id": "node1", "uri": "h1:102", "isCoordinator": False,
             "processIdx": 0},
        ],
    },
    {
        "type": "resize-instruction", "jobID": "00c0ffee", "nodeID": "n1",
        "coordinatorID": "n0", "coordinatorURI": "h0:101",
        "schema": [{
            "name": "i", "options": {"keys": False},
            "fields": [{
                "name": "f",
                "options": {"type": "set", "cacheType": "ranked",
                            "cacheSize": 50000, "min": 0, "max": 0,
                            "timeQuantum": "", "keys": False},
                "views": [{"name": "standard"}],
            }],
        }],
        "sources": [{"sourceNodeID": "n0", "index": "i", "field": "f",
                     "view": "standard", "shard": 3}],
        "nodeURIs": {"n0": "h0:101", "n1": "h1:102"},
        "maxShards": {"i": 9},
    },
    {"type": "resize-complete", "jobID": "00c0ffee", "nodeID": "n1"},
    {"type": "set-coordinator", "nodeID": "node1"},
    {"type": "node-state", "nodeID": "node0", "state": "READY"},
    {"type": "recalculate-caches"},
    {"type": "node-join",
     "node": {"id": "n2", "uri": "h2:103", "isCoordinator": False}},
    {"type": "node-leave", "nodeID": "n2"},
    {
        "type": "node-status",
        "node": {"id": "n0", "uri": "h0:101", "isCoordinator": True},
        "maxShards": {"i": 4},
        "schema": [{"name": "i", "options": {"keys": True}, "fields": []}],
    },
]


@pytest.mark.parametrize(
    "msg", ROUND_TRIP_CASES, ids=[m["type"] for m in ROUND_TRIP_CASES])
def test_round_trip(msg):
    buf = env.encode_message(msg)
    assert buf[0] != env.TYPE_JSON_EXT, "mapped types must ride protobuf"
    got = env.decode_message(buf)
    for key, want in msg.items():
        assert got[key] == want, f"{key}: {got[key]!r} != {want!r}"


def test_update_coordinator_decodes():
    # Reference UpdateCoordinatorMessage (type byte 11) must decode to the
    # same dispatch as set-coordinator, not raise on an unknown type.
    from pilosa_tpu_torch.server.proto import private_pb2 as pb

    m = pb.UpdateCoordinatorMessage()
    m.New.ID = "n9"
    got = env.decode_message(
        bytes([env.TYPE_UPDATE_COORDINATOR]) + m.SerializeToString())
    assert got == {"type": "set-coordinator", "nodeID": "n9"}


def test_node_update_event_decodes_as_update_not_leave():
    # Reference nodeUpdate (event.go:23) must never decode as a leave.
    from pilosa_tpu_torch.server.proto import private_pb2 as pb

    m = pb.NodeEventMessage()
    m.Event = env.EVENT_UPDATE
    m.Node.ID = "n1"
    got = env.decode_message(bytes([env.TYPE_NODE_EVENT]) + m.SerializeToString())
    assert got["type"] == "node-update" and got["node"]["id"] == "n1"


def test_json_extension_frame():
    msg = {"type": "collective-exec", "seq": 3, "descriptor": {"x": [1, 2]}}
    buf = env.encode_message(msg)
    assert buf[0] == env.TYPE_JSON_EXT
    assert env.decode_message(buf) == msg


def test_golden_node_state_bytes():
    # broadcast.go: messageTypeNodeState = 12; NodeStateMessage{NodeID=1,
    # State=2} (private.proto:102-105). Hand-encoded proto3 wire format.
    buf = env.encode_message(
        {"type": "node-state", "nodeID": "n1", "state": "READY"})
    assert buf == bytes([12]) + b"\x0a\x02n1\x12\x05READY"


def test_golden_create_view_bytes():
    # messageTypeCreateView = 5; CreateViewMessage{Index=1, Field=2,
    # View=3} (private.proto:124-128).
    buf = env.encode_message(
        {"type": "create-view", "index": "i", "field": "f", "view": "sv"})
    assert buf == bytes([5]) + b"\x0a\x01i\x12\x01f\x1a\x02sv"


def test_golden_cluster_status_bytes():
    # messageTypeClusterStatus = 7; ClusterStatus{ClusterID=1, State=2,
    # Nodes=3}, Node{ID=1, URI=2, IsCoordinator=3}, URI{Scheme=1, Host=2,
    # Port=3} (private.proto:85-99, 111-115).
    buf = env.encode_message({
        "type": "cluster-status", "state": "NORMAL",
        "nodes": [{"id": "a", "uri": "h:9", "isCoordinator": True}],
    })
    node = (b"\x0a\x01a"                       # ID="a"
            b"\x12\x0b"                        # URI, len 11
            b"\x0a\x04http\x12\x01h\x18\x09"   # Scheme/Host/Port
            b"\x18\x01")                       # IsCoordinator=true
    want = (bytes([7]) + b"\x12\x06NORMAL"
            + b"\x1a" + bytes([len(node)]) + node)
    assert buf == want


def test_reference_parser_sees_create_shard():
    # Our create-shard carries extension fields (Field=15/View=16) that a
    # reference parser must skip: re-parsing through the schema-declared
    # message yields exactly Index + Shard.
    from pilosa_tpu_torch.server.proto import private_pb2 as pb

    buf = env.encode_message(
        {"type": "create-shard", "index": "idx", "shard": 5, "field": "f",
         "view": "standard"})
    m = pb.CreateShardMessage()
    m.ParseFromString(buf[1:])
    assert m.Index == "idx" and m.Shard == 5


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        env.decode_message(b"")
    with pytest.raises(ValueError):
        env.decode_message(bytes([200]) + b"xx")


def test_cluster_plane_over_protobuf(tmp_path, monkeypatch):
    """A live 2-node exchange with the default (protobuf) wire format:
    create-field broadcast from node0 must materialize on node1, and the
    messages on the wire must actually be envelope frames (encode_message
    is spied to prove the protobuf path carried them)."""
    import socket
    import time

    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.server.client import InternalClient
    from tests.test_torch_envelope import Server

    monkeypatch.delenv("PILOSA_TPU_CLUSTER_JSON", raising=False)
    seen = []
    real_encode = env.encode_message
    monkeypatch.setattr(
        env, "encode_message",
        lambda msg: seen.append(msg["type"]) or real_encode(msg))

    def free_port():
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i, port in enumerate(ports):
            s = Server(
                data_dir=str(tmp_path / f"node{i}"), port=port,
                cluster_hosts=hosts, hasher=ModHasher(),
                cache_flush_interval=0, executor_workers=0,
            )
            s.open()
            servers.append(s)
        c = InternalClient()
        c.create_index(hosts[0], "pbix")
        c.create_field(hosts[0], "pbix", "pf")
        deadline = time.time() + 5
        while time.time() < deadline:
            if servers[1].holder.field("pbix", "pf") is not None:
                break
            time.sleep(0.05)
        assert servers[1].holder.field("pbix", "pf") is not None
        assert "create-index" in seen and "create-field" in seen
    finally:
        for s in servers:
            s.close()
