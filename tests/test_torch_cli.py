"""The cases of tests/test_cli.py, run against the port on the CPU.

CLI + config tests (model: reference cmd/*_test.go, ctl import/export
tests against an in-process node)."""

import json
import os

import pytest

from pilosa_tpu_torch.cli import main
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


def test_config_precedence(tmp_path, monkeypatch):
    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        'data-dir = "/from/file"\nbind = "localhost:1111"\n'
        "[cluster]\nreplicas = 2\n"
    )
    cfg = Config.load(str(cfg_file))
    assert cfg.data_dir == "/from/file"
    assert cfg.cluster.replicas == 2
    # Env beats file.
    monkeypatch.setenv("PILOSA_TPU_DATA_DIR", "/from/env")
    cfg = Config.load(str(cfg_file))
    assert cfg.data_dir == "/from/env"
    # Flags beat env.
    cfg = Config.load(str(cfg_file), {"data_dir": "/from/flag"})
    assert cfg.data_dir == "/from/flag"


def test_gossip_config_surface(tmp_path, monkeypatch):
    """Reference server/config.go:121-131 gossip{} knobs: TOML + env + flag
    precedence, and build_server wiring into the heartbeat monitor."""
    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        "[gossip]\nprobe-interval = 7.5\nprobe-timeout = 1.5\n"
        'key = "/from/file.key"\n'
    )
    cfg = Config.load(str(cfg_file))
    assert cfg.gossip.probe_interval == 7.5
    assert cfg.gossip.probe_timeout == 1.5
    assert cfg.gossip.key == "/from/file.key"
    monkeypatch.setenv("PILOSA_TPU_GOSSIP_PROBE_INTERVAL", "3.0")
    cfg = Config.load(str(cfg_file))
    assert cfg.gossip.probe_interval == 3.0
    cfg = Config.load(str(cfg_file), {"gossip_probe_interval": 9.0})
    assert cfg.gossip.probe_interval == 9.0
    # Round-trips through generate-config output.
    p = tmp_path / "rt.toml"
    p.write_text(cfg.to_toml())
    rt = Config.load(str(p))
    # (env still set, so compare the file-only fields)
    assert rt.gossip.probe_timeout == 1.5
    assert rt.gossip.key == "/from/file.key"

    keyfile = tmp_path / "secret.key"
    keyfile.write_text("s3cret\n")
    cfg = Config()
    cfg.data_dir = str(tmp_path / "d")
    cfg.bind = "localhost:0"
    cfg.gossip.probe_interval = 0  # don't spawn the monitor in tests
    cfg.gossip.probe_timeout = 0.5
    cfg.gossip.key = str(keyfile)
    s = cfg.build_server(device="cpu", executor_workers=0, cache_flush_interval=0)
    try:
        assert s.internal_key == "s3cret"
        assert s._probe_client.timeout == 0.5
        assert s._probe_client.key == "s3cret"
        assert s.member_monitor_interval == 0
    finally:
        pass  # never opened


def test_resilience_config_surface(tmp_path, monkeypatch):
    """[resilience] + gossip.probe-failures knobs: TOML + env + flag
    precedence, to_toml round-trip, and build_server wiring into the
    cluster health registry / member monitor."""
    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        "[resilience]\nbreaker-failures = 2\nretry-budget = 5.0\n"
        "hedge-max-fraction = 0.1\nbreaker-backoff = 0.5\n"
        "[gossip]\nprobe-failures = 5\n"
    )
    cfg = Config.load(str(cfg_file))
    assert cfg.resilience.breaker_failures == 2
    assert cfg.resilience.retry_budget == 5.0
    assert cfg.resilience.hedge_max_fraction == 0.1
    assert cfg.gossip.probe_failures == 5
    monkeypatch.setenv("PILOSA_TPU_RESILIENCE_RETRY_BUDGET", "7")
    cfg = Config.load(str(cfg_file))
    assert cfg.resilience.retry_budget == 7.0
    cfg = Config.load(str(cfg_file), {"resilience_retry_budget": 9.0})
    assert cfg.resilience.retry_budget == 9.0
    # Round-trips through generate-config output (env cleared: env beats
    # file, so the lingering override would mask the file's value).
    monkeypatch.delenv("PILOSA_TPU_RESILIENCE_RETRY_BUDGET")
    p = tmp_path / "rt.toml"
    p.write_text(cfg.to_toml())
    rt = Config.load(str(p))
    assert rt.resilience.retry_budget == 9.0
    assert rt.resilience.breaker_failures == 2
    assert rt.gossip.probe_failures == 5

    cfg.data_dir = str(tmp_path / "d")
    cfg.bind = "localhost:0"
    cfg.gossip.probe_interval = 0
    s = cfg.build_server(device="cpu", executor_workers=0, cache_flush_interval=0)
    assert s.member_probe_failures == 5
    assert s.cluster.health.config.retry_budget == 9.0
    assert s.cluster.health.config.breaker_failures == 2

    # Invalid knobs are rejected at build time, not at first failure.
    cfg.resilience.hedge_max_fraction = 2.0
    with pytest.raises(ValueError):
        cfg.build_server(device="cpu", executor_workers=0)


def test_internal_key_enforced(tmp_path):
    """A node with a cluster key refuses unauthenticated /internal/* (the
    memberlist-encryption analog): wrong key -> 403, right key -> 200,
    public routes stay open."""
    import urllib.error
    import urllib.request

    from pilosa_tpu_torch.server.client import ClientError, InternalClient

    keyfile = tmp_path / "k"
    keyfile.write_text("hunter2")
    s = Server(
        data_dir=str(tmp_path / "node"),
        port=0,
        cache_flush_interval=0,
        member_monitor_interval=0,
        executor_workers=0,
        internal_key_path=str(keyfile),
    )
    s.open()
    try:
        h = f"localhost:{s.port}"
        # Unkeyed client: public route OK, internal route 403.
        anon = InternalClient()
        assert anon.status(h)["state"] is not None
        with pytest.raises(ClientError) as ei:
            anon.shards_max(h)
        assert ei.value.status == 403
        # Wrong key: still 403.
        wrong = InternalClient(key="nope")
        with pytest.raises(ClientError) as ei:
            wrong.shards_max(h)
        assert ei.value.status == 403
        # Right key: internal plane open.
        good = InternalClient(key="hunter2")
        assert good.shards_max(h) is not None
        # Non-ASCII header bytes must 403, not crash the connection
        # (http.server hands headers to the gate as latin-1 str).
        req = urllib.request.Request(
            f"http://{h}/internal/shards/max",
            headers={"X-Pilosa-Key": "k\xe9y"},
        )
        with pytest.raises(urllib.error.HTTPError) as he:
            urllib.request.urlopen(req, timeout=5)
        assert he.value.code == 403
    finally:
        s.close()


def test_cluster_key_file_validation(tmp_path):
    """One shared loader rejects the same misconfigurations for Server and
    the ctl CLI: missing, empty, and non-ASCII key files."""
    from pilosa_tpu_torch.errors import PilosaError
    from pilosa_tpu_torch.server.client import load_cluster_key

    with pytest.raises(PilosaError, match="cannot read"):
        load_cluster_key(str(tmp_path / "nope"))
    empty = tmp_path / "empty"
    empty.write_text("  \n")
    with pytest.raises(PilosaError, match="empty"):
        load_cluster_key(str(empty))
    emoji = tmp_path / "emoji"
    emoji.write_text("kéy")
    with pytest.raises(PilosaError, match="ASCII"):
        load_cluster_key(str(emoji))
    # Interior newline would blow up http.client at header-send time —
    # must be rejected at load, not on the first probe.
    twolines = tmp_path / "twolines"
    twolines.write_text("line1\nline2\n")
    with pytest.raises(PilosaError, match="one line"):
        load_cluster_key(str(twolines))
    ok = tmp_path / "ok"
    ok.write_text("hunter2\n")
    assert load_cluster_key(str(ok)) == "hunter2"


def test_config_toml_roundtrip(tmp_path):
    toml = Config().to_toml()
    p = tmp_path / "default.toml"
    p.write_text(toml)
    cfg = Config.load(str(p))
    assert cfg.bind == Config().bind
    assert cfg.cluster.replicas == Config().cluster.replicas


def test_config_toml_dump_covers_every_parsed_knob(tmp_path):
    """Regression (pilint R11's drift class — engine.plan-cache was
    parseable from TOML but missing from the to_toml dump): flip EVERY
    config field to a non-default value, dump, reload, and assert
    nothing silently reverted. A knob dropped from the dump loses the
    operator's setting on any resolved-config round trip."""
    import dataclasses

    def perturb(v):
        if isinstance(v, bool):
            return not v
        if isinstance(v, int):
            return v + 1
        if isinstance(v, float):
            return v + 0.5
        if isinstance(v, str):
            return v + "x"
        if isinstance(v, list):
            return list(v) + ["localhost:19999"]
        return v

    cfg = Config()
    for f in dataclasses.fields(cfg):
        section = getattr(cfg, f.name)
        if dataclasses.is_dataclass(section):
            for sf in dataclasses.fields(section):
                setattr(section, sf.name, perturb(getattr(section, sf.name)))
        else:
            setattr(cfg, f.name, perturb(section))
    p = tmp_path / "perturbed.toml"
    p.write_text(cfg.to_toml())
    back = Config.load(str(p))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)


def test_generate_config(capsys):
    assert main(["generate-config"]) == 0
    out = capsys.readouterr().out
    assert "data-dir" in out and "[cluster]" in out


def test_config_command_with_flags(capsys):
    assert main(["config", "--bind", "0.0.0.0:9999"]) == 0
    assert 'bind = "0.0.0.0:9999"' in capsys.readouterr().out


@pytest.fixture
def server(tmp_path):
    s = Server(data_dir=str(tmp_path / "srv"), cache_flush_interval=0)
    s.open()
    yield s
    s.close()


def test_import_export_roundtrip(tmp_path, server, capsys):
    csv_path = tmp_path / "bits.csv"
    csv_path.write_text("1,10\n1,20\n2,30\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "imp", "-f", "f", "--create", str(csv_path),
    ])
    assert rc == 0
    out_path = tmp_path / "out.csv"
    rc = main([
        "export", "--host", f"localhost:{server.port}",
        "-i", "imp", "-f", "f", "-o", str(out_path),
    ])
    assert rc == 0
    assert sorted(out_path.read_text().strip().splitlines()) == ["1,10", "1,20", "2,30"]


def test_import_int_field(tmp_path, server):
    csv_path = tmp_path / "vals.csv"
    csv_path.write_text("1,100\n2,250\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "impv", "-f", "v", "--create",
        "--field-type", "int", "--field-min", "0", "--field-max", "1000",
        str(csv_path),
    ])
    assert rc == 0
    from pilosa_tpu_torch.server.client import InternalClient

    resp = InternalClient().query(f"localhost:{server.port}", "impv", "Sum(field=v)")
    assert resp["results"][0] == {"value": 350, "count": 2}


def test_import_with_timestamps(tmp_path, server):
    csv_path = tmp_path / "ts.csv"
    csv_path.write_text("1,10,2018-01-02T00:00\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "impt", "-f", "t", "--create",
        "--field-time-quantum", "YMD", str(csv_path),
    ])
    assert rc == 0
    from pilosa_tpu_torch.server.client import InternalClient

    resp = InternalClient().query(
        f"localhost:{server.port}", "impt",
        "Range(t=1, 2018-01-01T00:00, 2018-01-03T00:00)",
    )
    assert resp["results"][0]["columns"] == [10]


def test_inspect_and_check(tmp_path, server, capsys):
    from pilosa_tpu_torch.server.client import InternalClient

    client = InternalClient()
    client.create_index(f"localhost:{server.port}", "chk")
    client.create_field(f"localhost:{server.port}", "chk", "f")
    client.query(f"localhost:{server.port}", "chk", "Set(1, f=1)")
    frag_path = os.path.join(
        server.data_dir, "indexes", "chk", "f", "views", "standard", "fragments", "0"
    )
    assert os.path.exists(frag_path)
    assert main(["inspect", frag_path]) == 0
    out = capsys.readouterr().out
    assert "bits=1" in out
    assert main(["check", frag_path]) == 0
    # Corrupt file detected.
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00" * 32)
    assert main(["check", str(bad)]) == 1


def test_import_with_keys(tmp_path, server):
    csv_path = tmp_path / "keys.csv"
    csv_path.write_text("red,alice\nred,bob\nblue,alice\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "impk", "-f", "color", "--create",
        "--index-keys", "--field-keys", str(csv_path),
    ])
    assert rc == 0
    from pilosa_tpu_torch.server.client import InternalClient

    resp = InternalClient().query(
        f"localhost:{server.port}", "impk", 'Row(color="red")'
    )
    assert sorted(resp["results"][0]["keys"]) == ["alice", "bob"]
    resp = InternalClient().query(
        f"localhost:{server.port}", "impk", "TopN(color, n=2)"
    )
    assert resp["results"][0][0]["key"] == "red"
    assert resp["results"][0][0]["count"] == 2


def test_import_k_shorthand(tmp_path, server):
    """-k = --index-keys --field-keys (the reference's import -k)."""
    csv_path = tmp_path / "k.csv"
    csv_path.write_text("likes,alice\nlikes,bob\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "impk2", "-f", "kf", "--create", "-k", str(csv_path),
    ])
    assert rc == 0
    from pilosa_tpu_torch.server.client import InternalClient

    resp = InternalClient().query(
        f"localhost:{server.port}", "impk2", 'Count(Row(kf="likes"))'
    )
    assert resp["results"][0] == 2


def test_import_int_field_with_keys(tmp_path, server):
    csv_path = tmp_path / "kv.csv"
    csv_path.write_text("alice,42\nbob,58\n")
    rc = main([
        "import", "--host", f"localhost:{server.port}",
        "-i", "impkv", "-f", "v", "--create", "--index-keys",
        "--field-type", "int", "--field-min", "0", "--field-max", "100",
        str(csv_path),
    ])
    assert rc == 0
    from pilosa_tpu_torch.server.client import InternalClient

    resp = InternalClient().query(f"localhost:{server.port}", "impkv", "Sum(field=v)")
    assert resp["results"][0] == {"value": 100, "count": 2}


def test_import_length_mismatch_is_400(server):
    import urllib.error
    import urllib.request

    from pilosa_tpu_torch.server.client import InternalClient

    c = InternalClient()
    c.create_index(f"localhost:{server.port}", "mis", {"keys": True})
    c.create_field(f"localhost:{server.port}", "mis", "f", {"keys": True})
    req = urllib.request.Request(
        f"http://localhost:{server.port}/index/mis/field/f/import",
        data=json.dumps({"rowKeys": ["x", "y"], "columnKeys": ["a"]}).encode(),
        method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400
    assert "mismatch" in ei.value.read().decode()


def test_config_tls_and_cors_sections(tmp_path, monkeypatch):
    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        'bind = "https://localhost:4443"\n'
        '[tls]\ncertificate = "/c.pem"\nkey = "/k.pem"\nskip-verify = true\n'
        '[handler]\nallowed-origins = ["http://a/", "http://b/"]\n'
    )
    cfg = Config.load(str(cfg_file))
    assert cfg.tls.certificate_path == "/c.pem"
    assert cfg.tls.certificate_key_path == "/k.pem"
    assert cfg.tls.skip_verify is True
    assert cfg.handler.allowed_origins == ["http://a/", "http://b/"]
    # Round-trips through to_toml.
    (tmp_path / "dump.toml").write_text(cfg.to_toml())
    cfg2 = Config.load(str(tmp_path / "dump.toml"))
    assert cfg2.tls.certificate_path == "/c.pem"
    assert cfg2.handler.allowed_origins == ["http://a/", "http://b/"]
    # Env override.
    monkeypatch.setenv("PILOSA_TPU_HANDLER_ALLOWED_ORIGINS", "http://c/")
    assert Config.load(str(cfg_file)).handler.allowed_origins == ["http://c/"]
    # Flags (as parsed by the CLI) beat both.
    cfg3 = Config.load(str(cfg_file), {"allowed_origins": ["http://d/"],
                                       "tls_skip_verify": False})
    assert cfg3.handler.allowed_origins == ["http://d/"]
