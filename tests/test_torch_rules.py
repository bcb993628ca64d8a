"""Rules of the PyTorch/CUDA port.

(i)   No module of pilosa_tpu_torch, and not chip_smoke.py, imports jax or
      any pilosa_tpu module. Checked by a static scan of the source: the
      test environment pre-imports jax (tests/conftest.py), so a
      sys.modules check would prove nothing.
(ii)  Entry points run on the card unless the caller asks for the CPU:
      with no CUDA device, Holder(path) and Server() raise.
(iii) A kernel that cannot be built raises; a CUDA tensor never falls
      back to a kernel's plain twin (held on a card in
      tests/test_torch_cuda.py).
"""

import ast
import os

import pytest
import torch

import pilosa_tpu_torch
from pilosa_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pilosa_tpu_torch")


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out.extend(os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    return sorted(out)


def forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "pilosa_tpu" or name.startswith("pilosa_tpu."))


@pytest.mark.parametrize(
    "path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_pilosa_tpu_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)
              and forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_package():
    names = {os.path.relpath(p, PKG) for p in port_sources()}
    for must in ("executor.py", "parallel/engine.py", "ops/kernels.py",
                 "core/fragment.py", "core/holder.py", "server/server.py",
                 "sched/batcher.py", "translate.py", "cluster/syncer.py",
                 "parallel/collective.py", "parallel/distributed.py",
                 "cdc/log.py", "cdc/manager.py", "cdc/pit.py",
                 "cdc/standing.py", "cluster/rebalance.py",
                 "cluster/resize.py", "cluster/topology.py",
                 "geo/manager.py", "geo/tail.py", "server/mux.py",
                 "cluster/autoscale.py", "devtools/lockcheck.py",
                 "iterator.py", "uri.py", "storage/btree_containers.py"):
        assert must in names


def test_holder_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Holder() takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pilosa_tpu_torch.Holder(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pilosa_tpu_torch.Holder(None, device="cuda")
    h = pilosa_tpu_torch.Holder(None, device="cpu")
    assert h.device == torch.device("cpu")


def test_server_without_device_needs_cuda():
    """The server is an entry point: the card unless the caller asks for
    the CPU, and it raises before building anything."""
    from pilosa_tpu_torch.server.server import Server

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Server() takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(data_dir=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(data_dir=None, device="cuda")


def test_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of leaving a library-less
    module that would quietly count on the CPU."""
    monkeypatch.setattr(kernels, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        kernels.build(force=True)
