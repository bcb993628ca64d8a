"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
nothing reads the JAX package's bench files, and the reference imports
nothing of the port."""

import ast
import os
import sys

import pytest

from gpubench import harness, spec

SOURCES = [os.path.join(dp, f) for dp, _, fs in os.walk(spec.HERE) for f in fs
           if f.endswith(".py") and os.sep + "tests" not in dp]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    text = open(path).read()
    for name in ("bench.py", "chip_smoke.py", "BENCH_r0", "MULTICHIP_r0"):
        assert name not in text, name


@pytest.mark.parametrize("name", ["reference.py", "check.py", "datagen.py", "bounds.py"])
def test_the_reference_and_the_yardstick_import_nothing_of_the_port(name):
    tops = {n.split(".", 1)[0] for n in _imports(os.path.join(spec.HERE, name))}
    assert "pilosa_tpu_torch" not in tops


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pilosa_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())
    assert "pilosa_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pilosa_tpu.ops", sys)
    assert "pilosa_tpu.ops" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in harness.forbidden_modules()
