"""tools/pilint over the port, with no edit to the linter.

pilint's rules match paths under `pilosa_tpu/` (its wiring files, R2's
jax-free zones, R8's and R9's judged modules, R11's config surface), so
pointed at `pilosa_tpu_torch/` as it stands most rules would lint
nothing. The port's package is therefore staged as `pilosa_tpu/` under a
temporary root, beside a copy of `docs/` (R6's failpoint table, R7's
span table, with the port's own span rows from
`pilosa_tpu_torch/obs/README.md` appended) and the port's tests (R6's
activation specs), and that root is linted. Every rule runs; the tree
must have zero unannotated violations. A planted violation proves the staged tree is really judged.

The rule that cannot apply to the port, and why (it runs, and finds
nothing to judge): R8 (guarded materialization) judges jax's async
dispatch: a jitted program's value is forced by `np.asarray`/
`device_get`/`block_until_ready`, and must be forced inside the fault
guard. The port dispatches no jitted programs; a torch kernel's fault
surfaces at `.item()`/`.cpu()`, which the rule does not know, and the
port's guards wrap those reads by hand (held by
tests/test_torch_faults.py). R2 (jax-free zones) applies and holds
trivially: no module of the port imports jax (tests/test_torch_rules.py
checks that for every module).
"""

import os
import shutil
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from tools.pilint.core import parse_annotations  # noqa: E402
from tools.pilint.rules import ALL_RULES  # noqa: E402
from tools.pilint.runner import lint_paths  # noqa: E402

NOT_APPLICABLE = {"R8"}


def stage(root):
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    shutil.copytree(os.path.join(REPO_ROOT, "pilosa_tpu_torch"),
                    os.path.join(root, "pilosa_tpu"), ignore=ignore)
    shutil.copytree(os.path.join(REPO_ROOT, "docs"), os.path.join(root, "docs"))
    # The spans only the port records are documented beside it; R7 reads
    # them from the staged span table.
    with open(os.path.join(REPO_ROOT, "pilosa_tpu_torch", "obs", "README.md")) as f:
        port_doc = f.read()
    with open(os.path.join(root, "docs", "observability.md"), "a") as f:
        f.write("\n" + port_doc)
    os.makedirs(os.path.join(root, "tests"))
    for name in os.listdir(os.path.join(REPO_ROOT, "tests")):
        if name.startswith("test_torch_") and name.endswith(".py"):
            shutil.copy(os.path.join(REPO_ROOT, "tests", name),
                        os.path.join(root, "tests", name))
    return str(root)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    return stage(tmp_path_factory.mktemp("pilint") / "root")


def test_port_is_clean(staged):
    vs = lint_paths([os.path.join(staged, "pilosa_tpu")], repo_root=staged)
    assert vs == [], "\n".join(str(v) for v in vs)


def test_not_applicable_rules_are_known_rules():
    ids = {rule_id for rule_id, _ in ALL_RULES}
    assert NOT_APPLICABLE < ids


PLANTS = {
    # A swallowed broad except in the executor.
    "R1": ("executor.py", "\n\ndef _planted():\n    try:\n        work()\n"
           "    except Exception:\n        pass\n"),
    # A blocking call under a lock in the holder.
    "R3": ("core/holder.py", "\n\ndef _planted(lock):\n    import time\n\n"
           "    with lock:\n        time.sleep(1)\n"),
    # A failpoint fired that docs/durability.md's table does not list.
    "R6": ("core/fragment.py", "\n\ndef _planted():\n    from .. import failpoints\n\n"
           "    failpoints.fire(\"no-such-planted-point\")\n"),
}


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_planted_violation_is_caught(tmp_path, rule):
    root = stage(tmp_path / "root")
    rel, code = PLANTS[rule]
    with open(os.path.join(root, "pilosa_tpu", rel), "a") as f:
        f.write(code)
    vs = lint_paths([os.path.join(root, "pilosa_tpu")], repo_root=root,
                    rules=[rule])
    assert any(v.rule == rule and v.path.endswith(rel) for v in vs), vs


def test_every_annotation_carries_reason():
    total = 0
    for root, _dirs, files in os.walk(os.path.join(REPO_ROOT, "pilosa_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            full = os.path.join(root, name)
            with open(full, encoding="utf-8") as f:
                annotations, grammar = parse_annotations(full, f.read())
            assert grammar == [], grammar
            total += len(annotations)
            assert all(len(a.reason) >= 4 for a in annotations), (full, annotations)
    assert total > 0
