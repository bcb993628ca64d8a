"""Run pytest under the port's runtime lock checker
(pilosa_tpu_torch/devtools/lockcheck.py) and write its report.

    python tests/torch_lockcheck_run.py REPORT.json [pytest arguments]

The checker is loaded by file path and installed before pytest, the
test modules or the port are imported, so module-level locks and every
instance lock are built through its instrumented factories (as
tests/conftest.py does for the reference's checker under
PILOSA_TPU_LOCKCHECK=1, which must stay unset here). Seeding
sys.modules makes the package import reuse this instance. Exits with
pytest's code; the report is written either way.
"""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    out, args = argv[0], argv[1:]
    name = "pilosa_tpu_torch.devtools.lockcheck"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "pilosa_tpu_torch", "devtools", "lockcheck.py"))
    lockcheck = importlib.util.module_from_spec(spec)
    sys.modules[name] = lockcheck
    spec.loader.exec_module(lockcheck)
    lockcheck.install()
    import pytest

    rc = pytest.main(args)
    lockcheck.write_report(out)
    if lockcheck.findings():
        print("\n" + lockcheck.report())
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
