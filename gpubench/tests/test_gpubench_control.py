"""The controls at the cell's own size, on the card: the cell run with the
fault that breaks its configuration's guarantee, on three seeds, must
come out not correct. The taxi cell's guarantee is that an acknowledged
write is seen by every later read (control: writes acknowledged and
lost). Run on a card:

    python -m pytest gpubench/tests/test_gpubench_control.py -m cuda -s
"""

import gc
import json

import pytest

from gpubench import harness
from gpubench.tests import faults

CONTROLS = [("taxi-1b.groupby-live", "drop_writes")]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,fault", CONTROLS)
def test_the_control_is_not_correct_at_the_cells_size(card, capsys, tmpdir_env, cell, fault, seed):
    import torch

    hooks = harness.Hooks()
    hooks.after_server = faults.ALL[fault]
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "5",
                       "--trace", "0"], hooks=hooks)
    out = capsys.readouterr().out.strip().splitlines()
    gc.collect()
    torch.cuda.empty_cache()
    assert rc == 0
    line = json.loads(out[-1])
    print(f"control {cell} {fault} seed {seed}: checks {json.dumps(line['checks'])}")
    assert line["correct"] is False
