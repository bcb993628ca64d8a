"""The benchmark of pilosa_tpu_torch: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See gpubench/harness.py; BENCHMARK.json names the cells and metrics."""

import os
import sys
import time

T_PROC = time.monotonic()

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from gpubench import harness

    sys.exit(harness.main(t_proc=T_PROC))
