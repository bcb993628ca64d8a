#!/usr/bin/env python3
"""Time K1's staged variant for several ST_QB (queries per tape pass).

    python3 tools/k1_qb_sweep.py [QB ...]      # default: 1 2 4 8

Run from the root of a checkout on a machine with one CUDA card. For each
QB it builds pilosa_tpu_torch/csrc/bitplane_kernels.cu with -DST_QB=QB
into pilosa_tpu_torch/_build/, checks the staged variant against the
plain twin at the serving shape (U=128, S=256, W=32768, Q=256) for a
2-leaf Intersect and a 4-leaf Difference nest, and prints the kernel's
device time (torch.profiler) beside the streaming variant's, with the
registers of the set-op and the BSI instantiations. Imports nothing of
JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pilosa_tpu_torch.ops import kernels  # noqa: E402
from pilosa_tpu_torch.parallel.engine import lower_tape  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_qb_sweep: no CUDA device available", file=sys.stderr)
        return 2
    qbs = [int(x) for x in sys.argv[1:]] or [1, 2, 4, 8]
    print(cs.nvidia_smi())
    rng = np.random.default_rng(11)
    u, s, w, q = 128, 256, 32768, 256
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    stacked = torch.randint(-(1 << 31), (1 << 31) - 1, (u, s, w), dtype=torch.int32,
                            device="cuda", generator=g)
    leaf = cs.leaf
    cases = {
        "2-leaf Intersect": (
            lower_tape(("Intersect", (leaf(0), leaf(1)))),
            torch.from_numpy(np.ascontiguousarray(cs.distinct_pairs(rng, u, q).T.astype(np.int32)))),
        "4-leaf Difference nest": (
            lower_tape(("Difference", ("Union", (leaf(0), leaf(1))),
                        (("Intersect", (leaf(2), leaf(3))),))),
            torch.from_numpy(rng.integers(0, u, (4, q)).astype(np.int32))),
    }
    wants = {name: kernels.gather_expr_count_plain(stacked, idxs, tape)
             for name, (tape, idxs) in cases.items()}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    for qb in qbs:
        lib = os.path.join(kernels.BUILD_DIR, f"libbitplane_kernels_qb{qb}.so")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DST_QB={qb}",
                               "-Xptxas", "-v", "-o", lib, kernels.SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        report = (proc.stdout + proc.stderr).splitlines()
        regs = []
        # The instantiations without hoist programs (HOIST = false).
        for inst, name in (("Lb0", "set-op"), ("Lb1", "BSI")):
            at = next(j for j, line in enumerate(report)
                      if f"k1_staged_kernelILi3E{inst}ELb0E" in line)
            regs.append(name + " " + next(line.split(":", 1)[1].strip()
                                          for line in report[at:] if "Used" in line))
        kernels.LIBRARY, kernels._lib = lib, None
        times = []
        for name, (tape, idxs) in cases.items():
            for v in kernels.K1_VARIANTS:
                got = kernels.gather_expr_count(stacked, idxs, tape, variant=v)
                torch.cuda.synchronize()
                assert torch.equal(got, wants[name]), (qb, name, v)
            ms = {v: cs.kernel_ms(torch, lambda v=v: kernels.gather_expr_count(
                stacked, idxs, tape, variant=v), f"k1_{v}_kernel")[0]
                for v in kernels.K1_VARIANTS}
            times.append(f"{name}: staged {ms['staged']:.4f} ms, "
                         f"streaming {ms['streaming']:.4f} ms")
        print(f"ST_QB={qb} ({'; '.join(regs)}): " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
