"""The benchmark's one command, from the root of a checkout:

    python3 drcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It sets up the cell, measures a closed loop of requests for ``--seconds``,
checks every output against the plain reference and prints one JSON line.
Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT
    from drcbench.core.harness import main

    sys.exit(main(t0=T0))
