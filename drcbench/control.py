"""The lower-precision control of a cell (``core/control.py``), from the
root of a checkout:

    python3 drcbench/control.py --workload <cell> --seed <n> --seconds <s>

It prints the harness's result line, whose ``correct`` must read false."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT
    from drcbench.core.control import main

    sys.exit(main(t0=T0))
