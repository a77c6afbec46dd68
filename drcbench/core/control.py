"""The lower-precision control: the reference put in the program's place,
computed one step below the precision the configuration states. The
attributes are float32, so the step is bfloat16: the control encodes the
frames' attributes rounded to bfloat16. The benchmark's own runs
never use it; ``python drcbench/control.py`` runs it through the harness's
window and comparison, and ``correct`` must come out false.

    python3 drcbench/control.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

from ..reference import pool
from . import harness


class Control:
    """Wraps a cell's entry: ``prepare`` computes the control's outputs of
    each request (its k-th call is request k of the traffic, its frames
    named by (take, frame) pairs), ``run`` returns them."""

    def __init__(self, entry, config: dict, traffic: dict, seed: int,
                 workers: int) -> None:
        self.entry = entry
        self.config, self.traffic, self.seed = config, traffic, seed
        self.workers = workers
        self.made = 0

    def prepare(self, takes):
        ids = harness.request_frames(self.traffic, self.made)
        self.made += 1
        if self.made == 1:  # every request's frames in one pool
            n = (int(self.traffic["distinct_requests"])
                 + int(self.traffic["warm_requests"]))
            every = [f for r in range(n)
                     for f in harness.request_frames(self.traffic, r)]
            self.blobs = dict(zip(every, pool.encode(
                self.config, self.seed, every, self.workers,
                precision="bfloat16")[0]))
        return [self.blobs[f] for f in ids]

    def run(self, outputs):
        return outputs

    def timings(self) -> dict:
        return {}


def main(argv=None, **kwargs) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="drcbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    root = kwargs.get("root", harness.ROOT)
    cell = harness.Cell(root, args.workload)
    workers = kwargs.pop("workers", None) or pool.default_workers()

    def wrap(entry):
        return Control(entry, cell.config, cell.traffic, args.seed,
                       workers)

    return harness.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "0"], entry_wrapper=wrap,
                        max_requests=2 * int(cell.traffic["distinct_requests"]),
                        workers=workers, **kwargs)
