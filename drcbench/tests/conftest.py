"""The benchmark's CPU tests. They run the harness on the CPU (the program's
plain twins, ``device="cpu"``) over a copy of the benchmark shrunk to a
size a test run holds: lattices of some hundred vertices, charts of a
few, a few frames a request."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(root: Path, lattice=(11, 14), chart: int = 4,
           frames: int = 3) -> None:
    """The configurations at ``lattice`` (rows, columns) vertices in charts
    of ``chart`` a side, ``frames`` frames a group request."""
    for p in (root / "drcbench" / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["lattice"] = list(lattice)
        d["uv"]["chart_size"] = chart
        p.write_text(json.dumps(d))
    for p in (root / "drcbench" / "workloads").glob("*.json"):
        d = json.loads(p.read_text())
        if d["frames_per_request"] > 1:
            d["frames_per_request"] = frames
        p.write_text(json.dumps(d))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark (BENCHMARK.json and drcbench/) at a tiny
    size."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "drcbench", root / "drcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shrink(root)
    return root


def run_cell(root: Path, cell: str, capsys, seed: int = 2 ** 31 + 9,
             seconds: float = 0.5, trace: int = 0, **kwargs) -> dict:
    """One CPU run of ``cell`` through the harness; its result line."""
    from drcbench.core.harness import main

    capsys.readouterr()
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], device="cpu",
              require_cuda=False, root=root, workers=1, **kwargs)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
