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


# an entry over the router: the program's mesh building a take, then
# BatchEncoder.encode_meshes_auto over every mesh of the request; it keeps
# each take's topology_signature
AUTO_ENTRY = '''"""build_meshes a take, then encode_meshes_auto over the request."""

import numpy as np


class Entry:
    def __init__(self, config, traffic, device):
        from torchdraco.encode import Config
        from torchdraco.models import AttributeType
        from torchdraco.parallel.batch import BatchEncoder

        q = config["quantization"]
        self.encoder = BatchEncoder(cfg=Config(quant_bits={
            AttributeType.POSITION: q["position"],
            AttributeType.NORMAL: q["normal"],
            AttributeType.TEX_COORD: q["tex_coord"]}), device=device,
            route_cache_path=None)
        self.device = device
        self.signatures = []

    def prepare(self, takes):
        return [(faces, *(np.stack([f[k] for f in frames]) for k in range(3)))
                for faces, frames in takes]

    def run(self, request):
        from torchdraco import build_meshes
        from torchdraco.parallel.batch import topology_signature

        meshes, sigs = [], []
        for faces, pos, nrm, uvs in request:
            built = build_meshes(pos, faces, nrm, uvs)
            sigs.append(topology_signature(built[0]))
            meshes += built
        self.signatures.append(sigs)
        return self.encoder.encode_meshes_auto(meshes, device=self.device)

    def timings(self):
        return {}
'''


def add_takes_cell(root: Path, takes=((7, 9), (10, 8)), per_request: int = 3,
                   frames: int = 2, cell: str = "takes.encode") -> dict:
    """Adds, as new files and new entries of BENCHMARK.json only, a cell
    whose requests span ``per_request`` takes of ``frames`` frames each
    through ``AUTO_ENTRY``; its configuration lists ``takes`` (lattices)
    where there are any. Returns the configuration."""
    d = root / "drcbench"
    cfg = json.loads((d / "configs/dfaust-pnt.json").read_text())
    cfg["name"] = "takes-pnt"
    if takes:
        cfg["takes"] = [{"lattice": list(t)} for t in takes]
    (d / "configs/takes-pnt.json").write_text(json.dumps(cfg))
    (d / "workloads/takes-encode.json").write_text(json.dumps(
        {"entry": "encode_auto", "loop": "closed", "clients": 1,
         "frames_per_request": per_request * frames,
         "takes_per_request": per_request, "distinct_requests": 2,
         "warm_requests": 1}))
    (d / "entries/encode_auto.py").write_text(AUTO_ENTRY)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "takes-pnt", "source": "a test",
                            "file": "drcbench/configs/takes-pnt.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "takes-pnt",
                              "traffic": "takes-encode", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dfaust.encode" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cfg


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
