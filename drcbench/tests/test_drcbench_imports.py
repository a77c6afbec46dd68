"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program."""

import re
import subprocess
import sys
import textwrap

from conftest import ROOT

BLOCKER = textwrap.dedent("""
    import sys
    class Refuse:
        def __init__(self, names):
            self.names = names
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.names:
                raise ModuleNotFoundError(f"refused: {name}")
    sys.meta_path.insert(0, Refuse(NAMES))
    sys.path.insert(0, ROOT)
""")


def _python(code: str, names: tuple) -> str:
    src = BLOCKER.replace("NAMES", repr(names)).replace(
        "ROOT", repr(str(ROOT))) + textwrap.dedent(code)
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
        import json, shutil, sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT / 'drcbench' / 'tests')!r})
        from conftest import shrink
        root = Path({str(tmp_path)!r}) / "c"
        shutil.copytree({str(ROOT / 'drcbench')!r}, root / "drcbench")
        shutil.copy({str(ROOT / 'BENCHMARK.json')!r}, root / "BENCHMARK.json")
        shrink(root)
        from drcbench.core.harness import main
        for cell in ("dfaust.encode", "sim1m.encode"):
            assert main(["--workload", cell, "--seed", "5", "--seconds",
                         "0.2", "--trace", "1"], device="cpu",
                        require_cuda=False, root=root, workers=1) == 0
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print("TOPS", json.dumps(tops))
    """
    out = _python(code, ("jax", "jaxlib", "flax", "tpudraco"))
    tops = set(__import__("json").loads(out.split("TOPS ")[-1]))
    assert "torchdraco" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpudraco"}


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
        import json, sys
        from drcbench.reference import pool
        cfg = json.loads(open({str(ROOT / 'drcbench/configs/dfaust-pnt.json')!r}).read())
        cfg.update(lattice=[10, 12], uv=dict(cfg["uv"], chart_size=4))
        pool.encode(cfg, 3, [(0, 0), (1, 0)], workers=2)
        pool.encode(cfg, 3, [(0, 2)], workers=1, precision="bfloat16")
        print("TOPS", json.dumps(sorted({{m.split(".")[0]
                                          for m in sys.modules}})))
    """
    out = _python(code, ("jax", "jaxlib", "flax", "tpudraco", "torchdraco",
                         "torch"))
    tops = set(__import__("json").loads(out.split("TOPS ")[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "tpudraco", "torchdraco",
                       "torch"}


IMPORT = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)


def test_no_source_names_jax_and_the_reference_names_no_program():
    for path in (ROOT / "drcbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in IMPORT.findall(path.read_text())}
        assert not tops & {"jax", "jaxlib", "flax", "tpudraco"}, path
        if "reference" in path.parts:
            assert "torchdraco" not in tops and "torch" not in tops, path
