"""torchdraco's bench (``python -m torchdraco.bench``) on the CPU, as a
rehearsal at a tiny size: its inputs equal the root bench.py's, its host
step equals bench.py's, each metric runs in-process and returns a line in
bench.py's format with the device it ran on, each device path raises where
its bytes or its round trip diverge, and the command runs in a process
that refuses JAX and tpudraco and fails, naming ``--device cpu``, where
there is no card."""

import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from torchdraco import bench as tb  # noqa: E402
from torchdraco import ops as tops  # noqa: E402
from torchdraco.parallel import BatchEncoder  # noqa: E402
from torchdraco.parallel.decode_batch import BatchDecoder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = {"TORCHDRACO_BENCH_BATCH": "8", "TORCHDRACO_BENCH_N": "12",
        "TORCHDRACO_BENCH_HUGE_N": "32"}
KERNELS = ("predict_residual", "histogram", "rans_words_scan",
           "rans_scan_dense", "rans_decode_lanes", "normal_encode_cuda",
           "normal_decode_cuda", "uv_encode_cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """The bench's size knobs at batch 8, grids of 12 and a lone grid of
    32, and its inputs on the CPU."""
    monkeypatch.setattr(tb, "BATCH", 8)
    monkeypatch.setattr(tb, "N", 12)
    monkeypatch.setattr(tb, "HUGE_N", 32)
    return tb._setup(CPU)


def _root_bench_function(name: str):
    """A function of the root bench.py, compiled from its source alone:
    importing the module would set JAX's compile cache for the process."""
    path = os.path.join(ROOT, "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np}
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), ns)
    return ns[name]


def _assert_line(res: dict, metric: str) -> None:
    assert res["metric"] == "rehearsal_" + metric
    assert res["device"] == {"platform": "cpu"} and res["rehearsal"] is True
    assert res["value"] > 0 and res["unit"]
    if "baseline_measured" in res:
        assert res["baseline_measured"] > 0 and res["vs_baseline"] > 0
    # no card: the trace's keys are there, and say nothing
    assert res["device_idle_share"] is None
    assert res["device_busy_ms"] is None
    assert set(res["launches"]) == set(KERNELS)
    assert all(v == 0 for v in res["launches"].values())
    text = json.dumps(res)
    assert "tunnel" not in text and "link_" not in text


def test_setup_equals_graft_entry(tiny):
    positions, faces, gn, gathers = tiny
    want_pos, want_faces = graft._make_mesh_batch(batch=8, n=12, seed=1)
    np.testing.assert_array_equal(positions, want_pos)
    np.testing.assert_array_equal(faces, want_faces)
    want = graft._topology_gathers(want_pos[0], want_faces)
    assert set(gn) == set(want) == set(gathers)
    for k, v in want.items():
        np.testing.assert_array_equal(gn[k], np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(gathers[k].numpy(), np.asarray(v),
                                      err_msg=k)
        assert gathers[k].device == CPU


def test_host_step_once_equals_bench_py(tiny, monkeypatch):
    """bench.py's host step keeps no result: its np.bincount calls are
    recorded. Both equal the histograms of the port's fused step."""
    positions, _, gn, gathers = tiny
    got = tb._host_step_once(positions, gn)
    seen = []
    real = np.bincount

    def record(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    ref_step = _root_bench_function("_host_step_once")
    monkeypatch.setattr(np, "bincount", record)
    ref_step(positions, gn)
    monkeypatch.setattr(np, "bincount", real)
    assert len(got) == len(seen) == len(positions)
    for a, b in zip(got, seen):
        np.testing.assert_array_equal(a, b)
    _, counts = tb._device_step(torch.from_numpy(positions), gathers)
    np.testing.assert_array_equal(counts.numpy(), np.stack(got))


def _run_metric(name, tiny):
    positions, faces, gn, gathers = tiny
    return {
        "corpus": lambda: tb.bench_corpus_auto(positions, faces, CPU),
        "e2e": lambda: tb.bench_e2e(positions, faces, CPU),
        "breakdown": lambda: tb.bench_e2e_breakdown(positions, faces, CPU),
        "step": lambda: tb.bench_step(positions, gn, gathers, CPU),
        "decode": lambda: tb.bench_decode(positions, gathers, CPU),
        "decode-corpus": lambda: tb.bench_decode_corpus(positions, faces,
                                                        CPU),
        "huge": lambda: tb.bench_huge(CPU, n=32),
    }[name]()


@pytest.mark.parametrize("name, metric", [
    ("corpus", "corpus_encode_auto_throughput"),
    ("e2e", "device_encode_e2e_throughput"),
    ("breakdown", "device_encode_e2e_breakdown"),
    ("step", "device_encode_step_throughput"),
    ("decode", "device_rans_decode_throughput"),
    ("decode-corpus", "decode_corpus_throughput"),
    ("huge", "device_huge_mesh_throughput"),
])
def test_metric_line(name, metric, tiny):
    res = _run_metric(name, tiny)
    _assert_line(res, metric)
    if name == "corpus":
        assert len(res["routing"]) == 3
        assert res["auto_cold_s"] > 0 and res["auto_cold_cached_s"] > 0
        assert res["route_cache_hits"] >= 0
        assert res["bulk_device_mbs"] > 0 and res["bulk_host_mbs"] > 0
        assert "device_fallbacks" not in res
    elif name == "breakdown":
        assert {"signatures_ms", "topology_ms", "position_ms", "chains_ms",
                "assembly_ms", "total_ms", "mbps", "h2d_mb",
                "d2h_mb", "device_top_ops"} <= set(res)
        # the 12-bit pack of 8 meshes of 144 vertices at -qp 11
        assert res["h2d_mb"] == 8 * 144 * 3 * 1.5 / 1e6
    elif name == "decode":
        assert res["lanes"] == 8 and res["symbols_per_lane"] == 432
        assert res["wrapper_ms"] > 0
    elif name == "decode-corpus":
        assert res["normals_host_mps"] > 0 and res["normals_phased_mps"] > 0


def _diverge(monkeypatch, target, name):
    """Patch ``target.name`` to return what the real one returns, changed:
    a byte flipped in each blob, a symbol moved, or the meshes dropped."""
    real = getattr(target, name)

    def wrong(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, bytes):
            return out[:-1] + bytes([out[-1] ^ 1])
        if isinstance(out, list):
            return [b[:-1] + bytes([b[-1] ^ 1]) if isinstance(b, bytes)
                    else None for b in out]
        if isinstance(out, tuple):
            return (out[0] + 1, *out[1:])
        return out.to(torch.int64) + 1

    monkeypatch.setattr(target, name, wrong)


@pytest.mark.parametrize("name, target, attr", [
    ("corpus", BatchEncoder, "encode_meshes_auto"),
    ("e2e", BatchEncoder, "encode_meshes_device"),
    ("step", tops, "encode_step_from_q_cuda"),
    ("decode", tops, "rans_decode_lanes"),
    ("decode-corpus", BatchDecoder, "decode_blobs_shared_topology"),
    ("huge", BatchEncoder, "encode_mesh_device"),
])
def test_device_path_divergence_raises(name, target, attr, tiny,
                                       monkeypatch):
    _diverge(monkeypatch, target, attr)
    with pytest.raises(RuntimeError, match="diverge"):
        _run_metric(name, tiny)


def test_busy_union():
    assert tb._busy_us([]) == 0
    assert tb._busy_us([(5, 9), (0, 2), (1, 3), (8, 10), (4, 4)]) == 8


def test_card_line(monkeypatch):
    """The device object of a line on the card: its name, the count and
    the power limit that nvidia-smi reads."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return types.SimpleNamespace(
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n", returncode=0)

    monkeypatch.setattr(tb.subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tb._card.cache_clear()
    try:
        res = tb._result("device_encode_e2e_throughput", 100.0, "MB/s",
                         50.0, torch.device("cuda", 0))
    finally:
        tb._card.cache_clear()
    assert res == {"metric": "device_encode_e2e_throughput",
                   "device": {"platform": "gpu",
                              "name": "NVIDIA H100 80GB HBM3", "count": 1,
                              "power_limit_w": 700.0},
                   "value": 100.0, "unit": "MB/s", "baseline_measured": 50.0,
                   "vs_baseline": 2.0}
    assert calls[0][:2] == ["nvidia-smi", "--id=0"]


# the command in a process where jax and tpudraco cannot be imported
_NO_JAX_RUN = """
import json, runpy, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpudraco"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, ROOT)
sys.argv = ["torchdraco.bench", *ARGS]
try:
    runpy.run_module("torchdraco.bench", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tpudraco"))),
      file=sys.stderr)
sys.exit(rc)
"""


def _bench_process(args, **env):
    return subprocess.run(
        [sys.executable, "-c",
         f"ROOT, ARGS = {ROOT!r}, {args!r}\n" + _NO_JAX_RUN],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, **TINY, OMP_NUM_THREADS="1", **env))


def test_command_rehearsal_loads_no_jax():
    proc = _bench_process(["--metric", "corpus", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    assert lines[0]["metric"] == "rehearsal_corpus_encode_auto_throughput"
    assert lines[0]["device"] == {"platform": "cpu"}
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == []


def test_command_without_a_card_names_device_cpu():
    proc = _bench_process(["--metric", "e2e"], CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 2
    assert "--device cpu" in proc.stderr
    assert not any(ln.startswith("{") for ln in proc.stdout.splitlines())


def test_sizes_follow_the_knobs():
    code = ("import json, torchdraco.bench as b; "
            "print(json.dumps([b.BATCH, b.N, b.HUGE_N, b.SLICES]))")
    env = dict(os.environ, **TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert json.loads(out.stdout) == [8, 12, 32, 16]
    for k in TINY:
        env.pop(k)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert json.loads(out.stdout) == [512, 64, 768, 16]
