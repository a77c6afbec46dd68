"""torchdraco's corpus over several processes (torchdraco/parallel/
multihost.py) on the CPU: the slicing against tpudraco's, one process
against tpudraco's, and two processes joined by torch.distributed
on the gloo backend over localhost, through the function and through the
torchdraco-corpus CLI, against one process's files. Every subprocess has a
timeout, so that a hang fails its test."""

import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.io import save_obj, save_ply  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from torchdraco.parallel import multihost as tmh  # noqa: E402
from tpudraco.parallel import multihost as jmh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two topologies of 6 x 6 and 5 x 5 grids with normals and UVs (PLY),
    single meshes (OBJ), a broken file, and sub/m60.ply, whose output name
    collides with m60.ply's; the sorted slicing gives the two to different
    ranks of two. Returns (input directory, the inputs)."""
    d = str(tmp_path_factory.mktemp("mh_in"))
    os.makedirs(os.path.join(d, "sub"))
    paths = []
    for n, seed, count in ((6, 1, 4), (5, 3, 3)):
        pos, faces = torchdraco.make_mesh_batch(count, n, seed)
        nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
        for i, m in enumerate(torchdraco.build_meshes(pos, faces, nrm, uvs)):
            paths.append(os.path.join(d, f"m{n}{i}.ply"))
            save_ply(m, paths[-1])
    for j in range(3):
        pos, faces = torchdraco.make_mesh_batch(1, 4 + j, 10 + j)
        paths.append(os.path.join(d, f"s{j}.obj"))
        save_obj(torchdraco.build_meshes(pos, faces)[0], paths[-1])
    paths.append(os.path.join(d, "broken.obj"))
    with open(paths[-1], "w") as f:
        f.write("v 0 0\nf 1 2 9\n")
    pos, faces = torchdraco.make_mesh_batch(1, 7, 20)
    paths.append(os.path.join(d, "sub", "m60.ply"))
    save_ply(torchdraco.build_meshes(pos, faces)[0], paths[-1])
    return d, paths


def _drc_files(out) -> dict:
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.endswith(".drc")}


@pytest.mark.parametrize("world", (1, 2, 3, 5))
def test_shard_corpus_matches_tpudraco(world):
    inputs = [f"d/f{i:02d}.ply" for i in (7, 3, 11, 0, 5, 9, 1)]
    got = [tmh.shard_corpus(inputs, r, world) for r in range(world)]
    assert got == [jmh.shard_corpus(inputs, r, world) for r in range(world)]
    assert sorted(p for part in got for p in part) == sorted(inputs)


def test_single_process_matches_tpudraco(corpus, tmp_path):
    _, inputs = corpus
    rep = tmh.encode_corpus_multihost(inputs, str(tmp_path / "port"),
                                      device="cpu")
    jrep = jmh.encode_corpus_multihost(inputs, str(tmp_path / "jax"))
    files = _drc_files(tmp_path / "port")
    assert files == _drc_files(tmp_path / "jax")
    assert len(files) == rep["encoded"] == jrep["encoded"] == 10
    assert "num_hosts" not in rep
    failed = sorted(f["path"] for f in rep["failed"])
    assert failed == sorted(f["path"] for f in jrep["failed"])
    assert failed == sorted(inputs[-2:])  # the broken file, the collision
    with open(tmp_path / "port" / "corpus_report.json") as f:
        assert json.load(f)["encoded"] == 10


def test_rank_card_is_current_and_window_passes(monkeypatch, corpus,
                                               one_process, tmp_path):
    """A rank without a named card takes ``cuda:<LOCAL_RANK mod cards>``
    and makes it the current device; a named card is made current too,
    the CPU is left alone. ``device_window`` reaches ``encode_corpus``."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmh._rank_device(None) == "cuda:1"
    assert tmh._rank_device("cuda") == "cuda:1"
    assert tmh._rank_device("cuda:0") == "cuda:0"
    assert tmh._rank_device("cpu") == "cpu"
    assert chosen == [torch.device("cuda", 1)] * 2 + [torch.device("cuda",
                                                                   0)]
    monkeypatch.undo()
    windows = []
    real = tbatch.BatchEncoder.encode_corpus

    def spy(self, *a, **kw):
        windows.append(kw.get("device_window"))
        return real(self, *a, **kw)
    monkeypatch.setattr(tbatch.BatchEncoder, "encode_corpus", spy)
    _, inputs = corpus
    tmh.encode_corpus_multihost(inputs, str(tmp_path / "w"), device="cpu",
                                device_window=3)
    assert windows == [3]
    assert _drc_files(tmp_path / "w") == one_process[1]


_WORKER = """
import json, sys
sys.path.insert(0, {root!r})
from torchdraco.parallel import encode_corpus_multihost, init_distributed
rank, world = init_distributed()
assert world == 2, world
rep = encode_corpus_multihost({inputs!r}, {out!r}, device="cpu")
with open({out!r} + f"/../rank{{rank}}.json", "w") as f:
    json.dump(rep, f)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _two_ranks(cmd_for_rank):
    """Run two ranks on a free localhost port; returns (return code,
    standard output, standard error) of each."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), TORCHDRACO_ROUTE_CACHE="",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            cmd_for_rank(rank), env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, *o) for p, o in zip(procs, outs)]


@pytest.fixture(scope="module")
def one_process(corpus, tmp_path_factory):
    _, inputs = corpus
    out = str(tmp_path_factory.mktemp("one") / "out")
    rep = tbatch.BatchEncoder(device="cpu",
                              route_cache_path=None).encode_corpus(inputs,
                                                                   out)
    return rep, _drc_files(out)


def test_two_processes_match_one(corpus, one_process, tmp_path):
    _, inputs = corpus
    rep1, files1 = one_process
    out = str(tmp_path / "out")
    os.makedirs(out)
    script = _WORKER.format(root=ROOT, inputs=inputs, out=out)
    for rc, _, err in _two_ranks(lambda r: [sys.executable, "-c", script]):
        assert rc == 0, err[-3000:]
    assert _drc_files(out) == files1
    reps = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            reps.append(json.load(f))
    with open(os.path.join(out, "corpus_report.json")) as f:
        reps.append(json.load(f))
    for rep in reps:  # the merged totals on both ranks and on disk
        assert rep["num_hosts"] == 2
        for k in ("encoded", "skipped", "total_in_bytes", "total_out_bytes"):
            assert rep[k] == rep1[k], k
    assert sorted(f["path"] for r in reps[:2] for f in r["failed"]) \
        == sorted(f["path"] for f in rep1["failed"])


def test_two_processes_through_the_cli(corpus, one_process, tmp_path):
    d, _ = corpus
    _, files1 = one_process
    out = str(tmp_path / "out")
    runs = _two_ranks(lambda r: [
        sys.executable, "-m", "torchdraco.tools.corpus", "encode", "-i", d,
        os.path.join(d, "sub"), "-o", out, "--device", "cpu", "--window",
        "3"])
    reports = []
    for rc, text, err in runs:
        assert rc in (0, 1), err[-3000:]  # 1: the rank's failed files
        reports.append(json.loads(text))
        assert rc == int(bool(reports[-1]["failed"]))
    assert _drc_files(out) == files1
    assert [r["num_hosts"] for r in reports] == [2, 2]
    assert reports[0]["encoded"] == reports[1]["encoded"] == len(files1)
