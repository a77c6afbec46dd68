"""A run with the timed path broken underneath must read ``correct`` false,
once for each fault a cell can have: a step that returns its state
unchanged (the last request's answers again), half of the batch left out
(the other half answered with copies), and an answer altered where it is
produced. A sound run and the lower-precision control bound the two sides.
Every cell is on one chip, so there is no exchange between chips to leave
out."""

import json

import pytest

from conftest import add_takes_cell, run_cell
from drcbench.core import control

CELLS = ["dfaust.encode", "sim1m.encode"]


class Stale:
    """Answers every request after the first with the first's answers."""

    def __init__(self, entry):
        self.entry, self.first = entry, None

    def prepare(self, takes):
        return self.entry.prepare(takes)

    def run(self, request):
        if self.first is None:
            self.first = self.entry.run(request)
        return self.first

    def timings(self):
        return self.entry.timings()


class Half(Stale):
    """Runs the first half of each batch, answers the rest with copies of
    its answers (a single-frame request loses its frame to the previous
    request's)."""

    def run(self, request):
        if len(request) == 1:
            out = self.first or self.entry.run(request)
            self.first = self.entry.run(request)
            return out
        done = self.entry.run(request[: (len(request) + 1) // 2])
        return (done * 2)[: len(request)]


class Altered(Stale):
    """Alters one answer where it is produced: a byte of the last blob."""

    def run(self, request):
        out = list(self.entry.run(request))
        last = out[-1]
        out[-1] = last[:-3] + bytes([last[-3] ^ 0x10]) + last[-2:]
        return out


class SwappedFaces(Stale):
    """Hands each request's second take's frames over with its first
    take's faces: the frames go to the wrong topology."""

    def prepare(self, takes):
        takes = list(takes)
        takes[1] = (takes[0][0], takes[1][1])
        return self.entry.prepare(takes)

    def run(self, request):
        return self.entry.run(request)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, capsys, cell):
    res = run_cell(tiny_root, cell, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert all(v["value"] == 0 for v in res["compared"].values())


@pytest.mark.parametrize("fault", [Stale, Half, Altered],
                         ids=["state-unchanged", "half-batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_reads_not_correct(tiny_root, capsys, cell, fault):
    res = run_cell(tiny_root, cell, capsys, seconds=1.0,
                   entry_wrapper=fault)
    assert res["attempted"] >= 2
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_reads_not_correct(tiny_root, capsys,
                                                       cell):
    capsys.readouterr()
    rc = control.main(["--workload", cell, "--seed", "424242",
                       "--seconds", "0.2"], device="cpu",
                      require_cuda=False, root=tiny_root, workers=1)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False


def test_a_take_given_another_takes_faces_reads_not_correct(tiny_root,
                                                             capsys):
    add_takes_cell(tiny_root, takes=())  # one lattice, so the faces fit
    res = run_cell(tiny_root, "takes.encode", capsys,
                   entry_wrapper=SwappedFaces)
    assert res["compared"]["blobs_wrong"]["value"] > 0
    assert res["correct"] is False


def test_the_control_of_a_cell_of_takes_reads_not_correct(tiny_root,
                                                          capsys):
    add_takes_cell(tiny_root)
    capsys.readouterr()
    rc = control.main(["--workload", "takes.encode", "--seed", "424243",
                       "--seconds", "0.2"], device="cpu",
                      require_cuda=False, root=tiny_root, workers=1)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["compared"]["blobs_wrong"]["value"] > 0
