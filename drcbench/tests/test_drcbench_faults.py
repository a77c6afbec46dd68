"""A run with the timed path broken underneath must read ``correct`` false,
once for each fault a cell can have: a step that returns its state
unchanged (the last request's answers again), half of the batch left out
(the other half answered with copies), and an answer altered where it is
produced. A sound run and the lower-precision control bound the two sides.
Every cell is on one chip, so there is no exchange between chips to leave
out."""

import pytest

from conftest import run_cell
from drcbench.core import control

CELLS = ["dfaust.encode", "sim1m.encode"]


class Stale:
    """Answers every request after the first with the first's answers."""

    def __init__(self, entry):
        self.entry, self.first = entry, None

    def prepare(self, faces, items):
        return self.entry.prepare(faces, items)

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
    import json
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
