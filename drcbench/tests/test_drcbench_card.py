"""The command without a card exits 2 and prints no result; on the card
(marker ``cuda``, skipped without one), every cell runs at a shrunk size
and reads correct."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def test_without_a_card_the_command_exits_2_and_prints_nothing():
    if _cuda():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "drcbench/run.py", "--workload",
         "dfaust.encode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dfaust.encode", "sim1m.encode"])
def test_every_cell_runs_on_the_card(tiny_root, capsys, cell):
    if not _cuda():
        pytest.skip("needs a CUDA device")
    from drcbench.core.harness import main

    capsys.readouterr()
    rc = main(["--workload", cell, "--seed", "31337", "--seconds", "1",
               "--trace", "1"], device="cuda", root=tiny_root, workers=1)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
