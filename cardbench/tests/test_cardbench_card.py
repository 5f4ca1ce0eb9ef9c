"""The benchmark on the card (``python -m pytest -q -m cuda
cardbench/tests``): every one-card cell runs once, short, through its
command, and comes out correct.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_one_card_cells_run_and_are_correct(card, manifest, trace):
    for w in manifest["workloads"]:
        if w["chips"] != 1:
            continue
        got = subprocess.run(
            [sys.executable, "-m", "cardbench.run", "--workload", w["name"],
             "--seed", str(2 ** 31 + 17), "--seconds", "3",
             "--trace", str(trace)], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        assert got.returncode == 0, got.stderr[-3000:]
        line = json.loads(got.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["failed"] == 0, line["checks"]
        assert line["device"]["platform"] == "gpu"
        assert list(line)[-1] == "checks"


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card):
    got = subprocess.run(
        [sys.executable, "-m", "cardbench.control", "--workload",
         "rt768.stream", "--seconds", "3", "--seeds", "1",
         "--control-seeds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["program_max"] <= out["limit"] < out["control_min"]
