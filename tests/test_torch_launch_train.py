"""The port's training launcher, ``python -m repro_torch.launch.train``, on
a SMOKE arch with ``--device cpu``: a few steps with a checkpoint, then
again from the same directory, resuming where the first run stopped; a
crash in a step resumes from the last checkpoint through the restart
envelope and ends on the uninterrupted run's parameters (bitwise on the
CPU); a mesh of more than one rank is refused."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.ckpt import list_steps
from repro_torch.launch.train import main

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "2", "--seq", "16",
        "--log-every", "1"]


def test_cli_trains_then_resumes_from_its_checkpoint(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
           "--device", "cpu", "--ckpt-every", "4", "--ckpt-dir",
           str(tmp_path)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    first = subprocess.run(cmd + ["--steps", "6"], capture_output=True,
                           text=True, timeout=120, env=env)
    assert first.returncode == 0, first.stderr
    assert "step     5 loss" in first.stdout and "final loss" in \
        first.stdout
    assert list_steps(tmp_path) == [4, 6]
    again = subprocess.run(cmd + ["--steps", "8"], capture_output=True,
                           text=True, timeout=120, env=env)
    assert again.returncode == 0, again.stderr
    assert "resumed from step 6" in again.stdout
    assert "step     5 loss" not in again.stdout
    assert "step     6 loss" in again.stdout
    assert list_steps(tmp_path)[-1] == 8


def test_crash_resumes_and_matches_the_uninterrupted_run(tmp_path):
    argv = ARGS + ["--steps", "6", "--ckpt-every", "2"]
    clean = main(argv + ["--ckpt-dir", str(tmp_path / "clean")],
                 device="cpu")
    crashed = {"n": 0}

    def crash(step, metrics):
        if step == 2 and not crashed["n"]:
            crashed["n"] += 1
            raise RuntimeError("simulated node failure")

    out = main(argv + ["--ckpt-dir", str(tmp_path / "crash")],
               device="cpu", step_hook=crash)
    assert crashed["n"] == 1 and out["resumed"] == [2]
    assert out["step"] == clean["step"] == 6
    assert out["losses"] == clean["losses"]
    a = dict(out["state"]["params"].named_parameters())
    for name, p in clean["state"]["params"].named_parameters():
        assert torch.equal(a[name], p), name
    assert int(out["state"]["opt"]["step"]) == 6


def test_mesh_of_more_than_one_rank_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
        main(ARGS + ["--steps", "1", "--mesh", "2x1"], device="cpu")
