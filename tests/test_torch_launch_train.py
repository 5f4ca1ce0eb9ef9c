"""The port's training launcher, ``python -m repro_torch.launch.train``, on
a SMOKE arch with ``--device cpu``: a few steps with a checkpoint, then
again from the same directory, resuming where the first run stopped; a
crash in a step resumes from the last checkpoint through the restart
envelope and ends on the uninterrupted run's parameters (bitwise on the
CPU).  On 2 gloo ranks (``--mesh 2x1`` and ``1x2``): the one-rank
launcher's losses within 1e-5, a crash at step 2 on every rank resumed as
one rank resumes, and a checkpoint saved on ``2x1`` resumed on one
rank.  An MoE arch on ``1x3`` (8 experts padded to 9 over the model
axis) saves checkpoints of 8 experts, which resume on one rank and on
``1x2``."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.ckpt import list_steps
from repro_torch.launch.train import main

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "2", "--seq", "16",
        "--log-every", "1"]
RANKS = ["--rank-timeout", "120"]
MESH_TOL = 1e-5
# granite's SMOKE config: 8 experts, which 3 model ranks pad to 9
MOE = ["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "6",
       "--seq", "16", "--log-every", "1", "--steps", "4"]


def _close_losses(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= MESH_TOL, (k, got[k], want[k])


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


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_mesh_of_two_ranks_trains_to_the_one_rank_losses(mesh):
    argv = ARGS + ["--steps", "4"]
    one = main(argv, device="cpu")
    two = main(argv + ["--mesh", mesh] + RANKS, device="cpu")
    assert two["step"] == 4 and two["state"] is None
    _close_losses(two["losses"], one["losses"])


def test_mesh_crash_resumes_as_one_rank(tmp_path):
    argv = ARGS + ["--steps", "6", "--ckpt-every", "2"]
    clean = main(argv, device="cpu")
    out = main(argv + ["--mesh", "2x1", "--ckpt-dir", str(tmp_path)] +
               RANKS, device="cpu", step_hook=torch_ranks.CrashOnce(2))
    assert out["resumed"] == [2] and out["step"] == 6
    _close_losses(out["losses"], clean["losses"])
    assert list_steps(tmp_path)[-1] == 6


def test_mesh_checkpoint_resumes_on_one_rank(tmp_path):
    """A run saved on ``2x1`` (rank 0 writes every leaf whole), its last
    checkpoint taken away, resumes from step 4 on one rank and ends on the
    uninterrupted one-rank run's losses and parameters."""
    argv = ARGS + ["--steps", "6"]
    clean = main(argv, device="cpu")
    ck = ["--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    main(argv + ["--mesh", "2x1"] + ck + RANKS, device="cpu")
    assert list_steps(tmp_path) == [2, 4, 6]
    shutil.rmtree(tmp_path / "step_6")
    out = main(argv + ck, device="cpu")
    assert out["resumed"] == [4]
    _close_losses(out["losses"], {k: clean["losses"][k] for k in (4, 5)})
    a = dict(out["state"]["params"].named_parameters())
    for name, p in clean["state"]["params"].named_parameters():
        torch.testing.assert_close(a[name], p, atol=1e-4, rtol=0,
                                   msg=name)
    assert int(out["state"]["opt"]["step"]) == 6


@pytest.fixture(scope="module")
def padded_mesh_run(tmp_path_factory):
    """Granite's SMOKE config on ``1x3``, 4 steps with a checkpoint every
    2 steps: its losses (the padded init draws 9 experts, so they are not
    the one-rank run's) and its checkpoints."""
    ck = tmp_path_factory.mktemp("moe_1x3")
    run = main(MOE + ["--mesh", "1x3", "--ckpt-every", "2", "--ckpt-dir",
                      str(ck)] + RANKS, device="cpu")
    return run, ck


def test_padded_mesh_checkpoint_holds_the_real_experts(padded_mesh_run):
    """The JAX launcher's layout: every expert stack and router of the
    checkpoint has n_experts = 8 rows (columns), not the mesh's 9."""
    _, ck = padded_mesh_run
    with np.load(ck / "step_4" / "arrays.npz") as data:
        stacks = [k for k in data.files if "/moe/experts/" in k]
        routers = [k for k in data.files if k.endswith("/moe/router")]
        assert stacks and routers
        assert all(data[k].shape[0] == 8 for k in stacks)
        assert all(data[k].shape[1] == 8 for k in routers)


@pytest.fixture(scope="module")
def padded_resumes(padded_mesh_run, tmp_path_factory):
    """The ``1x3`` run's step-2 checkpoint (its step-4 one taken away)
    resumed to step 4 on one rank, on ``1x2`` and on ``1x3``."""
    _, ck = padded_mesh_run
    out = {}
    for mesh in (None, "1x2", "1x3"):
        d = tmp_path_factory.mktemp("resume") / "ck"
        shutil.copytree(ck, d)
        shutil.rmtree(d / "step_4")
        argv = MOE + ["--ckpt-every", "2", "--ckpt-dir", str(d)]
        if mesh is not None:
            argv += ["--mesh", mesh] + RANKS
        out[mesh] = main(argv, device="cpu")
    return out


def test_padded_mesh_checkpoint_resumes_on_its_mesh(padded_mesh_run,
                                                    padded_resumes):
    """Padded again on resume, the ``1x3`` run ends on its uninterrupted
    losses."""
    run, _ = padded_mesh_run
    out = padded_resumes["1x3"]
    assert out["resumed"] == [2] and out["step"] == 4
    _close_losses(out["losses"], {k: run["losses"][k] for k in (2, 3)})


def test_padded_mesh_checkpoint_resumes_unpadded(padded_resumes):
    """On one rank and on ``1x2`` (8 experts split 4 and 4) the
    checkpoint loads without padding and both runs end on the same
    losses.  They are not the ``1x3`` run's: the load-balancing loss
    scales with the expert count it is given, padded or not, in both
    packages (``moe.apply``'s ``lb_loss``)."""
    one, two = padded_resumes[None], padded_resumes["1x2"]
    for out in (one, two):
        assert out["resumed"] == [2] and out["step"] == 4
    _close_losses(two["losses"], one["losses"])
