"""The port's example drivers (``examples/torch_*.py``) run end to end on the
CPU with ``--device cpu`` at a smoke size, each in a subprocess with a
timeout, and print what their reference drivers print."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": (["--ranks", "2"],
                   ["reduce == sum: True", "fft roundtrip: True",
                    "quickstart OK"]),
    "mri_realtime": (["--frames", "3", "--n", "32", "--coils", "4",
                      "--newton", "5"],
                     ["steady", "plan cache: frame builds",
                      "nlinv beats gridding: True"]),
    "mri_service": (["--clients", "3", "--frames", "3", "--n", "16",
                     "--coils", "4", "--newton", "2", "--cg", "4"],
                    ["tick 2: scanner2 connected", "scanner2        3",
                     "aggregate: 9 frames"]),
    "serve_lm": ([], ["served 6 requests, 72 tokens", "req 0:"]),
    "train_lm": (["--steps", "4"], ["step     3 loss", "final loss"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    argv, wants = CASES[name]
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         "--device", "cpu", *argv], capture_output=True, text=True,
        timeout=120, env=env, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-2000:]
    for want in wants:
        assert want in run.stdout, (want, run.stdout[-2000:])
