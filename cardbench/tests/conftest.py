"""Shared fixtures of the benchmark's CPU tests (run them with
``python -m pytest cardbench/tests -q`` from the repository's root)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    here, when the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def manifest():
    from cardbench import run
    return run.manifest()


def tiny(man, cell, **traffic):
    """A cell's configuration and traffic at a size the CPU runs in
    seconds: the same path, grid 32, 4 coils, newton 3, cg 6."""
    import json

    from cardbench import run
    w = run.cell_of(man, cell)
    cfg = dict(run.config_of(man, w["config"]), n=16, grid=32, ncoils=4,
               newton=3, cg_iters=6)
    tf = json.loads((ROOT / "cardbench" / "workloads"
                     / f"{w['traffic']}.json").read_text())
    tf.update(cycle=4, traced_frames=2)
    tf.update(traffic)
    return cfg, tf
