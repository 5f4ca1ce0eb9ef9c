"""A run with its timed path broken underneath comes out not correct: the
harness's path on the CPU at a tiny size, past its look for a card, with
one fault planted in the program for each fault the cell can have (a
one-card, one-scanner stream has no batch to halve and no exchange
between cards to leave out); and the control (the reference stored in bfloat16) fails the limits."""

import pytest

import _faults
from cardbench import check
from cardbench import run as bench
from conftest import tiny


def _run(manifest, cell, **kw):
    cfg, tf = tiny(manifest, cell)
    line, ctx = bench.run_cell(manifest, cell, 2 ** 31 + 11, 0.5, False,
                               device="cpu", config=cfg, traffic=tf, **kw)
    return line, ctx


@pytest.mark.parametrize("cell", ["rt768.stream"])
def test_sound_runs_are_correct(manifest, cell):
    line, ctx = _run(manifest, cell)
    assert line["correct"], line["checks"]
    assert line["checks"]["frame_rel_err"]["value"] < 1e-5
    assert ctx.frames > 0 and ctx.latency_ms


@pytest.mark.parametrize("cell,fault", [
    ("rt768.stream", "state_unchanged"),
    ("rt768.stream", "answer_altered"),
])
def test_a_fault_makes_the_run_incorrect(manifest, monkeypatch, cell, fault):
    from repro_torch.nlinv.recon import Reconstructor
    if fault == "state_unchanged":
        monkeypatch.setattr(Reconstructor, "_frame_donate",
                            _faults.frozen_frame)
    else:
        monkeypatch.setattr(Reconstructor, "_frame_image",
                            _faults.altered_image(Reconstructor._frame_image))
    line, _ = _run(manifest, cell)
    assert not line["correct"]
    assert line["checks"]["frame_rel_err"]["value"] > \
        check.LIMITS["frame_rel_err"]


@pytest.mark.parametrize("cell", ["rt768.stream"])
def test_the_control_fails_the_limit(manifest, cell):
    _, ctx = _run(manifest, cell, control=True)
    ok, checks = check.verdict(check.readings(ctx.control_compared))
    assert not ok
    assert checks["frame_rel_err"]["value"] > check.LIMITS["frame_rel_err"]
