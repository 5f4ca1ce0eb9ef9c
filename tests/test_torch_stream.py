"""The port's streaming engine against the JAX package's, on the CPU.

* ``FrameStream`` over 3 frames matches JAX's ``FrameStream`` at the
  shallow operating point (n=16, J=4, newton 3, cg 10), <= 1e-5 relative;
* a resume: JAX runs frames 0-1, ``convert.carry_from_numpy`` takes its
  ``last_carry``, the port runs frames 2-3, and the movie matches JAX's
  own continuation;
* the engine's pieces: ``DoubleBuffer`` discipline, ``LatencyReport``,
  ``latency_stats``, ``stream_movie`` == ``reconstruct_movie``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.nlinv.recon import Reconstructor as JReconstructor
from repro.nlinv.stream import FrameStream as JFrameStream
from repro_torch import convert
from repro_torch.nlinv import phantom
from repro_torch.nlinv.operators import sobolev_weight
from repro_torch.nlinv.recon import Reconstructor, reconstruct_movie
from repro_torch.nlinv.stream import (DoubleBuffer, FrameStream,
                                      LatencyReport, latency_stats,
                                      stream_movie)

NEWTON, CG = 3, 10


@pytest.fixture(scope="module")
def movie_data():
    return phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=4, seed=2)


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_frame_stream_matches_jax(movie_data):
    d = movie_data
    args = (d["y"][:3], d["masks"][:3], d["fov"])
    jmovie, _ = JFrameStream(JReconstructor(newton=NEWTON, cg_iters=CG),
                             damping=0.9).run(*args)
    stream = FrameStream(Reconstructor(device="cpu", newton=NEWTON,
                                       cg_iters=CG), damping=0.9)
    movie, report = stream.run(*args)
    assert tuple(movie.shape) == (3, d["grid"], d["grid"])
    assert _rel_max(movie.numpy(), jmovie) <= 1e-5
    s = report.summary()
    assert s["frames"] == 3 and s["devices"] == 1 and s["ncoils"] == 4
    assert len(s["frame_ms"]) == 3
    assert set(stream.last_carry) == {"u", "x_ref"}


def test_resume_from_jax_carry(movie_data):
    d = movie_data
    jstream = JFrameStream(JReconstructor(newton=NEWTON, cg_iters=CG),
                           damping=0.9)
    jstream.run(d["y"][:2], d["masks"][:2], d["fov"])
    # numpy copy first: JAX's continuation donates these buffers
    carry_np = jax.tree.map(np.asarray, jstream.last_carry)
    carry_np = jax.tree.map(np.copy, carry_np)
    jcont, _ = jstream.run(d["y"][2:], d["masks"][2:], d["fov"],
                           carry=jstream.last_carry)
    carry = convert.carry_from_numpy(carry_np, device="cpu")
    stream = FrameStream(Reconstructor(device="cpu", newton=NEWTON,
                                       cg_iters=CG), damping=0.9)
    movie, _ = stream.run(d["y"][2:], d["masks"][2:], d["fov"], carry=carry)
    assert _rel_max(movie.numpy(), jcont) <= 1e-5
    # the final carry goes back to numpy and matches JAX's
    back = convert.carry_to_numpy(stream.last_carry)
    want = jax.tree.map(np.asarray, jstream.last_carry)
    for part in ("u", "x_ref"):
        for k in ("rho", "chat"):
            assert back[part][k].dtype == np.complex64
            assert _rel_max(back[part][k], want[part][k]) <= 1e-5


def test_carry_from_numpy_copies():
    arr = np.ones((2, 2), np.complex64)
    t = convert.carry_from_numpy({"rho": arr}, device="cpu")["rho"]
    t.mul_(3)
    assert arr[0, 0] == 1


def test_stream_movie_equals_blocking_loop(movie_data):
    d = {k: v[:2] if k in ("y", "masks", "rho") else v
         for k, v in movie_data.items()}
    movie, _ = stream_movie(d, newton=2, cg_iters=5, device="cpu")
    ref = reconstruct_movie(d, newton=2, cg_iters=5, device="cpu")
    assert torch.equal(movie, ref)


def test_donated_carry_is_updated_in_place(movie_data):
    d = movie_data
    rec = Reconstructor(device="cpu", newton=2, cg_iters=4)
    g = d["grid"]
    u0 = rec.init_carry(4, g)
    keep = u0["rho"]
    args = (rec.put_frame(d["y"][0]), rec.put_const(d["masks"][0]),
            rec.put_const(d["fov"]), rec.put_const(sobolev_weight(g)))
    u, _ = rec.fn_donate_carry(*args, u0, {k: v.clone()
                                           for k, v in u0.items()})
    assert u is u0 and u["rho"] is keep
    assert not torch.equal(keep, torch.ones_like(keep))


def test_double_buffer_discipline():
    buf = DoubleBuffer(lambda i: (torch.full((2,), float(i)),))
    assert not buf.ready
    with pytest.raises(RuntimeError):
        buf.take()
    buf.stage(1)
    with pytest.raises(RuntimeError):
        buf.stage(2)
    (t,) = buf.take()
    assert float(t[0]) == 1.0 and not buf.ready


def test_latency_report_and_stats(tmp_path):
    one = latency_stats([5.0])
    assert one["p50_ms"] == one["p95_ms"] == 5.0 and one["jitter_ms"] == 0.0
    rep = LatencyReport([100.0, 10.0, 12.0], 1, 32, 4)
    s = rep.summary()
    assert s["first_frame_ms"] == 100.0 and s["mean_ms"] == 11.0
    assert "plan_cache" not in s
    path = rep.save(tmp_path / "lat.json")
    assert json.loads(path.read_text())["frames"] == 3
