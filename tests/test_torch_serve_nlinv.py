"""The port's batched NLINV frame and NLINV serving workload, on the CPU.

* ``Reconstructor.fn_batched(width)``: row k equals the port's ``fn`` on
  client k within 1e-5, width 1 equals ``fn`` bitwise, and a row whose CG
  stops early (a client fed a zero acquisition) matches its unbatched
  solve and its ``cg_log`` counts; the plan key holds the channel sum's
  schedule and the solver's form, as the JAX package's (the unfused
  batched frame: ``test_torch_batched_unfused.py``);
* ``NlinvStreamWorkload`` through ``StreamScheduler`` (the port of
  ``tests/test_serve_scheduler.py``'s 1-device parity: K = 3 clients,
  F = 4 frames, n = 16, J = 4, newton 2, cg 4, buckets (1, 2, 4), client 0
  skipping tick 2): each client within 1e-5 of its own ``stream_movie``
  and of the JAX package's workload on the same data, and the batched
  plans built at widths {2, 4}, never 3;
* quarantine isolation (after ``tests/test_fault_injection.py``, with the
  NaN acquisition submitted directly; the injector's runs are in
  ``test_torch_ft_serve.py``): the poisoned frame ``Rejected``, the
  client streaming on, the other clients bitwise equal to a clean run;
* a bucket whose width holds while the last client skips a tick (K = 4,
  buckets (1, 2, 4), client 3 skipping tick 2): the stacked carry is
  rebuilt, and each client stays within 1e-5 of its own ``stream_movie``;
* a JAX workload's stacked carry through ``repro_torch.convert``, resumed
  in the port: the same next frame within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from repro.nlinv.recon import Reconstructor as JReconstructor
from repro.serve import NlinvStreamWorkload as JWorkload
from repro.serve import ServeConfig as JServeConfig
from repro.serve import StreamScheduler as JScheduler
from repro.serve import stack_carries as jstack_carries
from repro_torch import convert
from repro_torch.core.plan import PlanCache
from repro_torch.nlinv import phantom
from repro_torch.nlinv.operators import sobolev_weight
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.nlinv.stream import stream_movie
from repro_torch.serve import (NlinvStreamWorkload, Rejected, ServeConfig,
                               StreamScheduler, stack_carries,
                               unstack_carry)

K, F, NCOILS = 3, 4, 4
NEWTON, CG = 2, 4
SKIPPED = [(0, 2)]        # client 0 skips tick 2


@pytest.fixture(scope="module")
def datas():
    return [phantom.make_dataset(n=16, ncoils=NCOILS, nspokes=7, frames=F,
                                 seed=s) for s in range(K)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the batched frame -------------------------------------------------------

def _frame_inputs(rec, datas, frame=0, ys=None):
    g = datas[0]["grid"]
    ys = [d["y"][frame] for d in datas] if ys is None else ys
    y = torch.stack([rec.put_frame(v) for v in ys])
    m = torch.stack([rec.put_const(d["masks"][frame]) for d in datas])
    fov = rec.put_const(datas[0]["fov"])
    w = rec.put_const(sobolev_weight(g))
    u0 = stack_carries([rec.init_carry(NCOILS, g) for _ in datas])
    return y, m, fov, w, u0


def _unbatched(rec, y, m, fov, w, u0):
    """Each row through the unbatched frame: (u rows, images, CG logs)."""
    out = []
    for b in range(y.shape[0]):
        row = unstack_carry(u0, b)
        start = len(rec.cg_log)
        u, img = rec.fn(y[b], m[b], fov, w, row,
                        {k: v.clone() for k, v in row.items()})
        out.append((u, img, rec.cg_log[start:]))
    return out


def test_batched_frame_matches_each_client(datas):
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    y, m, fov, w, u0 = _frame_inputs(rec, datas)
    ref = _unbatched(rec, y, m, fov, w, u0)
    rec.cg_log.clear()
    u, img = rec.fn_batched(K)(y, m, fov, w, u0,
                               {k: v.clone() for k, v in u0.items()})
    assert tuple(img.shape) == (K, 32, 32)
    assert tuple(u["chat"].shape) == (K, NCOILS, 32, 32)
    for b, (ub, ib, log) in enumerate(ref):
        assert _rel(img[b], ib) <= 1e-5
        for k in ub:
            assert _rel(u[k][b], ub[k]) <= 1e-5
        # one tuple a CG solve, each row's count its own solve's
        assert [c[b] for c in rec.cg_log] == log
    assert all(len(c) == K for c in rec.cg_log)


def test_batched_frame_at_width_one_is_the_frame_bitwise(datas):
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    y, m, fov, w, u0 = _frame_inputs(rec, datas[:1])
    (ub, ib, log), = _unbatched(rec, y, m, fov, w, u0)
    rec.cg_log.clear()
    u, img = rec.fn_batched(1)(y, m, fov, w, u0,
                               {k: v.clone() for k, v in u0.items()})
    assert torch.equal(img[0], ib)
    assert all(torch.equal(u[k][0], ub[k]) for k in ub)
    assert [c[0] for c in rec.cg_log] == log


def test_early_stopped_row_matches_its_own_solve(datas):
    """Client 1 sends a zero acquisition: its residual is 0 from the
    start, so its CG runs no iteration while the others run theirs."""
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    ys = [datas[0]["y"][0], np.zeros_like(datas[1]["y"][0]),
          datas[2]["y"][0]]
    y, m, fov, w, u0 = _frame_inputs(rec, datas, ys=ys)
    ref = _unbatched(rec, y, m, fov, w, u0)
    assert ref[1][2] == [0] * NEWTON and ref[0][2] != [0] * NEWTON
    rec.cg_log.clear()
    u, img = rec.fn_batched(K)(y, m, fov, w, u0,
                               {k: v.clone() for k, v in u0.items()})
    for b, (ub, ib, log) in enumerate(ref):
        assert [c[b] for c in rec.cg_log] == log
        np.testing.assert_allclose(img[b].numpy(), ib.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for k in ub:
            np.testing.assert_allclose(u[k][b].numpy(), ub[k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_batched_frame_donates_and_checks_its_width(datas):
    rec = Reconstructor(device="cpu", newton=1, cg_iters=2)
    y, m, fov, w, u0 = _frame_inputs(rec, datas)
    keep = u0["rho"]
    u, _ = rec.fn_batched(K, donate=True)(
        y, m, fov, w, u0, {k: v.clone() for k, v in u0.items()})
    assert u is u0 and u["rho"] is keep
    with pytest.raises(ValueError, match="width 2"):
        rec.fn_batched(2)(y, m, fov, w, u0, u0)


def test_batched_plan_is_shared_and_logs_to_its_caller(datas):
    """Two reconstructors of one configuration share the width's plan (one
    build), and each solve logs into the caller's own ``cg_log``."""
    cache = PlanCache()
    recs = [Reconstructor(device="cpu", newton=1, cg_iters=2)
            for _ in range(2)]
    for rec in recs:
        rec.plan_cache = cache
        y, m, fov, w, u0 = _frame_inputs(rec, datas)
        rec.fn_batched(K)(y, m, fov, w, u0,
                          {k: v.clone() for k, v in u0.items()})
        assert len(rec.cg_log) == 1 and len(rec.cg_log[0]) == K
    assert cache.builds == 1 and cache.hits == 1
    recs[0].newton = 2                   # another depth: a plan of its own
    recs[0].fn_batched(K)
    assert cache.builds == 2


@pytest.mark.parametrize("field,other", [("overlap", "p2p"),
                                         ("fused", False)])
def test_batched_plan_key_holds_the_schedule_and_form(field, other):
    """Two reconstructors on one group and one cache that differ only in
    the channel sum's schedule, or only in the solver's form, build a
    batched plan each (2 builds, 0 hits), as the JAX package does."""
    from repro.core.plan import PlanCache as JPlanCache
    for make, cache in ((lambda **kw: Reconstructor(device="cpu", **kw),
                         PlanCache()),
                        (lambda **kw: JReconstructor(None, **kw),
                         JPlanCache())):
        for kw in ({}, {field: other}):
            rec = make(newton=NEWTON, cg_iters=CG, **kw)
            rec.plan_cache = cache
            rec.fn_batched(2)
        assert (cache.builds, cache.hits) == (2, 0), type(cache)


# -- the serving workload ----------------------------------------------------

def _serve(datas, sched, sessions, skipped=(), poison=()):
    for f in range(F):
        for k, d in enumerate(datas):
            if (k, f) in skipped:
                continue
            y = d["y"][f]
            if (k, f) in poison:
                y = np.full_like(y, np.nan)
            assert sched.submit(sessions[k], (y, d["masks"][f]))
        sched.tick()
    sched.drain()


def _port_scheduler(datas, rec=None):
    rec = rec or Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    sched = StreamScheduler(NlinvStreamWorkload(rec, damping=0.9),
                            ServeConfig(max_concurrency=4,
                                        buckets=(1, 2, 4)))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                     fov=d["fov"]) for k, d in enumerate(datas)]
    return rec, sched, ss


@pytest.fixture(scope="module")
def jax_results(datas):
    """The JAX package's workload through its scheduler on the same data
    and skip pattern: each client's images, as numpy."""
    rec = JReconstructor(None, newton=NEWTON, cg_iters=CG,
                         channel_sum="crop")
    sched = JScheduler(JWorkload(rec, damping=0.9),
                       JServeConfig(max_concurrency=4, buckets=(1, 2, 4)))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                     fov=d["fov"]) for k, d in enumerate(datas)]
    _serve(datas, sched, ss, skipped=SKIPPED)
    return [[np.asarray(r) for r in s.results] for s in ss]


def test_scheduler_parity(datas, jax_results):
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    rec.plan_cache = PlanCache()        # this run's plans alone
    rec, sched, ss = _port_scheduler(datas, rec)
    _serve(datas, sched, ss, skipped=SKIPPED)
    for k in range(K):
        frames = [f for f in range(F) if (k, f) not in SKIPPED]
        sub = dict(datas[k], y=datas[k]["y"][frames],
                   masks=datas[k]["masks"][frames])
        ref, _ = stream_movie(sub, newton=NEWTON, cg_iters=CG, damping=0.9,
                              device="cpu")
        assert len(ss[k].results) == len(frames) == len(jax_results[k])
        for i in range(len(frames)):
            assert _rel(ss[k].results[i], ref[i]) <= 1e-5, (k, i)
            assert _rel(ss[k].results[i], jax_results[k][i]) <= 1e-5, (k, i)
    # the scheduler's buckets: widths 2 and 4 were built, never 3, each a
    # plan of its own keyed on its width
    widths = {key[3] for key in rec.plan_cache._plans
              if key[:2] == ("nlinv", "frame_batched")}
    assert widths == {2, 4}
    report = sched.report()
    assert report["aggregate"]["frames"] == K * F - len(SKIPPED)
    assert report["aggregate"]["ft"]["quarantined"] == 0


def test_last_client_skipping_in_a_full_bucket_keeps_every_stream(datas):
    """Four clients fill a width-4 bucket; when client 3 skips tick 2 the
    three left still launch at width 4 with client 2 repeated as the pad.
    The stack of ticks 0-1 (rows 0-3) must not be reused for it: row 3
    would solve client 2's frame on client 3's carry, and the spill would
    hand that row to client 2."""
    four = list(datas) + [phantom.make_dataset(
        n=16, ncoils=NCOILS, nspokes=7, frames=F, seed=K)]
    skipped = [(3, 2)]
    _, sched, ss = _port_scheduler(four)
    _serve(four, sched, ss, skipped=skipped)
    for k, d in enumerate(four):
        frames = [f for f in range(F) if (k, f) not in skipped]
        sub = dict(d, y=d["y"][frames], masks=d["masks"][frames])
        ref, _ = stream_movie(sub, newton=NEWTON, cg_iters=CG, damping=0.9,
                              device="cpu")
        assert len(ss[k].results) == len(frames)
        for i in range(len(frames)):
            assert _rel(ss[k].results[i], ref[i]) <= 1e-5, (k, i)


def test_quarantine_isolates_a_poisoned_client(datas):
    _, clean, cs = _port_scheduler(datas)
    _serve(datas, clean, cs)
    _, sched, ss = _port_scheduler(datas)
    _serve(datas, sched, ss, poison=[(1, 1)])
    assert isinstance(ss[1].results[1], Rejected)
    assert ss[1].poisoned == 1
    assert sched.report()["aggregate"]["ft"]["quarantined"] == 1
    # the quarantined client streams on from a fresh carry
    assert not any(isinstance(r, Rejected) for r in ss[1].results[2:])
    assert all(bool(torch.isfinite(r).all()) for r in ss[1].results[2:])
    # every other client's frames, and the client's own frame before the
    # poison, are bitwise those of the clean run
    for k in (0, 2):
        assert all(torch.equal(a, b) for a, b in zip(ss[k].results,
                                                     cs[k].results))
    assert torch.equal(ss[1].results[0], cs[1].results[0])


def test_workload_levels_and_geometry(datas):
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    wl = NlinvStreamWorkload(rec)
    assert wl.levels == 1 and wl._points == ((2, 4), (1, 2))
    wl.set_level(1)
    assert (rec.newton, rec.cg_iters) == (1, 2)
    with pytest.raises(ValueError, match="outside"):
        wl.set_level(2)
    sched = StreamScheduler(wl)
    d = datas[0]
    sched.open(grid=d["grid"], ncoils=NCOILS, fov=d["fov"])
    with pytest.raises(ValueError, match="one protocol per scheduler"):
        sched.open(grid=d["grid"], ncoils=NCOILS + 2, fov=d["fov"])
    assert set(wl.counters()) == {"retried_tasks", "quarantined",
                                  "remeshes"}


def test_stacked_jax_carry_resumes_in_the_port(datas):
    """Two clients stream frames 0-1 through the JAX workload; their
    carries, stacked by JAX's ``stack_carries``, cross into the port,
    which solves frame 2 for both in one batched frame: within 1e-5 of
    the JAX workload's frame 2."""
    two = datas[:2]
    rec = JReconstructor(None, newton=NEWTON, cg_iters=CG,
                         channel_sum="crop")
    wl = JWorkload(rec, damping=0.9)
    sched = JScheduler(wl, JServeConfig(buckets=(1, 2)))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=NCOILS,
                     fov=d["fov"]) for k, d in enumerate(two)]
    for f in range(2):
        for k, d in enumerate(two):
            sched.submit(ss[k], (d["y"][f], d["masks"][f]))
        sched.tick()
    wl._spill()
    stacked = {part: jstack_carries([s.state[part] for s in ss])
               for part in ("u", "x_ref")}
    carry = convert.carry_from_numpy(
        jax.tree.map(lambda a: np.array(a), stacked), device="cpu")
    for k, d in enumerate(two):
        sched.submit(ss[k], (d["y"][2], d["masks"][2]))
    sched.tick()
    want = [np.asarray(s.results[2]) for s in ss]

    port = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    g = two[0]["grid"]
    y = torch.stack([port.put_frame(d["y"][2]) for d in two])
    m = torch.stack([port.put_const(d["masks"][2]) for d in two])
    _, img = port.fn_batched(2)(y, m, port.put_const(two[0]["fov"]),
                                port.put_const(sobolev_weight(g)),
                                carry["u"], carry["x_ref"])
    for k in range(2):
        assert _rel(img[k], want[k]) <= 1e-5
