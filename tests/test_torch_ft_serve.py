"""The port's NLINV service under injected faults, on 1, 2 and 4 gloo
ranks on the CPU, held against the JAX package's (after
``tests/test_fault_injection.py``'s subprocess tests, at their size: n =
16, 4 coils, 7 spokes, newton 2, cg 6).

* ``SERVE_CHAOS`` on 1, 2 and 4 ranks: a transient solve absorbed by the
  task retry, one client's tick items poisoned (that frame ``Rejected``,
  the client quarantined once and streaming on, everything else bitwise
  the clean run's), a transient step requeued (full parity) and a seeded
  straggle replaying its log; every rank's results equal; each case's
  ``fired`` log equal to the JAX package's on the same device count, and
  the clean run within 1e-4 of JAX's ``NlinvStreamWorkload`` (the N-rank
  frame's tolerance against JAX, ``test_torch_nlinv_distributed.py``);
* ``PIPELINE_DRAIN`` on 1 and 4 ranks: ``FramePipeline`` with a retried
  solve (bitwise the clean movie) and a dropped one (the movie stays
  frame-aligned, the dropped index repeats the last image);
* ``ELASTIC_REMESH`` on 4 ranks: a device loss at the third solve, the
  survivor group of ranks 0-1, every carry migrated: frames before the
  loss bitwise the uninterrupted 4-rank run's, after it within 1e-5; the
  lost ranks retire and end;
* the N-rank batched frame on 4 ranks under the default schedule, the
  p2p ring and the hierarchy on a (2, 2) group: each row against its
  client's own 4-rank frame, every rank's bits equal, and one
  ``masked_sum`` per channel sum for all rows.

One set of rank processes per world size runs every scenario of that
size (``torch_ranks.ft_serve_rank``), and one JAX subprocess per device
count the reference's runs.
"""

import pickle

import numpy as np
import pytest

import torch_ranks
from helpers import run_with_devices
from repro_torch.core import run_ranks
from repro_torch.nlinv import phantom

K, F, NCOILS = 3, 4, 4
NEWTON, CG = 2, 6
JAX_TOL = 1e-4       # the N-rank frame against JAX's
REMESH_TOL = 1e-5    # after the remesh, against the uninterrupted run
ROW_TOL = 1e-5       # a batched row against its client's own frame


@pytest.fixture(scope="module")
def datas():
    return [phantom.make_dataset(n=16, ncoils=NCOILS, nspokes=7, frames=F,
                                 seed=s) for s in range(K)]


@pytest.fixture(scope="module")
def ranks(datas, tmp_path_factory):
    """``ft_serve_rank`` on a world of each size, run once and kept."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = run_ranks(
                torch_ranks.ft_serve_rank, n, device="cpu", args=(datas,),
                timeout=240, store_dir=tmp_path_factory.mktemp(f"ft{n}"))
        return cache[n]
    return get


JAX_CHAOS = """
import pickle
from repro.core.env import Environment
from repro.nlinv import phantom
from repro.nlinv.recon import Reconstructor
from repro.serve import (NlinvStreamWorkload, Rejected, ServeConfig,
                         StreamScheduler)
from repro.ft import FaultInjector, FaultSpec, RestartPolicy

K, F = 3, 4
comm = Environment().group()
datas = [phantom.make_dataset(n=16, ncoils=4, nspokes=7, frames=F, seed=s)
         for s in range(K)]

def run(specs, seed=1234, retry=None):
    rec = Reconstructor(comm, newton=2, cg_iters=6, channel_sum="crop")
    sched = StreamScheduler(NlinvStreamWorkload(rec, retry=retry),
                            ServeConfig(buckets=(1, 2, 4)))
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=4, fov=d["fov"])
          for k, d in enumerate(datas)]
    inj = FaultInjector(specs, seed=seed)
    with inj:
        for f in range(F):
            for k, d in enumerate(datas):
                sched.submit(ss[k], (d["y"][f], d["masks"][f]))
            while sched.tick() == 0 and any(
                    s.pending for s in sched.sessions.values()):
                pass
    return sched, ss, inj

out = {"fired": {}}
_, ss, _ = run([])
out["clean"] = [[np.asarray(r) for r in s.results] for s in ss]
retry = RestartPolicy(max_restarts=2, backoff_s=0.0)
for name, spec, seed, pol in (
        ("retry", FaultSpec(site="task", kind="transient", match="solve",
                            at=(1,), max_fires=1), 1234, retry),
        ("corrupt", FaultSpec(site="step", kind="corrupt", at=(1,), pick=1,
                              max_fires=1), 1234, None),
        ("step", FaultSpec(site="step", kind="transient", at=(1,),
                           max_fires=1), 1234, None),
        ("straggle_a", FaultSpec(site="task", kind="straggle",
                                 match="solve", prob=0.4, delay_ms=0.0),
         7, None)):
    _, _, inj = run([spec], seed=seed, retry=pol)
    out["fired"][name] = list(inj.fired)
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def jax_chaos(tmp_path_factory):
    """The reference's ``SERVE_CHAOS`` runs on each device count: the
    clean run's images and each case's ``fired`` log."""
    cache = {}

    def get(n):
        if n not in cache:
            dst = tmp_path_factory.mktemp(f"jax_chaos{n}") / "out.pkl"
            run_with_devices(f"OUT = {str(dst)!r}\n" + JAX_CHAOS, ndev=n)
            cache[n] = pickle.loads(dst.read_bytes())
        return cache[n]
    return get


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and \
        len(a) == len(b)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_serving_chaos_parity(ranks, n):
    """The reference's ``SERVE_CHAOS`` checks, on every rank."""
    out = ranks(n)
    for r in out:
        c = r["chaos"]
        ref = c["clean"]["results"]
        assert all(len(res) == F and all(x is not None for x in res)
                   for res in ref), "clean run delivers all frames"
        # (1) a transient solve absorbed by the task retry: full parity
        assert c["retry"]["fired"] == [("task", "solve", 1, "transient")]
        assert c["retry"]["ft"]["retried_tasks"] == 1
        assert all(_equal(c["retry"]["results"][k], ref[k])
                   for k in range(K))
        # (2) one client's tick items poisoned: that frame Rejected, the
        # client recovers next tick, every other frame bitwise the clean
        bad = c["corrupt"]
        assert [f[3] for f in bad["fired"]] == ["corrupt"]
        assert bad["results"][1][1] is None
        assert bad["poisoned"] == [0, 1, 0] and bad["ft"]["quarantined"] == 1
        assert bad["results"][1][2] is not None and \
            bad["results"][1][3] is not None
        assert _equal(bad["results"][0], ref[0]) and \
            _equal(bad["results"][2], ref[2])
        assert np.array_equal(bad["results"][1][0], ref[1][0])
        # (3) a transient step: the tick requeues and the retry delivers
        assert c["step"]["step_faults"] == 1 == c["step"]["ft"]["step_faults"]
        assert all(_equal(c["step"]["results"][k], ref[k]) for k in range(K))
        # (4) the schedule replays exactly from its seed
        assert c["straggle_a"]["fired"] == c["straggle_b"]["fired"]
        assert c["straggle_a"]["fired"]
    first = out[0]["chaos"]
    for r in out[1:]:
        for name, case in r["chaos"].items():
            assert case["fired"] == first[name]["fired"]
            for k in range(K):
                got, want = case["results"][k], first[name]["results"][k]
                assert [x is None for x in got] == [x is None for x in want]
                assert _equal([x for x in got if x is not None],
                              [x for x in want if x is not None])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_chaos_matches_jax_on_the_same_device_count(ranks, jax_chaos, n):
    """Each case's ``fired`` log is the JAX package's on ``n`` devices,
    and the clean service within ``JAX_TOL`` of JAX's workload."""
    port, ref = ranks(n)[0]["chaos"], jax_chaos(n)
    for name, log in ref["fired"].items():
        assert [tuple(f) for f in port[name]["fired"]] == \
            [tuple(f) for f in log], name
    for k in range(K):
        for f in range(F):
            got, want = port["clean"]["results"][k][f], ref["clean"][k][f]
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            assert rel <= JAX_TOL, (k, f, rel)


@pytest.mark.parametrize("n", [1, 4])
def test_pipeline_drains_past_fault(ranks, n):
    for r in ranks(n):
        d = r["drain"]
        assert np.array_equal(d["retried"], d["ref"]), "retry parity"
        assert "dropped" not in d["retried_summary"]
        s = d["dropped_summary"]
        assert s["dropped"] == [2]
        assert d["dropped"].shape[0] == 5
        assert np.array_equal(d["dropped"][2], d["dropped"][1])
        assert np.isfinite(d["dropped"][3:]).all()
        assert s["frames"] == 5 and len(s["dropped"]) == 1


def test_elastic_remesh_survives_device_loss(ranks):
    out = ranks(4)
    for rank, r in enumerate(out):
        m = r["remesh"]
        assert m["lost_at"] == 2 and m["remeshes"] == 1
        assert m["fired"] == [("task", "solve", 2, "device_loss")]
        if rank in (2, 3):
            # a lost rank took part in the gather, then retired
            assert m["retired"] and "retired" in m["refused"]
            assert m["survivor_size"] is None
            continue
        assert not m["retired"] and m["survivor_size"] == 2
        assert m["report_remeshes"] == 1
        assert all(len(res) == F for res in m["results"])
        for k in range(2):
            for f in range(2):
                assert np.array_equal(m["results"][k][f], m["ref"][k][f]), \
                    (k, f)
            for f in range(2, F):
                a, b = m["results"][k][f], m["ref"][k][f]
                rel = float(np.abs(a - b).max() / np.abs(b).max())
                assert rel <= REMESH_TOL, (k, f, rel)
    for k in range(2):
        for f in range(F):
            assert np.array_equal(out[1]["remesh"]["results"][k][f],
                                  out[0]["remesh"]["results"][k][f])


@pytest.mark.parametrize("schedule", ["psum", "p2p", "hier22"])
def test_batched_frame_on_four_ranks(ranks, schedule):
    """Each row of the 4-rank batched frame against its client's own
    4-rank frame; ``rho``, the CG logs and the images bitwise equal on
    every rank; one ``masked_sum`` a channel sum (a Newton step's right
    side and each CG iteration the loop ran) for all rows."""
    out = [r["batched"][schedule] for r in ranks(4)]
    b0 = out[0]
    assert b0["masked_sum_calls"] == sum(1 + max(c) for c in b0["log"])
    assert len(b0["log"]) == NEWTON and all(len(c) == K for c in b0["log"])
    for k, own in enumerate(b0["own"]):
        assert [c[k] for c in b0["log"]] == own["log"]
        rel = float(np.abs(b0["img"][k] - own["img"]).max() /
                    np.abs(own["img"]).max())
        assert rel <= ROW_TOL, (k, rel)
    for r in out[1:]:
        assert r["rho"] == b0["rho"] and r["log"] == b0["log"]
        np.testing.assert_array_equal(r["img"], b0["img"])
        assert r["masked_sum_calls"] == b0["masked_sum_calls"]


def test_batched_frame_of_one_row_is_its_own_frame_bitwise(ranks):
    """At width 1 on 4 ranks the batched frame is the client's own frame
    bit for bit (``rho``, image, CG log): the windows sum in one
    rank-ordered ``masked_sum`` whatever the batch, and the extras in
    rank order.  At width 3 a row can differ in the last bits: gloo's
    all-reduce of the (B,) residual partials adds an element in an order
    that depends on the vector's length (rows within ``ROW_TOL`` above)."""
    b0 = ranks(4)[0]["batched"]["psum1"]
    own, = b0["own"]
    assert b0["rho"] == [own["rho"]] and b0["chat"] == [own["chat"]]
    assert [c[0] for c in b0["log"]] == own["log"]
    np.testing.assert_array_equal(b0["img"][0], own["img"])
