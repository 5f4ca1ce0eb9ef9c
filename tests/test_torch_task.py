"""The port's task layer and pipelined frame stream, on the CPU.

* ``repro_torch.task``: the host-only cases of ``tests/test_task_graph.py``
  (toposort order, cycles, missing feeds, cross-group races and the copy
  edge that clears them, duplicate producers, output arity), the
  executor's trace and retry envelope, and the ``Pipeline`` window
  (retire order, ``flush``, ``drop_failed``);
* ``FramePipeline(inflight=3)`` against the port's ``FrameStream`` and
  against the JAX package's ``FramePipeline`` on the same movie (n = 16,
  J = 2, 5 frames, newton 3, cg 6, as ``test_task_graph.py`` runs it),
  within 1e-5 relative, and a frame whose solve raises dropped and
  frozen.
"""

import dataclasses
import doctest

import numpy as np
import pytest
import torch

from repro.nlinv.recon import Reconstructor as JReconstructor
from repro.nlinv.stream import FramePipeline as JFramePipeline
from repro_torch.core import Communicator, DeviceGroup
from repro_torch.nlinv import phantom
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.nlinv.stream import (FramePipeline, FrameStream,
                                      LatencyReport, stream_movie)
from repro_torch.task import (TASK_HOOK, CrossGroupError, CycleError,
                              Executor, Pipeline, TaskError, TaskGraph,
                              TaskRun, executor, graph, placement_token)

NEWTON, CG, FRAMES = 3, 6, 5


@pytest.mark.parametrize("module", [graph, executor],
                         ids=lambda m: m.__name__)
def test_task_doctests(module):
    result = doctest.testmod(module)
    assert result.attempted > 0 and result.failed == 0


# -- graph construction / validation ----------------------------------------

def test_empty_and_single_task_graph():
    g = TaskGraph()
    assert len(g) == 0 and g.toposort() == ()
    assert Executor().run(g) == {}
    g.add("one", lambda: 41, outputs=("x",))
    ex = Executor()
    assert ex.run(g) == {"x": 41}
    assert [r.name for r in ex.trace] == ["one"]
    assert isinstance(ex.trace[0], TaskRun) and ex.trace[0].retries == 0


def test_toposort_orders_by_dependency_then_insertion():
    g = TaskGraph()
    g.add("crop", lambda u: u, inputs=("u",), outputs=("img",))
    g.add("upload", lambda: 1, outputs=("y",))
    g.add("damp", lambda u: u, inputs=("u",), outputs=("xref",))
    g.add("solve", lambda y: y, inputs=("y",), outputs=("u",))
    assert [t.name for t in g.toposort()] == ["upload", "solve", "crop",
                                              "damp"]


def test_cycle_detection_raises():
    g = TaskGraph()
    g.add("a", lambda x: x, inputs=("b_out",), outputs=("a_out",))
    g.add("b", lambda x: x, inputs=("a_out",), outputs=("b_out",))
    with pytest.raises(CycleError, match="dependency cycle: a -> b -> a"):
        g.toposort()
    with pytest.raises(CycleError):
        Executor().run(g)


def test_duplicate_producer_and_name_raise():
    g = TaskGraph()
    g.add("a", lambda: 1, outputs=("x",))
    with pytest.raises(TaskError, match="duplicate task name"):
        g.add("a", lambda: 2, outputs=("y",))
    with pytest.raises(TaskError, match="already produced"):
        g.add("b", lambda: 2, outputs=("x",))
    # failed adds are no-ops: the graph still has exactly one task
    assert len(g) == 1 and g.values() == ("x",)
    with pytest.raises(TaskError, match="kind must be"):
        g.add("c", lambda: 3, outputs=("z",), kind="gather")


def test_missing_feed_raises():
    g = TaskGraph()
    g.add("a", lambda x: x, inputs=("nowhere",), outputs=("y",))
    with pytest.raises(TaskError, match="no task produces and no feed"):
        Executor().run(g)
    assert Executor().run(g, feeds={"nowhere": 3}) == {"y": 3}


def test_output_arity_mismatch_raises():
    g = TaskGraph()
    g.add("a", lambda: 1, outputs=("x", "y"))
    with pytest.raises(TypeError, match="declares 2 outputs"):
        Executor().run(g)


def _two_groups():
    """Two 1-rank groups on different devices (a meta device stands in
    for a second card): distinct placement identities."""
    return (Communicator.single("cpu"),
            Communicator(DeviceGroup(0, 1, torch.device("meta"))))


def test_placement_tokens():
    ga, gb = _two_groups()
    assert placement_token(None) is None
    assert placement_token(ga) == placement_token(Communicator.single("cpu"))
    assert placement_token(ga) != placement_token(gb)


def test_cross_group_race_raises():
    ga, gb = _two_groups()
    g = TaskGraph()
    g.add("produce", lambda: torch.ones(4), outputs=("v",), group=ga)
    g.add("consume", lambda v: v + 1, inputs=("v",), outputs=("w",),
          group=gb)
    with pytest.raises(CrossGroupError, match="explicit copy/verb edge"):
        g.validate()


def test_cross_group_copy_edge_passes():
    ga, gb = _two_groups()
    g = TaskGraph()
    g.add("produce", lambda: torch.ones(4), outputs=("v",), group=ga)
    g.copy("move", lambda v: v.clone(), inputs=("v",), outputs=("v_b",),
           group=gb)
    g.add("consume", lambda v: v + 1, inputs=("v_b",), outputs=("w",),
          group=gb)
    g.validate()
    out = Executor().run(g, outputs=("w",))
    assert set(out) == {"w"} and float(out["w"][0]) == 2.0


# -- the executor's retry envelope ------------------------------------------

@dataclasses.dataclass
class Policy:
    max_restarts: int = 2
    backoff_s: float = 0.0
    backoff_mult: float = 2.0


class Transient(RuntimeError):
    transient = True


def _flaky(fails, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc("boom")
        return len(calls)
    return fn, calls


def test_executor_retries_a_transient_failure():
    fn, calls = _flaky(2, Transient)
    g = TaskGraph()
    g.add("solve", fn, outputs=("u",))
    ex = Executor(retry=Policy(max_restarts=2))
    assert ex.run(g) == {"u": 3}
    assert ex.retried == 2 and ex.trace[-1].retries == 2
    # one failure more than max_restarts propagates
    fn, calls = _flaky(3, Transient)
    g = TaskGraph()
    g.add("solve", fn, outputs=("u",))
    with pytest.raises(Transient):
        Executor(retry=Policy(max_restarts=2)).run(g)
    assert len(calls) == 3


def test_executor_raises_a_non_transient_failure():
    fn, calls = _flaky(1, ValueError)
    g = TaskGraph()
    g.add("solve", fn, outputs=("u",))
    with pytest.raises(ValueError):
        Executor(retry=Policy()).run(g)
    assert len(calls) == 1
    # ... unless the executor names its type retryable
    fn, calls = _flaky(1, ValueError)
    g = TaskGraph()
    g.add("solve", fn, outputs=("u",))
    assert Executor(retry=Policy(), retryable=(ValueError,)).run(g) == \
        {"u": 2}
    # and without a policy nothing is retried
    fn, calls = _flaky(1, Transient)
    g = TaskGraph()
    g.add("solve", fn, outputs=("u",))
    with pytest.raises(Transient):
        Executor().run(g)


def test_task_hook_sees_every_dispatch(monkeypatch):
    assert TASK_HOOK is None and executor.TASK_HOOK is None
    seen = []

    def hook(task, args):
        seen.append(task.name)
        return [a * 10 for a in args]

    monkeypatch.setattr(executor, "TASK_HOOK", hook)
    g = TaskGraph()
    g.add("scale", lambda x: x + 1, inputs=("x",), outputs=("y",))
    assert Executor().run(g, feeds={"x": 2}) == {"y": 21}
    assert seen == ["scale"]


# -- the rolling pipeline window --------------------------------------------

def test_pipeline_window_and_flush_order():
    pipe = Pipeline(inflight=2)
    g = TaskGraph()
    g.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
    vals, done = pipe.push(g, {"x": 0}, tag=0)
    assert done == [] and len(pipe) == 1
    chained = vals
    retired = []
    for f in range(1, 4):
        chained, done = pipe.push(g, {"x": chained["y"]}, tag=f)
        retired += done
    # frames retire oldest-first as they leave the inflight window
    assert [tag for tag, _ in retired] == [0, 1]
    assert [tag for tag, _ in pipe.flush()] == [2, 3]
    assert len(pipe) == 0
    assert chained["y"] == 4


def test_pipeline_rejects_empty_window():
    with pytest.raises(ValueError, match="inflight >= 1"):
        Pipeline(inflight=0)


def test_pipeline_drop_failed():
    g_ok = TaskGraph()
    g_ok.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
    g_bad = TaskGraph()
    g_bad.add("inc", lambda x: 1 / 0, inputs=("x",), outputs=("y",))
    with pytest.raises(ZeroDivisionError):
        Pipeline().push(g_bad, {"x": 0}, tag=0)
    pipe = Pipeline(inflight=1, drop_failed=True)
    pipe.push(g_ok, {"x": 0}, tag=0)
    vals, done = pipe.push(g_bad, {"x": 1}, tag=1)
    assert vals is None and done == [] and len(pipe) == 1
    assert [(t, type(e)) for t, e in pipe.dropped] == [(1, ZeroDivisionError)]
    _, done = pipe.push(g_ok, {"x": 5}, tag=2)
    assert [t for t, _ in done] == [0]
    assert [t for t, _ in pipe.flush()] == [2]


# -- pipelined frame stream --------------------------------------------------

@pytest.fixture(scope="module")
def movie():
    return phantom.make_dataset(n=16, ncoils=2, nspokes=7, frames=FRAMES,
                                seed=11)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_pipeline_matches_frame_stream_and_jax(movie):
    d = movie
    args = (d["y"], d["masks"], d["fov"])
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    seq, _ = FrameStream(rec, damping=0.9).run(*args)
    pipe, rep = FramePipeline(rec, damping=0.9, inflight=3).run(*args)
    assert _rel(pipe, seq) <= 1e-5
    assert len(rep.frame_ms) == FRAMES
    assert sum(rep.frame_plan_builds[1:]) == 0
    assert rep.dropped == [] and "dropped" not in rep.summary()
    jpipe, _ = JFramePipeline(JReconstructor(newton=NEWTON, cg_iters=CG,
                                             channel_sum="crop"),
                              damping=0.9, inflight=3).run(*args)
    assert _rel(pipe, jpipe) <= 1e-5
    again, _ = stream_movie(d, newton=NEWTON, cg_iters=CG, device="cpu",
                            pipelined=True, inflight=2)
    assert _rel(again, seq) <= 1e-5


def test_pipeline_leaves_the_carry_it_resumes_from(movie):
    """The solve node reads ``u_prev`` and never writes it: a resumed
    run's carry is unchanged, and the movie matches FrameStream's resume."""
    d = movie
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    stream = FrameStream(rec, damping=0.9, donate_carry=False)
    stream.run(d["y"][:2], d["masks"][:2], d["fov"])
    carry = stream.last_carry
    kept = {k: {kk: v.clone() for kk, v in c.items()}
            for k, c in carry.items()}
    pipe = FramePipeline(rec, damping=0.9, inflight=3)
    got, _ = pipe.run(d["y"][2:], d["masks"][2:], d["fov"], carry=carry)
    for k in carry:
        for kk in carry[k]:
            assert torch.equal(carry[k][kk], kept[k][kk])
    want, _ = FrameStream(rec, damping=0.9).run(
        d["y"][2:], d["masks"][2:], d["fov"], carry=kept)
    assert _rel(got, want) <= 1e-5


def test_pipeline_drops_a_failed_frame_and_freezes(movie, monkeypatch):
    """A solve that raises on frame 2: frame 2 repeats frame 1's image,
    ``dropped == [2]``, and frames 3-4 continue from frame 1's carry."""
    d = movie
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG)
    solves = []

    def hook(task, args):
        if task.name == "solve":
            solves.append(1)
            if len(solves) == 3:
                raise RuntimeError("solve failed on frame 2")
        return args

    monkeypatch.setattr(executor, "TASK_HOOK", hook)
    got, rep = FramePipeline(rec, damping=0.9, inflight=2,
                             drop_failed=True).run(d["y"], d["masks"],
                                                   d["fov"])
    monkeypatch.setattr(executor, "TASK_HOOK", None)
    assert rep.dropped == [2] and rep.summary()["dropped"] == [2]
    assert len(rep.summary()["frame_ms"]) == FRAMES
    assert torch.equal(got[2], got[1])
    # the reference: frames 0-1, then frames 3-4 from frame 1's carry
    stream = FrameStream(rec, damping=0.9)
    first, _ = stream.run(d["y"][:2], d["masks"][:2], d["fov"])
    rest, _ = stream.run(d["y"][3:], d["masks"][3:], d["fov"],
                         carry=stream.last_carry)
    assert _rel(got[:2], first) <= 1e-5
    assert _rel(got[3:], rest) <= 1e-5
    # with drop_failed off the failure propagates
    solves.clear()
    monkeypatch.setattr(executor, "TASK_HOOK", hook)
    with pytest.raises(RuntimeError, match="frame 2"):
        FramePipeline(rec, damping=0.9).run(d["y"], d["masks"], d["fov"])


def test_pipeline_every_frame_dropped_raises(movie, monkeypatch):
    def hook(task, args):
        if task.name == "solve":
            raise RuntimeError("no solve")
        return args

    monkeypatch.setattr(executor, "TASK_HOOK", hook)
    rec = Reconstructor(device="cpu", newton=1, cg_iters=1)
    with pytest.raises(RuntimeError, match="every frame dropped"):
        FramePipeline(rec, drop_failed=True).run(
            movie["y"][:2], movie["masks"][:2], movie["fov"])


def test_latency_report_leaves_dropped_frames_out():
    rep = LatencyReport([10.0, 4.0, 99.0, 6.0], 1, 32, 2, dropped=[2])
    s = rep.summary()
    assert s["dropped"] == [2] and s["frames"] == 4
    assert s["first_frame_ms"] == 10.0 and s["mean_ms"] == 5.0
    assert s["frame_ms"] == [10.0, 4.0, 99.0, 6.0]
