"""The port's fault-tolerance layer (``repro_torch.ft``) against the JAX
package's, on the CPU.

The in-process cases of ``tests/test_fault_injection.py``, each through
the port: spec validation, the seeded replay, ``at`` and ``max_fires``,
``match``, the injector not being reentrant and the hooks restored after
it, ``poison`` (numpy, CPU tensors complex64 included, a
``SegmentedArray``, leaves that are not inexact passing through), the
executor's retry envelope, ``run_with_restarts``' fresh default, the
scheduler's requeue of a transient step (at the front, the submit
timestamps kept), ``Rejected`` counted and not timed, the degradation
ladder and ``Pipeline(drop_failed=True)``.  Beside them: for the same
specs and seed over the same call stream, the port's ``fired`` log is
``repro.ft.FaultInjector``'s; and the package's surface is the
reference's, its two checkpoint names included.
"""

import doctest
import inspect
import time

import numpy as np
import pytest
import torch

import repro.ft as jft
import repro_torch.ft as ft
from repro.task import Executor as JExecutor
from repro.task import TaskGraph as JTaskGraph
from repro_torch.core import Communicator, Policy
from repro_torch.ft import (DeviceLossFault, FaultInjector, FaultSpec,
                            RestartPolicy, StragglerWatchdog, TransientFault,
                            migrate_carry, pad_rows, poison,
                            run_with_restarts)
from repro_torch.ft import inject
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.serve import (Rejected, ServeConfig, StreamScheduler,
                               Workload)
from repro_torch.task import Executor, Pipeline, TaskGraph

SEED = 1234


def test_surface_is_the_reference_less_checkpoints():
    """The reference's surface in full: the two checkpoint names that
    this test once left out (``PreemptionGuard``, ``resume_or_init``)
    are ported with the checkpoint layer."""
    assert ft.__all__ == jft.__all__
    assert (inject.SITES, inject.KINDS) == (jft.inject.SITES,
                                           jft.inject.KINDS)
    assert inject.SEED_ENV == jft.inject.SEED_ENV


def test_inject_doctest():
    result = doctest.testmod(inject)
    assert result.attempted > 0 and result.failed == 0


# -- injector determinism contract ------------------------------------------

def test_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec(site="gpu", kind="transient")
    with pytest.raises(ValueError):
        FaultSpec(site="task", kind="explode")
    with pytest.raises(ValueError):
        FaultSpec(site="task", kind="transient", prob=1.5)


def _noop_graph(graph_cls=TaskGraph):
    g = graph_cls()
    g.add("noop", lambda: 0, outputs=("z",))
    return g


def test_probabilistic_schedule_replays_from_seed():
    spec = FaultSpec(site="task", kind="straggle", prob=0.3, delay_ms=0.0)
    inj = FaultInjector([spec], seed=SEED)
    g = _noop_graph()
    with inj:
        for _ in range(40):
            Executor().run(g)
    first = list(inj.fired)
    assert first, "prob=0.3 over 40 calls should fire at least once"
    inj.reset()
    with inj:
        for _ in range(40):
            Executor().run(g)
    assert inj.fired == first


def test_seed_defaults_to_the_environment(monkeypatch):
    monkeypatch.setenv(inject.SEED_ENV, "17")
    assert FaultInjector([]).seed == 17
    monkeypatch.delenv(inject.SEED_ENV)
    assert FaultInjector([]).seed == 0


def test_scheduled_at_indices_and_max_fires():
    spec = FaultSpec(site="task", kind="straggle", at=(1, 3, 5),
                     delay_ms=0.0, max_fires=2)
    inj = FaultInjector([spec], seed=0)
    g = _noop_graph()
    with inj:
        for _ in range(8):
            Executor().run(g)
    assert [idx for _, _, idx, _ in inj.fired] == [1, 3]   # max_fires=2


def test_match_filters_call_stream():
    """``at`` indices count only the spec's OWN matching calls."""
    spec = FaultSpec(site="task", kind="straggle", match="solve",
                     at=(0,), delay_ms=0.0)
    inj = FaultInjector([spec], seed=0)
    g = TaskGraph()
    g.add("prep", lambda: 1, outputs=("a",))
    g.add("solve", lambda a: a + 1, inputs=("a",), outputs=("b",))
    with inj:
        Executor().run(g)
    assert inj.fired == [("task", "solve", 0, "straggle")]


def test_injector_not_reentrant():
    inj = FaultInjector([], seed=0)
    with inj:
        with pytest.raises(RuntimeError, match="not reentrant"):
            inj.__enter__()


def test_hooks_restored_after_exit():
    from repro_torch.core import env as core_env
    from repro_torch.serve import scheduler as serve_sched
    from repro_torch.task import executor as task_exec
    before = (core_env.VERB_HOOK, task_exec.TASK_HOOK,
              serve_sched.STEP_HOOK)
    with pytest.raises(TransientFault):
        with FaultInjector([FaultSpec(site="task", kind="transient",
                                      at=(0,))], seed=0):
            assert task_exec.TASK_HOOK is not None
            assert core_env.VERB_HOOK is not None
            assert serve_sched.STEP_HOOK is not None
            Executor().run(_noop_graph())
    assert (core_env.VERB_HOOK, task_exec.TASK_HOOK,
            serve_sched.STEP_HOOK) == before


def test_verb_site_fires_at_the_communicator():
    """The verb hook sees a container's payload and a gather's container;
    a corrupt there poisons what the verb moves."""
    comm = Communicator.single("cpu")
    seg = comm.container(np.ones((2, 2), np.float32))
    with FaultInjector([FaultSpec(site="verb", kind="corrupt",
                                  match="gather", at=(0,))], seed=0) as inj:
        out = comm.gather(seg)
        again = comm.gather(seg)
    assert inj.fired == [("verb", "gather", 0, "corrupt")]
    assert torch.isnan(out).all() and torch.equal(again, torch.ones(2, 2))
    assert torch.equal(seg.data, torch.ones(2, 2))   # the source untouched


# -- poison -----------------------------------------------------------------

def test_poison_hits_inexact_leaves_only():
    payload = {"y": torch.ones((2, 2), dtype=torch.complex64),
               "x": np.ones((3,), np.float32),
               "mask": np.ones((2, 2), bool),
               "idx": torch.arange(3),
               "flag": torch.ones(2, dtype=torch.bool),
               "n": 7, "tag": "frame0", "none": None,
               "pair": (torch.zeros(2), [np.zeros(2, np.complex64), 1.5])}
    bad = poison(payload)
    assert bad["y"].dtype == torch.complex64 and bad["y"].device == \
        payload["y"].device
    assert torch.isnan(bad["y"].real).all() and \
        torch.isnan(bad["y"].imag).all()
    assert np.isnan(bad["x"]).all() and bad["x"].dtype == np.float32
    assert bad["mask"].dtype == bool and bad["mask"].all()
    assert torch.equal(bad["idx"], torch.arange(3))
    assert bad["flag"].dtype == torch.bool and bad["flag"].all()
    assert (bad["n"], bad["tag"], bad["none"]) == (7, "frame0", None)
    assert isinstance(bad["pair"], tuple) and isinstance(bad["pair"][1],
                                                         list)
    assert torch.isnan(bad["pair"][0]).all()
    assert np.isnan(bad["pair"][1][0]).all() and bad["pair"][1][1] == 1.5
    # the caller's arrays are left as they were
    assert torch.equal(payload["y"], torch.ones((2, 2),
                                                dtype=torch.complex64))
    assert (payload["x"] == 1).all()


def test_poison_matches_the_reference_on_numpy():
    payload = {"a": np.arange(4, dtype=np.float64), "b": np.arange(3),
               "c": [np.ones(2, np.complex64), "s"]}
    want, got = jft.poison(payload), poison(payload)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["c"][0], want["c"][0])
    assert got["c"][1] == want["c"][1] == "s"


def test_poison_a_segmented_array_keeps_its_metadata():
    comm = Communicator.single("cpu")
    seg = comm.container(np.ones((4, 3), np.complex64))
    bad = poison(seg)
    assert torch.isnan(bad.data.real).all()
    assert (bad.policy, bad.dim, bad.global_shape, bad.orig_len,
            bad.comm) == (seg.policy, seg.dim, seg.global_shape,
                          seg.orig_len, seg.comm)
    assert not torch.isnan(seg.data.real).any()
    idx = comm.container(np.arange(4), policy=Policy.CLONE)
    assert torch.equal(poison(idx).data, idx.data)


def test_step_corrupt_with_pick_poisons_one_client():
    """The step site hands ``[(session, item), ...]``: ``pick`` poisons
    one client's item and the session object passes through."""
    inj = FaultInjector([FaultSpec(site="step", kind="corrupt", at=(0,),
                                   pick=1)], seed=0)
    sess = [object(), object()]
    batch = [(sess[0], torch.ones(2)), (sess[1], torch.ones(2))]
    out = inj.fire("step", "Echo", batch)
    assert out[0] is batch[0] and out[1][0] is sess[1]
    assert torch.isnan(out[1][1]).all() and torch.equal(batch[1][1],
                                                        torch.ones(2))


# -- the fired log against the JAX package's ---------------------------------

STREAM_SPECS = [
    dict(site="task", kind="straggle", prob=0.3, delay_ms=0.0),
    dict(site="task", kind="corrupt", match="solve", prob=0.5,
         max_fires=3),
    dict(site="step", kind="straggle", at=(2, 5), prob=0.2, delay_ms=0.0),
    dict(site="verb", kind="corrupt", match="gather", prob=0.25),
    dict(site="task", kind="straggle", match="damp", at=(0, 4),
         delay_ms=0.0, max_fires=1),
]
STREAM = [("task", "stack"), ("task", "solve"), ("task", "damp"),
          ("step", "NlinvStreamWorkload"), ("verb", "container"),
          ("verb", "gather"), ("verb", "bcast")] * 12


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_fired_log_is_the_reference_log(seed):
    """The same specs, seed and call stream (every site, matching and
    not) fire the same faults in both packages."""
    port = FaultInjector([FaultSpec(**d) for d in STREAM_SPECS], seed=seed)
    ref = jft.FaultInjector([jft.FaultSpec(**d) for d in STREAM_SPECS],
                            seed=seed)
    for site, name in STREAM:
        port.fire(site, name, np.zeros(2, np.float32))
        ref.fire(site, name, np.zeros(2, np.float32))
    assert port.fired == ref.fired and port.fired


def test_fired_log_is_the_reference_log_through_executors():
    """The same graph run 30 times through each package's executor under
    a seeded straggle: one log."""
    spec = dict(site="task", kind="straggle", match="o", prob=0.4,
                delay_ms=0.0)
    logs = []
    for inj_cls, spec_cls, ex_cls, g_cls in (
            (FaultInjector, FaultSpec, Executor, TaskGraph),
            (jft.FaultInjector, jft.FaultSpec, JExecutor, JTaskGraph)):
        g = g_cls()
        g.add("prep", lambda: 1, outputs=("a",))
        g.add("solve", lambda a: a + 1, inputs=("a",), outputs=("b",))
        g.add("done", lambda b: b, inputs=("b",), outputs=("c",))
        with inj_cls([spec_cls(**spec)], seed=SEED) as inj:
            for _ in range(30):
                ex_cls().run(g)
        logs.append(inj.fired)
    assert logs[0] == logs[1] and logs[0]


# -- executor retry envelope ------------------------------------------------

def _graph():
    g = TaskGraph()
    g.add("solve", lambda x: x * 2, inputs=("x",), outputs=("y",))
    return g


def test_executor_retries_transient_and_counts():
    ex = Executor(retry=RestartPolicy(max_restarts=2, backoff_s=0.0))
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  at=(0,))], seed=0):
        out = ex.run(_graph(), feeds={"x": 21})
    assert out == {"y": 42}
    assert ex.retried == 1
    assert [r.retries for r in ex.trace] == [1]


def test_executor_retry_exhaustion_raises():
    ex = Executor(retry=RestartPolicy(max_restarts=1, backoff_s=0.0))
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  at=(0, 1, 2))], seed=0):
        with pytest.raises(TransientFault):
            ex.run(_graph(), feeds={"x": 1})


def test_executor_device_loss_not_retried():
    ex = Executor(retry=RestartPolicy(max_restarts=5, backoff_s=0.0))
    with FaultInjector([FaultSpec(site="task", kind="device_loss",
                                  at=(0,), device=2)], seed=0):
        with pytest.raises(DeviceLossFault) as ei:
            ex.run(_graph(), feeds={"x": 1})
    assert ei.value.device == 2 and not ei.value.transient
    assert ex.retried == 0


def test_executor_without_policy_propagates():
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  at=(0,))], seed=0):
        with pytest.raises(TransientFault):
            Executor().run(_graph(), feeds={"x": 1})


def test_run_with_restarts_fresh_default_policy():
    sig = inspect.signature(run_with_restarts)
    assert sig.parameters["policy"].default is None, \
        "mutable RestartPolicy() default would be shared across calls"
    calls = []

    def loop(start):
        calls.append(start)
        if len(calls) < 2:
            raise RuntimeError("boom")
        return 7

    seen = []
    assert run_with_restarts(
        loop, policy=RestartPolicy(backoff_s=0.0),
        on_restart=lambda n, e: seen.append(n)) == 7
    assert seen == [1]

    def always(start):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        run_with_restarts(always, policy=RestartPolicy(max_restarts=2,
                                                       backoff_s=0.0))


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(threshold=2.0)
    assert [wd.record(t) for t in (1.0, 1.0, 1.1, 0.9, 1.0)] == [False] * 5
    assert wd.record(5.0) and not wd.record(1.5)
    assert wd.flagged == 1 and wd.median == 1.0


# -- scheduler: transient tick requeue + Rejected accounting ----------------

class EchoWorkload(Workload):
    def open_session(self, session):
        return {}

    def step(self, batch, width):
        return [(item, False) for _, item in batch]


def test_scheduler_requeues_transient_step():
    sched = StreamScheduler(EchoWorkload())
    s = sched.open("scanner")
    t = sched.open("other")
    sched.submit(s, "f0")
    sched.submit(s, "f1")
    sched.submit(t, "g0")
    stamps = [ts for _, ts in s.pending]
    with FaultInjector([FaultSpec(site="step", kind="transient",
                                  at=(0,))], seed=0):
        assert sched.tick() == 0          # fault absorbed, nothing lost
        # the popped items are back at the FRONT, their timestamps kept
        assert [item for item, _ in s.pending] == ["f0", "f1"]
        assert [ts for _, ts in s.pending] == stamps
        assert [item for item, _ in t.pending] == ["g0"]
        assert sched.step_faults == 1 and sched.ticks == 0
        assert sched.tick() == 2          # the retry delivers
    assert s.results == ["f0"] and t.results == ["g0"]
    rep = sched.report()
    assert rep["aggregate"]["ft"]["step_faults"] == 1
    assert rep["aggregate"]["ticks"] == 1


def test_scheduler_propagates_a_step_error_that_is_not_transient():
    sched = StreamScheduler(EchoWorkload())
    s = sched.open("scanner")
    sched.submit(s, "f0")
    with FaultInjector([FaultSpec(site="step", kind="device_loss",
                                  at=(0,))], seed=0):
        with pytest.raises(DeviceLossFault):
            sched.tick()
    assert sched.step_faults == 0


class RejectingWorkload(Workload):
    def open_session(self, session):
        return {}

    def step(self, batch, width):
        return [(Rejected("poisoned") if i == 0 else item, False)
                for i, (_, item) in enumerate(batch)]


def test_rejected_counted_not_timed():
    sched = StreamScheduler(RejectingWorkload())
    a, b = sched.open("a"), sched.open("b")
    sched.submit(a, 1), sched.submit(b, 2)
    sched.tick()
    assert isinstance(a.results[0], Rejected) and b.results == [2]
    assert (a.poisoned, len(a.latency_ms)) == (1, 0)
    assert (b.poisoned, len(b.latency_ms)) == (0, 1)
    rep = sched.report()
    assert rep["clients"]["a"]["poisoned"] == 1
    assert rep["aggregate"]["ft"]["rejected_poisoned"] == 1


# -- scheduler: deadline enforcement + degradation ladder -------------------

class DialWorkload(Workload):
    """Sleep-controlled workload with one degraded operating point."""

    levels = 1

    def __init__(self):
        self.sleep_ms = 0.0
        self.level = 0
        self.set_levels: list = []

    def open_session(self, session):
        return {}

    def set_level(self, level):
        self.level = level
        self.set_levels.append(level)

    def step(self, batch, width):
        time.sleep(self.sleep_ms / 1e3)
        return [(item, False) for _, item in batch]


def test_degradation_ladder_steps_down_and_recovers():
    wl = DialWorkload()
    sched = StreamScheduler(wl, ServeConfig(
        buckets=(1, 2), deadline_ms=20.0, breach_ticks=2,
        recover_ticks=2, headroom=0.5))
    s = sched.open("scanner")

    wl.sleep_ms = 40.0                    # sustained breach
    for _ in range(4):
        sched.submit(s, 0)
        sched.tick()
    # rung 1 = operating point shed, rung 2 = bucket cap shed
    assert sched.rung == 2
    assert wl.set_levels[:1] == [1]
    assert sched._bucket_cap() == 1
    downs = [e for e in sched.events if e["dir"] == "down"]
    assert len(downs) == 2 and downs[0]["op_level"] == 1

    wl.sleep_ms = 0.0                     # sustained headroom
    for _ in range(4):
        sched.submit(s, 0)
        sched.tick()
    assert sched.rung == 0
    assert wl.level == 0                  # throughput back, then accuracy
    ups = [e for e in sched.events if e["dir"] == "up"]
    assert len(ups) == 2
    ft_rep = sched.report()["aggregate"]["ft"]
    assert ft_rep["degradation_events"] == 4 and ft_rep["rung"] == 0


def test_ladder_bottoms_out_without_levels():
    class SlowEcho(EchoWorkload):
        def step(self, batch, width):
            time.sleep(2e-3)              # every tick breaches the budget
            return super().step(batch, width)

    sched = StreamScheduler(SlowEcho(), ServeConfig(
        buckets=(1, 2, 4), deadline_ms=0.5, breach_ticks=1,
        recover_ticks=99))
    s = sched.open("scanner")
    for _ in range(8):
        sched.submit(s, 0)
        sched.tick()
    assert sched.rung == sched._max_rung() == 2
    assert sched._bucket_cap() == 1       # fully shed, and stays there


# -- pipeline: drain past a poisoned frame ----------------------------------

def test_pipeline_drop_failed_drains():
    pipe = Pipeline(inflight=2, drop_failed=True)
    g = TaskGraph()
    g.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  at=(2,))], seed=0):
        done = []
        for f in range(5):
            _, retired = pipe.push(g, {"x": f}, tag=f)
            done += retired
        done += pipe.flush()
    assert [tag for tag, _ in done] == [0, 1, 3, 4]
    assert [tag for tag, _ in pipe.dropped] == [2]
    assert isinstance(pipe.dropped[0][1], TransientFault)


def test_pipeline_without_drop_failed_raises():
    pipe = Pipeline(inflight=2)
    g = TaskGraph()
    g.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  at=(0,))], seed=0):
        with pytest.raises(TransientFault):
            pipe.push(g, {"x": 0}, tag=0)


# -- remesh: the carry-level mechanics on one rank ----------------------------

def test_pad_rows_and_migrate_carry_on_one_rank():
    a = np.ones((3, 2), np.complex64)
    assert pad_rows(a, 2) is a
    p = pad_rows(a, 5)
    assert p.shape == (5, 2) and not p[3:].any() and (p[:3] == 1).all()
    np.testing.assert_array_equal(p, jft.pad_rows(a, 5))
    rec = Reconstructor(device="cpu")
    rho = (np.arange(16).reshape(4, 4) * (1 + 2j)).astype(np.complex64)
    chat = np.ones((3, 4, 4), np.complex64)
    u = migrate_carry(rec, {"rho": torch.from_numpy(rho), "chat": chat},
                      pad_to=4)
    assert u["rho"].dtype == torch.complex64    # rho keeps its imag part
    np.testing.assert_array_equal(u["rho"].numpy(), rho)
    assert tuple(u["chat"].shape) == (4, 4, 4) and not u["chat"][3].any()
    assert tuple(migrate_carry(rec, {"rho": rho, "chat": chat})["chat"]
                 .shape) == (3, 4, 4)
