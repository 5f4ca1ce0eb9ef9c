"""The port's serving layer on the CPU: the scheduler's workload-agnostic
cases of ``tests/test_serve_scheduler.py`` (admission, backpressure,
bucketed width, refill, rotation, report) on a stub workload, the
``SlotPool``, ``Engine``'s continuous batching with the assertions of
``tests/test_substrates.py``, and the port's greedy tokens against the
JAX ``Engine``'s, token for token, on the same float32 SMOKE weights and
prompts, for every arch of the registry (the cross-attention archs with
their gates opened and the JAX frontend's embeddings handed to both
engines)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import frontends as jfrontends
from repro.models import transformer as jt
from repro.serve import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.models import frontends
from repro_torch.serve import (AdmissionError, Engine, ServeConfig,
                               SlotPool, StreamScheduler, Workload,
                               make_serve_steps)
from test_torch_lm_configs import open_gates

ARCHS = ("recurrentgemma-2b", "xlstm-350m") + tuple(
    a for a in ARCH_IDS if a not in ("recurrentgemma-2b", "xlstm-350m"))


class StubWorkload(Workload):
    """Records every scheduler interaction; items pass through as
    results, and an item equal to "last" completes its session."""

    def __init__(self):
        self.opened, self.closed, self.steps = [], [], []

    def open_session(self, session):
        self.opened.append(session.sid)
        return {}

    def step(self, batch, width):
        self.steps.append((tuple(s.sid for s, _ in batch), width))
        return [(item, item == "last") for _, item in batch]

    def close_session(self, session):
        self.closed.append(session.sid)


def test_admission_concurrency_queue_and_reject():
    wl = StubWorkload()
    sched = StreamScheduler(wl, ServeConfig(max_concurrency=2, max_queue=1))
    a, b = sched.open("a"), sched.open("b")
    assert a.admitted and b.admitted and wl.opened == [a.sid, b.sid]
    c = sched.open("c")
    assert not c.admitted and len(sched.waiting) == 1
    with pytest.raises(AdmissionError):
        sched.open("d")
    sched.close(a)
    assert c.admitted and wl.closed == [a.sid]


def test_backpressure_sheds_past_queue_depth():
    sched = StreamScheduler(StubWorkload(), ServeConfig(queue_depth=2))
    s = sched.open("a")
    assert sched.submit(s, 1) and sched.submit(s, 2)
    assert not sched.submit(s, 3)
    assert s.rejected == 1 and len(s.pending) == 2
    sched.tick()
    assert sched.submit(s, 3)


def test_tick_batches_ready_sessions_at_bucketed_width():
    wl = StubWorkload()
    sched = StreamScheduler(wl, ServeConfig(buckets=(1, 2, 4)))
    ss = [sched.open(f"c{i}") for i in range(3)]
    for s in ss:
        sched.submit(s, "x")
    assert sched.tick() == 3
    (sids, width), = wl.steps
    assert sids == tuple(s.sid for s in ss) and width == 4
    assert sched.tick() == 0


def test_done_result_closes_session_and_refills_from_queue():
    wl = StubWorkload()
    sched = StreamScheduler(wl, ServeConfig(max_concurrency=1, max_queue=4))
    a = sched.open("a")
    b = sched.open("b")
    sched.submit(a, "last")
    sched.tick()
    assert a.done and wl.closed == [a.sid]
    assert b.admitted
    sched.submit(b, "x")
    assert sched.drain() == 1
    assert b.results == ["x"] and not b.done


def test_overcommit_rotates_so_no_client_starves():
    wl = StubWorkload()
    sched = StreamScheduler(wl, ServeConfig(buckets=(1, 2)))
    ss = [sched.open(f"c{i}") for i in range(4)]
    for s in ss:
        for _ in range(2):
            sched.submit(s, "x")
    sched.drain()
    served = [sid for sids, _ in wl.steps for sid in sids]
    assert all(served.count(s.sid) == 2 for s in ss)


def test_report_latency_slo_and_single_sample_guard():
    sched = StreamScheduler(StubWorkload(), ServeConfig(budget_ms=1e6))
    s = sched.open("a")
    sched.submit(s, "x")
    sched.tick()
    rep = sched.report()
    row = rep["clients"]["a"]
    assert row["frames"] == 1
    assert row["jitter_ms"] == 0.0 and row["p95_ms"] == row["p50_ms"]
    assert row["slo"]["met"] == 1.0
    assert rep["aggregate"]["frames"] == 1 and rep["aggregate"]["ticks"] == 1


def test_slot_pool_exhaustion_refill_and_double_free():
    pool = SlotPool(3)
    slots = [pool.assign() for _ in range(3)]
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.assign()
    pool.free(slots[1])
    assert pool.in_use == (0, 2) and pool.assign() == 1
    pool.free(0)
    with pytest.raises(RuntimeError, match="not assigned"):
        pool.free(0)


# -- the LM engine ------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """Float32 SMOKE weights from the JAX init, with every matrix scaled
    up 5x in both packages so that greedy decoding walks through varied
    tokens rather than repeating one, and the cross-attention gates
    open."""
    arch = request.param
    cfg_j = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    cfg_t = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jt.init_params(cfg_j,
                                                   jax.random.PRNGKey(0)))
    tree = open_gates(jax.tree.map(lambda x: x * 5.0 if x.ndim >= 2 else x,
                                   tree))
    return cfg_j, jax.tree.map(jax.numpy.asarray, tree), cfg_t, \
        convert.params_from_numpy(cfg_t, tree, device="cpu")


def test_engine_continuous_batching(weights):
    _, _, cfg, params = weights
    eng = Engine(cfg, params, batch=2, max_len=64, device="cpu")
    rids = [eng.submit([1, 2, 3], max_new=5), eng.submit([4, 5], max_new=4),
            eng.submit([6], max_new=3)]
    done = eng.run()
    assert sorted(r.rid for r in done) == sorted(rids)
    assert [len(r.out) for r in sorted(done, key=lambda r: r.rid)] == [5, 4, 3]
    eng2 = Engine(cfg, params, batch=2, max_len=64, device="cpu")
    for r in sorted(done, key=lambda r: r.rid):
        eng2.submit(r.prompt, max_new=r.max_new)
    done2 = eng2.run()
    for a, b in zip(sorted(done, key=lambda r: r.rid),
                    sorted(done2, key=lambda r: r.rid)):
        assert a.out == b.out
    late = eng.submit([7, 8], max_new=2)
    assert late not in rids
    (r,) = eng.run()
    assert r.rid == late and len(r.out) == 2


def test_greedy_tokens_equal_the_jax_engine(weights, monkeypatch):
    """Four requests through two slots, two prompts past the SMOKE window
    of 16: the same tokens as the JAX Engine, token for token.  JAX's
    frontend draws from ``PRNGKey(7)``, which torch cannot reproduce, so
    the port's engine is handed the same array."""
    cfg_j, params_j, cfg_t, params_t = weights
    if cfg_t.encoder_seq:
        enc = np.array(jfrontends.synthetic_frontend(cfg_j, 1))
        monkeypatch.setattr(
            frontends, "synthetic_frontend",
            lambda cfg, batch, generator=None, dtype=torch.float32,
            device=None: torch.from_numpy(enc).to(device=device,
                                                  dtype=dtype))
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg_t.vocab, n)]
               for n in (24, 17, 5, 1)]
    max_new = [8, 6, 4, 2]
    outs = []
    for eng in (JEngine(cfg_j, params_j, batch=2, max_len=64),
                Engine(cfg_t, params_t, batch=2, max_len=64, device="cpu")):
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new=m)
        outs.append([r.out for r in sorted(eng.run(), key=lambda r: r.rid)])
    assert [len(o) for o in outs[1]] == max_new
    assert outs[1] == outs[0]
    assert len({t for o in outs[1] for t in o}) > 4     # not one token


def test_engine_defaults_to_the_card(monkeypatch, weights):
    _, _, cfg, params = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Engine(cfg, params, batch=1, max_len=8)
    with pytest.raises(RuntimeError):
        make_serve_steps(cfg, max_len=8, batch=1)
