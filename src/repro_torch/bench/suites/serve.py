"""Serving-layer scenarios: the multi-stream reconstruction service.

``serve.multi_stream`` is the SLO evidence: K concurrent clients
streaming through one ``StreamScheduler``, per-tick latency plus the
worst per-client p95 (``extra.client_p95_ms`` — the column
``repro_torch.bench.compare`` gates for serve scenarios).

``serve.batched_vs_sequential`` is the acceptance A/B: aggregate
steady-state frames/sec of the batched scheduler vs the same K streams
solved one-at-a-time (``FrameStream`` per client), same card, same run
— plus the max relative error between the two answers (the batched
frame runs every row through the batched kernels, each row the
unbatched frame's arithmetic).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...ft import FaultInjector, FaultSpec, RestartPolicy
from ...lib.plan import default_cache
from ...nlinv import phantom
from ...nlinv.recon import Reconstructor
from ...nlinv.stream import FrameStream, latency_stats
from ...serve import NlinvStreamWorkload, ServeConfig, StreamScheduler
from ..registry import scenario

# newton/cg deep enough to be collective-bound: the batched win is the
# amortized per-iteration rendezvous, so a too-shallow solve understates
# it and makes the A/B flaky
PARAMS = {"tiny": dict(n=16, J=4, newton=3, cg=8, frames=5, clients=4),
          "paper": dict(n=32, J=8, newton=4, cg=10, frames=6, clients=4)}


def _datasets(p):
    return [phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=7,
                                 frames=p["frames"], seed=s)
            for s in range(p["clients"])]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _save_report(ctx, name, rep) -> None:
    """Rank 0 writes the scheduler's report beside the artifact."""
    if ctx.comm.rank == 0:
        (ctx.out_dir / name).parent.mkdir(parents=True, exist_ok=True)
        (ctx.out_dir / name).write_text(json.dumps(rep, indent=2) + "\n")


def _run_scheduler(ctx, p, datas):
    """K clients in lockstep through the scheduler; returns (scheduler,
    sessions, plan builds on tick 0, plan builds after)."""
    rec = Reconstructor(ctx.comm, newton=p["newton"], cg_iters=p["cg"],
                        channel_sum="crop")
    sched = StreamScheduler(
        NlinvStreamWorkload(rec, damping=0.9),
        ServeConfig(max_concurrency=2 * p["clients"], buckets=(1, 2, 4, 8)))
    sessions = [sched.open(client=f"client{k}", grid=d["grid"],
                           ncoils=p["J"], fov=d["fov"])
                for k, d in enumerate(datas)]
    cache = default_cache()
    start = cache.builds
    setup_builds = steady_builds = 0
    for f in range(p["frames"]):
        for k, d in enumerate(datas):
            sched.submit(sessions[k], (d["y"][f], d["masks"][f]))
        sched.tick()
        if f == 0:
            setup_builds = cache.builds - start
    steady_builds = cache.builds - start - setup_builds
    return sched, sessions, setup_builds, steady_builds


@scenario("serve", "multi_stream")
def multi_stream(ctx):
    """K concurrent NLINV streams through one scheduler: per-tick
    latency and worst per-client p95 (the serving SLO columns)."""
    p = PARAMS[ctx.size]
    datas = _datasets(p)
    sched, _, setup_builds, steady_builds = _run_scheduler(ctx, p, datas)
    rep = sched.report()
    ticks = sched.tick_ms
    steady = ticks[1:] if len(ticks) > 1 else ticks
    stats = latency_stats(steady)
    client_p95 = max(c["p95_ms"] for c in rep["clients"].values())
    agg = rep["aggregate"]
    name = f"serve_multi_stream_d{ctx.devices}_{ctx.size}.json"
    _save_report(ctx, name, rep)
    return {
        "wall_ms": round(float(sum(ticks)), 3),
        "compile_ms": round(ticks[0], 3),
        "steady_ms": round(min(steady), 3),
        "p50_ms": stats["p50_ms"],
        "p95_ms": stats["p95_ms"],
        "jitter_ms": stats["jitter_ms"],
        "plan_cache": {"setup": {"builds": setup_builds},
                       "steady": {"builds": steady_builds}},
        "extra": {"clients": p["clients"], "frames": agg["frames"],
                  "ticks": agg["ticks"], "agg_fps": agg["fps"],
                  "client_p95_ms": client_p95, "artifact": name},
    }


@scenario("serve", "chaos")
def chaos(ctx):
    """Serving under seed-scheduled fault injection (ADVISORY — not
    regression-gated, ``extra.advisory`` tells the comparator so): K
    clients stream while the injector fires a transient solve failure
    (absorbed by task retry), poisons one client's tick items (absorbed
    by quarantine), and straggles the step (feeds the deadline ladder).
    Evidence columns: recovery latency of the faulted ticks and the
    aggregate frames/sec the degraded service still delivers."""
    p = PARAMS[ctx.size]
    datas = _datasets(p)
    seed = int(os.environ.get("REPRO_FAULT_SEED", "1234"))
    rec = Reconstructor(ctx.comm, newton=p["newton"], cg_iters=p["cg"],
                        channel_sum="crop")
    wl = NlinvStreamWorkload(rec, damping=0.9,
                             retry=RestartPolicy(max_restarts=2,
                                                 backoff_s=0.0))
    sched = StreamScheduler(wl, ServeConfig(
        max_concurrency=2 * p["clients"], buckets=(1, 2, 4, 8),
        deadline_ms=10_000.0, breach_ticks=2, recover_ticks=2))
    sessions = [sched.open(client=f"client{k}", grid=d["grid"],
                           ncoils=p["J"], fov=d["fov"])
                for k, d in enumerate(datas)]
    specs = [
        FaultSpec(site="task", kind="transient", match="solve", at=(1,),
                  max_fires=1),
        FaultSpec(site="step", kind="corrupt", at=(2,), pick=1,
                  max_fires=1),
        FaultSpec(site="step", kind="straggle", at=(3,), delay_ms=2.0),
    ]
    with FaultInjector(specs, seed=seed) as inj:
        for f in range(p["frames"]):
            for k, d in enumerate(datas):
                sched.submit(sessions[k], (d["y"][f], d["masks"][f]))
            while sched.tick() == 0 and \
                    any(s.pending for s in sched.sessions.values()):
                pass    # transient tick: retry until the batch lands
    rep = sched.report()
    ft = rep["aggregate"]["ft"]
    ticks = sched.tick_ms
    steady = ticks[1:] if len(ticks) > 1 else ticks
    # recovery latency: the faulted ticks' cost over the clean floor
    floor = min(steady)
    faulted = [round(t - floor, 3) for t in steady if t > floor]
    name = f"serve_chaos_d{ctx.devices}_{ctx.size}.json"
    _save_report(ctx, name, rep)
    return {
        "wall_ms": round(float(sum(ticks)), 3),
        "compile_ms": round(ticks[0], 3),
        "steady_ms": round(floor, 3),
        "extra": {
            "advisory": True,
            "seed": seed,
            "fired": [list(f) for f in inj.fired],
            "step_faults": ft["step_faults"],
            "retried_tasks": ft["retried_tasks"],
            "quarantined": ft["quarantined"],
            "rejected_poisoned": ft["rejected_poisoned"],
            "degradation_events": ft["degradation_events"],
            "recovery_ms_max": max(faulted, default=0.0),
            "degraded_fps": rep["aggregate"]["fps"],
            "artifact": name,
        },
    }


@scenario("serve", "batched_vs_sequential")
def batched_vs_sequential(ctx):
    """A/B: batched-scheduler aggregate frames/sec vs K one-at-a-time
    streams, plus parity of the two answers (the acceptance gate)."""
    p = PARAMS[ctx.size]
    datas = _datasets(p)
    K, F = p["clients"], p["frames"]
    sched, sessions, setup_builds, steady_builds = \
        _run_scheduler(ctx, p, datas)
    ticks = sched.tick_ms
    steady = ticks[1:] if len(ticks) > 1 else ticks
    batched_wall = float(sum(steady))
    batched_fps = K * len(steady) / max(batched_wall, 1e-9) * 1e3

    # sequential baseline: the same K streams, one FrameStream each
    seq_wall, seq_frames, errs = 0.0, 0, []
    for k, d in enumerate(datas):
        rec = Reconstructor(ctx.comm, newton=p["newton"],
                            cg_iters=p["cg"], channel_sum="crop")
        imgs, rep = FrameStream(rec, damping=0.9).run(
            d["y"], d["masks"], d["fov"])
        fms = rep.frame_ms[1:] if len(rep.frame_ms) > 1 else rep.frame_ms
        seq_wall += float(sum(fms))
        seq_frames += len(fms)
        for f in range(F):
            a = _host(sessions[k].results[f])
            b = _host(imgs[f])
            errs.append(float(np.abs(a - b).max() /
                              max(np.abs(b).max(), 1e-30)))
    seq_fps = seq_frames / max(seq_wall, 1e-9) * 1e3
    return {
        "wall_ms": round(float(sum(ticks)) + seq_wall, 3),
        "compile_ms": round(ticks[0], 3),
        "steady_ms": round(min(steady), 3),
        "plan_cache": {"setup": {"builds": setup_builds},
                       "steady": {"builds": steady_builds}},
        "extra": {"clients": K, "frames_per_client": F,
                  "batched_fps": round(batched_fps, 2),
                  "sequential_fps": round(seq_fps, 2),
                  "batched_speedup": round(batched_fps /
                                           max(seq_fps, 1e-9), 3),
                  "max_rel_err": max(errs)},
    }
