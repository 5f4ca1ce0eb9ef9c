"""Paper Fig. 6 (+Fig. 7): NLINV frame rate vs (#ranks, #channels) and
the paper-claims validation at the paper's own problem size.

Measured: per-frame solve cost of the ``Reconstructor`` frame on the
scenario's ranks (coils NATURAL-split over the group), on the CUDA
kernels of the fused path.  Derived: the calibrated speedup model at 1-4
devices (paper §3.2 — FFT+pointwise scale 1/G, the Sum rho_g all-reduce
grows with G; validated against the paper's claims: ~1.7x @ 2 GPUs,
~2.1x @ 4), and the same model on the H100's rates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...kernels import registry as kreg
from ...nlinv import phantom
from ...nlinv.operators import sobolev_weight
from ...nlinv.recon import Reconstructor, pad_channels
from ...nlinv.stream import FramePipeline, FrameStream, latency_stats
from .. import models
from ..registry import scenario

PARAMS = {"tiny": dict(n=24, J=4, newton=3, cg=6),
          "paper": dict(n=64, J=8, newton=6, cg=10)}


def frame_setup(ctx, fused: bool = True):
    """The scenario's frame on this rank: ``(rec, args)`` with
    ``rec.fn(*args)`` one frame solve, every input on the rank's
    device."""
    p = PARAMS[ctx.size]
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11, frames=1)
    g = d["grid"]
    rec = Reconstructor(ctx.comm, newton=p["newton"], cg_iters=p["cg"],
                        channel_sum="crop", fused=fused)
    y0 = pad_channels(np.asarray(d["y"][0]), rec.comm.size)
    y = rec.put_frame(y0)
    mask = rec.put_const(np.asarray(d["masks"][0]))
    fov = rec.put_const(np.asarray(d["fov"]))
    w = rec.put_const(np.asarray(sobolev_weight(g)))
    u0 = rec.init_carry(y0.shape[0], g)
    x_ref = {k: v.clone() for k, v in u0.items()}
    return rec, (y, mask, fov, w, u0, x_ref)


@scenario("fig6", "nlinv_frame")
def nlinv_frame(ctx):
    """One NLINV frame solve (IRGNM + CG) at the sweep's rank count."""
    p = PARAMS[ctx.size]
    rec, args = frame_setup(ctx)
    g, J = args[2].shape[-1], p["J"]
    t = ctx.measure(lambda: rec.fn(*args)[1])
    sp = models.speedup_model(g, J)
    sh = models.speedup_model(g, J, hw="h100")
    extra = {"grid": g, "ncoils": J, "newton": p["newton"], "cg": p["cg"],
             "fps": round(1e3 / max(t.steady_ms, 1e-9), 2),
             "model_paper_s2": round(sp[2], 2),
             "model_paper_s4": round(sp[4], 2),
             "model_h100_s4": round(sh[4], 2)}
    return {**t.as_dict(), "extra": extra}


@scenario("fig6", "cg_fused")
def cg_fused(ctx):
    """A/B: fused CG hot path (default) vs the unfused escape hatch.

    ``steady_ms`` is the fused frame (what the regression gate tracks);
    ``extra`` carries the back-to-back unfused measurement and the
    resulting same-machine speedup.
    """
    rec_f, args_f = frame_setup(ctx, fused=True)
    rec_u, args_u = frame_setup(ctx, fused=False)
    g = args_f[2].shape[-1]
    # interleave the A/B rounds so slow machine episodes (shared-host
    # neighbors, thermal) hit both arms instead of biasing whichever
    # ran second; per arm the best (minimum) sample is kept.
    t_f = ctx.measure(lambda: rec_f.fn(*args_f)[1])
    t_u = ctx.measure(lambda: rec_u.fn(*args_u)[1])
    t_f2 = ctx.measure(lambda: rec_f.fn(*args_f)[1])
    t_u2 = ctx.measure(lambda: rec_u.fn(*args_u)[1])
    fused_ms = min(t_f.steady_ms, t_f2.steady_ms)
    unfused_ms = min(t_u.steady_ms, t_u2.steady_ms)
    speedup = round(unfused_ms / max(fused_ms, 1e-9), 3)
    extra = {"grid": g, "ncoils": PARAMS[ctx.size]["J"],
             "unfused_steady_ms": unfused_ms,
             "fused_speedup": speedup,
             # the block choices the fused frame ran with (swept on the
             # card, the defaults on the CPU): the autotuner's output is
             # part of the artifact
             "kernel_blocks": kreg.choices("cg_fused")}
    out = t_f.as_dict()
    out["steady_ms"] = fused_ms
    return {**out, "extra": extra}


@scenario("fig6", "pipelined_vs_overlap")
def pipelined_vs_overlap(ctx):
    """A/B: task-graph ``FramePipeline`` vs two-stage ``FrameStream``.

    Both arms reconstruct the same short movie with the same
    ``Reconstructor``; the difference is purely the execution schedule —
    per-frame host fence + upload overlap (baseline) vs ``inflight``
    whole frame graphs queued on the card.  ``steady_ms`` is the
    pipelined arm's best steady per-frame time (what the regression gate
    tracks); ``extra`` carries the baseline's back-to-back measurement,
    the resulting same-machine speedup, and the output parity between the
    two movies.
    """
    p = PARAMS[ctx.size]
    F = 8
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11, frames=F)
    rec = Reconstructor(ctx.comm, newton=p["newton"], cg_iters=p["cg"],
                        channel_sum="crop")
    pipe = FramePipeline(rec, inflight=2)
    seq = FrameStream(rec)
    args = (d["y"], d["masks"], d["fov"])

    def steady(rep):
        return float(np.mean(rep.frame_ms[1:]))

    t_all = time.perf_counter()
    # first run of each arm pays the block sweeps and plan builds and
    # provides the movies for the parity check
    t0 = time.perf_counter()
    mov_p, _ = pipe.run(*args)
    mov_s, _ = seq.run(*args)
    compile_ms = (time.perf_counter() - t0) * 1e3
    # interleave the A/B rounds (as in cg_fused) so slow host episodes
    # hit both arms; per arm the best steady-state mean is kept
    reps_p, reps_s = [], []
    for _ in range(2):
        reps_p.append(pipe.run(*args)[1])
        reps_s.append(seq.run(*args)[1])
    pipe_ms = min(steady(r) for r in reps_p)
    overlap_ms = min(steady(r) for r in reps_s)
    best = min(reps_p, key=steady)
    err = float(torch.max(torch.abs(mov_p - mov_s))
                / torch.max(torch.abs(mov_s)))
    stats = latency_stats(best.frame_ms[1:])
    extra = {"grid": d["grid"], "ncoils": d["ncoils"], "frames": F,
             "inflight": pipe.inflight,
             "overlap_steady_ms": round(overlap_ms, 3),
             "pipelined_speedup": round(overlap_ms / max(pipe_ms, 1e-9),
                                        3),
             "max_rel_err": err,
             "steady_builds": int(sum(best.frame_plan_builds))}
    return {"wall_ms": round((time.perf_counter() - t_all) * 1e3, 3),
            "compile_ms": round(compile_ms, 3),
            "steady_ms": round(pipe_ms, 3),
            "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
            "jitter_ms": stats["jitter_ms"], "extra": extra}


@scenario("fig6", "paper_claims", devices=(1,))
def paper_claims(ctx):
    """Model-only validation of the paper's speedups + Fig. 7 energy."""
    # the paper's own problem size (grid 768 = 2x384, J=8 compressed;
    # claims ~1.7x @ 2 GPUs, ~2.1x @ 4, degradation past the IOH at 8)
    sp = models.speedup_model(768, 8)
    extra = {"model_paper_s2": round(sp[2], 2), "claim_s2": 1.7,
             "model_paper_s4": round(sp[4], 2), "claim_s4": 2.1,
             "model_paper_s8": round(sp[8], 2)}
    # fig7: energy/frame model — chips-busy vs speedup tradeoff
    for G in (1, 2, 4):
        extra[f"model_rel_J_per_frame_G{G}"] = round(G / sp[G], 2)
    return {"wall_ms": 0.0, "compile_ms": 0.0, "steady_ms": 0.0,
            "extra": extra}
