"""Streaming real-time engine: steady-state per-frame latency + jitter.

Frame f+1's upload overlaps frame f's solve (``DoubleBuffer``: a side
CUDA stream on the card), the Newton carry is updated in place, and the
per-frame latency report artifact is the recon-service SLO evidence.
``compile_ms`` is the first frame (it pays the kernels' block sweeps and
every plan build), ``steady_ms`` the best steady-state frame (the
harness's robust metric; mean/p50/p95/jitter ride along) — and the
plan-cache columns prove the steady state builds nothing.
"""

from __future__ import annotations

from ...nlinv import phantom
from ...nlinv.recon import Reconstructor
from ...nlinv.stream import FrameStream
from ..registry import scenario

PARAMS = {"tiny": dict(n=24, J=4, newton=3, cg=6, frames=4),
          "paper": dict(n=48, J=8, newton=6, cg=10, frames=8)}


@scenario("stream", "nlinv_latency")
def nlinv_latency(ctx):
    """Per-frame latency/jitter of the double-buffered frame loop."""
    p = PARAMS[ctx.size]
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11,
                             frames=p["frames"])
    rec = Reconstructor(ctx.comm, newton=p["newton"], cg_iters=p["cg"],
                        channel_sum="crop")
    # one report per sweep point — the 4-rank child must not clobber the
    # 1-rank child's SLO evidence; rank 0 writes it
    name = f"nlinv_stream_latency_d{ctx.devices}_{ctx.size}.json"
    path = ctx.out_dir / name if ctx.comm.rank == 0 else None
    _, rep = FrameStream(rec, damping=0.9).run(
        d["y"], d["masks"], d["fov"], report_path=path)
    s = rep.summary()
    pc = s.get("plan_cache", {})
    return {
        "wall_ms": round(float(sum(s["frame_ms"])), 3),
        "compile_ms": s["first_frame_ms"],
        # best steady frame, like every harness-measured scenario: the
        # compare gate sees one consistently-defined robust metric
        "steady_ms": round(min(s["frame_ms"][1:] or s["frame_ms"]), 3),
        "p50_ms": s["p50_ms"],
        "p95_ms": s["p95_ms"],
        "jitter_ms": s["jitter_ms"],
        "plan_cache": {
            "setup": {"builds": (pc.get("frame_builds") or [0])[0]},
            "steady": {"builds": pc.get("steady_builds", 0),
                       "hit_rate": pc.get("hit_rate", 0.0)},
        },
        "extra": {"fps": s["fps"], "frames": s["frames"],
                  "mean_ms": s["mean_ms"], "grid": s["grid"],
                  "ncoils": s["ncoils"], "artifact": name},
    }
