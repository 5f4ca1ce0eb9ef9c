"""Gridding plan: geometry setup cost vs a plan-cache hit.

The radial gridding plan precomputes the interpolation operator + Ram-Lak
DCF once per trajectory (on the card: the taps and the kernels' block
sweeps); per-frame re-planning would put that on the real-time latency
budget.  ``compile_ms`` is the cold build, ``steady_ms`` the LRU-hit
lookup — their ratio is the library-port win for the frame loop.
"""

from __future__ import annotations

from ...kernels import registry as kreg
from ...lib.gridding import plan_gridding, radial_trajectory
from ...lib.plan import PlanCache
from ..registry import scenario

PARAMS = {"tiny": dict(grid=64, nspokes=11), "paper": dict(grid=256, nspokes=65)}


@scenario("gridding", "plan_cold_vs_hit")
def plan_cold_vs_hit(ctx):
    """Cold gridding-plan build vs an LRU cache hit."""
    p = PARAMS[ctx.size]
    traj = radial_trajectory(p["grid"], p["nspokes"])
    cache = PlanCache()         # private: the first call is surely cold
    t = ctx.measure(lambda: plan_gridding(traj, p["grid"],
                                          device=ctx.device, cache=cache),
                    cache=cache)
    return {**t.as_dict(),
            "extra": {"grid": p["grid"], "nspokes": p["nspokes"],
                      "cold_ms": t.compile_ms, "hit_ms": t.steady_ms,
                      "speedup_cold_vs_hit": round(
                          t.compile_ms / max(t.steady_ms, 1e-6), 1),
                      # the (bs,) sample-block choices baked into the
                      # plan key by the registry autotuner
                      "kernel_blocks": kreg.choices("gridding")}}
