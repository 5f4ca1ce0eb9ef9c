"""Paper Fig. 8/9: DF and DF^H runtime vs channel count; FFT batch
scaling vs the all-reduce cost that erodes DF^H beyond 2 devices.

Measured: DF / DF^H and the plan-cached batched FFT at the scenario's
channel count.  Derived: modeled multi-device times on the H100's rates
showing the paper's crossover (the all-reduce share grows with G —
execution time of DF^H can *increase* at G=4, paper Fig. 8 right).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.runtime import HW
from ...lib import fft as lfft
from ...nlinv import phantom
from ...nlinv.operators import make_ops, sobolev_weight, uinit
from .. import models
from ..registry import scenario

PARAMS = {"tiny": dict(n=48, J=4, fft_n=64, fft_batch=4),
          "paper": dict(n=96, J=12, fft_n=256, fft_batch=8)}


def _ops_setup(ctx):
    p = PARAMS[ctx.size]
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11, frames=1)
    g = d["grid"]
    ops = make_ops(d["masks"][0], d["fov"], sobolev_weight(g),
                   device=ctx.device)
    u0 = uinit(d["ncoils"], g, device=ctx.device)
    du = {k: v + 0.1 for k, v in u0.items()}
    r = torch.as_tensor(d["y"][0], device=ctx.device)
    return p, g, d["ncoils"], ops, u0, du, r


@scenario("fig89", "df")
def df(ctx):
    """DF (derivative of the NLINV forward model): scales 1/G."""
    p, g, J, ops, u0, du, _ = _ops_setup(ctx)
    t = ctx.measure(ops.DG, u0, du)
    return {**t.as_dict(),
            "extra": {"grid": g, "ncoils": J, "model_scaling": "1/G"}}


@scenario("fig89", "dfh")
def dfh(ctx):
    """DF^H: 1/G compute + the channel-sum all-reduce that grows with G."""
    p, g, J, ops, u0, _, r = _ops_setup(ctx)
    t = ctx.measure(ops.DGH, u0, r)
    flop_fft = 5 * g * g * np.log2(g * g)
    t_fft1 = 3 * J * flop_fft / HW["peak_flops_bf16"]
    img_b = g * g * 8
    extra = {"grid": g, "ncoils": J}
    for G in (1, 2, 4):
        t_dfh = t_fft1 / G + models.allreduce_time(img_b // 4, G)
        extra[f"model_t{G}_us"] = round(t_dfh * 1e6, 1)
    return {**t.as_dict(), "extra": extra}


@scenario("fig89", "fft_batch")
def fft_batch(ctx):
    """Plan-cached batched FFT vs the all-reduce that would join it."""
    p = PARAMS[ctx.size]
    n, batch = p["fft_n"], p["fft_batch"]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((batch, n, n))
         + 1j * rng.standard_normal((batch, n, n))).astype(np.complex64)
    sx = ctx.comm.container(x)
    plan = lfft.plan_fft2_batched(sx)       # built once per geometry
    t = ctx.measure(lambda a: plan(a).data, sx)
    extra = {"n": n, "batch": batch}
    for G in (2, 4):
        extra[f"model_allreduce{G}_us"] = round(
            models.allreduce_time(n * n * 8, G) * 1e6, 1)
    return {**t.as_dict(), "extra": extra}
