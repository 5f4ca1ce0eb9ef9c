"""Paper Fig. 4: FFT / aX+Y / A.B over a batch of complex square
matrices.

Measured: steady-state per-call cost of the plan-cached
``repro_torch.lib`` implementations on the scenario's ranks.  Derived:
modeled parallel efficiency at 2/4/8 devices on the H100's rates — FFT
and aXPY are embarrassingly batch-parallel (efficiency ~1); A.B with the
contracted dim split pays one inter-device reduction (the paper's
finding that A.B does not strong-scale).
"""

from __future__ import annotations

import numpy as np

from ...core.runtime import HW
from ...lib import blas as lblas
from ...lib import fft as lfft
from .. import models
from ..registry import scenario

# paper: 12 complex square matrices, 128..512
PARAMS = {"tiny": dict(n=64, batch=4), "paper": dict(n=512, batch=12)}


def _cbatch(ctx, seed=0):
    p = PARAMS[ctx.size]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((p["batch"], p["n"], p["n"]))
         + 1j * rng.standard_normal((p["batch"], p["n"], p["n"])))
    return p, x.astype(np.complex64)


@scenario("fig4", "fft_fwdinv")
def fft_fwdinv(ctx):
    """Forward+inverse batched 2-D FFT (batch-parallel, zero comm)."""
    p, x = _cbatch(ctx)
    sx = ctx.comm.container(x)
    t = ctx.measure(lambda a: lfft.fft2_batched(
        lfft.fft2_batched(a), inverse=True).data, sx)
    return {**t.as_dict(),
            "extra": {"n": p["n"], "batch": p["batch"],
                      "model_eff2": 1.0, "model_eff4": 1.0,
                      "model_eff8": 1.0}}


@scenario("fig4", "axpy")
def axpy(ctx):
    """aX+Y over the segmented batch (batch-parallel, zero comm)."""
    p, x = _cbatch(ctx)
    sx = ctx.comm.container(x)
    sy = ctx.comm.container(x[..., ::-1].copy())
    t = ctx.measure(lambda u, v: lblas.axpy(2.0 + 1j, u, v).data, sx, sy)
    return {**t.as_dict(),
            "extra": {"n": p["n"], "batch": p["batch"],
                      "model_eff2": 1.0, "model_eff4": 1.0,
                      "model_eff8": 1.0}}


@scenario("fig4", "gemm_ksplit")
def gemm_ksplit(ctx):
    """A.B with the contracted dim split: local matmul + one psum."""
    n = PARAMS[ctx.size]["n"]
    rng = np.random.default_rng(1)
    A = rng.standard_normal((n, n)).astype(np.float32)
    B = rng.standard_normal((n, n)).astype(np.float32)
    sA = ctx.comm.container(A, dim=1)
    sB = ctx.comm.container(B, dim=0)
    t = ctx.measure(lambda u, v: lblas.gemm_ksplit(u, v).data, sA, sB)
    # modeled: local matmul scales 1/G, then psum of the full (n, n)
    t1 = 2 * n ** 3 / HW["peak_flops_bf16"]
    extra = {"n": n, "schedule": lblas.gemm_ksplit_schedule(sA, sB)}
    for G in (2, 4, 8):
        tG = t1 / G + models.allreduce_time(n * n * 4, G)
        extra[f"model_eff{G}"] = round(t1 / (G * tG), 3)
    return {**t.as_dict(), "extra": extra}
