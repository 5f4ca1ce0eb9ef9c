"""Iteratively Regularized Gauss-Newton Method (paper eq. 3).

    (DG^H DG + alpha_n I)(x_{n+1} - x_n)
        = DG^H (y - G(x_n)) - alpha_n (x_n - x_ref)

with alpha_n = alpha0 * q^n in float32 and the previous frame as x_ref.
``irgnm`` is the unfused baseline, ``irgnm_fused`` the hot path over the
fused operators and ``cg_fused``; the reduction hooks default to the
one-device forms, as in ``repro.nlinv.irgnm``.
"""

from __future__ import annotations

import torch

from ..kernels.coil_mult import plane_mult
from .cg import cg, cg_fused
from .operators import local_reducer, uaxpy, udot


def _alpha0(alpha0, like):
    return torch.tensor(alpha0, dtype=torch.float32, device=like.device)


def irgnm(ops, y, x0, x_ref=None, *, newton: int = 7, cg_iters: int = 30,
          alpha0: float = 1.0, q: float = 1.0 / 3.0,
          channel_sum=None, dot=None):
    """Returns the solution state u = {rho, chat}.  Over batched
    operators (``ops.batched``) the B frames share the Newton schedule
    (alpha0, q), ``dot`` returns a product a row, and each row's CG stops
    on its own."""
    if dot is None:
        dot = udot
    x = x0
    if x_ref is None:
        x_ref = x0
    alpha = _alpha0(alpha0, y)
    for _ in range(newton):
        r = uaxpy(-1.0, ops.G(x), y)                       # y - G(x)
        rhs = ops.DGH(x, r, channel_sum=channel_sum)
        rhs = uaxpy(alpha, uaxpy(-1.0, x, x_ref), rhs)     # - a (x - ref)

        def A(du, x=x, alpha=alpha):
            return ops.normal(x, du, alpha, channel_sum=channel_sum)

        dx = cg(A, rhs, {k: torch.zeros_like(v) for k, v in x.items()},
                iters=cg_iters, dot=dot, batched=ops.batched)
        x = uaxpy(1.0, dx, x)
        alpha = alpha * q
    return x


def irgnm_fused(ops, y, x0, x_ref=None, *, newton: int = 7,
                cg_iters: int = 30, alpha0: float = 1.0, q: float = 1.0 / 3.0,
                reducer=None, rs_sum=None, log=None):
    """IRGNM on the fused hot path: the same Newton/regularization
    schedule as :func:`irgnm`, with the Newton-point constants hoisted
    (``NlinvOps.precompute``) and the CG body on the update kernels.
    ``log`` collects each CG solve's iteration count.  Over batched
    operators (``ops.batched``) the B frames share the Newton schedule
    (alpha0, q) and each row's CG stops on its own."""
    if reducer is None:
        reducer = local_reducer
    x = x0
    if x_ref is None:
        x_ref = x0
    # G_fused's output is masked by construction; masking y once makes
    # every residual mask-supported, which DGH_fused relies on.
    y = plane_mult(y, ops.mask, impl=ops.impl,
                   block=ops.blocks.get("plane_mult"))
    alpha = _alpha0(alpha0, y)
    for _ in range(newton):
        pre = ops.precompute(x)
        r = uaxpy(-1.0, ops.G_fused(x, c0=pre["c0"]), y)   # y - G(x), masked
        rhs, _ = ops.DGH_fused(pre, r, reducer=reducer)
        rhs = uaxpy(alpha, uaxpy(-1.0, x, x_ref), rhs)     # - a (x - ref)

        def pap(p, pre=pre, alpha=alpha):
            return ops.normal_pap(pre, p, alpha, reducer=reducer)

        dx = cg_fused(pap, rhs, iters=cg_iters, rs_sum=rs_sum,
                      impl=ops.impl, log=log, batched=ops.batched,
                      blocks=ops.blocks)
        x = uaxpy(1.0, dx, x)
        alpha = alpha * q
    return x


def postprocess(ops, u):
    """rho * |c| normalization: the displayed image (RSS-weighted)."""
    c = ops.coils(u["chat"])
    rss = torch.sqrt(torch.sum(torch.abs(c) ** 2, dim=0))
    return u["rho"] * rss
