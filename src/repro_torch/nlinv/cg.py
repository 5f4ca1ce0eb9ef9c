"""Conjugate gradient on the {rho, chat} state (inner solver of eq. 3).

``cg``        the unfused baseline: every scalar product through ``dot``
              and three separate ``uaxpy`` passes per iteration.
``cg_fused``  the hot path: the operator returns ``<p, A p>`` with ``A p``
              (``NlinvOps.normal_pap``), the x/r updates and the ``r.r``
              epilogue run as one ``cg_update`` kernel per leaf, and the
              search direction is one ``xpby`` kernel per leaf.

Both keep the JAX while-loop's stop rule ``i < iters and rs > thresh``
exactly.  ``rs`` stays a float32 device scalar, and so do ``alpha`` and
``beta``; the one host sync per iteration is the stop test.  A NaN
residual makes ``rs > thresh`` false, so a NaN frame returns ``x0`` as the
JAX loop does (the serving layer's quarantine relies on it).

``cg_fused(..., batched=True)`` solves B independent systems at once,
one a client (the JAX package's vmapped ``while_loop``): ``rs``,
``thresh``, ``alpha`` and ``beta`` are (B,) device vectors, each row keeps
the stop rule on its own, and a row that stops is frozen (the update
kernels' ``active`` mask) while the loop runs until every row is done.
The host syncs once per iteration for all rows.
"""

from __future__ import annotations

import torch

from ..kernels.cg_fused import cg_update, row_sq_norm, sq_norm, xpby_dot
from .operators import uaxpy, udot


def _floor(v):
    """``jnp.maximum(v, 1e-30)``; NaN stays NaN."""
    return torch.clamp(v, min=1e-30)


def cg(A, rhs, x0, *, iters: int = 30, tol: float = 1e-6, dot=udot):
    """Solve A x = rhs, A SPD (normal operator + alpha I)."""
    r = uaxpy(-1.0, A(x0), rhs)
    p = r
    rs = torch.real(dot(r, r))
    thresh = tol * tol * rs
    x, i = x0, 0
    while i < iters and bool(rs > thresh):
        Ap = A(p)
        alpha = rs / _floor(torch.real(dot(p, Ap)))
        x = uaxpy(alpha, p, x)
        r = uaxpy(-alpha, Ap, r)
        rs_new = torch.real(dot(r, r))
        beta = rs_new / _floor(rs)
        p = uaxpy(beta, p, r)
        rs, i = rs_new, i + 1
    return x


def _tree_sum(parts):
    """Sum of the per-leaf partials in JAX's leaf order (chat, then rho)."""
    return sum(parts[k] for k in sorted(parts))


def cg_fused(apply_pap, rhs, *, iters: int = 30, tol: float = 1e-6,
             rs_sum=None, x0=None, impl: str = "auto", log=None,
             batched: bool = False):
    """Fused-hot-path CG.

    ``apply_pap(p) -> (A p, <p, A p>)``; ``rs_sum`` merges the per-leaf
    ``sum |.|^2`` partials (default: their plain sum); ``x0=None`` starts
    at zero with ``r0 = rhs`` exactly.  ``impl`` goes to the update
    kernels.  ``log``, a list, gets the number of iterations that ran
    appended to it: with ``batched`` (leaves (B, ...), ``<p, A p>`` (B,)),
    a tuple of each row's count.
    """
    if rs_sum is None:
        rs_sum = _tree_sum
    norm = row_sq_norm if batched else sq_norm
    if x0 is None:
        x = {k: torch.zeros_like(v) for k, v in rhs.items()}
        r = rhs
    else:
        x = x0
        ax0, _ = apply_pap(x0)
        r = uaxpy(-1.0, ax0, rhs)
    rs = rs_sum({k: norm(v) for k, v in r.items()})
    thresh = tol * tol * rs
    p, i = r, 0
    # each row's stop rule, on the device; a row once stopped stays so
    active = ran = None
    if batched:
        active = rs > thresh
        ran = torch.zeros(rs.shape, dtype=torch.int32, device=rs.device)
    while i < iters and bool(active.any() if batched else rs > thresh):
        ap, pap = apply_pap(p)
        alpha = rs / _floor(torch.real(pap))
        outs = {k: cg_update(alpha, p[k], ap[k], x[k], r[k], impl=impl,
                             active=active)
                for k in sorted(p)}
        x = {k: o[0] for k, o in outs.items()}
        r = {k: o[1] for k, o in outs.items()}
        rs_new = rs_sum({k: o[2] for k, o in outs.items()})
        beta = rs_new / _floor(rs)
        p = {k: xpby_dot(r[k], p[k], beta, impl=impl, with_dot=False,
                         active=active)[0]
             for k in sorted(r)}
        rs, i = rs_new, i + 1
        if batched:
            ran += active
            active = active & (rs > thresh)
    if log is not None:
        log.append(tuple(ran.tolist()) if batched else i)
    return x
