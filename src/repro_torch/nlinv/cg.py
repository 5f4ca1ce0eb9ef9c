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

``batched=True`` solves B independent systems at once, one a client (the
JAX package's vmapped ``while_loop``): ``rs``, ``thresh``, ``alpha`` and
``beta`` are (B,) device vectors, each row keeps the stop rule on its
own, and a row that stops is frozen (``cg_fused``: the update kernels'
``active`` mask; ``cg``: its state selected back) while the loop runs
until every row is done.  The host syncs once per iteration for all
rows.
"""

from __future__ import annotations

import torch

from ..kernels.cg_fused import cg_update, row_sq_norm, sq_norm, xpby_dot
from .operators import uaxpy, udot


def _floor(v):
    """``jnp.maximum(v, 1e-30)``; NaN stays NaN."""
    return torch.clamp(v, min=1e-30)


def _rows_axpy(a, x, y):
    """``a * x + y`` leaf by leaf with ``a`` a (B,) vector, row b of each
    leaf scaled by a[b] (the bits of ``uaxpy`` on that row)."""
    return {k: a.reshape(-1, *(1,) * (x[k].ndim - 1)) * x[k] + y[k]
            for k in x}


def _keep(active, new, old):
    """``new`` on the rows still running, ``old`` on the rows stopped."""
    return {k: torch.where(active.reshape(-1, *(1,) * (new[k].ndim - 1)),
                           new[k], old[k]) for k in new}


def cg(A, rhs, x0, *, iters: int = 30, tol: float = 1e-6, dot=udot,
       batched: bool = False):
    """Solve A x = rhs, A SPD (normal operator + alpha I).

    ``batched``: the leaves carry B independent systems, ``dot`` returns
    one product a row, and each row keeps the stop rule on its own, as
    the JAX package's vmapped ``while_loop``: a stopped row keeps its
    ``x``, ``r``, ``p`` and ``rs`` (a NaN row stops before its first
    iteration) while the loop runs until every row is done."""
    axpy = _rows_axpy if batched else uaxpy
    r = uaxpy(-1.0, A(x0), rhs)
    p = r
    rs = torch.real(dot(r, r))
    thresh = tol * tol * rs
    x, i = x0, 0
    active = rs > thresh
    while i < iters and bool(active.any()):
        Ap = A(p)
        alpha = rs / _floor(torch.real(dot(p, Ap)))
        x_new = axpy(alpha, p, x)
        r_new = axpy(-alpha, Ap, r)
        rs_new = torch.real(dot(r_new, r_new))
        beta = rs_new / _floor(rs)
        p_new = axpy(beta, p, r_new)
        if batched:
            x, r, p = (_keep(active, x_new, x), _keep(active, r_new, r),
                       _keep(active, p_new, p))
            rs = torch.where(active, rs_new, rs)
            active = active & (rs > thresh)
        else:
            x, r, p, rs = x_new, r_new, p_new, rs_new
            active = rs > thresh
        i += 1
    return x


def _tree_sum(parts):
    """Sum of the per-leaf partials in JAX's leaf order (chat, then rho)."""
    return sum(parts[k] for k in sorted(parts))


def cg_fused(apply_pap, rhs, *, iters: int = 30, tol: float = 1e-6,
             rs_sum=None, x0=None, impl: str = "auto", log=None,
             batched: bool = False, blocks=None):
    """Fused-hot-path CG.

    ``apply_pap(p) -> (A p, <p, A p>)``; ``rs_sum`` merges the per-leaf
    ``sum |.|^2`` partials (default: their plain sum); ``x0=None`` starts
    at zero with ``r0 = rhs`` exactly.  ``impl`` goes to the update
    kernels, and ``blocks`` (``{"cg_update": ..., "xpby": ...}``, the
    frame plan's) their launch shapes.  ``log``, a list, gets the number
    of iterations that ran appended to it: with ``batched`` (leaves
    (B, ...), ``<p, A p>`` (B,)), a tuple of each row's count.
    """
    if rs_sum is None:
        rs_sum = _tree_sum
    blocks = {} if blocks is None else blocks
    b_update, b_xpby = blocks.get("cg_update"), blocks.get("xpby")
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
                             active=active, block=b_update)
                for k in sorted(p)}
        x = {k: o[0] for k, o in outs.items()}
        r = {k: o[1] for k, o in outs.items()}
        rs_new = rs_sum({k: o[2] for k, o in outs.items()})
        beta = rs_new / _floor(rs)
        p = {k: xpby_dot(r[k], p[k], beta, impl=impl, with_dot=False,
                         active=active, block=b_xpby)[0]
             for k in sorted(r)}
        rs, i = rs_new, i + 1
        if batched:
            ran += active
            active = active & (rs > thresh)
    if log is not None:
        log.append(tuple(ran.tolist()) if batched else i)
    return x
