"""Plain PyTorch versions of the fused CG vector updates.

The CPU path of the wrappers in ``ops.py`` and the oracle their CUDA
kernels are held against on the card.  A batch (``alpha``/``beta`` a
(B,) vector, the operands' leading dim B) runs row by row through the
unbatched form, with the optional (B,) ``active`` mask: an inactive row's
outputs are copies of its inputs (``x``, ``r`` and ``rs`` of that ``r``;
``w = y``), whatever its scalar holds."""

import torch


def sq_norm(v):
    """sum |v|^2 as a real float32 scalar (``jnp.real(jnp.vdot(v, v))``):
    the plain form of the kernels' dot epilogues, and the solver's
    residual and curvature norms."""
    flat = v.reshape(-1)
    return torch.real(torch.vdot(flat, flat)).to(torch.float32)


def row_sq_norm(v):
    """sum |v_b|^2 of each row of a batch (B, ...), as a (B,) float32
    vector: ``sq_norm`` of each row, so that a row's bits are those of
    the unbatched norm (a reduction over a (B, n) view may sum in another
    order)."""
    return torch.stack([sq_norm(v[b]) for b in range(v.shape[0])])


def _active(active, b) -> bool:
    return active is None or bool(active[b])


def cg_update_ref(alpha, p, ap, x, r, active=None):
    """``x' = x + alpha*p``, ``r' = r - alpha*Ap`` and the residual
    epilogue ``rs = sum |r'|^2`` (real float32) over one array."""
    if isinstance(alpha, torch.Tensor) and alpha.ndim == 1:
        rows = [cg_update_ref(alpha[b], p[b], ap[b], x[b], r[b])
                if _active(active, b)
                else (x[b].clone(), r[b].clone(), sq_norm(r[b]))
                for b in range(alpha.shape[0])]
        return tuple(torch.stack(t) for t in zip(*rows))
    x2 = x + alpha * p
    r2 = r - alpha * ap
    return x2, r2, sq_norm(r2)


def xpby_ref(x, y, beta, active=None):
    """``w = x + beta*y``: the CG search-direction step."""
    if isinstance(beta, torch.Tensor) and beta.ndim == 1:
        return torch.stack([xpby_ref(x[b], y[b], beta[b])
                            if _active(active, b) else y[b].clone()
                            for b in range(beta.shape[0])])
    return x + beta * y


def xpby_dot_ref(x, y, beta):
    """``w = x + beta*y`` with the ``sum |w|^2`` epilogue."""
    w = xpby_ref(x, y, beta)
    return w, sq_norm(w)
