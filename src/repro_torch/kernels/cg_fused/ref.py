"""Plain PyTorch versions of the fused CG vector updates.

The CPU path of the wrappers in ``ops.py`` and the oracle their CUDA
kernels are held against on the card."""

import torch


def sq_norm(v):
    """sum |v|^2 as a real float32 scalar (``jnp.real(jnp.vdot(v, v))``):
    the plain form of the kernels' dot epilogues, and the solver's
    residual and curvature norms."""
    flat = v.reshape(-1)
    return torch.real(torch.vdot(flat, flat)).to(torch.float32)


def cg_update_ref(alpha, p, ap, x, r):
    """``x' = x + alpha*p``, ``r' = r - alpha*Ap`` and the residual
    epilogue ``rs = sum |r'|^2`` (real float32) over one array."""
    x2 = x + alpha * p
    r2 = r - alpha * ap
    return x2, r2, sq_norm(r2)


def xpby_ref(x, y, beta):
    """``w = x + beta*y``: the CG search-direction step."""
    return x + beta * y


def xpby_dot_ref(x, y, beta):
    """``w = x + beta*y`` with the ``sum |w|^2`` epilogue."""
    w = xpby_ref(x, y, beta)
    return w, sq_norm(w)
