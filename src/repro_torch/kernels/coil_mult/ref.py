"""Plain PyTorch versions of the coil-sensitivity pointwise operators.

The CPU path of the wrappers in ``ops.py`` and the oracle their CUDA
kernels are held against on the card."""

import torch


def coil_forward_ref(coils, x):
    """z_j = c_j * x.  coils: (J, X, Y) complex, x: (X, Y) complex."""
    return coils * x[None]


def coil_adjoint_ref(coils, z, mask=None):
    """Sum_j conj(c_j) * z_j, optionally masked (M_Omega fused)."""
    out = torch.sum(torch.conj(coils) * z, dim=0)
    if mask is not None:
        out = out * mask
    return out


def coil_lincomb_ref(a, x, b=None, y=None, scale=None):
    """out_j = scale * (a * x_j + b * y_j); ``b=None`` drops the second
    term and ``scale=None`` the scale."""
    out = a[None] * x
    if b is not None:
        out = out + b[None] * y
    if scale is not None:
        out = scale[None] * out
    return out


def plane_mult_ref(z, m):
    """Broadcast real-plane multiply ``z_j * m``."""
    return z * m[None] if z.ndim == m.ndim + 1 else z * m
