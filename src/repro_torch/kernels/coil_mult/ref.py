"""Plain PyTorch versions of the coil-sensitivity pointwise operators.

The CPU path of the wrappers in ``ops.py`` and the oracle their CUDA
kernels are held against on the card.  A batch of B rows, (B, J, X, Y)
stacks with (B, X, Y) or shared (X, Y) planes, runs row by row through
the unbatched form, so that each row's bits are the unbatched call's."""

import torch


def _row(plane, b):
    """Row ``b``'s plane: its own of a (B, X, Y) plane, else the shared
    one (or None)."""
    return plane[b] if plane is not None and plane.ndim == 3 else plane


def _rows(fn, stack, *planes):
    """``fn(stack[b], *planes of row b)`` for every row, stacked."""
    return torch.stack([fn(stack[b], *(_row(p, b) for p in planes))
                        for b in range(stack.shape[0])])


def coil_forward_ref(coils, x):
    """z_j = c_j * x.  coils: (J, X, Y) complex, x: (X, Y) complex."""
    if coils.ndim == 4:
        return _rows(coil_forward_ref, coils, x)
    return coils * x[None]


def coil_adjoint_ref(coils, z, mask=None):
    """Sum_j conj(c_j) * z_j, optionally masked (M_Omega fused)."""
    if coils.ndim == 4:
        return torch.stack([coil_adjoint_ref(coils[b], z[b], _row(mask, b))
                            for b in range(coils.shape[0])])
    out = torch.sum(torch.conj(coils) * z, dim=0)
    if mask is not None:
        out = out * mask
    return out


def coil_lincomb_ref(a, x, b=None, y=None, scale=None):
    """out_j = scale * (a * x_j + b * y_j); ``b=None`` drops the second
    term and ``scale=None`` the scale."""
    if x.ndim == 4:
        return torch.stack([
            coil_lincomb_ref(_row(a, i), x[i], _row(b, i),
                             None if y is None else y[i], _row(scale, i))
            for i in range(x.shape[0])])
    out = a[None] * x
    if b is not None:
        out = out + b[None] * y
    if scale is not None:
        out = scale[None] * out
    return out


def plane_mult_ref(z, m):
    """Broadcast real-plane multiply ``z_j * m``; a (B, X, Y) plane
    multiplies row b of ``z`` (B, ..., X, Y) by m[b]."""
    if m.ndim == 3:
        return _rows(plane_mult_ref, z, m)
    return z * m[None] if z.ndim == m.ndim + 1 else z * m
