"""Per-sample oracle for non-Cartesian (radial) gridding/degridding.

The counterpart of ``repro/kernels/gridding/ref.py``, for tests only:
direct bilinear interpolation on the periodic k-space grid.
``degrid_ref`` gathers the four corner cells around each trajectory
point and ``grid_ref`` (its exact adjoint) scatter-adds with the same
weights.  The kernels and their plain versions compute the same operator
another way (taps and a cell-major index, or dense separable matrices);
this module is the independent reference they are held against.
"""

from __future__ import annotations

import torch


def _corners(traj, grid: int, device):
    """Integer corners and fractional weights of each trajectory point on
    the periodic grid.  traj: (S, 2) (x, y) in grid units."""
    t = torch.as_tensor(traj, dtype=torch.float32, device=device)
    i0 = torch.floor(t).to(torch.int64)
    f = t - i0
    ix0, iy0 = i0[:, 0] % grid, i0[:, 1] % grid
    ix1, iy1 = (ix0 + 1) % grid, (iy0 + 1) % grid
    return ix0, ix1, iy0, iy1, f[:, 0], f[:, 1]


def degrid_ref(g, traj):
    """g: (J, X, Y) complex grid, traj: (S, 2) -> (J, S) complex samples."""
    ix0, ix1, iy0, iy1, fx, fy = _corners(traj, g.shape[-1], g.device)
    return ((1 - fx) * (1 - fy) * g[:, ix0, iy0]
            + fx * (1 - fy) * g[:, ix1, iy0]
            + (1 - fx) * fy * g[:, ix0, iy1]
            + fx * fy * g[:, ix1, iy1])


def grid_ref(y, traj, grid: int):
    """Adjoint of ``degrid_ref``: y (J, S) complex samples -> (J, X, Y)."""
    ix0, ix1, iy0, iy1, fx, fy = _corners(traj, grid, y.device)
    J = y.shape[0]
    out = torch.zeros((J, grid, grid), dtype=y.dtype, device=y.device)
    j = torch.arange(J, device=y.device)[:, None]
    for ix, iy, w in ((ix0, iy0, (1 - fx) * (1 - fy)),
                      (ix1, iy0, fx * (1 - fy)),
                      (ix0, iy1, (1 - fx) * fy),
                      (ix1, iy1, fx * fy)):
        out.index_put_((j, ix[None], iy[None]), w * y, accumulate=True)
    return out
