"""Gridding baseline (paper Fig. 10 comparison), Cartesian-mask form.

``gridding_recon`` reconstructs from on-grid masked k-space: IFFT of the
density-compensated samples and root-sum-of-squares channel combination.
It is the quality baseline NLINV must beat.  The true radial trajectory
(``RadialOps``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lib.fft import fft2


def ramlak_dcf(grid: int) -> np.ndarray:
    """Ram-Lak style radial density compensation |k| on the Cartesian
    grid (symmetric under k -> -k)."""
    k = np.fft.fftshift(np.fft.fftfreq(grid))
    ky, kx = np.meshgrid(k, k, indexing="ij")
    r = np.sqrt(kx ** 2 + ky ** 2)
    return (r / max(r.max(), 1e-9)).astype(np.float32) + 1e-3


def gridding_recon(y, mask, fov):
    """y: (J, X, Y) masked Cartesian k-space -> (X, Y) magnitude image."""
    dcf = torch.as_tensor(ramlak_dcf(y.shape[-1]), device=y.device)
    imgs = fft2(y * (mask * dcf)[None], inverse=True, centered=True)
    rss = torch.sqrt(torch.sum(torch.abs(imgs) ** 2, dim=0))
    return fov * rss
