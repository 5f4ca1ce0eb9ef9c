"""Gridding baseline and the radial forward/adjoint operator pair (paper
Fig. 10 comparison; the §3 radial-trajectory workload).

Two acquisition models share this module:

* **Cartesian-mask approximation**: ``gridding_recon`` reconstructs from
  on-grid masked k-space: IFFT of the density-compensated samples and
  root-sum-of-squares channel combination.  It is the quality baseline
  NLINV must beat.
* **True radial trajectory** (through ``repro_torch.lib.gridding``):
  ``radial_ops`` builds the plan-cached operator pair, ``forward`` (coil
  images -> off-grid samples: centered FFT then degrid) and ``adjoint``
  (samples -> coil images: grid then inverse FFT), on the card unless
  ``device="cpu"`` is asked for.  ``gridding_recon_radial`` is the
  matching DCF-adjoint-RSS baseline image.  ``impl="plain"`` runs the
  gridding kernels' plain versions, for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lib.fft import fft2
from ..lib.gridding import GriddingPlan, plan_gridding, radial_trajectory


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


# ---------------------------------------------------------------------------
# true radial trajectory (the lib.gridding port)
# ---------------------------------------------------------------------------

class RadialOps:
    """Forward/adjoint pair for one radial geometry.

    ``forward``: coil images (J, X, Y) -> trajectory samples (J, Sp)
    (centered FFT then degridding); ``adjoint`` is its exact adjoint
    (gridding then inverse FFT)."""

    def __init__(self, plan: GriddingPlan, impl: str = "auto"):
        self.plan = plan
        self.impl = impl

    def forward(self, coil_imgs):
        """(J, X, Y) coil images -> (J, Sp) radial k-space samples."""
        return self.plan.degrid(fft2(coil_imgs, inverse=False, centered=True),
                                impl=self.impl)

    def adjoint(self, samples, density_comp: bool = False):
        """(J, Sp) samples -> (J, X, Y) coil images (exact adjoint of
        ``forward``; DCF optional, the adjoint stays exact without it)."""
        return fft2(self.plan.grid(samples, impl=self.impl,
                                   density_comp=density_comp),
                    inverse=True, centered=True)

    def recon(self, samples, fov):
        """DCF-adjoint-RSS baseline image (Fig. 10)."""
        return self.plan.adjoint_recon(samples, fov, impl=self.impl)


def radial_ops(grid: int, nspokes: int, frame: int = 0, *,
               nsamp: int | None = None, device=None,
               impl: str = "auto") -> RadialOps:
    """Plan-cached radial operator pair for one acquisition geometry.

    The trajectory, interpolation operator and DCF are built once per
    (geometry, device) and cached; calling this again for the same frame
    geometry is a plan-cache hit."""
    traj = radial_trajectory(grid, nspokes, frame=frame, nsamp=nsamp)
    return RadialOps(plan_gridding(traj, grid, device=device), impl=impl)


def gridding_recon_radial(samples, grid: int, nspokes: int, fov, *,
                          frame: int = 0, nsamp: int | None = None,
                          device=None, impl: str = "auto"):
    """Radial baseline reconstruction: samples (J, Sp) -> (X, Y)
    magnitude image."""
    return radial_ops(grid, nspokes, frame=frame, nsamp=nsamp,
                      device=device, impl=impl).recon(samples, fov)
