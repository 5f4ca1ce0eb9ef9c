"""libgridding port: plan-cached non-Cartesian (radial) gridding on one
device (paper §4's third ported library).

The counterpart of ``repro.lib.gridding`` for plain tensors.  A gridding
*plan* captures one acquisition geometry: the radial trajectory, its
bilinear interpolation operator (built once, on the host) and the
Ram-Lak density compensation, on one device.  Execution is then
per-frame work only:

  ``plan.degrid(g)``   Cartesian k-space (J, X, Y) -> samples (J, Sp)
  ``plan.grid(y)``     samples -> Cartesian k-space (the exact adjoint)
  ``plan.adjoint_recon(y, fov)``
                       density-compensated adjoint reconstruction with
                       root-sum-of-squares channel combination: the
                       Fig. 10 baseline.

The plan keeps the operator as per-sample taps and a cell-major index
over the touched cells (``repro_torch.kernels.gridding.Interp``, about
1.7 MB at grid 768 with 16896 samples, of which 19887 cells are
touched), not as the JAX plan's dense (Sp, grid) matrices
(103.8 MB at that width), so the 256 plans of a cache of golden-angle
frames stay small on the card.

A coil-segmented ``SegmentedArray`` (NATURAL on dim 0) in gives a
``SegmentedArray`` out, with no communication: each rank grids its own
coils through ``Communicator.invoke_all``; ``adjoint_recon`` then takes
one channel-sum all-reduce.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..core.segmented import Policy, SegmentedArray
from ..device import resolve_device
from ..kernels.gridding import (Interp, degrid, grid_adjoint,  # noqa: F401
                                radial_trajectory)
from . import fft as lfft
from .plan import Plan, PlanCache, default_cache, device_token


def ramlak_dcf_radial(traj, grid: int) -> np.ndarray:
    """Ram-Lak density compensation |k| per trajectory sample (the radial
    sampling density is 1/|k|; symmetric under k -> -k)."""
    t = np.asarray(traj, np.float64)
    c = grid // 2
    r = np.sqrt(((t - c) ** 2).sum(1))
    return (r / max(r.max(), 1e-9)).astype(np.float32) + 1e-3


@dataclasses.dataclass(frozen=True, eq=False)
class GriddingPlan:
    """One built gridding geometry (the plan's executable payload)."""

    traj: np.ndarray          # (S, 2) trajectory
    grid_size: int
    interp: Interp            # taps + cell index on the plan's device
    dcf: torch.Tensor         # (Sp,) Ram-Lak weights (zero-padded)
    nsamp: int                # true (pre-padding) sample count S

    @property
    def nsamp_padded(self) -> int:
        return self.interp.nsamp_padded

    @property
    def device(self) -> torch.device:
        return self.interp.device

    def device_bytes(self) -> int:
        """Bytes the plan keeps on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (*self.interp.tensors(), self.dcf))

    def _apply(self, x, fn):
        if isinstance(x, SegmentedArray):
            if x.policy is not Policy.NATURAL or x.dim != 0:
                raise ValueError(
                    "gridding expects the coil dim NATURAL-segmented "
                    f"(dim 0), got {x.policy}/dim={x.dim}")
            return x.comm.invoke_all(fn, x)
        return fn(x)

    def degrid(self, g, impl: str = "auto"):
        """Cartesian k-space (J, X, Y) -> trajectory samples (J, Sp).
        Coil-local: a container in is a container out."""
        return self._apply(g, lambda gl: degrid(gl, self.interp, impl=impl))

    def grid(self, y, impl: str = "auto", density_comp: bool = False):
        """Adjoint: samples (J, Sp) -> Cartesian k-space (J, X, Y).
        ``density_comp`` pre-weights with the Ram-Lak DCF (the adjoint
        reconstruction path).  Coil-local, as ``degrid``."""
        def fn(yl):
            if density_comp:
                yl = yl * self.dcf[None]
            return grid_adjoint(yl, self.interp, impl=impl)
        return self._apply(y, fn)

    def adjoint_recon(self, y, fov, impl: str = "auto"):
        """Density-compensated adjoint recon with RSS channel combine
        (paper Fig. 10 baseline): IFFT(grid(dcf * y)), sqrt(sum_j |.|^2).
        ``y`` is (J, Sp) samples, a tensor or a coil-segmented container
        (then one channel-sum all-reduce); returns the (X, Y) magnitude
        image."""
        k = self.grid(y, impl=impl, density_comp=True)
        if isinstance(k, SegmentedArray):
            imgs = lfft.fft2_batched(k, inverse=True, centered=True)
            tot = imgs.with_data(torch.abs(imgs.data) ** 2) \
                .allreduce_window().data
        else:
            imgs = lfft.fft2(k, inverse=True, centered=True)
            tot = torch.sum(torch.abs(imgs) ** 2, dim=0)
        fov = torch.as_tensor(fov, device=tot.device)
        return fov * torch.sqrt(tot)


def plan_gridding(traj, grid: int, *, device=None,
                  cache: PlanCache | None = None) -> GriddingPlan:
    """Build (or fetch) the gridding plan for a trajectory on a device.

    Keyed on the trajectory's digest, its sample count, the grid size and
    the device (``device=None`` is the card); the interpolation operator
    and DCF are computed exactly once per geometry.  Returns the
    executable :class:`GriddingPlan` (the cache stores it wrapped in a
    :class:`repro_torch.core.plan.Plan`).
    """
    cache = default_cache() if cache is None else cache
    dev = resolve_device(device)
    t = np.ascontiguousarray(np.asarray(traj, np.float32))
    digest = hashlib.sha1(t.tobytes()).hexdigest()[:16]
    grid = int(grid)
    key = ("gridding", "plan", digest, t.shape[0], grid, device_token(dev))

    def build():
        interp = Interp.build(t, grid, device=dev)
        dcf = np.zeros(interp.nsamp_padded, np.float32)
        dcf[: t.shape[0]] = ramlak_dcf_radial(t, grid)
        ops = GriddingPlan(traj=t, grid_size=grid, interp=interp,
                           dcf=torch.from_numpy(dcf).to(dev),
                           nsamp=t.shape[0])
        return Plan(key=key, fn=ops, lib="gridding", op="plan",
                    meta={"nsamp": t.shape[0],
                          "nsamp_padded": interp.nsamp_padded, "grid": grid,
                          "device_bytes": ops.device_bytes()})

    return cache.get_or_build(key, build).fn
