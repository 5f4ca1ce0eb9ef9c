"""NLINV operators (paper §3.1, eq. 2-3), on PyTorch tensors.

    F = P_k . DTFT . M_Omega . C . W^{-1}

Unknowns u = {rho (X, Y), chat (J, X, Y)}, a plain dict of complex64
tensors: the image and the coil coefficients in the weighted Fourier
domain, with c_j = W(chat_j) = IFFT(w . chat_j) and the Sobolev weight
w(k) = (1 + s|k|^2)^{-l/2}.

Two forms of each operator, as in ``repro.nlinv.operators``: the unfused
methods (``G``/``DG``/``DGH``/``normal``), which re-derive the Newton
point in every application and hand DGᴴ's channel sum to the caller,
and the fused hot path (``precompute``/``G_fused``/``DG_fused``/
``DGH_fused``/``normal_pap``).  The pointwise chains of both run through
the ``coil_mult`` kernels, but for the unfused DGᴴ's ``conj(c0) z``,
whose channel sum is the caller's hook.  ``NlinvOps.impl`` is handed to
every kernel wrapper: ``"auto"`` launches the CUDA kernels for tensors
on the card, ``"plain"`` forces the plain versions (the same operations
as the JAX package's ``jnp`` forms).

Both forms also run B frames at once, one a client of the serving layer
(the JAX package vmaps its frame): a (B, X, Y) ``mask``, state
{rho (B, X, Y), chat (B, J, X, Y)}, and ``fov``/``weight`` shared by the
rows.  Every kernel takes the batch as it is, the unfused channel sum
reduces the coil dim (dim 1 of a batch), and the norms of
``normal_pap`` are taken row by row, so ``pap`` is (B,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.cg_fused import row_sq_norm, sq_norm
from ..kernels.coil_mult import (coil_adjoint, coil_forward, coil_lincomb,
                                 plane_mult)
from ..lib.blas import tree_axpy, tree_vdot
from ..lib.fft import fft2 as _cfft2


def sobolev_weight(grid: int, s: float = 32.0, l: int = 4) -> np.ndarray:
    """w(k) = (1 + s |k|^2)^{-l/2} on the centered grid (Uecker 2008)."""
    k = np.fft.fftshift(np.fft.fftfreq(grid))  # centered, cycles/sample
    ky, kx = np.meshgrid(k, k, indexing="ij")
    k2 = (kx ** 2 + ky ** 2) * 4.0             # normalize to ~[-1,1]^2
    return ((1.0 + s * k2) ** (-l / 2.0)).astype(np.float32)


def fft2c(x):
    return _cfft2(x, inverse=False, centered=True)


def ifft2c(x):
    return _cfft2(x, inverse=True, centered=True)


@dataclasses.dataclass(frozen=True)
class NlinvOps:
    """Closure over the acquisition geometry of one frame, or of a batch
    of B frames (``mask`` (B, X, Y)) on the fused path."""
    mask: torch.Tensor     # (X, Y) or (B, X, Y) P_k sampling mask (0/1)
    fov: torch.Tensor      # (X, Y) M_Omega
    weight: torch.Tensor   # (X, Y) Sobolev w
    impl: str = "auto"     # kernel dispatch of the fused path

    @property
    def batched(self) -> bool:
        """B frames at once: the state has a leading client dim."""
        return self.mask.ndim == 3

    def sq_norm(self, v):
        """sum |v|^2: a float32 scalar, or (B,) row by row for a batch,
        each row's bits those of the unbatched norm."""
        return row_sq_norm(v) if self.batched else sq_norm(v)

    # -- variable transform ------------------------------------------------
    def coils(self, chat):
        """c_j = W(c_hat_j): weighted k-space -> smooth image coils."""
        return ifft2c(chat * self.weight)

    def coils_adj(self, c):
        """W^H."""
        return fft2c(c) * self.weight

    # -- forward model -----------------------------------------------------
    def G(self, u):
        """u = {rho (X,Y), chat (J,X,Y)} -> sampled k-space (J,X,Y)."""
        return self.G_fused(u)

    def DG(self, u0, du):
        """Directional derivative at u0."""
        pre = {"rho0": u0["rho"], "c0": self.coils(u0["chat"])}
        return self.DG_fused(pre, du)

    def DGH(self, u0, r, *, channel_sum=None):
        """Adjoint of DG applied to residual r (J,X,Y); ``channel_sum``
        overrides the Sum_j reduction of ``conj(c0) z`` (J,X,Y), or
        (B,J,X,Y) over a batch."""
        c0 = self.coils(u0["chat"])
        z = plane_mult(ifft2c(plane_mult(r, self.mask, impl=self.impl)),
                       self.fov, impl=self.impl)
        prod = torch.conj(c0) * z
        drho = torch.sum(prod, dim=-3) if channel_sum is None \
            else channel_sum(prod)
        dchat = plane_mult(
            fft2c(coil_forward(z, torch.conj_physical(u0["rho"]),
                               impl=self.impl)),
            self.weight, impl=self.impl)
        return {"rho": drho, "chat": dchat}

    def normal(self, u0, du, alpha, *, channel_sum=None):
        """(DG^H DG + alpha I) du — the CG system matrix (eq. 3 LHS)."""
        out = self.DGH(u0, self.DG(u0, du), channel_sum=channel_sum)
        return {"rho": out["rho"] + alpha * du["rho"],
                "chat": out["chat"] + alpha * du["chat"]}

    # -- fused hot path ----------------------------------------------------
    # Same math as G/DG/DGH, with the Newton-point constants hoisted out of
    # the CG loop and the pointwise chains in the coil_mult kernels.  The
    # forward/derivative outputs are supported on ``mask`` (0/1), so DG^H
    # in the normal operator skips the re-mask; A(0) = 0 exactly, so CG
    # starts from r0 = rhs.

    def precompute(self, u0):
        """Per-Newton-point constants.  ``rho0c`` is conjugated in memory
        (``conj_physical``): the kernels read raw bytes, not PyTorch's
        lazy conjugate view."""
        return {"rho0": u0["rho"], "rho0c": torch.conj_physical(u0["rho"]),
                "c0": self.coils(u0["chat"])}

    def G_fused(self, u, c0=None):
        """Forward model through the fused pointwise chain."""
        c = self.coils(u["chat"]) if c0 is None else c0
        img = coil_lincomb(u["rho"], c, scale=self.fov, impl=self.impl)
        return plane_mult(fft2c(img), self.mask, impl=self.impl)

    def DG_fused(self, pre, du):
        """Derivative at the precomputed Newton point ``pre``."""
        dc = self.coils(du["chat"])
        img = coil_lincomb(du["rho"], pre["c0"], pre["rho0"], dc,
                           scale=self.fov, impl=self.impl)
        return plane_mult(fft2c(img), self.mask, impl=self.impl)

    def DGH_fused(self, pre, r, *, reducer, extras=(), premasked=True):
        """Adjoint of DG with the fused reduction schedule.
        ``reducer(prod, extras, compute) -> (drho, extras_out, dchat)``;
        returns ``({rho, chat}, extras_out)``."""
        rin = r if premasked else plane_mult(r, self.mask, impl=self.impl)
        z = plane_mult(ifft2c(rin), self.fov, impl=self.impl)
        prod = coil_adjoint(pre["c0"], z, impl=self.impl)

        def dchat():
            return plane_mult(
                fft2c(coil_forward(z, pre["rho0c"], impl=self.impl)),
                self.weight, impl=self.impl)

        drho, extras_out, dchat_out = reducer(prod, tuple(extras), dchat)
        return {"rho": drho, "chat": dchat_out}, extras_out

    def normal_pap(self, pre, du, alpha, *, reducer):
        """``(A du, <du, A du>)`` with the curvature scalar from
        self-adjointness: ||DG du||^2 + alpha ||du||^2."""
        dgp = self.DG_fused(pre, du)
        nat = self.sq_norm(dgp) + alpha * self.sq_norm(du["chat"])
        clone = alpha * self.sq_norm(du["rho"])
        out, (nat_red,) = self.DGH_fused(pre, dgp, reducer=reducer,
                                         extras=(nat,))
        pap = nat_red + clone
        ap = {"rho": out["rho"] + alpha * du["rho"],
              "chat": out["chat"] + alpha * du["chat"]}
        return ap, pap


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_ops(mask, fov, weight, *, device=None, impl="auto") -> NlinvOps:
    """NlinvOps over float32 planes.  Tensors stay on their device unless
    ``device`` is given; numpy planes go to ``device`` (the card when it
    is None).  A (B, X, Y) ``mask`` makes the batched operators of B
    frames, ``fov`` and ``weight`` shared."""
    if device is None and not isinstance(mask, torch.Tensor):
        device = resolve_device(None)
    elif device is None:
        device = mask.device
    return NlinvOps(_f32(mask, device), _f32(fov, device),
                    _f32(weight, device), impl=impl)


# -- pytree algebra for (rho, chat) ----------------------------------------

def uzeros(J, grid, *, device=None, dtype=torch.complex64):
    dev = resolve_device(device)
    return {"rho": torch.zeros((grid, grid), dtype=dtype, device=dev),
            "chat": torch.zeros((J, grid, grid), dtype=dtype, device=dev)}


def uinit(J, grid, *, device=None, dtype=torch.complex64):
    """Paper/Uecker init: rho = 1, chat = 0."""
    dev = resolve_device(device)
    return {"rho": torch.ones((grid, grid), dtype=dtype, device=dev),
            "chat": torch.zeros((J, grid, grid), dtype=dtype, device=dev)}


def uaxpy(a, x, y):
    """a*x + y over the state dict (``repro_torch.lib.blas.tree_axpy``)."""
    return tree_axpy(a, x, y)


def udot(x, y):
    """<x, y> with conjugation, summed over both components (complex)."""
    return tree_vdot(x, y)


def local_reducer(prod, extras, compute):
    """The one-device form of the fused DG^H reduction hook: no
    collective, the overlapped branch just runs."""
    return prod, tuple(extras), compute() if compute is not None else None
