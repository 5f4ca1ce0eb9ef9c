"""The plain reference of the NLINV frame chain (Uecker 2008; the
paper's §3.1): plain torch, complex64, TF32 off, one frame at a time.

    F = P_k . DTFT . M_Omega . C . W^{-1}

The unknowns are u = {rho (X, Y), chat (J, X, Y)}: the image and the coil
coefficients in the weighted Fourier domain, c_j = IFFT(w . chat_j) with
the Sobolev weight w(k) = (1 + s |k|^2)^{-l/2}.  Each frame runs the
IRGNM (eq. 3),

    (DG^H DG + a_n I) dx = DG^H (y - G(x_n)) - a_n (x_n - x_ref),

a_n = a_0 q^n, each step solved by conjugate gradients from zero with the
stop rule ``i < iters and |r|^2 > tol^2 |r_0|^2``.  The displayed image is
rho times the root-sum-of-squares of the coils, and the next frame's
x_ref is the damped solution.

This module imports nothing of the program: the frozen mathematics is
written out here and computes everything from the acquisitions, the
initial carry and the settings.  ``rnd`` rounds every operator output and
every CG vector: the identity for the reference, ``bf16`` for the
control, the reference stored in the next precision below the
configuration's.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA0, Q, TOL = 1.0, 1.0 / 3.0, 1e-6


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 in each of its real and imaginary parts
    (the control's storage precision)."""
    if x.is_complex():
        r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
        return torch.view_as_complex(r.contiguous())
    return x.to(torch.bfloat16).to(x.dtype)


def sobolev_weight(grid: int, s: float = 32.0, l: int = 4) -> np.ndarray:
    """w(k) = (1 + s |k|^2)^{-l/2} on the centered grid."""
    k = np.fft.fftshift(np.fft.fftfreq(grid))
    ky, kx = np.meshgrid(k, k, indexing="ij")
    k2 = (kx ** 2 + ky ** 2) * 4.0
    return ((1.0 + s * k2) ** (-l / 2.0)).astype(np.float32)


def fft2c(x):
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fft2(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifft2c(x):
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.ifft2(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def _vdot(a, b):
    """sum conj(a) b over both leaves, real part, float32."""
    return sum(torch.real(torch.vdot(a[k].reshape(-1), b[k].reshape(-1)))
               for k in ("chat", "rho"))


def _axpy(a, x, y):
    return {k: a * x[k] + y[k] for k in x}


class Operators:
    """The forward model of one frame's geometry and its derivative."""

    def __init__(self, mask, fov, weight, rnd=fp32):
        self.mask, self.fov, self.weight, self.rnd = mask, fov, weight, rnd

    def coils(self, chat):
        return self.rnd(ifft2c(chat * self.weight))

    def G(self, u):
        c = self.coils(u["chat"])
        return self.rnd(fft2c(self.fov * (u["rho"] * c)) * self.mask)

    def DG(self, rho0, c0, du):
        dc = self.coils(du["chat"])
        img = self.fov * (du["rho"] * c0 + rho0 * dc)
        return self.rnd(fft2c(img) * self.mask)

    def DGH(self, rho0, c0, r):
        z = self.rnd(self.fov * ifft2c(r * self.mask))
        drho = self.rnd(torch.sum(torch.conj(c0) * z, dim=0))
        dchat = self.rnd(fft2c(z * torch.conj(rho0)) * self.weight)
        return {"rho": drho, "chat": dchat}


def cg(A, rhs, iters, rnd=fp32):
    """CG from x = 0 for the SPD system A x = rhs."""
    x = {k: torch.zeros_like(v) for k, v in rhs.items()}
    r = rhs
    p = r
    rs = _vdot(r, r)
    thresh = TOL * TOL * rs
    i = 0
    while i < iters and bool(rs > thresh):
        Ap = A(p)
        alpha = rs / torch.clamp(_vdot(p, Ap), min=1e-30)
        x = {k: rnd(v) for k, v in _axpy(alpha, p, x).items()}
        r = {k: rnd(v) for k, v in _axpy(-alpha, Ap, r).items()}
        rs_new = _vdot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = {k: rnd(v) for k, v in _axpy(beta, p, r).items()}
        rs, i = rs_new, i + 1
    return x


def solve_frame(y, mask, fov, weight, x0, x_ref, *, newton, cg_iters,
                rnd=fp32):
    """One frame's IRGNM: the acquisition ``y`` (J, X, Y) and the carry
    ``x0`` / ``x_ref`` -> the new u."""
    ops = Operators(mask, fov, weight, rnd)
    y = y * mask
    x = x0
    alpha = torch.tensor(ALPHA0, dtype=torch.float32, device=y.device)
    for _ in range(newton):
        rho0, c0 = x["rho"], ops.coils(x["chat"])
        r = y - ops.G(x)
        rhs = ops.DGH(rho0, c0, r)
        rhs = _axpy(alpha, _axpy(-1.0, x, x_ref), rhs)

        def A(du, rho0=rho0, c0=c0, alpha=alpha):
            out = ops.DGH(rho0, c0, ops.DG(rho0, c0, du))
            return {k: rnd(out[k] + alpha * du[k]) for k in out}

        dx = cg(A, rhs, cg_iters, rnd)
        x = {k: rnd(v) for k, v in _axpy(1.0, dx, x).items()}
        alpha = alpha * Q
    return x


def image(u, weight, rnd=fp32):
    """rho times the root-sum-of-squares of the coils."""
    c = rnd(ifft2c(u["chat"] * weight))
    return u["rho"] * torch.sqrt(torch.sum(torch.abs(c) ** 2, dim=0))


def initial_carry(ncoils: int, grid: int, device):
    """rho = 1, chat = 0 (the paper's initialisation)."""
    return {"rho": torch.ones((grid, grid), dtype=torch.complex64,
                              device=device),
            "chat": torch.zeros((ncoils, grid, grid), dtype=torch.complex64,
                                device=device)}


def frames(ys, masks, fov, u, x_ref, *, newton, cg_iters, damping,
           rnd=fp32):
    """The chain of frames from the carry ``u`` / ``x_ref``: yields each
    frame's image.  ``ys`` / ``masks`` are host arrays, moved to ``u``'s
    device one frame at a time; frame f+1 regularises towards ``damping``
    times frame f's solution."""
    dev = u["rho"].device
    grid = u["rho"].shape[-1]
    fov_d = torch.as_tensor(np.asarray(fov, np.float32), device=dev)
    w_d = torch.as_tensor(sobolev_weight(grid), device=dev)
    for y, m in zip(ys, masks):
        y_d = torch.as_tensor(np.asarray(y), device=dev)
        m_d = torch.as_tensor(np.asarray(m, np.float32), device=dev)
        u = solve_frame(y_d, m_d, fov_d, w_d, u, x_ref, newton=newton,
                        cg_iters=cg_iters, rnd=rnd)
        x_ref = {k: damping * v for k, v in u.items()}
        yield image(u, w_d, rnd)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole image, in float64."""
    g = got.to(torch.complex128)
    w = want.to(torch.complex128)
    return float(torch.linalg.vector_norm(g - w)
                 / torch.clamp(torch.linalg.vector_norm(w), min=1e-300))
