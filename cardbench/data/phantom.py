"""The benchmark's traffic source: synthetic radial MRI acquisitions.

A frozen copy of the port's ``nlinv/phantom.py`` mathematics (Shepp-Logan
phantom, birdcage coil sensitivities, golden-angle radial masks on the
doubled grid, the centered orthonormal k-space simulator), written in
torch so that a whole cycle of frames is made on the card in a few large
calls.  The program may change its own generator; this one stays as it
is, so that every commit is measured on the same acquisitions.

A cycle's ``seed`` sets the noise, the phantom's motion phase and the
first spoke rotation; ``start`` rotates the cycle, so that the scanner's
movie begins at another acquisition of the same set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (intensity, a, b, x0, y0, phi): the standard Shepp-Logan ellipses
ELLIPSES = (
    (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
    (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
    (-0.2, 0.11, 0.31, 0.22, 0.0, -18.0),
    (-0.2, 0.16, 0.41, -0.22, 0.0, 18.0),
    (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
    (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
    (0.1, 0.046, 0.046, 0.0, -0.1, 0.0),
    (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
    (0.1, 0.023, 0.023, 0.0, -0.606, 0.0),
    (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
)
GOLDEN = math.pi * (3 - math.sqrt(5.0))


def _grid(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``np.mgrid[-1:1:n*1j, -1:1:n*1j]`` as float32 (y, x)."""
    t = torch.linspace(-1.0, 1.0, n, device=device, dtype=torch.float32)
    return torch.meshgrid(t, t, indexing="ij")


def shepp_logan(n: int, motion: torch.Tensor, device) -> torch.Tensor:
    """(F, n, n) complex64 phantoms, one for each entry of ``motion``
    (F,): each ellipse is shifted by ``0.05 m sin(2 pi m + i)``."""
    y, x = _grid(n, device)
    m = motion.to(device=device, dtype=torch.float32)[:, None, None]
    img = torch.zeros((m.shape[0], n, n), dtype=torch.float32, device=device)
    for i, (a, ea, eb, x0, y0, phi) in enumerate(ELLIPSES):
        dx = m * 0.05 * torch.sin(2 * math.pi * m + i)
        th = math.radians(phi)
        xs = x - x0 - dx
        xr = xs * math.cos(th) + (y - y0) * math.sin(th)
        yr = -xs * math.sin(th) + (y - y0) * math.cos(th)
        img += a * ((xr / ea) ** 2 + (yr / eb) ** 2 <= 1.0)
    return img.to(torch.complex64)


def birdcage_coils(n: int, ncoils: int, device) -> torch.Tensor:
    """(J, n, n) complex64 smooth sensitivities on a ring, normalised to
    a root-sum-of-squares of one."""
    y, x = _grid(n, device)
    th = 2 * math.pi * torch.arange(ncoils, device=device,
                                    dtype=torch.float32)[:, None, None] \
        / ncoils
    cx, cy = 1.3 * torch.cos(th), 1.3 * torch.sin(th)
    mag = torch.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 1.8)
    pha = th + 0.5 * (x * torch.cos(th) + y * torch.sin(th))
    c = torch.polar(mag, pha)
    rss = torch.sqrt((c.abs() ** 2).sum(0, keepdim=True))
    return c / torch.clamp(rss, min=1e-6)


def radial_masks(grid: int, nspokes: int, frames: np.ndarray) -> np.ndarray:
    """(F, grid, grid) float32 Cartesian masks of ``nspokes`` radial
    lines, frame ``f`` rotated by ``f`` golden angles."""
    c = grid // 2
    rr = np.arange(-c, c, 0.5)
    out = np.zeros((len(frames), grid, grid), np.float32)
    for i, f in enumerate(frames):
        for s in range(nspokes):
            th = s * np.pi / nspokes + float(f) * GOLDEN
            xs = np.clip(np.round(c + rr * np.cos(th)).astype(int), 0,
                         grid - 1)
            ys = np.clip(np.round(c + rr * np.sin(th)).astype(int), 0,
                         grid - 1)
            out[i, ys, xs] = 1.0
    return out


def fov_mask(grid: int) -> np.ndarray:
    """M_Omega: the centered half of the doubled grid."""
    m = np.zeros((grid, grid), np.float32)
    q = grid // 4
    m[q:3 * q, q:3 * q] = 1.0
    return m


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D FFT over the trailing two dims."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fft2(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def make_cycle(n: int, ncoils: int, nspokes: int, frames: int,
               noise: float, seed: int, device, start: int = 0) -> dict:
    """One scanner's cycle of ``frames`` acquisitions on the doubled grid
    (2n): ``y`` (F, J, 2n, 2n) complex64 and ``masks`` (F, 2n, 2n)
    float32 as numpy (the program takes host arrays, as a scanner hands
    them over), ``fov`` (2n, 2n) float32.  The k-space and its noise are
    made on ``device``, one frame stack at a time.  Frame ``f`` of the
    result is acquisition ``(start + f) % frames`` of the seed's cycle."""
    seed = int(seed) % (1 << 63)
    rng = np.random.default_rng(seed)
    phase = float(rng.random())
    first = int(rng.integers(0, 1 << 16))
    grid, q = 2 * n, n // 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    coils = torch.zeros((ncoils, grid, grid), dtype=torch.complex64,
                        device=device)
    coils[:, q:q + n, q:q + n] = birdcage_coils(n, ncoils, device)
    motion = torch.tensor([(phase + f / frames) % 1.0 for f in range(frames)])
    small = shepp_logan(n, motion, device)
    masks = radial_masks(grid, nspokes, np.arange(first, first + frames))
    start = int(start) % frames
    y = np.empty((frames, ncoils, grid, grid), np.complex64)
    for f in range(frames):
        rho = torch.zeros((grid, grid), dtype=torch.complex64, device=device)
        rho[q:q + n, q:q + n] = small[f]
        m = torch.from_numpy(masks[f]).to(device)
        ksp = fft2c(rho[None] * coils) * m
        w = torch.randn((2, ncoils, grid, grid), generator=gen,
                        device=device, dtype=torch.float32)
        ksp = (ksp + noise * torch.complex(w[0], w[1])) * m
        y[(f - start) % frames] = ksp.cpu().numpy()
    return {"y": y, "masks": np.roll(masks, -start, axis=0),
            "fov": fov_mask(grid), "grid": grid}
