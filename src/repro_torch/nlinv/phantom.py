"""Synthetic MRI data: Shepp-Logan phantom, birdcage-style coil
sensitivities, radial sampling masks, and the k-space simulator.

Matches the paper's acquisition model: matrix size N (192..384 in the
paper), grid doubled to 2N for the non-periodic PSF convolution, J coil
channels (32 compressed to 8-12), radial spokes with golden-angle
interleaving across frames (real-time FLASH).
"""

from __future__ import annotations

import numpy as np

# (intensity, a, b, x0, y0, phi) — standard Shepp-Logan ellipses
_ELLIPSES = [
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
]


def shepp_logan(n: int, motion: float = 0.0) -> np.ndarray:
    """(n, n) complex64 phantom; ``motion`` perturbs ellipse positions
    (simulates the beating-heart frames of the paper's movies)."""
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = np.zeros((n, n), np.float32)
    for i, (a, ea, eb, x0, y0, phi) in enumerate(_ELLIPSES):
        dx = motion * 0.05 * np.sin(2 * np.pi * motion + i)
        th = np.deg2rad(phi)
        xr = (x - x0 - dx) * np.cos(th) + (y - y0) * np.sin(th)
        yr = -(x - x0 - dx) * np.sin(th) + (y - y0) * np.cos(th)
        img[(xr / ea) ** 2 + (yr / eb) ** 2 <= 1.0] += a
    return img.astype(np.complex64)


def birdcage_coils(n: int, ncoils: int) -> np.ndarray:
    """(J, n, n) complex64 smooth sensitivities on a ring (birdcage-like)."""
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    coils = []
    for j in range(ncoils):
        th = 2 * np.pi * j / ncoils
        cx, cy = 1.3 * np.cos(th), 1.3 * np.sin(th)
        r2 = (x - cx) ** 2 + (y - cy) ** 2
        mag = np.exp(-r2 / 1.8)
        pha = np.exp(1j * (th + 0.5 * (x * np.cos(th) + y * np.sin(th))))
        coils.append(mag * pha)
    c = np.stack(coils).astype(np.complex64)
    rss = np.sqrt((np.abs(c) ** 2).sum(0, keepdims=True))
    return (c / np.maximum(rss, 1e-6)).astype(np.complex64)


def radial_mask(grid: int, nspokes: int, frame: int = 0) -> np.ndarray:
    """(grid, grid) bool Cartesian mask of ``nspokes`` radial lines.

    Golden-angle rotation per frame gives the interleaved acquisition of
    the paper's real-time protocol (P_k after gridding: on-grid samples).
    """
    ga = np.pi * (3 - np.sqrt(5.0))
    mask = np.zeros((grid, grid), bool)
    c = grid // 2
    rr = np.arange(-c, c, 0.5)
    for s in range(nspokes):
        th = s * np.pi / nspokes + frame * ga
        xs = np.clip(np.round(c + rr * np.cos(th)).astype(int), 0, grid - 1)
        ys = np.clip(np.round(c + rr * np.sin(th)).astype(int), 0, grid - 1)
        mask[ys, xs] = True
    return mask


def fov_mask(grid: int) -> np.ndarray:
    """M_Omega: restrict to the centered FOV (grid is doubled -> half)."""
    m = np.zeros((grid, grid), np.float32)
    q = grid // 4
    m[q:3 * q, q:3 * q] = 1.0
    return m


def make_dataset(n: int = 96, ncoils: int = 8, nspokes: int = 11,
                 frames: int = 1, noise: float = 1e-4, seed: int = 0):
    """Full synthetic acquisition.  Returns dict with doubled-grid arrays:
    y (frames, J, 2n, 2n) sampled k-space, masks, ground truth."""
    rng = np.random.default_rng(seed)
    grid = 2 * n
    q = grid // 4
    coils_small = birdcage_coils(n, ncoils)
    out_y, out_masks, truths = [], [], []
    coils = np.zeros((ncoils, grid, grid), np.complex64)
    coils[:, q:3 * q, q:3 * q] = coils_small
    for f in range(frames):
        rho = np.zeros((grid, grid), np.complex64)
        rho[q:3 * q, q:3 * q] = shepp_logan(n, motion=float(f) / max(frames, 1))
        mask = radial_mask(grid, nspokes, frame=f)
        ksp = np.fft.fftshift(
            np.fft.fft2(np.fft.ifftshift(rho[None] * coils, axes=(-2, -1)),
                        axes=(-2, -1), norm="ortho"), axes=(-2, -1))
        ksp *= mask[None]
        ksp += noise * (rng.standard_normal(ksp.shape) +
                        1j * rng.standard_normal(ksp.shape)).astype(np.complex64)
        ksp *= mask[None]
        out_y.append(ksp.astype(np.complex64))
        out_masks.append(mask)
        truths.append(rho)
    return {
        "y": np.stack(out_y),                  # (F, J, grid, grid)
        "masks": np.stack(out_masks),          # (F, grid, grid)
        "coils": coils,                        # (J, grid, grid) truth
        "rho": np.stack(truths),               # (F, grid, grid) truth
        "fov": fov_mask(grid),
        "grid": grid, "n": n, "ncoils": ncoils,
    }
