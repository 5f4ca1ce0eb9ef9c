"""Centered, orthonormal 2-D FFT over the trailing two dims.

The counterpart of ``repro.lib.fft.fft2`` for plain tensors: the JAX
package leaves the transform to XLA, and the port leaves it to
``torch.fft`` (cuFFT on the card).  Plan caching (``plan_fft2``/
``PlanCache``) is not ported yet; cuFFT keeps its own plan cache.
"""

from __future__ import annotations

import torch

_AXES = (-2, -1)


def fft2(x: torch.Tensor, inverse: bool = False,
         centered: bool = False) -> torch.Tensor:
    """Batched 2-D FFT with ``norm="ortho"``; ``centered`` puts the zero
    frequency in the middle of the grid on both sides of the transform."""
    if centered:
        x = torch.fft.ifftshift(x, dim=_AXES)
    x = (torch.fft.ifft2(x, dim=_AXES, norm="ortho") if inverse
         else torch.fft.fft2(x, dim=_AXES, norm="ortho"))
    if centered:
        x = torch.fft.fftshift(x, dim=_AXES)
    return x
