"""Centered, orthonormal 2-D FFT over the trailing two dims, plan-cached.

The counterpart of ``repro.lib.fft.plan_fft2``/``fft2`` for plain
tensors: ``plan_fft2`` builds a :class:`repro_torch.core.plan.Plan` keyed
on (shape, dtype, device, direction, centering) and ``fft2`` is the
plan-at-call-site form, so the first call of a geometry builds and every
later call is a cache hit.  The transform itself is ``torch.fft`` (cuFFT
on the card, which keeps its own plans), as the JAX package leaves it to
XLA.  The segmented ``fft2_batched`` comes with the multi-rank core.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device
from .plan import Plan, PlanCache, default_cache, device_token

_AXES = (-2, -1)


def _fft2_local(x: torch.Tensor, inverse: bool,
                centered: bool) -> torch.Tensor:
    if centered:
        x = torch.fft.ifftshift(x, dim=_AXES)
    x = (torch.fft.ifft2(x, dim=_AXES, norm="ortho") if inverse
         else torch.fft.fft2(x, dim=_AXES, norm="ortho"))
    if centered:
        x = torch.fft.fftshift(x, dim=_AXES)
    return x


def plan_fft2(shape, dtype, *, device=None, inverse: bool = False,
              centered: bool = False, cache: PlanCache | None = None) -> Plan:
    """Plan a (batched) 2-D FFT with ``norm="ortho"`` over the trailing
    two dims; ``centered`` puts the zero frequency in the middle of the
    grid on both sides of the transform.  ``device=None`` is the card."""
    cache = default_cache() if cache is None else cache
    dev = device_token(resolve_device(device))
    key = ("fft", "fft2", tuple(shape), str(dtype), dev, bool(inverse),
           bool(centered))

    def build():
        fn = functools.partial(_fft2_local, inverse=bool(inverse),
                               centered=bool(centered))
        return Plan(key=key, fn=fn, lib="fft", op="fft2",
                    meta={"shape": tuple(shape), "device": dev,
                          "inverse": inverse, "centered": centered})

    return cache.get_or_build(key, build)


def fft2(x: torch.Tensor, inverse: bool = False, centered: bool = False,
         cache: PlanCache | None = None) -> torch.Tensor:
    """Batched 2-D FFT of a tensor through the plan cache."""
    plan = plan_fft2(x.shape, x.dtype, device=x.device, inverse=inverse,
                     centered=centered, cache=cache)
    return plan(x)
