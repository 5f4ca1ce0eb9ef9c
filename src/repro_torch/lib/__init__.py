"""Library layer of the port: plans (``plan``, re-exported from
``repro_torch.core``), the plan-cached centered 2-D FFT on ``torch.fft``
(cuFFT on the card), plan-cached radial gridding (``gridding``) and the
plan-cached segmented level-1 BLAS (``blas``) with the plain pytree forms
the NLINV solver uses."""

from . import blas, fft, gridding, plan
from .plan import Plan, PlanCache, default_cache, plan_stats

__all__ = ["blas", "fft", "gridding", "plan",
           "Plan", "PlanCache", "default_cache", "plan_stats"]
