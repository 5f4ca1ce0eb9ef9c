"""Centered, orthonormal 2-D FFT over the trailing two dims, plan-cached.

The counterpart of ``repro.lib.fft.plan_fft2``/``fft2`` for plain
tensors: ``plan_fft2`` builds a :class:`repro_torch.core.plan.Plan` keyed
on (shape, dtype, device, direction, centering) and ``fft2`` is the
plan-at-call-site form, so the first call of a geometry builds and every
later call is a cache hit.  The transform itself is ``torch.fft`` (cuFFT
on the card, which keeps its own plans), as the JAX package leaves it to
XLA.

``plan_fft2_batched``/``fft2_batched`` take a segmented container (paper
§2.4): with the segmented dim outside the transform plane each rank
transforms its own segment, with no communication; with it inside the
plane the transform is distributed by the transpose algorithm, a local
FFT of the complete axis, an all-to-all, a local FFT of the other axis
and an all-to-all back, in up to ``FFT_TRANSPOSE_CHUNKS`` chunks along a
batch dim (``fused_transpose``), or through the container verbs where
the complete axis does not tile over the ranks (``verbs``).
"""

from __future__ import annotations

import functools

import torch

from ..core.comm import all_to_all_tiled
from ..core.segmented import Policy, SegmentedArray
from ..device import resolve_device
from .plan import Plan, PlanCache, default_cache, device_token, seg_token

_AXES = (-2, -1)

FFT_TRANSPOSE_CHUNKS = 4
"""The chunks of the distributed transpose along a batch dim: chunk
``i + 1``'s local FFT can run while chunk ``i`` is on the wire."""


def _fft1_local(x: torch.Tensor, axis: int, inverse: bool,
                centered: bool) -> torch.Tensor:
    if centered:
        x = torch.fft.ifftshift(x, dim=axis)
    x = (torch.fft.ifft(x, dim=axis, norm="ortho") if inverse
         else torch.fft.fft(x, dim=axis, norm="ortho"))
    if centered:
        x = torch.fft.fftshift(x, dim=axis)
    return x


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


# ---------------------------------------------------------------------------
# segmented containers
# ---------------------------------------------------------------------------

def _dim_in_plane(seg: SegmentedArray) -> bool:
    """Is the segmented dim one of the two transform axes?"""
    nd = seg.data.ndim
    return seg.policy is not Policy.CLONE and seg.dim in (nd - 2, nd - 1)


def _fused_transpose(seg, inverse, centered, seg_ax, other_ax):
    nd = seg.data.ndim
    batch_ax = next((i for i in range(nd) if i not in (seg_ax, other_ax)
                     and seg.data.shape[i] > 1), None)
    chunks = 1 if batch_ax is None else next(
        c for c in (FFT_TRANSPOSE_CHUNKS, 2, 1)
        if seg.data.shape[batch_ax] % c == 0)
    group = seg.group

    def chain(c):
        c = _fft1_local(c, other_ax, inverse, centered)
        c = all_to_all_tiled(c, other_ax, seg_ax, group)
        c = _fft1_local(c, seg_ax, inverse, centered)
        return all_to_all_tiled(c, seg_ax, other_ax, group)

    def fn(s):
        parts = [s.data] if chunks == 1 else \
            list(s.data.tensor_split(chunks, batch_ax))
        return s.with_data(torch.cat([chain(p) for p in parts],
                                     dim=batch_ax) if chunks > 1
                           else chain(parts[0]))

    return fn, chunks


def _verbs_transpose(inverse, centered, seg_ax, other_ax):
    """The transpose through the container verbs, for a complete axis
    that does not tile over the ranks (``alltoall`` pads it)."""

    def fn(s):
        src_policy, src_halo = s.policy, s.halo
        work = s
        if src_policy is Policy.OVERLAP2D:
            work = s.comm.copy(s, policy=Policy.NATURAL)
        work = work.invoke(lambda xl: _fft1_local(xl, other_ax, inverse,
                                                  centered))
        work = work.alltoall(other_ax)
        work = work.invoke(lambda xl: _fft1_local(xl, seg_ax, inverse,
                                                  centered))
        work = work.alltoall(seg_ax)
        if src_policy is Policy.OVERLAP2D:
            work = work.comm.copy(work, policy=Policy.OVERLAP2D,
                                  halo=src_halo)
        return work

    return fn


def plan_fft2_batched(seg: SegmentedArray, *, inverse: bool = False,
                      centered: bool = False,
                      cache: PlanCache | None = None) -> Plan:
    """Plan a batched 2-D FFT over a segmented container, keyed on its
    layout (``seg_token``) and the direction and centering; the plan's
    ``fn`` maps ``SegmentedArray -> SegmentedArray`` and its ``meta``
    names the schedule (``local``, ``fused_transpose`` or ``verbs``)."""
    cache = default_cache() if cache is None else cache
    key = ("fft", "fft2_batched", seg_token(seg), bool(inverse),
           bool(centered))

    def build():
        inv, cen = bool(inverse), bool(centered)
        meta = {"policy": seg.policy.value, "dim": seg.dim,
                "distributed": _dim_in_plane(seg)}
        if not _dim_in_plane(seg):
            meta["schedule"] = "local"

            def fn(s):
                return s.with_data(_fft2_local(s.data, inv, cen))
        else:
            nd = seg.data.ndim
            seg_ax = seg.dim
            other_ax = nd - 1 if seg_ax == nd - 2 else nd - 2
            if seg.orig_len is not None and \
                    seg.orig_len != seg.global_shape[seg_ax]:
                raise ValueError(
                    "distributed in-plane FFT needs the segmented dim "
                    f"unpadded (orig_len={seg.orig_len} != "
                    f"{seg.global_shape[seg_ax]}); pick a length divisible "
                    "by the group size")
            if seg.data.shape[other_ax] % seg.nseg == 0:
                fn, chunks = _fused_transpose(seg, inv, cen, seg_ax,
                                              other_ax)
                meta.update(schedule="fused_transpose", chunks=chunks)
            else:
                fn = _verbs_transpose(inv, cen, seg_ax, other_ax)
                meta["schedule"] = "verbs"
        return Plan(key=key, fn=fn, lib="fft", op="fft2_batched", meta=meta)

    return cache.get_or_build(key, build)


def fft2_batched(x: SegmentedArray, inverse: bool = False,
                 centered: bool = False,
                 cache: PlanCache | None = None) -> SegmentedArray:
    """Batched 2-D FFT over a segmented container through the plan cache
    (the MGPU libfft call path: plan once per geometry, run every
    frame)."""
    return plan_fft2_batched(x, inverse=inverse, centered=centered,
                             cache=cache)(x)
