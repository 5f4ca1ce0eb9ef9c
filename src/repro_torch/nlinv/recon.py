"""Reconstruction drivers on one device.

``Reconstructor`` is the frame solver: ``(y, mask, fov, weight, x0,
x_ref) -> (u, image)``, the counterpart of ``repro.nlinv.recon``'s
single-device case.  It runs on the card unless ``device="cpu"`` is
asked for.  There is no communicator yet: the coil split across ranks
and its channel-sum collectives are later work, so ``channel_sum``
(``"full"`` or ``"crop"``) is accepted and both are the identity here:
the channel sum's product is supported on the FOV window, so cropping to
it drops only zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .irgnm import irgnm, irgnm_fused
from .operators import make_ops, sobolev_weight, uinit


class Reconstructor:
    """One NLINV frame solver on one device.

    ``fused=True`` (default) runs the hot path (``irgnm_fused`` on the
    CUDA kernels); ``fused=False`` the unfused plain-tensor solver.
    ``impl="plain"`` makes the fused path use the kernels' plain PyTorch
    versions even on the card (for holding the kernels against them).
    ``cg_log`` collects the iteration count of every fused CG solve.
    """

    def __init__(self, *, device=None, newton: int = 7, cg_iters: int = 30,
                 channel_sum: str = "crop", fused: bool = True,
                 impl: str = "auto"):
        if channel_sum not in ("full", "crop"):
            raise ValueError(f"channel_sum must be full|crop: {channel_sum}")
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be auto|plain: {impl}")
        self.device = resolve_device(device)
        self.newton, self.cg_iters = newton, cg_iters
        self.channel_sum, self.fused, self.impl = channel_sum, fused, impl
        self.cg_log: list[int] = []

    def _ops(self, mask, fov, weight):
        return make_ops(mask, fov, weight, device=self.device,
                        impl=self.impl)

    def _frame_solve(self, y, mask, fov, weight, x0, x_ref):
        """Newton/CG stage only: acquisition -> solved ``u``."""
        ops = self._ops(mask, fov, weight)
        if self.fused:
            return irgnm_fused(ops, y, x0, x_ref, newton=self.newton,
                               cg_iters=self.cg_iters, log=self.cg_log)
        return irgnm(ops, y, x0, x_ref, newton=self.newton,
                     cg_iters=self.cg_iters)

    def _frame_image(self, mask, fov, weight, u):
        """Readout stage: solved ``u`` -> displayed image (the
        root-sum-of-squares channel combination)."""
        ops = self._ops(mask, fov, weight)
        c = ops.coils(u["chat"])
        rss = torch.sum(torch.abs(c) ** 2, dim=0)
        return u["rho"] * torch.sqrt(rss)

    def _frame(self, y, mask, fov, weight, x0, x_ref):
        u = self._frame_solve(y, mask, fov, weight, x0, x_ref)
        return u, self._frame_image(mask, fov, weight, u)

    def _frame_donate(self, y, mask, fov, weight, x0, x_ref):
        """``_frame`` that writes the new ``u`` into ``x0``'s tensors, in
        place, and returns them: the carry's buffers are reused frame to
        frame (the JAX package donates them)."""
        u, img = self._frame(y, mask, fov, weight, x0, x_ref)
        for k in x0:
            x0[k].copy_(u[k])
        return x0, img

    @property
    def fn(self):
        return self._frame

    @property
    def fn_donate_carry(self):
        """The frame function that overwrites ``x0`` in place with the new
        ``u``; the caller must not rely on ``x0``'s old values after it."""
        return self._frame_donate

    @property
    def fn_solve(self):
        return self._frame_solve

    @property
    def fn_image(self):
        return self._frame_image

    def __call__(self, y, mask, fov, weight, x0, x_ref):
        return self.fn(y, mask, fov, weight, x0, x_ref)

    # -- carry/constant placement -----------------------------------------
    def init_carry(self, ncoils: int, grid: int):
        """Newton carry on the device: rho = 1, chat = 0."""
        return uinit(ncoils, grid, device=self.device)

    def _put(self, x, dtype):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        if self.device.type == "cuda":
            # staged from page-locked memory so the copy is asynchronous
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def put_frame(self, y):
        """One frame of coil data (J, X, Y) as complex64 on the device."""
        return self._put(np.asarray(y), torch.complex64)

    def put_const(self, x):
        """A per-frame real plane (mask / fov / weight) as float32 on the
        device."""
        return self._put(np.asarray(x), torch.float32)


def reconstruct_frame(y, mask, fov, weight, x0, x_ref, *, newton=7,
                      cg_iters=30, device=None):
    """One NLINV frame on one device; ``y`` (J, X, Y) and the planes may
    be numpy arrays or tensors."""
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        channel_sum="full")

    def put(a, how):
        return a.to(rec.device) if isinstance(a, torch.Tensor) else how(a)

    return rec(put(y, rec.put_frame), put(mask, rec.put_const),
               put(fov, rec.put_const), put(weight, rec.put_const), x0, x_ref)


def pad_channels(y, nseg, axis: int = 0):
    """Zero-pad the coil dim to a multiple of the group size (zero
    channels are exact no-ops for all NLINV sums)."""
    J = y.shape[axis]
    Jp = -(-J // nseg) * nseg
    if Jp == J:
        return y
    pad = np.zeros(y.shape[:axis] + (Jp - J,) + y.shape[axis + 1:], y.dtype)
    return np.concatenate([y, pad], axis=axis)


def reconstruct_movie(data, *, newton=7, cg_iters=30, damping=0.9,
                      device=None):
    """Blocking sequential movie loop (frames depend on x_ref, paper
    §3.2).  Returns (F, X, Y) images; ``FrameStream`` is the
    transfer-overlapped engine."""
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        channel_sum="full")
    y, masks, fov = data["y"], data["masks"], data["fov"]
    F, J, g, _ = y.shape
    fov_d = rec.put_const(fov)
    w_d = rec.put_const(sobolev_weight(g))
    u = rec.init_carry(J, g)
    x_ref = u
    images = []
    for f in range(F):
        u, img = rec(rec.put_frame(y[f]), rec.put_const(masks[f]), fov_d,
                     w_d, u, x_ref)
        x_ref = {k: damping * v for k, v in u.items()}
        images.append(img)
    return torch.stack(images)
