"""Coil-sensitivity pointwise ops: the CUDA kernels of ``csrc/coil_mult.cu``
on the card, their plain PyTorch versions on the CPU.

Signatures follow ``repro/kernels/coil_mult/ops.py`` with ``impl`` =
``"auto"`` (kernel for CUDA tensors, plain for CPU tensors) or
``"plain"``.  Complex operands are complex64 and go to the kernels as
interleaved float2; real planes are float32.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, pointers, sampler
from .ref import (coil_adjoint_ref, coil_forward_ref, coil_lincomb_ref,
                  plane_mult_ref)

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_C64, _F32 = torch.complex64, torch.float32
_SOURCE = "src/repro_torch/kernels/csrc/coil_mult.cu"
_TPU = "src/repro/kernels/coil_mult/kernel.py"


def _stack(x, name):
    if x.ndim != 3:
        raise ValueError(f"{name}: expected a (J, X, Y) stack, got "
                         f"{tuple(x.shape)}")
    return x.shape


def _plane(p, shape, dtype):
    """An (X, Y) plane, broadcast out as the JAX wrapper does."""
    if p is None:
        return None
    if dtype == _F32 and not p.is_complex():
        p = p.to(_F32)              # a bool or float64 mask, as in JAX
    if p.shape != shape:
        p = p.expand(shape).contiguous()
    return p


def coil_forward(coils, x, impl="auto"):
    """z_j = c_j * x over a (J, X, Y) stack."""
    if not kreg.use_kernel(impl, coils, x):
        return coil_forward_ref(coils, x)
    J, X, Y = _stack(coils, "coils")
    x = _plane(x, (X, Y), _C64)
    z = torch.empty_like(coils)
    pc, px, s = pointers((coils, _C64, "coils"), (x, _C64, "x"))
    COIL_FORWARD.launch(pc, px, z.data_ptr(), J, X * Y, s)
    return z


def coil_lincomb(a, x, b=None, y=None, scale=None, impl="auto"):
    """out_j = scale * (a * x_j + b * y_j) in one pass; ``b=None`` runs
    the one-term ``coil_scale_mult`` kernel (G's ``fov*(rho*c)``)."""
    if not kreg.use_kernel(impl, a, x, b, y, scale):
        return coil_lincomb_ref(a, x, b, y, scale)
    J, X, Y = _stack(x, "x")
    a = _plane(a, (X, Y), _C64)
    s = _plane(scale, (X, Y), _F32)
    out = torch.empty_like(x)
    if b is None:
        pa, px, ps, st = pointers((a, _C64, "a"), (x, _C64, "x"),
                                  (s, _F32, "scale"))
        COIL_SCALE_MULT.launch(pa, px, ps, out.data_ptr(), J, X * Y, st)
        return out
    if y is None or tuple(y.shape) != (J, X, Y):
        raise ValueError("coil_lincomb: y must be a stack shaped like x")
    b = _plane(b, (X, Y), _C64)
    pa, px, pb, py, ps, st = pointers(
        (a, _C64, "a"), (x, _C64, "x"), (b, _C64, "b"), (y, _C64, "y"),
        (s, _F32, "scale"))
    COIL_LINCOMB.launch(pa, px, pb, py, ps, out.data_ptr(), J, X * Y, st)
    return out


def plane_mult(z, m, impl="auto"):
    """z_j * m: the mask / FOV / Sobolev-weight broadcast multiply as one
    pass over the stack (any leading dims of ``z``)."""
    if not kreg.use_kernel(impl, z, m):
        return plane_mult_ref(z, m)
    m = m.to(_F32)
    if m.ndim != 2 or tuple(z.shape[-2:]) != tuple(m.shape):
        raise ValueError(f"plane_mult: z {tuple(z.shape)} does not end in "
                         f"the plane's shape {tuple(m.shape)}")
    out = torch.empty_like(z)
    npix = m.numel()
    pz, pm, s = pointers((z, _C64, "z"), (m, _F32, "m"))
    PLANE_MULT.launch(pz, pm, out.data_ptr(), z.numel() // max(npix, 1),
                      npix, s)
    return out


def coil_adjoint(coils, z, mask=None, impl="auto"):
    """mask * Sum_j conj(c_j) * z_j, summed in a fixed order."""
    if not kreg.use_kernel(impl, coils, z, mask):
        return coil_adjoint_ref(coils, z, mask)
    J, X, Y = _stack(coils, "coils")
    if tuple(z.shape) != (J, X, Y):
        raise ValueError("coil_adjoint: z must be shaped like coils")
    m = _plane(mask, (X, Y), _F32)
    out = torch.empty((X, Y), dtype=_C64, device=coils.device)
    pc, pz, pm, s = pointers((coils, _C64, "coils"), (z, _C64, "z"),
                             (m, _F32, "mask"))
    COIL_ADJOINT.launch(pc, pz, pm, out.data_ptr(), J, X * Y, s)
    return out


# -- specs: main-path inputs, bytes and flops, yardsticks -------------------

COIL_FORWARD = kreg.register(KernelSpec(
    name="coil_forward", replaces=f"{_TPU}:37",
    tpu_function="coil_forward_pallas", source=_SOURCE,
    entry="coil_forward", argtypes=(_P, _P, _P, _N, _N, _P),
    kernel=lambda c, x: coil_forward(c, x), plain=coil_forward_ref,
    tol=1e-5,
    sample=sampler("stack", "plane"),
    nbytes=lambda c, x: nbytes(c, x, c),
    flops=lambda c, x: 6 * c.numel(),
    library=lambda c, x: torch.mul(c, x),
))

COIL_LINCOMB = kreg.register(KernelSpec(
    name="coil_lincomb", replaces=f"{_TPU}:75",
    tpu_function="coil_lincomb_pallas", source=_SOURCE,
    entry="coil_lincomb", argtypes=(_P, _P, _P, _P, _P, _P, _N, _N, _P),
    kernel=lambda a, x, b, y, s: coil_lincomb(a, x, b, y, s),
    plain=coil_lincomb_ref, tol=1e-5,
    sample=sampler("plane", "stack", "plane", "stack", "real"),
    nbytes=lambda a, x, b, y, s: nbytes(a, x, b, y, s, x),
    flops=lambda a, x, b, y, s: 16 * x.numel(),
))

COIL_SCALE_MULT = kreg.register(KernelSpec(
    name="coil_scale_mult", replaces=f"{_TPU}:106",
    tpu_function="coil_scale_mult_pallas", source=_SOURCE,
    entry="coil_scale_mult", argtypes=(_P, _P, _P, _P, _N, _N, _P),
    kernel=lambda a, x, s: coil_lincomb(a, x, scale=s),
    plain=lambda a, x, s: coil_lincomb_ref(a, x, scale=s), tol=1e-5,
    sample=sampler("plane", "stack", "real"),
    nbytes=lambda a, x, s: nbytes(a, x, s, x),
    flops=lambda a, x, s: 8 * x.numel(),
))

PLANE_MULT = kreg.register(KernelSpec(
    name="plane_mult", replaces=f"{_TPU}:133",
    tpu_function="plane_mult_pallas", source=_SOURCE,
    entry="plane_mult", argtypes=(_P, _P, _P, _N, _N, _P),
    kernel=lambda z, m: plane_mult(z, m), plain=plane_mult_ref, tol=1e-5,
    sample=sampler("stack", "real"),
    nbytes=lambda z, m: nbytes(z, m, z),
    flops=lambda z, m: 2 * z.numel(),
    library=lambda z, m: torch.mul(z, m),
))

# The main path calls coil_adjoint without a mask (DGH_fused), so the
# sample has none and the yardstick is one conjugating dot over coils.
COIL_ADJOINT = kreg.register(KernelSpec(
    name="coil_adjoint", replaces=f"{_TPU}:173",
    tpu_function="coil_adjoint_pallas", source=_SOURCE,
    entry="coil_adjoint", argtypes=(_P, _P, _P, _P, _N, _N, _P),
    kernel=lambda c, z: coil_adjoint(c, z), plain=coil_adjoint_ref,
    tol=1e-4,
    sample=sampler("stack", "stack"),
    nbytes=lambda c, z: nbytes(c, z, c[0]),
    flops=lambda c, z: 8 * c.numel(),
    library=lambda c, z: torch.linalg.vecdot(c, z, dim=0),
))
