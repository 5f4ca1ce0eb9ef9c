"""Coil-sensitivity pointwise ops: the CUDA kernels of ``csrc/coil_mult.cu``
on the card, their plain PyTorch versions on the CPU.

Signatures follow ``repro/kernels/coil_mult/ops.py`` with ``impl`` =
``"auto"`` (kernel for CUDA tensors, plain for CPU tensors) or
``"plain"``.  Complex operands are complex64 and go to the kernels as
interleaved float2; real planes are float32.

Each op also takes a leading batch of B independent rows, the serving
layer's clients solved in one launch (what ``jax.vmap`` of the JAX
package's frame does to its Pallas kernels): (B, J, X, Y) stacks, each
plane either (X, Y), shared by the rows, or (B, X, Y), one a row.  The
kernels take the row as one more grid dimension and each plane's row
stride; their plain versions loop over the rows through the unbatched
ones (``ref.py``).
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
    """(B, J, X, Y) of a (J, X, Y) coil stack (B = 1) or a batch of B."""
    if x.ndim == 3:
        return (1, *x.shape)
    if x.ndim == 4:
        return tuple(x.shape)
    raise ValueError(f"{name}: expected a (J, X, Y) stack or a (B, J, X, Y) "
                     f"batch of them, got {tuple(x.shape)}")


def _plane(p, batch, shape, dtype, name):
    """A plane operand and its row stride: an (X, Y) plane (anything that
    broadcasts to one, as the JAX wrapper takes it) is shared by every
    row, stride 0; a (B, X, Y) plane of a batch gives each row its own,
    stride X * Y."""
    if p is None:
        return None, 0
    if dtype == _F32 and not p.is_complex():
        p = p.to(_F32)              # a bool or float64 mask, as in JAX
    if p.ndim == 3:
        if tuple(p.shape) != (batch, *shape):
            raise ValueError(f"{name}: a plane of each row is (B, X, Y) = "
                             f"{(batch, *shape)}, got {tuple(p.shape)}")
        return p, shape[0] * shape[1]
    if p.shape != shape:
        p = p.expand(shape).contiguous()
    return p, 0


def coil_forward(coils, x, impl="auto"):
    """z_j = c_j * x over a (J, X, Y) stack, or row by row over a
    (B, J, X, Y) batch with x (B, X, Y) (or one (X, Y) plane for all)."""
    if not kreg.use_kernel(impl, coils, x):
        return coil_forward_ref(coils, x)
    B, J, X, Y = _stack(coils, "coils")
    x, xs = _plane(x, B, (X, Y), _C64, "x")
    z = torch.empty_like(coils)
    pc, px, s = pointers((coils, _C64, "coils"), (x, _C64, "x"))
    COIL_FORWARD.launch(pc, px, z.data_ptr(), B, J, X * Y, xs, s,
                        work=(coils, x))
    return z


def coil_lincomb(a, x, b=None, y=None, scale=None, impl="auto"):
    """out_j = scale * (a * x_j + b * y_j) in one pass; ``b=None`` runs
    the one-term ``coil_scale_mult`` kernel (G's ``fov*(rho*c)``).  Over a
    (B, J, X, Y) batch each plane is (B, X, Y), one a row, or (X, Y),
    shared."""
    if not kreg.use_kernel(impl, a, x, b, y, scale):
        return coil_lincomb_ref(a, x, b, y, scale)
    B, J, X, Y = _stack(x, "x")
    a, a_row = _plane(a, B, (X, Y), _C64, "a")
    s, s_row = _plane(scale, B, (X, Y), _F32, "scale")
    out = torch.empty_like(x)
    if b is None:
        pa, px, ps, st = pointers((a, _C64, "a"), (x, _C64, "x"),
                                  (s, _F32, "scale"))
        COIL_SCALE_MULT.launch(pa, px, ps, out.data_ptr(), B, J, X * Y,
                               a_row, s_row, st, work=(a, x, s))
        return out
    if y is None or y.shape != x.shape:
        raise ValueError("coil_lincomb: y must be a stack shaped like x")
    b, b_row = _plane(b, B, (X, Y), _C64, "b")
    pa, px, pb, py, ps, st = pointers(
        (a, _C64, "a"), (x, _C64, "x"), (b, _C64, "b"), (y, _C64, "y"),
        (s, _F32, "scale"))
    COIL_LINCOMB.launch(pa, px, pb, py, ps, out.data_ptr(), B, J, X * Y,
                        a_row, b_row, s_row, st, work=(a, x, b, y, s))
    return out


def plane_mult(z, m, impl="auto"):
    """z_j * m: the mask / FOV / Sobolev-weight broadcast multiply as one
    pass.  An (X, Y) plane multiplies every plane of ``z`` (any leading
    dims); a (B, X, Y) plane multiplies row b of a batch ``z`` (B, ...,
    X, Y) by its own plane m[b]."""
    if not kreg.use_kernel(impl, z, m):
        return plane_mult_ref(z, m)
    m = m.to(_F32)
    if m.ndim not in (2, 3) or tuple(z.shape[-2:]) != tuple(m.shape[-2:]) \
            or m.ndim == 3 and (z.ndim < 3 or z.shape[0] != m.shape[0]):
        raise ValueError(f"plane_mult: z {tuple(z.shape)} does not take "
                         f"the plane {tuple(m.shape)}")
    out = torch.empty_like(z)
    npix = m.shape[-2] * m.shape[-1]
    B, m_row = (m.shape[0], npix) if m.ndim == 3 else (1, 0)
    pz, pm, s = pointers((z, _C64, "z"), (m, _F32, "m"))
    PLANE_MULT.launch(pz, pm, out.data_ptr(), B,
                      z.numel() // max(B * npix, 1), npix, m_row, s,
                      work=(z, m))
    return out


def coil_adjoint(coils, z, mask=None, impl="auto"):
    """mask * Sum_j conj(c_j) * z_j, summed in a fixed order; over a
    (B, J, X, Y) batch, (B, X, Y), row by row."""
    if not kreg.use_kernel(impl, coils, z, mask):
        return coil_adjoint_ref(coils, z, mask)
    B, J, X, Y = _stack(coils, "coils")
    if z.shape != coils.shape:
        raise ValueError("coil_adjoint: z must be shaped like coils")
    m, m_row = _plane(mask, B, (X, Y), _F32, "mask")
    out = torch.empty(coils.shape[:-3] + (X, Y), dtype=_C64,
                      device=coils.device)
    pc, pz, pm, s = pointers((coils, _C64, "coils"), (z, _C64, "z"),
                             (m, _F32, "mask"))
    COIL_ADJOINT.launch(pc, pz, pm, out.data_ptr(), B, J, X * Y, m_row, s,
                        work=(coils, z))
    return out


# -- specs: main-path inputs, bytes and flops, yardsticks -------------------

COIL_FORWARD = kreg.register(KernelSpec(
    name="coil_forward", replaces=f"{_TPU}:37",
    tpu_function="coil_forward_pallas", source=_SOURCE,
    entry="coil_forward", argtypes=(_P, _P, _P, _N, _N, _N, _N, _P),
    kernel=lambda c, x: coil_forward(c, x), plain=coil_forward_ref,
    tol=1e-5,
    sample=sampler("stack", "plane"),
    nbytes=lambda c, x: nbytes(c, x, c),
    flops=lambda c, x: 6 * c.numel(),
    library=lambda c, x: torch.mul(c, x.unsqueeze(-3)),
    batched=True,
))

COIL_LINCOMB = kreg.register(KernelSpec(
    name="coil_lincomb", replaces=f"{_TPU}:75",
    tpu_function="coil_lincomb_pallas", source=_SOURCE,
    entry="coil_lincomb",
    argtypes=(_P, _P, _P, _P, _P, _P, _N, _N, _N, _N, _N, _N, _P),
    kernel=lambda a, x, b, y, s: coil_lincomb(a, x, b, y, s),
    plain=coil_lincomb_ref, tol=1e-5,
    sample=sampler("plane", "stack", "plane", "stack", "real"),
    nbytes=lambda a, x, b, y, s: nbytes(a, x, b, y, s, x),
    flops=lambda a, x, b, y, s: 16 * x.numel(),
    batched=True,
))

COIL_SCALE_MULT = kreg.register(KernelSpec(
    name="coil_scale_mult", replaces=f"{_TPU}:106",
    tpu_function="coil_scale_mult_pallas", source=_SOURCE,
    entry="coil_scale_mult",
    argtypes=(_P, _P, _P, _P, _N, _N, _N, _N, _N, _P),
    kernel=lambda a, x, s: coil_lincomb(a, x, scale=s),
    plain=lambda a, x, s: coil_lincomb_ref(a, x, scale=s), tol=1e-5,
    sample=sampler("plane", "stack", "real"),
    nbytes=lambda a, x, s: nbytes(a, x, s, x),
    flops=lambda a, x, s: 8 * x.numel(),
    batched=True,
))

PLANE_MULT = kreg.register(KernelSpec(
    name="plane_mult", replaces=f"{_TPU}:133",
    tpu_function="plane_mult_pallas", source=_SOURCE,
    entry="plane_mult", argtypes=(_P, _P, _P, _N, _N, _N, _N, _P),
    kernel=lambda z, m: plane_mult(z, m), plain=plane_mult_ref, tol=1e-5,
    sample=sampler("stack", "row"),
    nbytes=lambda z, m: nbytes(z, m, z),
    flops=lambda z, m: 2 * z.numel(),
    library=lambda z, m: torch.mul(z, m.unsqueeze(-3)),
    batched=True,
))

# The main path calls coil_adjoint without a mask (DGH_fused), so the
# sample has none and the yardstick is one conjugating dot over coils.
# In a batch the planes that G and DG read per client (rho, the Newton
# point) are one a row, the FOV is shared, and plane_mult's sample is the
# sampling mask, one a row.
COIL_ADJOINT = kreg.register(KernelSpec(
    name="coil_adjoint", replaces=f"{_TPU}:173",
    tpu_function="coil_adjoint_pallas", source=_SOURCE,
    entry="coil_adjoint", argtypes=(_P, _P, _P, _P, _N, _N, _N, _N, _P),
    kernel=lambda c, z: coil_adjoint(c, z), plain=coil_adjoint_ref,
    tol=1e-4,
    sample=sampler("stack", "stack"),
    nbytes=lambda c, z: nbytes(c, z, c[..., 0, :, :]),
    flops=lambda c, z: 8 * c.numel(),
    library=lambda c, z: torch.linalg.vecdot(c, z, dim=-3),
    batched=True,
))
