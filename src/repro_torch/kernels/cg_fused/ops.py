"""Fused CG vector updates: the CUDA kernels of ``csrc/cg_fused.cu`` on the
card, their plain PyTorch versions on the CPU.

Operands are complex64 arrays of any shape (the kernels see them flat);
``alpha``/``beta`` are real scalars, passed to the kernels as float32
device scalars through a pointer so that no launch waits on the host.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, ptr, sampler, stream
from .ref import cg_update_ref, xpby_dot_ref, xpby_ref

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_C64, _F32 = torch.complex64, torch.float32
_SOURCE = "src/repro_torch/kernels/csrc/cg_fused.cu"
_TPU = "src/repro/kernels/cg_fused/kernel.py"

# Per-block partial sums of cg_update's rs epilogue: at most this many
# blocks, so the scratch is fixed and the summation order depends on n
# alone.
PARTIALS = 1024


def _scalar(v, device) -> torch.Tensor:
    """A real float32 0-d tensor on ``device`` (the kernels' scalar
    operand); a device tensor stays where it is, with no host sync."""
    if isinstance(v, torch.Tensor):
        v = torch.real(v) if v.is_complex() else v
        return v.to(device=device, dtype=_F32).reshape(()).contiguous()
    return torch.tensor(float(v), dtype=_F32, device=device)


def _same_shape(*arrays):
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays):
        raise ValueError(f"operands differ in shape: "
                         f"{[tuple(a.shape) for a in arrays]}")


def cg_update(alpha, p, ap, x, r, impl="auto"):
    """``x' = x + alpha*p``, ``r' = r - alpha*Ap`` with the
    ``rs = sum |r'|^2`` epilogue in one pass.  Returns ``(x', r', rs)``,
    ``rs`` a real float32 0-d tensor, summed in a fixed order."""
    if not kreg.use_kernel(impl, p, ap, x, r):
        return cg_update_ref(alpha, p, ap, x, r)
    _same_shape(p, ap, x, r)
    a = _scalar(alpha, p.device)
    x2, r2 = torch.empty_like(x), torch.empty_like(r)
    partials = torch.empty(PARTIALS, dtype=_F32, device=p.device)
    rs = torch.empty((), dtype=_F32, device=p.device)
    CG_UPDATE.launch(ptr(a, _F32, "alpha"), ptr(p, _C64, "p"),
                     ptr(ap, _C64, "ap"), ptr(x, _C64, "x"),
                     ptr(r, _C64, "r"), ptr(x2, _C64, "x_out"),
                     ptr(r2, _C64, "r_out"), ptr(partials, _F32, "partials"),
                     PARTIALS, ptr(rs, _F32, "rs"), p.numel(), stream(p))
    return x2, r2, rs


def xpby_dot(x, y, beta, impl="auto", with_dot=True):
    """``w = x + beta*y``; returns ``(w, d)`` with ``d = sum |w|^2``, or
    ``(w, None)`` with ``with_dot=False``, the CG search-direction step.

    Only the ``with_dot=False`` form has a kernel yet; the epilogue form
    runs its plain version, and asking for it on the card with
    ``impl="auto"`` raises."""
    if with_dot:
        if kreg.use_kernel(impl, x, y):
            raise NotImplementedError(
                "xpby_dot's epilogue kernel is not ported yet; pass "
                "impl='plain' or with_dot=False")
        return xpby_dot_ref(x, y, beta)
    if not kreg.use_kernel(impl, x, y):
        return xpby_ref(x, y, beta), None
    _same_shape(x, y)
    b = _scalar(beta, x.device)
    w = torch.empty_like(x)
    XPBY.launch(ptr(b, _F32, "beta"), ptr(x, _C64, "x"), ptr(y, _C64, "y"),
                ptr(w, _C64, "w"), x.numel(), stream(x))
    return w, None


# -- specs: main-path inputs (the chat leaf), bytes and flops ---------------

_ALPHA, _BETA = 0.37, 0.61

CG_UPDATE = kreg.register(KernelSpec(
    name="cg_update", replaces=f"{_TPU}:59",
    tpu_function="cg_update_pallas", source=_SOURCE,
    entry="cg_update",
    argtypes=(_P, _P, _P, _P, _P, _P, _P, _P, _N, _P, _N, _P),
    kernel=lambda a, p, ap, x, r: cg_update(a, p, ap, x, r),
    plain=cg_update_ref, tol=1e-4,
    sample=sampler(_ALPHA, "stack", "stack", "stack", "stack"),
    # alpha and the four operands read, x' and r' and rs written
    nbytes=lambda a, p, ap, x, r: nbytes(a, p, ap, x, r, x, r, a),
    flops=lambda a, p, ap, x, r: 12 * p.numel(),
))

XPBY = kreg.register(KernelSpec(
    name="xpby", replaces=f"{_TPU}:90",
    tpu_function="xpby_pallas", source=_SOURCE,
    entry="xpby", argtypes=(_P, _P, _P, _P, _N, _P),
    kernel=lambda x, y, b: xpby_dot(x, y, b, with_dot=False)[0],
    plain=xpby_ref, tol=1e-4,
    sample=sampler("stack", "stack", _BETA),
    nbytes=lambda x, y, b: nbytes(b, x, y, x),
    flops=lambda x, y, b: 4 * x.numel(),
    library=lambda x, y, b: torch.add(x, y, alpha=_BETA),
))
