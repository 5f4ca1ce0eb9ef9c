"""Fused CG vector updates: the CUDA kernels of ``csrc/cg_fused.cu`` on the
card, their plain PyTorch versions on the CPU.

Operands are complex64 arrays of any shape (the kernels see them flat);
``alpha``/``beta`` are real scalars, passed to the kernels as float32
device scalars through a pointer so that no launch waits on the host.

``cg_update`` and the search-direction step (``xpby_dot(...,
with_dot=False)``) also take a batch of B independent CG states, one a
client of the batched NLINV frame: ``alpha``/``beta`` a (B,) device
vector, the operands (B, ...), ``rs`` (B,), and an optional (B,) bool
``active`` mask that freezes the rows whose loop has stopped.  Each row's
rs sums in the unbatched call's tiles and order (``PARTIALS`` slots a
row), so its bits depend neither on B nor on the other rows.

Each wrapper takes ``block=None``: threads per block, 128, 256 or 512,
resolved by ``KernelSpec.pick_block``.  The partial sums' tiles do not
depend on it, so every block gives the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry as kreg
from ..registry import (MAIN_NCOILS, MAIN_RANKS, KernelSpec, nbytes,
                        pointers, sampler)
from .ref import cg_update_ref, xpby_dot_ref, xpby_ref

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_C64, _F32 = torch.complex64, torch.float32
_SOURCE = "src/repro_torch/kernels/csrc/cg_fused.cu"
_TPU = "src/repro/kernels/cg_fused/kernel.py"

# Per-block partial sums of the rs and d epilogues: at most this many
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


def _batched(v) -> bool:
    """A (B,) scalar vector: the call is a batch of B rows."""
    return isinstance(v, torch.Tensor) and v.ndim == 1


def _rows_of(scalar, active, first):
    """The batch's (B,) float32 scalars, its (B,) active bytes (None: all
    rows active) and B, checked against the operands' leading dim."""
    v = torch.real(scalar) if scalar.is_complex() else scalar
    v = v.to(device=first.device, dtype=_F32).contiguous()
    B = v.shape[0]
    if first.ndim < 1 or first.shape[0] != B:
        raise ValueError(f"a batch of {B} scalars needs operands of leading "
                         f"dim {B}, got {tuple(first.shape)}")
    if active is not None:
        if tuple(active.shape) != (B,):
            raise ValueError(f"active must be ({B},), got "
                             f"{tuple(active.shape)}")
        active = active.to(device=first.device, dtype=torch.bool) \
            .contiguous()
    return v, active, B


def _same_shape(*arrays):
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays):
        raise ValueError(f"operands differ in shape: "
                         f"{[tuple(a.shape) for a in arrays]}")


def cg_update(alpha, p, ap, x, r, impl="auto", active=None, block=None):
    """``x' = x + alpha*p``, ``r' = r - alpha*Ap`` with the
    ``rs = sum |r'|^2`` epilogue in one pass.  Returns ``(x', r', rs)``,
    ``rs`` a real float32 0-d tensor, summed in a fixed order; with a (B,)
    ``alpha``, row by row over (B, ...) operands, ``rs`` (B,), and the
    rows that ``active`` marks False left as they are."""
    if active is not None and not _batched(alpha):
        raise ValueError("cg_update: an active mask needs a (B,) alpha")
    if not kreg.use_kernel(impl, p, ap, x, r):
        return cg_update_ref(alpha, p, ap, x, r, active)
    _same_shape(p, ap, x, r)
    if _batched(alpha):
        a, act, B = _rows_of(alpha, active, p)
    else:
        a, act, B = _scalar(alpha, p.device), None, 1
    x2, r2 = torch.empty_like(x), torch.empty_like(r)
    partials = torch.empty(B * PARTIALS, dtype=_F32, device=p.device)
    rs = torch.empty(a.shape, dtype=_F32, device=p.device)
    pa, pact, *ptrs, s = pointers(
        (a, _F32, "alpha"), (act, torch.bool, "active"), (p, _C64, "p"),
        (ap, _C64, "ap"), (x, _C64, "x"), (r, _C64, "r"))
    CG_UPDATE.launch(pa, pact, *ptrs, x2.data_ptr(), r2.data_ptr(),
                     partials.data_ptr(), PARTIALS, rs.data_ptr(),
                     p.numel() // B, B, *CG_UPDATE.pick_block(block), s,
                     work=(a, p, ap, x, r))
    return x2, r2, rs


def xpby_dot(x, y, beta, impl="auto", with_dot=True, active=None,
             block=None):
    """``w = x + beta*y``; returns ``(w, d)`` with ``d = sum |w|^2`` (a
    real float32 0-d tensor, summed in a fixed order), or ``(w, None)``
    with ``with_dot=False``, the CG search-direction step.  Each form is
    its own kernel: the no-epilogue one skips the reduction.  The step
    also takes a (B,) ``beta`` over (B, ...) operands, row by row; a row
    that ``active`` marks False gets ``w = y``, its frozen direction."""
    batch = _batched(beta)
    if batch and with_dot:
        raise ValueError("xpby_dot: the epilogue form takes one scalar beta")
    if not batch and active is not None:
        raise ValueError("xpby_dot: an active mask needs a (B,) beta")
    if not kreg.use_kernel(impl, x, y):
        if with_dot:
            return xpby_dot_ref(x, y, beta)
        return xpby_ref(x, y, beta, active), None
    _same_shape(x, y)
    w = torch.empty_like(x)
    if not with_dot:
        if batch:
            b, act, B = _rows_of(beta, active, x)
        else:
            b, act, B = _scalar(beta, x.device), None, 1
        pb, pact, px, py, s = pointers((b, _F32, "beta"),
                                       (act, torch.bool, "active"),
                                       (x, _C64, "x"), (y, _C64, "y"))
        XPBY.launch(pb, pact, px, py, w.data_ptr(), x.numel() // B, B,
                    *XPBY.pick_block(block), s, work=(x, y, b))
        return w, None
    b = _scalar(beta, x.device)
    partials = torch.empty(PARTIALS, dtype=_F32, device=x.device)
    d = torch.empty((), dtype=_F32, device=x.device)
    pb, px, py, s = pointers((b, _F32, "beta"), (x, _C64, "x"),
                             (y, _C64, "y"))
    XPBY_DOT.launch(pb, px, py, w.data_ptr(), partials.data_ptr(), PARTIALS,
                    d.data_ptr(), x.numel(), *XPBY_DOT.pick_block(block), s,
                    work=(x, y, b))
    return w, d


# -- specs: main-path inputs (the chat leaf, or its segment), bytes, flops ---

_ALPHA, _BETA = 0.37, 0.61
# threads per block; 256, the default, is the constant the kernels had
_THREADS = dict(block_args=("threads",), default_block=(256,),
                block_space=((128,), (256,), (512,)))

CG_UPDATE = kreg.register(KernelSpec(
    name="cg_update", replaces=f"{_TPU}:59",
    tpu_function="cg_update_pallas", source=_SOURCE,
    entry="cg_update",
    argtypes=(_P, _P, _P, _P, _P, _P, _P, _P, _P, _N, _P, _N, _N, _I, _P),
    kernel=lambda a, p, ap, x, r, block=None: cg_update(a, p, ap, x, r,
                                                        block=block),
    plain=cg_update_ref, tol=1e-4,
    sample=sampler(_ALPHA, "stack", "stack", "stack", "stack"),
    # alpha and the four operands read, x' and r' and rs written
    nbytes=lambda a, p, ap, x, r: nbytes(a, p, ap, x, r, x, r, a),
    flops=lambda a, p, ap, x, r: 12 * p.numel(),
    batched=True, **_THREADS,
))

XPBY = kreg.register(KernelSpec(
    name="xpby", replaces=f"{_TPU}:90",
    tpu_function="xpby_pallas", source=_SOURCE,
    entry="xpby", argtypes=(_P, _P, _P, _P, _P, _N, _N, _I, _P),
    kernel=lambda x, y, b, block=None: xpby_dot(x, y, b, with_dot=False,
                                                block=block)[0],
    plain=xpby_ref, tol=1e-4,
    sample=sampler("stack", "stack", _BETA),
    nbytes=lambda x, y, b: nbytes(b, x, y, x),
    flops=lambda x, y, b: 4 * x.numel(),
    library=lambda x, y, b: torch.add(x, y, alpha=_BETA),
    batched=True, **_THREADS,
))

# the segmented BLAS's main path: one rank's 2-coil segment of the chat
# leaf of a full-width CG state split over 4 ranks
XPBY_DOT = kreg.register(KernelSpec(
    name="xpby_dot", replaces=f"{_TPU}:130",
    tpu_function="xpby_dot_pallas", source=_SOURCE,
    entry="xpby_dot", argtypes=(_P, _P, _P, _P, _P, _N, _P, _N, _I, _P),
    kernel=lambda x, y, b, block=None: xpby_dot(x, y, b, block=block),
    plain=xpby_dot_ref, tol=1e-4,
    sample=sampler("stack", "stack", _BETA,
                   ncoils=MAIN_NCOILS // MAIN_RANKS),
    # beta, x and y read, w and d written
    nbytes=lambda x, y, b: nbytes(b, x, y, x, b),
    flops=lambda x, y, b: 8 * x.numel(),
    **_THREADS,
))
