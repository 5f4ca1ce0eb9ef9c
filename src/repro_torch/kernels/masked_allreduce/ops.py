"""Masked G-way partial sum: the CUDA kernel of
``csrc/masked_allreduce.cu`` on the card, its plain PyTorch version on
the CPU; and ``masked_psum_crop``, the whole of the paper's
``kern_all_red_p2p_2d`` on a communicator.

The CUDA original has each GPU read its peers' partial images over PCIe
P2P and sum them inside one kernel, masked to the 2-D section M_Omega
keeps.  The port moves the section with one all-gather of the
communicator and then sums the G gathered windows in ONE kernel on every
rank (``masked_sum``), in rank order, so every rank gets the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, pointers, window_sampler
from .ref import masked_sum_ref

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_C64, _F32 = torch.complex64, torch.float32
_SOURCE = "src/repro_torch/kernels/csrc/masked_allreduce.cu"
_TPU = "src/repro/kernels/masked_allreduce/kernel.py"


def masked_sum(partials, mask, impl="auto", out=None, block=None):
    """``mask * sum_g partials_g`` for a (G, X, Y) complex64 stack and a
    float32 (X, Y) mask, the G partials summed in order.  A (G, B, X, Y)
    stack is B rows (the batched frame's clients) under the one mask: the
    result is (B, X, Y), and a row's bits are those of the unbatched call
    on that row.

    The stack's rows must be contiguous; its plane, batch and row strides
    are free (a window of a larger image, or a gathered payload with
    extras after each plane).  ``out``, a ``partials.shape[1:]`` complex64
    tensor with contiguous rows (a window of a zero-filled image, say),
    receives the result in place and is returned.  ``block``: threads per
    block (``KernelSpec.pick_block``); every block gives the same
    bits."""
    if not kreg.use_kernel(impl, partials, mask, out):
        res = masked_sum_ref(partials, mask)
        return res if out is None else out.copy_(res)
    if partials.ndim not in (3, 4) or \
            (out is not None and out.ndim != partials.ndim - 1):
        raise ValueError(f"masked_sum: the kernel takes a (G, X, Y) or "
                         f"(G, B, X, Y) stack and an out of its planes' "
                         f"shape, got {tuple(partials.shape)}")
    G, X, Y = partials.shape[0], partials.shape[-2], partials.shape[-1]
    batched = partials.ndim == 4
    B = partials.shape[1] if batched else 1
    if tuple(mask.shape) != (X, Y):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                         f"partials' planes {(X, Y)}")
    shape = tuple(partials.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=_C64, device=partials.device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out {tuple(out.shape)} is not {shape}")
    pp, pm, po, s = pointers((partials, _C64, "partials", True),
                             (mask, _F32, "mask"), (out, _C64, "out", True))
    MASKED_SUM.launch(pp, partials.stride(0),
                      partials.stride(1) if batched else 0,
                      partials.stride(-2), pm, po,
                      out.stride(0) if batched else 0, out.stride(-2), G, B,
                      X, Y, *MASKED_SUM.pick_block(block), s,
                      work=(partials, mask))
    return out


def masked_psum_crop(x, mask, comm, impl="auto"):
    """The distributed form: each rank holds one partial (X, Y); only the
    centered FOV quarter crosses the wire, and every rank sums the G
    quarters with ``masked_sum``, masked to ``mask``'s quarter, into
    zeros elsewhere (``comm.allreduce_overlap``'s masked schedule).  The
    counterpart of ``repro.kernels.masked_allreduce.masked_psum_crop``."""
    q = x.shape[-1] // 4
    win = ((q, 3 * q), (q, 3 * q))
    m = mask[q:3 * q, q:3 * q].contiguous()
    return comm.allreduce_overlap(x, win, mask=m, impl=impl)[0]


# -- spec: the frame's gathered FOV window (G = 4 ranks, 384 x 384; with
# ``width=B`` the batched frame's B rows of it) -------------------------------

MASKED_SUM = kreg.register(KernelSpec(
    name="masked_sum", replaces=f"{_TPU}:32",
    tpu_function="masked_sum_pallas", source=_SOURCE, entry="masked_sum",
    argtypes=(_P, _N, _N, _N, _P, _P, _N, _N, ctypes.c_int, _N, _N, _N,
              ctypes.c_int, _P),
    kernel=lambda p, m, block=None: masked_sum(p, m, block=block),
    plain=masked_sum_ref, tol=1e-4,
    sample=window_sampler(),
    # the G partials and the mask read, one plane (a plane a row) written
    nbytes=lambda p, m: nbytes(p, m, p[0]),
    # G - 1 complex adds and the masking, 2 flops each, per element
    flops=lambda p, m: 2 * p.numel(),
    library=lambda p, m: torch.einsum("g...xy,xy->...xy", p, m),
    # the batched frame's B clients in one launch, under one mask
    batched=True,
    # threads per block; 256, the default, is the constant it had
    block_args=("threads",), default_block=(256,),
    block_space=((128,), (256,), (512,)),
))
