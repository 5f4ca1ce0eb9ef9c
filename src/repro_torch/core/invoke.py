"""Kernel invocation: the MGPU ``invoke_kernel`` family (paper §2.5).

The counterpart of ``repro.core.invoke``.  MGPU forwards segmented
containers to user kernels as device ranges over local memory, with a
pass-through type for a kernel that needs the whole vector.  The port
runs one process per rank, so a launch is a call of the user function on
this rank's segments: ``invoke_kernel_all`` passes each container as its
local segment, a :class:`PassThrough` as the whole logical array (an
all-gather), anything else as a tensor on the rank's device; ``dev_rank``
is the calling rank.  ``Communicator.spmd`` covers the JAX package's
``make_spmd``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .segmented import Policy, SegmentedArray, upload


@dataclasses.dataclass(frozen=True)
class PassThrough:
    """Forward the whole segmented vector to the kernel (the paper's
    pass-through type for peer access)."""
    seg: SegmentedArray


def dev_rank(comm) -> int:
    """The calling rank's index in ``comm`` (a Communicator or a
    DeviceGroup), for use inside a kernel's host function."""
    return getattr(comm, "group", comm).rank


def _local_args(args, comm):
    out = []
    for a in args:
        if isinstance(a, SegmentedArray):
            out.append(a.data)
        elif isinstance(a, PassThrough):
            out.append(a.seg.gather())
        elif isinstance(a, torch.Tensor):
            out.append(a.to(comm.device))
        elif hasattr(a, "__array__") or isinstance(a, (list, tuple)):
            out.append(upload(a, comm.device))
        else:
            out.append(a)                    # a scalar, or any other value
    return out


def _wrap(res: torch.Tensor, comm, out_policy: Policy, out_dim: int):
    """``res``, this rank's segment, as a container of ``out_policy``
    along ``out_dim`` (no padding recorded, as in the JAX package), or
    itself for CLONE."""
    if out_policy is Policy.CLONE:
        return res
    shape = list(res.shape)
    shape[out_dim] *= comm.size
    return SegmentedArray(res, comm, out_policy, out_dim, tuple(shape))


def invoke_kernel_all(fn: Callable, *args, comm, out_policy=Policy.NATURAL,
                      out_dim: int = 0):
    """Launch ``fn`` on every rank of ``comm`` (MGPU
    ``invoke_kernel_all``): containers arrive as this rank's segment.
    The result is a container segmented along ``out_dim`` (the default),
    or with ``out_policy=Policy.CLONE`` the tensor itself, which ``fn``
    must make the same on every rank.

    >>> from repro_torch.core import Communicator
    >>> comm = Communicator.single("cpu")
    >>> seg = comm.container([1., 2., 3.])
    >>> out = invoke_kernel_all(lambda xl, full: xl * full.sum(), seg,
    ...                         PassThrough(seg), comm=comm)
    >>> (out.policy, out.gather().tolist(), dev_rank(comm))
    (<Policy.NATURAL: 'natural'>, [6.0, 12.0, 18.0], 0)
    """
    return _wrap(fn(*_local_args(args, comm)), comm, out_policy, out_dim)


def invoke_kernel(fn: Callable, *args, rank: int, comm, **kw):
    """Launch ``fn`` in the context of rank ``rank`` only.  Every rank runs
    it (a collective inside ``fn`` would otherwise hang), and the other
    ranks' results are zeros, as only the target device's segment is
    written in MGPU."""
    if not 0 <= rank < comm.size:
        raise ValueError(f"rank {rank} outside a group of {comm.size}")

    def masked(*local):
        out = fn(*local)
        return out if comm.rank == rank else torch.zeros_like(out)

    return invoke_kernel_all(masked, *args, comm=comm, **kw)
