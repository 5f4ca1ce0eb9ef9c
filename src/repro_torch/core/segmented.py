"""Segmented containers: the core MGPU abstraction, one rank's view.

The counterpart of ``repro.core.segmented``.  An MGPU ``seg_dev_vector``
is one logical array split across device memories, with its own location
metadata.  The JAX package keeps the global ``jax.Array`` and attaches
the policy; the port runs one process per rank, so a
:class:`SegmentedArray` holds THIS rank's segment (``data``) with the
metadata every rank shares: the physical global shape (padding
included), the segmented ``dim``, the pre-padding length ``orig_len``,
the BLOCK ``block`` and the owning communicator.

Split policies (paper §2.2):
  NATURAL   contiguous even split along one dim (zero-padded to a
            multiple of the group size),
  BLOCK     block-cyclic split (fixed block size, round-robin),
  CLONE     the whole array on every rank,
  OVERLAP2D contiguous row split with a halo of ``h`` rows exchanged
            with the neighbours (for stencil-style kernels).  Its stored
            layout is NATURAL's; ``halo_exchange`` extends each segment
            by its neighbours' rows over the p2p path, on demand.

Construction mirrors the JAX ctor: every rank passes the same global
array and keeps its own segment.  A numpy input is padded, permuted and
sliced on the host, so each rank uploads only its own segment.

The fluent methods of a container (``allreduce``, ``reduce_scatter``,
``alltoall``, ``shift``, ``invoke``, ``to``, ...) call the verbs of its
communicator; elementwise arithmetic keeps the segmentation.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

import numpy as np
import torch


class Policy(enum.Enum):
    NATURAL = "natural"
    BLOCK = "block"
    CLONE = "clone"
    OVERLAP2D = "overlap2d"


# numpy dtypes as JAX canonicalizes them without 64-bit mode
_CANONICAL = {np.dtype(np.float64): np.float32,
              np.dtype(np.complex128): np.complex64,
              np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def _canonical(x: np.ndarray) -> np.ndarray:
    dt = _CANONICAL.get(x.dtype)
    return x if dt is None else x.astype(dt)


def _pad_to(x, dim: int, mult: int):
    """Zero-pad ``dim`` of a numpy array or tensor up to a multiple of
    ``mult``; returns ``(padded, original length)``."""
    n = x.shape[dim]
    target = math.ceil(n / mult) * mult
    if target == n:
        return x, n
    if isinstance(x, np.ndarray):
        pad = [(0, 0)] * x.ndim
        pad[dim] = (0, target - n)
        return np.pad(x, pad), n
    shape = list(x.shape)
    shape[dim] = target - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim), n


def _block_cyclic_perm(n: int, nseg: int, block: int) -> np.ndarray:
    """Permutation mapping logical index -> segment-major block-cyclic
    order."""
    nblocks = n // block
    ids = np.arange(n).reshape(nblocks, block)
    return np.concatenate([ids[s::nseg].reshape(-1) for s in range(nseg)])


def _take(x, index: np.ndarray, dim: int):
    if isinstance(x, np.ndarray):
        return np.take(x, index, axis=dim)
    return torch.index_select(x, dim, torch.as_tensor(index,
                                                      device=x.device))


def physical_layout(x, nseg: int, policy: Policy, dim: int = 0,
                    block: int | None = None):
    """The global array as the segments lay it out: padded along ``dim``
    to a multiple of ``nseg`` (``nseg * block`` and block-cyclically
    permuted for BLOCK).  Returns ``(layout, orig_len)``."""
    if policy is Policy.CLONE:
        return x, (x.shape[dim] if x.ndim else None)
    if policy is Policy.BLOCK:
        if block is None:
            raise ValueError("BLOCK policy requires block=")
        x, orig = _pad_to(x, dim, nseg * block)
        return _take(x, _block_cyclic_perm(x.shape[dim], nseg, block),
                     dim), orig
    if policy in (Policy.NATURAL, Policy.OVERLAP2D):
        return _pad_to(x, dim, nseg)
    raise ValueError(policy)


def local_segment(layout, rank: int, nseg: int, policy: Policy,
                  dim: int = 0):
    """Rank ``rank``'s segment of a physical layout (a view)."""
    if policy is Policy.CLONE:
        return layout
    per = layout.shape[dim] // nseg
    idx = [slice(None)] * layout.ndim
    idx[dim] = slice(rank * per, (rank + 1) * per)
    return layout[tuple(idx)]


def logical_array(layout, nseg: int, policy: Policy, dim: int = 0,
                  orig_len: int | None = None, block: int | None = None):
    """Inverse of :func:`physical_layout`: undo the block-cyclic order
    and strip the padding."""
    x = layout
    if policy is Policy.BLOCK:
        perm = _block_cyclic_perm(x.shape[dim], nseg, block)
        x = _take(x, np.argsort(perm), dim)
    if orig_len is not None and orig_len != x.shape[dim]:
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(0, orig_len)
        x = x[tuple(idx)]
    return x


def upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor of its own on
    ``device`` (a copy, never a view of the caller's memory).  From numpy
    to a card it goes through page-locked memory, asynchronously."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=dtype, copy=True)
        return t.contiguous()
    arr = _canonical(np.asarray(x))
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentedArray:
    """This rank's segment of a logical array, with the segmentation
    metadata every rank shares."""

    data: torch.Tensor                # this rank's segment (CLONE: all)
    comm: object                      # the owning Communicator
    policy: Policy
    dim: int = 0                      # logical dim that is segmented
    global_shape: tuple = ()          # physical shape, padding included
    orig_len: int | None = None       # pre-padding length along `dim`
    block: int | None = None          # BLOCK policy block size
    halo: int = 0                     # OVERLAP2D halo rows

    # -- basic queries ----------------------------------------------------
    @property
    def group(self):
        return self.comm.group

    @property
    def nseg(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def seg_len(self, rank: int | None = None) -> int:
        """Per-segment length along the segmented dim: without ``rank``
        the uniform physical length (padding included), with ``rank`` the
        logical length of that segment (block-cyclic remainders
        included)."""
        if rank is not None:
            return self._seg_sizes()[rank]
        if self.policy is Policy.CLONE:
            return self.global_shape[self.dim]
        return self.global_shape[self.dim] // self.nseg

    def _seg_sizes(self) -> list[int]:
        n = self.nseg
        total = self.global_shape[self.dim]
        orig = total if self.orig_len is None else self.orig_len
        if self.policy is Policy.CLONE:
            return [orig] * n
        if self.policy is Policy.BLOCK:
            nblocks = total // self.block
            return [sum(max(0, min(orig - b * self.block, self.block))
                        for b in range(r, nblocks, n)) for r in range(n)]
        per = total // n
        sizes = [max(0, min(orig - r * per, per)) for r in range(n)]
        if self.policy is Policy.OVERLAP2D and self.halo:
            # a segment also holds ``halo`` rows of each neighbour it has
            h = self.halo
            sizes = [sz + (h if r > 0 else 0) + (h if r < n - 1 else 0)
                     for r, sz in enumerate(sizes)]
        return sizes

    def segments(self) -> list[tuple[int, ...]]:
        """MGPU's (pointer, size) vector as logical per-segment shapes,
        one entry per rank, CLONE included (BLOCK's remainders and
        OVERLAP2D's halo rows counted)."""
        if self.policy is Policy.CLONE:
            return [tuple(self.global_shape)] * self.nseg
        out = []
        for sz in self._seg_sizes():
            s = list(self.global_shape)
            s[self.dim] = sz
            out.append(tuple(s))
        return out

    def with_data(self, data: torch.Tensor) -> "SegmentedArray":
        return dataclasses.replace(self, data=data)

    # elementwise arithmetic keeps the segmentation
    def _binop(self, other, op):
        o = other.data if isinstance(other, SegmentedArray) else other
        return self.with_data(op(self.data, o))

    def __add__(self, o): return self._binop(o, torch.add)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __truediv__(self, o): return self._binop(o, torch.div)

    def astype(self, dtype) -> "SegmentedArray":
        return self.with_data(self.data.to(dtype))

    def gather(self) -> torch.Tensor:
        """The logical array, on every rank (inverse of construction)."""
        return gather(self)

    # -- fluent verbs: the owning communicator's methods ------------------
    def to(self, policy: "Policy | None" = None, **kw) -> "SegmentedArray":
        """Re-segment under a new policy or dim (``comm.copy``).

        >>> from repro_torch.core import Communicator, Policy
        >>> seg = Communicator.single("cpu").container([1., 2.])
        >>> seg.to(Policy.CLONE).policy
        <Policy.CLONE: 'clone'>
        """
        return self.comm.copy(self, policy=policy, **kw)

    def reduce(self, op: str = "sum") -> torch.Tensor:
        """Merge the segments: the segmented dim is reduced away.

        >>> from repro_torch.core import Communicator
        >>> seg = Communicator.single("cpu").container([[1., 2.], [3., 4.]])
        >>> seg.reduce().tolist()
        [4.0, 6.0]
        """
        return self.comm.reduce(self, op)

    def allreduce(self, op: str = "sum", *, hierarchical: bool = False,
                  p2p: bool = False) -> "SegmentedArray":
        """Reduce + replicate (-> CLONE container).

        >>> from repro_torch.core import Communicator
        >>> seg = Communicator.single("cpu").container([[1., 2.], [3., 4.]])
        >>> seg.allreduce(p2p=True).data.tolist()
        [4.0, 6.0]
        """
        return self.comm.allreduce(self, op, hierarchical=hierarchical,
                                   p2p=p2p)

    def allreduce_window(self, window=None, **kw) -> "SegmentedArray":
        """Windowed all-reduce: only ``window`` goes on the wire,
        scattered back into zeros.

        >>> from repro_torch.core import Communicator
        >>> seg = Communicator.single("cpu").container([[1., 2., 3., 4.]])
        >>> seg.allreduce_window(((1, 3),)).data.tolist()
        [0.0, 2.0, 3.0, 0.0]
        """
        return self.comm.allreduce_window(self, window, **kw)

    def allgather(self) -> "SegmentedArray":
        """MPI_Allgather: the whole logical array, CLONEd."""
        return self.comm.allgather(self)

    def reduce_scatter(self, op: str = "sum") -> "SegmentedArray":
        """Reduce the segments, leave the result segmented.

        >>> from repro_torch.core import Communicator
        >>> seg = Communicator.single("cpu").container([[1., 2.], [3., 4.]])
        >>> seg.reduce_scatter().gather().tolist()
        [4.0, 6.0]
        """
        return self.comm.reduce_scatter(self, op)

    def alltoall(self, new_dim: int) -> "SegmentedArray":
        """Re-segment onto ``new_dim`` with an all-to-all."""
        return self.comm.alltoall(self, new_dim)

    def vdot(self, other):
        """Inner product of the logical arrays (one reduction)."""
        return self.comm.vdot(self, other)

    def shift(self, offset: int = 1, *, wrap: bool = True):
        """Ring-shift the segments by ``offset`` (p2p path)."""
        return self.comm.shift(self, offset, wrap=wrap)

    def send_recv(self, perm) -> "SegmentedArray":
        """Pairwise segment exchange over ``(src, dst)`` pairs."""
        return self.comm.send_recv(self, perm)

    def halo_exchange(self, fn: Callable | None = None):
        """OVERLAP2D halo exchange over the p2p path.  With ``fn``: apply
        it to every halo-extended block (``(rows + 2h, ...) -> (rows,
        ...)``); without: the halo-extended container itself.

        A single segment has no neighbours, so its halo rows are zeros:

        >>> from repro_torch.core import Communicator, Policy
        >>> seg = Communicator.single("cpu").container(
        ...     [[1., 1.], [2., 2.]], policy=Policy.OVERLAP2D, halo=1)
        >>> seg.halo_exchange().gather().tolist()
        [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [0.0, 0.0]]
        """
        return overlap2d_map(self, fn)

    def invoke(self, fn: Callable, *args) -> "SegmentedArray":
        """Run a shape-preserving ``fn`` on this rank's segment (and
        ``args``); the result keeps this container's segmentation.

        >>> from repro_torch.core import Communicator
        >>> seg = Communicator.single("cpu").container([1., 2.])
        >>> seg.invoke(lambda xl: xl * 10).gather().tolist()
        [10.0, 20.0]
        """
        res = self.comm.invoke_all(fn, self, *args)
        return self.with_data(res.data if isinstance(res, SegmentedArray)
                              else res)


def segment(x, comm, *, policy: Policy = Policy.NATURAL, dim: int = 0,
            block: int | None = None, halo: int = 0,
            dtype=None) -> SegmentedArray:
    """Build this rank's container from the global array ``x`` (numpy,
    list or tensor), the same on every rank (MGPU ctor)."""
    if not isinstance(x, torch.Tensor):
        x = _canonical(np.asarray(x))
    nseg = comm.size
    layout, orig = physical_layout(x, nseg, policy, dim, block)
    mine = local_segment(layout, comm.rank, nseg, policy, dim)
    data = upload(mine, comm.device, dtype)
    return SegmentedArray(data, comm, policy, dim, tuple(layout.shape),
                          orig, block if policy is Policy.BLOCK else None,
                          halo if policy is Policy.OVERLAP2D else 0)


def gather(seg: SegmentedArray) -> torch.Tensor:
    """Materialize the logical array on every rank (an all-gather of the
    segments), the inverse of :func:`segment`: a tensor of its own,
    never the container's memory."""
    from .comm import all_gather_stack
    if seg.policy is Policy.CLONE:
        layout = seg.data.clone()
    else:
        stack = all_gather_stack(seg.data, seg.group)
        layout = torch.cat(list(stack.unbind(0)), dim=seg.dim)
    return logical_array(layout, seg.nseg, seg.policy, seg.dim,
                         seg.orig_len, seg.block)


def overlap2d_map(seg: SegmentedArray, fn: Callable | None):
    """Halo exchange + map over an OVERLAP2D container.

    Each rank's row block is extended by ``halo`` rows of each neighbour
    through the p2p path: two open-boundary ``shift``s (the last rows go
    to the next rank, the first rows to the previous one; the edge ranks
    receive zeros).  ``fn`` maps the extended block ``(rows + 2h, ...)
    -> (rows, ...)``.  ``fn=None`` returns the extended blocks
    themselves as a NATURAL container (MGPU's physically overlapped
    segments)."""
    if seg.policy is not Policy.OVERLAP2D:
        raise ValueError("overlap2d_map requires an OVERLAP2D container")
    from .comm import shift
    h = seg.halo
    xm = torch.movedim(seg.data, seg.dim, 0)
    if h:
        from_prev = shift(xm[-h:].contiguous(), +1, wrap=False,
                          comm=seg.comm)
        from_next = shift(xm[:h].contiguous(), -1, wrap=False,
                          comm=seg.comm)
        xm = torch.cat([from_prev, xm, from_next], dim=0)
    ext = torch.movedim(xm, 0, seg.dim)
    if fn is not None:
        return seg.with_data(fn(ext))
    shape = list(seg.global_shape)
    shape[seg.dim] = ext.shape[seg.dim] * seg.nseg
    return SegmentedArray(ext.contiguous(), seg.comm, Policy.NATURAL,
                          seg.dim, tuple(shape), shape[seg.dim])
