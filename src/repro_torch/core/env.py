"""The environment / communicator API (paper §2.1, §2.3).

The counterpart of ``repro.core.env``.  An MGPU program instantiates an
``environment`` and calls MPI-like methods bound to a device group:

  ``Environment``    one rank's entry into the group: built from an
                     explicit rank, world size, store and backend (there
                     is no cluster to discover), it initializes the
                     ``torch.distributed`` process group, picks this
                     rank's device and mints :class:`Communicator`
                     objects over a mesh of named axes (``group``), the
                     first ranks (``subgroup``) or the ranks that are
                     left after a loss (``survivor``);
  ``Communicator``   a group-bound object whose methods are the verbs:
                     ``container``/``bcast``/``scatter``/``gather``/
                     ``allgather``/``reduce``/``allreduce``/
                     ``allreduce_window``/``allreduce_overlap``/
                     ``reduce_scatter``/``alltoall``/``copy``/``vdot``,
                     point to point (``send_recv``/``shift``),
                     synchronization (``barrier``/``fence``/
                     ``barrier_fence``), the kernel launchers
                     (``invoke``/``invoke_all``) and ``spmd``, the launch
                     point that segments global inputs by policy, runs
                     the shard-local function and wraps its outputs.

Every rank runs the same program: each passes the same global inputs to
``container`` and keeps its own segment.  A 1-rank communicator without
a process group runs it with no-op collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Callable

import torch
import torch.distributed as dist

from ..device import rank_device
from . import comm as _comm
from . import invoke as _invoke
from . import sync as _sync
from .runtime import AXIS, BACKENDS, DeviceGroup
from .segmented import Policy, SegmentedArray, segment

DEFAULT_TIMEOUT_S = 300.0

# Fault-injection hook on verb dispatch (the fault-tolerance layer
# installs it; the core never imports that layer).  Called as
# ``payload = VERB_HOOK(verb_name, payload)`` at the entry of the
# payload-carrying verbs (container, bcast, scatter, gather, the eager
# allreduce, copy): it may return the payload (changed or not), sleep (a
# straggling link) or raise (a transfer failure, a lost rank).  ``None``
# costs one attribute read a call.
VERB_HOOK = None


def _fire_verb(name, payload):
    hook = VERB_HOOK
    return payload if hook is None else hook(name, payload)


class Environment:
    """One rank's entry into a group of ``world_size`` ranks on one host.

    ``backend`` is the caller's explicit choice: ``"nccl"`` when every
    rank has its own card, ``"gloo"`` on the CPU (``device="cpu"``) or
    when the ranks share one card (``shared_card=True``); it is checked,
    never swapped.  ``store`` is a ``torch.distributed`` store every rank
    opens (a ``FileStore`` of one path, say).  With ``world_size == 1``
    and no backend there is no process group; with a backend even one
    rank gets one (to exercise the backend).  Collectives wait at most
    ``timeout`` seconds before they raise."""

    def __init__(self, rank: int = 0, world_size: int = 1, *, store=None,
                 backend: str | None = None, device=None,
                 shared_card: bool = False,
                 timeout: float = DEFAULT_TIMEOUT_S):
        if world_size > 1 and backend is None:
            raise ValueError(f"{world_size} ranks need a backend "
                             f"({' or '.join(BACKENDS)})")
        self.rank, self.world_size = rank, world_size
        self.shared_card = shared_card
        self.device = rank_device(rank, shared=shared_card, device=device)
        if backend is not None:
            if backend not in BACKENDS:
                raise ValueError(f"backend must be one of {BACKENDS}")
            if backend == "nccl" and (self.device.type != "cuda"
                                      or (shared_card and world_size > 1)):
                raise ValueError("nccl needs a card of its own for every "
                                 "rank; ranks on the CPU or sharing one "
                                 "card use gloo")
            if store is None:
                raise ValueError("a process group needs a store")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.backend = backend
        self._pg = None
        if backend is not None:
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout))
            self._pg = dist.group.WORLD
            if world_size > 1:
                # every rank's connections are up before any rank goes on:
                # a rank that closed the group while a peer was still
                # connecting would fail that peer's setup
                dist.barrier(device_ids=[self.device.index]
                             if backend == "nccl" else None)

    def __repr__(self) -> str:
        return (f"Environment(rank {self.rank} of {self.world_size}, "
                f"{self.device}, backend={self.backend})")

    # -- communicator constructors ----------------------------------------
    @property
    def world(self) -> "Communicator":
        """Communicator over every rank (MPI_COMM_WORLD)."""
        return Communicator(DeviceGroup(self.rank, self.world_size,
                                        self.device, self.backend, self._pg,
                                        self.shared_card))

    def group(self, shape=None, axes=(AXIS,)) -> "Communicator | None":
        """Communicator over the first ``prod(shape)`` ranks as a mesh of
        named axes, row-major (default: every rank on one ``"data"``
        axis).  A ``(2, 2)`` ``("pod", "data")`` group over 4 ranks has
        rank ``pod * 2 + data``; ``"pod"`` is a DCN axis, so
        ``hierarchical`` sums stage over it.  Every rank of the world
        must call it with the same arguments (the axes' process groups
        are made by every rank, in one order); ranks outside get
        ``None``.

        >>> Environment(device="cpu").group((1,)).size
        1
        """
        if shape is None:
            shape = (self.world_size,)
        if isinstance(shape, int):
            shape = (shape,)
        shape, axes = tuple(shape), tuple(axes)
        if shape == (self.world_size,) and axes == (AXIS,):
            return self.world
        if not dist.is_initialized():
            if math.prod(shape) != 1:
                raise ValueError(f"mesh shape {shape} needs "
                                 f"{math.prod(shape)} ranks, the "
                                 f"environment has {self.world_size}")
            return Communicator(DeviceGroup(0, 1, self.device, shape=shape,
                                            axes=axes))
        group = DeviceGroup.mesh(shape, axes, self.device,
                                 shared_card=self.shared_card)
        return None if group is None else Communicator(group)

    def subgroup(self, n: int, axes=(AXIS,)) -> "Communicator | None":
        """Communicator over the first ``n`` ranks on one axis; every
        rank must call it, and ranks outside get ``None``."""
        return self.group((n,), axes)

    def survivor(self, comm: "Communicator",
                 lost=()) -> "Communicator | None":
        """A Communicator over ``comm``'s ranks minus the ``lost`` ones
        (group ranks): the elastic remesh after a lost rank.  Only the
        ranks that are kept make its process group, so a lost rank need
        not take part; a lost rank gets ``None``.  One-axis groups only
        (the survivor of a mesh has no canonical shape).

        >>> env = Environment(device="cpu")
        >>> env.survivor(env.subgroup(1)).size     # nobody lost
        1
        """
        if len(comm.group.axes) > 1:
            raise ValueError(f"survivor() supports 1-D groups; got axes "
                             f"{comm.group.axes}")
        gone = {int(r) for r in lost}
        bad = [r for r in gone if not 0 <= r < comm.size]
        if bad:
            raise ValueError(f"lost ranks {bad} are not in a group of "
                             f"{comm.size}")
        keep = [r for r in range(comm.size) if r not in gone]
        if not keep:
            raise ValueError("no surviving ranks in the group")
        if not gone:
            return comm
        if comm.rank in gone:
            return None
        g = comm.group
        if len(keep) == 1:
            return Communicator(DeviceGroup(0, 1, g.device, axes=g.axes))
        pg = dist.new_group([g.global_rank(r) for r in keep],
                            backend=g.backend,
                            use_local_synchronization=True)
        return Communicator(DeviceGroup(keep.index(comm.rank), len(keep),
                                        g.device, g.backend, pg,
                                        g.shared_card, axes=g.axes))

    def close(self) -> None:
        """Tear the process group down (every rank calls it)."""
        if self._pg is not None:
            dist.destroy_process_group()
            self._pg = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass(frozen=True, eq=False)
class Communicator:
    """Group-bound MPI-like verbs (the paper's communication methods)."""

    group: DeviceGroup

    # -- queries ----------------------------------------------------------
    @classmethod
    def single(cls, device=None) -> "Communicator":
        """One rank on ``device`` (the card unless ``"cpu"``), no process
        group."""
        return cls(DeviceGroup.single(device))

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def backend(self) -> str | None:
        return self.group.backend

    def __repr__(self) -> str:
        return (f"Communicator(rank {self.rank} of {self.size}, "
                f"{self.device}, backend={self.backend})")

    # -- containers (paper §2.2: the ctor controls the split) -------------
    def container(self, x, *, policy: Policy = Policy.NATURAL, dim: int = 0,
                  block: int | None = None, halo: int = 0,
                  dtype=None) -> SegmentedArray:
        """This rank's container of the global array ``x`` (the same on
        every rank).

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([[1., 2.], [3., 4.]])
        >>> (seg.policy, seg.dim, seg.global_shape)
        (<Policy.NATURAL: 'natural'>, 0, (2, 2))
        """
        x = _fire_verb("container", x)
        return segment(x, self, policy=policy, dim=dim, block=block,
                       halo=halo, dtype=dtype)

    # -- collectives (paper §2.3, Fig. 3) ---------------------------------
    def bcast(self, x, *, src: int = 0) -> SegmentedArray:
        """Rank ``src``'s array on every rank (-> CLONE container).

        >>> Communicator.single("cpu").bcast([1., 2., 3.]).policy
        <Policy.CLONE: 'clone'>
        """
        x = _fire_verb("bcast", x)
        return _comm.broadcast(x, self, src=src)

    def scatter(self, x, *, policy: Policy = Policy.NATURAL, dim: int = 0,
                block: int | None = None, halo: int = 0,
                src: int = 0) -> SegmentedArray:
        """Split rank ``src``'s array across the group (the other ranks
        may pass ``None``).

        >>> comm = Communicator.single("cpu")
        >>> comm.scatter([[1., 2.], [3., 4.]], dim=1).seg_len(0)
        2
        """
        x = _fire_verb("scatter", x)
        return _comm.scatter(x, self, policy=policy, dim=dim, block=block,
                             halo=halo, src=src)

    def gather(self, seg: SegmentedArray) -> torch.Tensor:
        """The logical array of a container, on every rank.

        >>> comm = Communicator.single("cpu")
        >>> comm.gather(comm.container([1., 2., 3.])).tolist()
        [1.0, 2.0, 3.0]
        """
        seg = _fire_verb("gather", seg)
        return _comm.gather(seg)

    def allgather(self, x, *, dim: int | None = None):
        """MPI_Allgather: a container -> CLONE container of its logical
        array; a local tensor -> every rank's, concatenated along
        ``dim``.

        >>> comm = Communicator.single("cpu")
        >>> full = comm.allgather(comm.container([1., 2., 3., 4.]))
        >>> (full.policy, full.data.tolist())
        (<Policy.CLONE: 'clone'>, [1.0, 2.0, 3.0, 4.0])
        """
        return _comm.all_gather(x, dim=dim, comm=self)

    def reduce(self, seg: SegmentedArray, op: str = "sum") -> torch.Tensor:
        """Merge the segments elementwise (the segmented dim is reduced).

        >>> comm = Communicator.single("cpu")
        >>> comm.reduce(comm.container([[1., 2.], [3., 4.]])).tolist()
        [4.0, 6.0]
        """
        return _comm.reduce(seg, op)

    def allreduce(self, x, op: str = "sum", *, hierarchical: bool = False,
                  p2p: bool = False):
        """Reduce + replicate: a container -> CLONE container; a local
        tensor -> the group's ``op`` of it.  ``p2p=True`` runs the ring
        of ``shift``s, ``hierarchical=True`` the sum staged over the
        ICI and DCN axes.

        >>> comm = Communicator.single("cpu")
        >>> tot = comm.allreduce(comm.container([[1., 2.], [3., 4.]]))
        >>> (tot.policy, tot.data.tolist())
        (<Policy.CLONE: 'clone'>, [4.0, 6.0])
        """
        if isinstance(x, SegmentedArray):
            x = _fire_verb("allreduce", x)
        return _comm.all_reduce_window(x, None, op=op,
                                       hierarchical=hierarchical, p2p=p2p,
                                       comm=self)

    def allreduce_window(self, x, window=None, *, op: str = "sum",
                         reduce_dim: int | None = None,
                         hierarchical: bool = False, window_axes=None,
                         p2p: bool = False):
        """Windowed all-reduce (``comm.all_reduce_window``): only the
        window goes on the wire, scattered back into zeros.

        >>> import numpy as np
        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container(np.ones((2, 4, 4), np.float32))
        >>> comm.allreduce_window(seg, ((1, 3), (1, 3))).data[:, 1].tolist()
        [0.0, 2.0, 2.0, 0.0]
        """
        return _comm.all_reduce_window(x, window, op=op,
                                       reduce_dim=reduce_dim,
                                       window_axes=window_axes,
                                       hierarchical=hierarchical, p2p=p2p,
                                       comm=self)

    def allreduce_overlap(self, x, window=None, *, op: str = "sum",
                          reduce_dim: int | None = None, window_axes=None,
                          extras: tuple = (), compute=None,
                          p2p: bool = False, chunks: int = 2,
                          hierarchical: bool = False, mask=None,
                          impl: str = "auto", block=None):
        """Windowed all-reduce with piggybacked scalars and the caller's
        compute overlapped (``comm.all_reduce_overlap``: the psum,
        gathered, ``p2p`` ring and ``hierarchical`` schedules), on this
        rank's local tensor.  Returns ``(reduced, extras_out,
        compute_out)``; ``block`` is the ``masked_sum`` kernel's.

        >>> import torch
        >>> comm = Communicator.single("cpu")
        >>> red, ex, out = comm.allreduce_overlap(
        ...     torch.ones((4, 4)), ((1, 3), (1, 3)),
        ...     extras=(torch.tensor(2.0),), compute=lambda: torch.ones(2))
        >>> (red[1].tolist(), float(ex[0]), out.tolist())
        ([0.0, 1.0, 1.0, 0.0], 2.0, [1.0, 1.0])
        """
        if isinstance(x, SegmentedArray):
            raise TypeError("allreduce_overlap takes this rank's local "
                            "tensor; for containers use allreduce_window")
        return _comm.all_reduce_overlap(
            x, window, op=op, reduce_dim=reduce_dim,
            window_axes=window_axes, extras=extras, compute=compute,
            mask=mask, p2p=p2p, chunks=chunks, hierarchical=hierarchical,
            comm=self, impl=impl, block=block)

    def reduce_scatter(self, seg: SegmentedArray,
                       op: str = "sum") -> SegmentedArray:
        """MPI_Reduce_scatter: reduce the segments, leave the result
        segmented along dim 0 of the merged array.

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([[1., 2.], [3., 4.]])
        >>> comm.reduce_scatter(seg).gather().tolist()
        [4.0, 6.0]
        """
        return _comm.reduce_scatter(seg, op)

    def alltoall(self, seg: SegmentedArray, new_dim: int) -> SegmentedArray:
        """MPI_Alltoall: re-segment a container onto another dim.

        >>> import numpy as np
        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container(np.zeros((4, 6), np.float32))
        >>> comm.alltoall(seg, 1).dim
        1
        """
        return _comm.all_to_all(seg, new_dim)

    def copy(self, seg: SegmentedArray, *, policy: Policy | None = None,
             **kw) -> SegmentedArray:
        """Segmented-to-segmented copy / re-segmentation (Fig. 3), by the
        route ``comm.copy_route`` names.

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([1., 2., 3., 4.])
        >>> comm.copy(seg, policy=Policy.CLONE).policy
        <Policy.CLONE: 'clone'>
        """
        seg = _fire_verb("copy", seg)
        return _comm.copy(seg, policy=policy, **kw)

    def vdot(self, x, y, *, policies=None, batched: bool = False):
        """Segmented inner product over mixed CLONE/NATURAL pytrees;
        ``batched``: one product a row of a leading batch (``comm.vdot``).

        >>> comm = Communicator.single("cpu")
        >>> float(comm.vdot(comm.container([1., 2.]),
        ...                 comm.container([3., 4.])))
        11.0
        """
        return _comm.vdot(x, y, policies=policies, comm=self,
                          batched=batched)

    # -- point to point (the paper's P2P transfer path) -------------------
    def send_recv(self, x, perm):
        """Ship rank ``src``'s segment to rank ``dst`` for every
        ``(src, dst)`` pair; ranks nothing is sent to receive zeros.

        >>> comm = Communicator.single("cpu")
        >>> comm.send_recv(comm.container([5., 6.]), [(0, 0)]).gather().tolist()
        [5.0, 6.0]
        """
        return _comm.send_recv(x, perm, comm=self)

    def shift(self, x, offset: int = 1, *, wrap: bool = True):
        """Ring shift by ``offset`` (``wrap=False``: edges get zeros).

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([5., 6.])
        >>> comm.shift(seg, 1).gather().tolist()
        [5.0, 6.0]
        >>> comm.shift(seg, 1, wrap=False).gather().tolist()
        [0.0, 0.0]
        """
        return _comm.shift(x, offset, wrap=wrap, comm=self)

    # -- synchronization (paper §2.5) -------------------------------------
    def barrier(self) -> None:
        """Every rank of the group reaches this point."""
        _sync.barrier(self.group)

    def fence(self, *tensors):
        """Host-block until the given tensors are computed."""
        return _sync.fence(*tensors)

    def barrier_fence(self, *tensors):
        """Fence, then barrier: the paper's strongest primitive."""
        return _sync.barrier_fence(*tensors, group=self.group)

    # -- kernel launch (paper §2.5) ---------------------------------------
    def invoke(self, fn: Callable, *args, rank: int, **kw):
        """Launch ``fn`` in the context of one rank of the group: every
        rank runs it, the other ranks' segments of the result are zeros.

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([1., 2.])
        >>> comm.invoke(lambda xl: xl * 10, seg, rank=0).gather().tolist()
        [10.0, 20.0]
        """
        return _invoke.invoke_kernel(fn, *args, rank=rank, comm=self, **kw)

    def invoke_all(self, fn: Callable, *args, **kw):
        """Launch ``fn`` on every rank: segmented arguments arrive as this
        rank's segment, plain arrays whole.

        >>> comm = Communicator.single("cpu")
        >>> seg = comm.container([1., 2.])
        >>> comm.invoke_all(lambda xl: xl + 1, seg).gather().tolist()
        [2.0, 3.0]
        """
        return _invoke.invoke_kernel_all(fn, *args, comm=self, **kw)

    # -- the launch point (paper §2.5) ------------------------------------
    def spmd(self, fn: Callable, *, in_policies, out_policies) -> Callable:
        """An SPMD program from segmentation policies: the returned
        function takes the global inputs (the same on every rank),
        builds this rank's container of each by its policy (a
        ``Policy``, a ``(Policy, dim)`` pair, or a dict of them for a
        dict input), runs ``fn`` on the local segments and wraps its
        outputs as containers by ``out_policies``.

        >>> import torch
        >>> comm = Communicator.single("cpu")
        >>> prog = comm.spmd(lambda xl: 2 * xl,
        ...                  in_policies=(Policy.NATURAL,),
        ...                  out_policies=Policy.NATURAL)
        >>> prog(torch.arange(2.0)).gather().tolist()
        [0.0, 2.0]
        """
        def run(*args):
            if len(args) != len(in_policies):
                raise ValueError(f"{len(args)} inputs for "
                                 f"{len(in_policies)} policies")
            local = [_map(lambda a, p: self.container(
                a, policy=p[0], dim=p[1]).data, a, pol)
                for a, pol in zip(args, in_policies)]
            return _map(self._wrap, fn(*local), out_policies)

        return run

    def _wrap(self, data: torch.Tensor, pol) -> SegmentedArray:
        policy, dim = pol
        shape = list(data.shape)
        if policy is not Policy.CLONE:
            shape[dim] *= self.size
        return SegmentedArray(data, self, policy, dim, tuple(shape))


def _is_leaf_policy(p) -> bool:
    """A ``Policy``, or a ``(Policy, dim)`` pair."""
    return isinstance(p, Policy) or (
        isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], Policy)
        and isinstance(p[1], int))


def _map(f, value, policy):
    """``f(leaf, (Policy, dim))`` over a value and a matching policy
    tree: a dict policy maps a dict value, a tuple of policies a tuple
    value."""
    if isinstance(policy, dict):
        return {k: _map(f, value[k], policy[k]) for k in policy}
    if not _is_leaf_policy(policy):
        return tuple(_map(f, v, p) for v, p in zip(value, policy))
    return f(value, policy if isinstance(policy, tuple) else (policy, 0))
