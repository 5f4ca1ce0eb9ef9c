"""Device groups over ``torch.distributed``: the MGPU ``dev_group``.

The counterpart of ``repro.core.runtime``.  The JAX package holds every
device of a named-axis mesh in one program; the port runs one process per
rank, and a :class:`DeviceGroup` is what one rank knows of its group: its
rank, the group's size, its own ``torch.device``, the backend and the
explicit process group the collectives run on.  The group is a mesh of
named axes laid out in row-major order, as the JAX mesh is: a ``(2, 2)``
``("pod", "data")`` group over 4 ranks has rank ``pod * 2 + data``.  By
default it has one axis, ``"data"``, the axis the NLINV coils split
over.  Each axis of a mesh has a process group per line of ranks along
it (:meth:`DeviceGroup.sub`); axes named in ``DCN_AXES`` are the slow,
cross-node ones (the paper's cross-IOH boundary), the others ICI.

The backend is the caller's choice, never swapped after a failure:
``"nccl"`` when every rank has its own card, ``"gloo"`` on the CPU or when
ranks share one card (NCCL refuses two ranks on one card).  A dry group
(backend ``"dry"``, :meth:`DeviceGroup.dry`) is one rank's place on a
mesh with no process behind the others, on the ``meta`` device: its
collectives note themselves in ``core.comm.record()`` and return results
of the shape a real group gives, so that one rank's step of a large mesh
is traced without a process group (``launch.dryrun``).  Gloo takes
CUDA tensors in three collectives only (``GLOO_CARD_VERBS``); with gloo
on the card the other verbs stage their tensors through the host
(:meth:`DeviceGroup.transport`), by rule, never as a retry.  A 1-rank
group needs no process group (``pg=None``): its collectives are no-ops,
so it runs the same program as N ranks (design rule 2 of
``docs/architecture.md``).  ``HW`` is the hardware table, as the JAX
module's (a TPU's there): here one NVIDIA H100's published rates, which
``launch.roofline`` reads (the kernels' bounds read the same rates).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import registry as _kreg

AXIS = "data"
BACKENDS = ("gloo", "nccl")
DRY = "dry"          # the backend of a mesh with no processes (meta device)
# axis names that cross the slow inter-node link rather than the fast one
DCN_AXES = ("pod",)
# the collectives gloo runs on CUDA tensors; with gloo on the card every
# other verb (send_recv, reduce_scatter, all_to_all, scatter) goes
# through the host
GLOO_CARD_VERBS = ("all_reduce", "all_gather", "broadcast")

# One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, the published
# dense rates of NVIDIA's data sheet (the kernel registry's): HBM bytes/s,
# bf16 tensor-core and float32 (outside the tensor cores) FLOP/s, and
# NVLink 4 bytes/s a direction (900 GB/s both ways) among the 8 cards of
# a node; between nodes a DGX H100 node has 8 ConnectX-7 ports of 400
# Gb/s, 50 GB/s a card a direction (NVIDIA DGX H100 data sheet).
# ``hbm_bytes`` is the card's memory as
# ``torch.cuda.get_device_properties(0).total_memory`` reads it on an H100
# 80GB HBM3 at 700 W.  A card set below 700 W runs slower.
HW = dict(name="NVIDIA H100 80GB HBM3", power_limit_w=700.0,
          hbm_bw=_kreg.H100_BYTES_PER_S,
          peak_flops_bf16=_kreg.H100_BF16_FLOPS,
          peak_flops_f32=_kreg.H100_F32_FLOPS, nvlink_bw=450e9,
          cards_per_node=8, net_bw=50e9, hbm_bytes=85_017_493_504)


@dataclasses.dataclass(frozen=True)
class DryLine:
    """The process group of a dry group's line: the global ranks it
    holds, and nothing to run on."""

    ranks: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGroup:
    """This rank's view of a group of ranks (MGPU ``dev_group``)."""

    rank: int
    size: int
    device: torch.device
    backend: str | None = None    # None: one rank without a process group
    pg: object = None             # the torch.distributed process group
    shared_card: bool = False     # every rank of the group on one card
    shape: tuple = ()             # extent of each axis; () is (size,)
    axes: tuple = (AXIS,)         # the axes' names, major to minor
    # axis name -> the process group of this rank's line along that axis
    # (axes of extent 1 have none)
    axis_pgs: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of "
                             f"{self.size}")
        if (self.pg is None) != (self.backend is None):
            raise ValueError("a process group and its backend come together")
        if self.pg is None and self.size > 1:
            raise ValueError(f"a group of {self.size} ranks needs a process "
                             f"group")
        if self.backend is not None and self.backend not in BACKENDS + (
                DRY,):
            raise ValueError(f"backend must be one of {BACKENDS}, not "
                             f"{self.backend!r}")
        object.__setattr__(self, "device", torch.device(self.device))
        shape = tuple(int(n) for n in (self.shape or (self.size,)))
        axes = tuple(self.axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"match")
        if math.prod(shape) != self.size:
            raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                             f"ranks, the group {self.size}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axes", axes)

    # -- constructors -----------------------------------------------------
    @classmethod
    def single(cls, device=None) -> "DeviceGroup":
        """One rank on ``device`` (the card unless ``"cpu"``), no process
        group: the degenerate group whose collectives are no-ops."""
        from ..device import resolve_device
        return cls(0, 1, resolve_device(device))

    @classmethod
    def all_devices(cls, device=None, *,
                    shared_card: bool = False) -> "DeviceGroup":
        """Every rank of the default process group, or one rank when none
        is initialized.  ``device`` and ``shared_card`` as for
        :func:`repro_torch.device.rank_device`."""
        if not dist.is_initialized():
            return cls.single(device)
        from ..device import rank_device
        rank = dist.get_rank()
        return cls(rank, dist.get_world_size(),
                   rank_device(rank, shared=shared_card, device=device),
                   dist.get_backend(), dist.group.WORLD, shared_card)

    @classmethod
    def subset(cls, n: int, device=None, *,
               shared_card: bool = False) -> "DeviceGroup | None":
        """The first ``n`` ranks of the default process group on one
        ``"data"`` axis (MGPU ``dev_group`` ctor).  Every rank of the world
        must call it (a new process group is collective); ranks outside
        the subset get ``None``.  ``n = 1`` needs no process group."""
        return cls.mesh((n,), (AXIS,), device, shared_card=shared_card)

    @classmethod
    def mesh(cls, shape, axes=(AXIS,), device=None, *,
             shared_card: bool = False) -> "DeviceGroup | None":
        """The first ``prod(shape)`` ranks of the default process group as
        a mesh of named axes, row-major.  Every rank of the world must
        call it with the same arguments: it makes the group's process
        group and one per line of every axis, in one order on every rank
        (``dist.new_group`` is collective over the world, so a rank that
        skipped one would leave the others waiting).  Ranks outside the
        mesh get ``None``."""
        shape = tuple(int(k) for k in shape)
        axes = tuple(axes)
        n = math.prod(shape)
        world = cls.all_devices(device, shared_card=shared_card)
        if not 1 <= n <= world.size:
            raise ValueError(f"mesh shape {shape} needs {n} ranks, the "
                             f"world has {world.size}")
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"match")
        if n == 1:
            if world.rank != 0:
                return None
            return cls(0, 1, world.device, shape=shape, axes=axes)
        pg = world.pg if n == world.size else \
            dist.new_group(list(range(n)), backend=world.backend)
        ids = np.arange(n).reshape(shape)
        axis_pgs = {}
        for i, ax in enumerate(axes):
            if shape[i] == 1 or len(axes) == 1:
                continue
            lines = np.moveaxis(ids, i, -1).reshape(-1, shape[i])
            for line in lines:
                sub = dist.new_group([int(r) for r in line],
                                     backend=world.backend)
                if world.rank in line:
                    axis_pgs[ax] = sub
        if world.rank >= n:
            return None
        return cls(world.rank, n, world.device, world.backend, pg,
                   shared_card, shape, axes, axis_pgs)

    @classmethod
    def dry(cls, shape, axes, rank: int = 0) -> "DeviceGroup":
        """Rank ``rank`` of a mesh of named axes with no process group
        behind it, on the ``meta`` device (backend ``"dry"``): each of its
        lines has a :class:`DryLine` of the global ranks it holds.  Its
        collectives return results of the shapes a real group's give,
        with no values, and note themselves in ``core.comm.record()``."""
        shape = tuple(int(k) for k in shape)
        axes = tuple(axes)
        n = math.prod(shape)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"match")
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} outside a mesh of {n}")
        meta = torch.device("meta")
        if n == 1:
            return cls(0, 1, meta, shape=shape, axes=axes)
        ids = np.arange(n).reshape(shape)
        coords = np.unravel_index(rank, shape)
        axis_pgs = {}
        for i, ax in enumerate(axes):
            if shape[i] == 1 or len(axes) == 1:
                continue
            line = ids[tuple(slice(None) if j == i else coords[j]
                             for j in range(len(axes)))]
            axis_pgs[ax] = DryLine(tuple(int(r) for r in line))
        return cls(rank, n, meta, DRY, DryLine(tuple(range(n))), False,
                   shape, axes, axis_pgs)

    # -- queries ----------------------------------------------------------
    @property
    def is_dry(self) -> bool:
        return self.backend == DRY

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.axes

    @property
    def mesh_shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.shape))

    @property
    def ici_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a not in DCN_AXES)

    @property
    def dcn_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in DCN_AXES)

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's index on each axis (row-major)."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def axis_size(self, *axes: str) -> int:
        bad = [a for a in axes if a not in self.axes]
        if bad:
            raise ValueError(f"the group's axes are {self.axes}, not {bad}")
        return math.prod(self.mesh_shape[a] for a in axes)

    def sub(self, *axes: str) -> "DeviceGroup":
        """The group of the ranks that share this rank's place on the
        other axes: its line along one axis, or the whole group for all
        of them.  Its rank is this rank's index on that axis."""
        if set(axes) == set(self.axes):
            return self
        if len(axes) != 1:
            raise ValueError(f"a sub-group runs along one axis or all of "
                             f"{self.axes}, not {axes}")
        (ax,) = axes
        i = self.axes.index(ax)
        n = self.shape[i]
        if n == 1:
            return DeviceGroup(0, 1, self.device, axes=(ax,))
        return DeviceGroup(self.coords[i], n, self.device, self.backend,
                           self.axis_pgs[ax], self.shared_card, (n,), (ax,))

    @property
    def unified_memory(self) -> bool:
        """True when the ranks share one memory domain: the CPU, or one
        card shared by every rank."""
        return self.device.type == "cpu" or self.shared_card

    def transport(self, verb: str) -> str:
        """How a collective ``verb`` moves its tensors: ``"device"``
        (they go to the backend where they lie) or ``"host-staged"``
        (gloo with CUDA tensors, a verb outside ``GLOO_CARD_VERBS``:
        copied to the host, sent, copied back)."""
        if (self.backend == "gloo" and self.device.type == "cuda"
                and verb not in GLOO_CARD_VERBS):
            return "host-staged"
        return "device"

    @property
    def p2p_transport(self) -> str:
        """How ``send_recv``/``shift`` move a segment (``transport``)."""
        return self.transport("send_recv")

    @property
    def ranks(self) -> tuple[int, ...]:
        """Global ranks of the group's members."""
        if self.pg is None:
            return (self.rank,)
        if self.is_dry:
            return self.pg.ranks
        return tuple(dist.get_process_group_ranks(self.pg))

    def global_rank(self, group_rank: int) -> int:
        return self.ranks[group_rank] if self.pg is not None else group_rank

    def __repr__(self) -> str:
        mesh = "" if self.axes == (AXIS,) else f", mesh={self.mesh_shape}"
        return (f"DeviceGroup(rank={self.rank}/{self.size}, "
                f"device={self.device}, backend={self.backend}{mesh})")
