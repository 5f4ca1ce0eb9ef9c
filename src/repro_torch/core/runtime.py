"""Device groups over ``torch.distributed``: the MGPU ``dev_group``.

The counterpart of ``repro.core.runtime``.  The JAX package holds every
device of a named-axis mesh in one program; the port runs one process per
rank, and a :class:`DeviceGroup` is what one rank knows of its group: its
rank, the group's size, its own ``torch.device``, the backend and the
explicit process group the collectives run on.  There is one axis,
``"data"``, the axis the NLINV coils split over.

The backend is the caller's choice, never swapped after a failure:
``"nccl"`` when every rank has its own card, ``"gloo"`` on the CPU or when
ranks share one card (NCCL refuses two ranks on one card).  A 1-rank
group needs no process group (``pg=None``): its collectives are no-ops,
so it runs the same program as N ranks (design rule 2 of
``docs/architecture.md``).  The TPU hardware table of the JAX module is
left out; the port's bounds come from the kernel registry's H100
constants.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

AXIS = "data"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGroup:
    """This rank's view of a group of ranks (MGPU ``dev_group``)."""

    rank: int
    size: int
    device: torch.device
    backend: str | None = None    # None: one rank without a process group
    pg: object = None             # the torch.distributed process group
    shared_card: bool = False     # every rank of the group on one card

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of "
                             f"{self.size}")
        if (self.pg is None) != (self.backend is None):
            raise ValueError("a process group and its backend come together")
        if self.pg is None and self.size > 1:
            raise ValueError(f"a group of {self.size} ranks needs a process "
                             f"group")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not "
                             f"{self.backend!r}")
        object.__setattr__(self, "device", torch.device(self.device))

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
        """The first ``n`` ranks of the default process group (MGPU
        ``dev_group`` ctor).  Every rank of the world must call it (a new
        process group is collective); ranks outside the subset get
        ``None``.  ``n = 1`` needs no process group."""
        world = cls.all_devices(device, shared_card=shared_card)
        if not 1 <= n <= world.size:
            raise ValueError(f"requested {n} ranks, the world has "
                             f"{world.size}")
        if n == world.size:
            return world
        if n == 1:
            return cls(0, 1, world.device) if world.rank == 0 else None
        pg = dist.new_group(list(range(n)), backend=world.backend)
        if world.rank >= n:
            return None
        return cls(world.rank, n, world.device, world.backend, pg,
                   shared_card)

    # -- queries ----------------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return (AXIS,)

    def axis_size(self, *axes: str) -> int:
        bad = [a for a in axes if a != AXIS]
        if bad:
            raise ValueError(f"the group has one axis {AXIS!r}, not {bad}")
        return self.size

    @property
    def unified_memory(self) -> bool:
        """True when the ranks share one memory domain: the CPU, or one
        card shared by every rank."""
        return self.device.type == "cpu" or self.shared_card

    @property
    def p2p_transport(self) -> str:
        """How ``send_recv``/``shift`` move a segment: ``"device"``
        (tensors go to the backend where they lie) or ``"host-staged"``
        (gloo with CUDA tensors: copied to the host, sent, copied back)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "host-staged"
        return "device"

    @property
    def ranks(self) -> tuple[int, ...]:
        """Global ranks of the group's members."""
        if self.pg is None:
            return (self.rank,)
        return tuple(dist.get_process_group_ranks(self.pg))

    def global_rank(self, group_rank: int) -> int:
        return self.ranks[group_rank] if self.pg is not None else group_rank

    def __repr__(self) -> str:
        return (f"DeviceGroup(rank={self.rank}/{self.size}, "
                f"device={self.device}, backend={self.backend})")
