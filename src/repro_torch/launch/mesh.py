"""Meshes of ranks for sharded steps, the port of ``repro/launch/mesh.py``.

A mesh is a ``Communicator`` (or its ``DeviceGroup``) of named axes from
``Environment.group(shape, axes)``: ``("data", "model")``, or ``("pod",
"data", "model")`` across pods.  :func:`mesh_axes` names its FSDP and TP
axes, and :func:`expert_pad_for` the expert padding that lets an MoE
config's expert stacks split over the TP axis (``launch/cells.py:37`` of
the JAX package).

:func:`make_production_mesh` is the dry run's mesh: one rank of an H100
cluster as a dry ``Communicator`` (``DeviceGroup.dry``: no processes, the
meta device).  The JAX module's is a v5e pod of 16 x 16 chips (2 pods
over DCN); the port keeps its card counts, 256 and 512, and puts the
tensor-parallel axis inside a node: ``("data", "model")`` = (32, 8), 32
nodes of 8 cards, and ``("pod", "data", "model")`` = (2, 32, 8).  A model
axis of 16 would span two nodes, and NVLink joins only the 8 cards of a
node (``core.runtime.HW["cards_per_node"]``).
"""

from __future__ import annotations

from ..core.env import Communicator
from ..core.runtime import HW, DeviceGroup

NODE = HW["cards_per_node"]
SINGLE = (32, NODE)                 # 256 cards: 32 nodes of 8
MULTI = (2, 32, NODE)               # 512 cards: 2 pods of 32 nodes


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> Communicator:
    """Rank ``rank`` of the production mesh, dry: ``("data", "model")`` =
    (32, 8), or with ``multi_pod`` ``("pod", "data", "model")`` = (2, 32,
    8)."""
    shape = MULTI if multi_pod else SINGLE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Communicator(DeviceGroup.dry(shape, axes, rank))


def _mesh_shape(mesh) -> dict[str, int]:
    return getattr(mesh, "group", mesh).mesh_shape


def mesh_axes(mesh) -> tuple[tuple[str, ...], str | None]:
    """``(fsdp, tp)``: the data axes present (``"pod"``, ``"data"``) and
    ``"model"`` when the mesh has it."""
    names = tuple(_mesh_shape(mesh))
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return fsdp, tp


def expert_pad_for(cfg, mesh) -> int:
    """The model axis's size when an MoE config's expert count does not
    divide it (``init_params(expert_pad=)``), else 1."""
    tpn = _mesh_shape(mesh).get("model", 1)
    return tpn if (cfg.n_experts and cfg.n_experts % tpn) else 1
