"""Meshes of ranks for sharded steps, the port of ``repro/launch/mesh.py``.

A mesh is a ``Communicator`` (or its ``DeviceGroup``) of named axes from
``Environment.group(shape, axes)``: ``("data", "model")``, or ``("pod",
"data", "model")`` across pods.  :func:`mesh_axes` names its FSDP and TP
axes, and :func:`expert_pad_for` the expert padding that lets an MoE
config's expert stacks split over the TP axis (``launch/cells.py:37`` of
the JAX package).  The JAX module's ``make_production_mesh`` builds a v5e
pod of 16 x 16 chips for the dry run; it goes with the dry-run tooling
(ROADMAP Queue 1).
"""

from __future__ import annotations


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
