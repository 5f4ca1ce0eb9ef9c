"""Roofline terms of a run of the port against one NVIDIA H100, the port of
``repro/launch/roofline.py``.

  compute term    = FLOPs / the card's peak for their type
  memory term     = bytes / HBM bandwidth
  collective term = wire bytes a rank (ring model) / its link's rate

The JAX package reads its collectives out of a compiled cell's HLO text
(``parse_collectives``).  The port compiles no HLO, so there is nothing
to parse and no ``parse_collectives``: its collectives record themselves
(``core.comm.record()``, one entry a call: ``kind``, ``bytes``, ``group``)
and :func:`collectives` prices those entries.  Each entry's wire traffic
takes the JAX module's ring model on its group size n:

  all_reduce      2 B (n-1)/n        all_gather      B (n-1)/n
  reduce_scatter  B_out (n-1)        all_to_all      B (n-1)/n
  send_recv       B                  (the HLO's collective-permute)

with ``B`` the buffer the HLO shape would give (an all-gather's result, a
reduce-scatter's output), and two kinds the HLO never shows, which the
port's transfer schedules issue: ``broadcast`` B (every rank receives the
payload once) and ``scatter`` B (n-1)/n (the source sends every other
rank its share).

Each entry is priced by where its line's ranks lie (its ``axes`` on a
mesh of that shape, ranks in row-major order, ``HW["cards_per_node"]`` a
node): NVLink (``nvlink_bw``) where they all lie in one node, the network
(``net_bw``) where they do not.  Without a mesh shape, or for an entry
without ``axes``, every line is one host's, joined all to all by NVLink.
The pod axis's share (entries whose line spans ``"pod"``) is reported
apart, as the JAX module reports its DCN bytes.

The card's rates are ``core.runtime.HW``: NVIDIA H100 80GB HBM3 at 700 W,
NVIDIA's published dense rates, which assume that power limit.
"""

from __future__ import annotations

import numpy as np

from ..core.runtime import HW

_PEAK = {"bfloat16": "peak_flops_bf16", "float32": "peak_flops_f32"}


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """One collective's wire bytes a rank under the ring model."""
    return {"all_reduce": 2 * nbytes * (n - 1) / n,
            "all_gather": nbytes * (n - 1) / n,
            "reduce_scatter": nbytes * (n - 1),
            "all_to_all": nbytes * (n - 1) / n,
            "send_recv": float(nbytes),
            "broadcast": float(nbytes),
            "scatter": nbytes * (n - 1) / n}[kind]


def in_one_node(mesh_shape: dict, axes) -> bool:
    """True when every line along ``axes`` of a row-major mesh of
    ``mesh_shape`` (axis name -> extent) lies in one node of
    ``HW["cards_per_node"]`` consecutive ranks."""
    names = list(mesh_shape)
    ids = np.arange(int(np.prod(list(mesh_shape.values())))).reshape(
        tuple(mesh_shape.values()))
    inner = [names.index(a) for a in axes]
    lines = np.moveaxis(ids, inner, list(range(-len(inner), 0)))
    nodes = lines.reshape(-1, int(np.prod([ids.shape[i] for i in inner])))
    nodes = nodes // HW["cards_per_node"]
    return bool((nodes == nodes[:, :1]).all())


def collectives(records: list[dict], mesh_shape: dict | None = None
                ) -> list[dict]:
    """The record's collectives of more than one rank, each with its
    ``wire_bytes`` (the JAX module's ``parse_collectives`` records) and
    its ``link``: ``"nvlink"`` or ``"net"`` by where its line's ranks lie
    on a mesh of ``mesh_shape`` (NVLink for all without one)."""
    out = []
    for r in records:
        if r["group"] <= 1:
            continue
        axes = tuple(r.get("axes", ()))
        local = mesh_shape is None or not axes or \
            in_one_node(mesh_shape, axes)
        out.append({**r, "wire_bytes": wire_bytes(r["kind"], r["bytes"],
                                                  r["group"]),
                    "link": "nvlink" if local else "net"})
    return out


def collective_summary(colls: list[dict]) -> dict:
    """The wire bytes of ``collectives``' entries in all, by link, on the
    pod axis, and by kind: ``{"wire_bytes", "nvlink_wire_bytes",
    "net_wire_bytes", "pod_wire_bytes", "by_kind": {kind: {"count",
    "wire"}}}``."""
    s = {"wire_bytes": 0.0, "nvlink_wire_bytes": 0.0, "net_wire_bytes": 0.0,
         "pod_wire_bytes": 0.0, "by_kind": {}}
    for c in colls:
        s["wire_bytes"] += c["wire_bytes"]
        s[f"{c.get('link', 'nvlink')}_wire_bytes"] += c["wire_bytes"]
        if "pod" in c.get("axes", ()):
            s["pod_wire_bytes"] += c["wire_bytes"]
        k = s["by_kind"].setdefault(c["kind"], {"count": 0, "wire": 0.0})
        k["count"] += 1
        k["wire"] += c["wire_bytes"]
    return s


def roofline_terms(cost: dict, colls: list[dict], *,
                   dtype: str = "bfloat16") -> dict:
    """The three terms in seconds, the dominant one and its time, for a
    run of ``cost["flops"]`` operations of ``dtype`` and ``cost["bytes"]``
    HBM bytes a rank, with the collectives ``colls`` (each at its link's
    rate)."""
    cs = collective_summary(colls)
    t_compute = float(cost.get("flops", 0.0)) / HW[_PEAK[dtype]]
    t_memory = float(cost.get("bytes", 0.0)) / HW["hbm_bw"]
    t_coll = cs["nvlink_wire_bytes"] / HW["nvlink_bw"] + \
        cs["net_wire_bytes"] / HW["net_bw"]
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll, "collectives": cs}
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])
    terms["dominant"] = dom[0]
    terms["step_time_bound_s"] = dom[1]
    return terms
