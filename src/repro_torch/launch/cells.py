"""One (architecture x input shape x mesh) cell of the dry run, the port of
``repro/launch/cells.py``: one rank's step of a production mesh, built on
the meta device so that no parameter, moment, cache or batch is ever
allocated.

The JAX module lowers the jitted step of every device at once; the port
runs one process a rank, so a cell is one rank's step over a dry mesh
(``launch.mesh.make_production_mesh``): the train step
(``train.make_train_state(device="meta", mesh=)`` and
``make_train_step(mesh=, act_sharding=)``), or the serving steps
(``serve.make_serve_steps(mesh=)``) for a prefill and a decode.  Its
collectives note themselves (``core.comm.record()``) and its kernels take
the card's branch without a launch inside ``kernels.registry.dry()``
(``launch.costing`` runs it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs import SHAPES, cell_applicable, get_config
from ..models import frontends, sharding, transformer
from .mesh import expert_pad_for, mesh_axes

__all__ = ["Cell", "build_cell", "expert_pad_for", "model_flops",
           "shape_of"]


@dataclasses.dataclass
class Cell:
    """One rank's step and its meta inputs: ``run()`` is the step on
    ``args``; ``arguments`` the tensors the step is given (the rank's
    shards, moments, batch, cache)."""

    cfg: object
    kind: str
    step: Callable
    args: tuple
    act_sharding: tuple | None

    def run(self):
        return self.step(*self.args)

    @property
    def arguments(self) -> list:
        return _tensors(self.args)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def shape_of(shape) -> tuple[str, int, int, str]:
    """``(id, seq, gbatch, kind)`` of a ``SHAPES`` id or of a ``(seq,
    gbatch, kind)`` tuple (named ``<kind>_<seq>x<gbatch>``)."""
    if isinstance(shape, str):
        return (shape, *SHAPES[shape])
    seq, gbatch, kind = shape
    return f"{kind}_{seq}x{gbatch}", int(seq), int(gbatch), kind


def build_cell(arch: str, shape, mesh, *, remat=True, act_sp=True,
               overrides=None, policy="fsdp_tp"):
    """Returns ``(cell, meta)`` or ``(None, skip_reason)``.

    ``shape``: a ``SHAPES`` id, or a ``(seq, gbatch, kind)`` tuple (for
    comparisons with a real step at another size).  ``policy``:
    ``"fsdp_tp"`` (FSDP over the data axes, TP over ``"model"``) or
    ``"pure_fsdp"`` (every axis an FSDP axis, no tensor parallelism).
    ``act_sp``: sequence parallelism where ``tp`` is set, the sequence
    divides the model axis and the step is not a decode, as the JAX
    module turns it on.  ``meta`` has the JAX module's keys.  On a real
    mesh (``Environment.group``) the cell is the same step on that mesh's
    device, from seeded weights and zero tokens."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sid, seq, gbatch, kind = shape_of(shape)
    if sid in SHAPES:
        ok, reason = cell_applicable(cfg, sid)
        if not ok:
            return None, reason
    group = sharding._group(mesh)
    mesh_shape = group.mesh_shape
    fsdp, tp = mesh_axes(mesh)
    if policy == "pure_fsdp":
        fsdp, tp = tuple(group.axes), None
    elif policy != "fsdp_tp":
        raise ValueError(f"policy must be 'fsdp_tp' or 'pure_fsdp', not "
                         f"{policy!r}")
    tpn = mesh_shape.get("model", 1)
    epad = expert_pad_for(cfg, mesh)
    nbatch = math.prod(mesh_shape[a] for a in fsdp)
    batch_ok = gbatch % nbatch == 0
    meta = dict(arch=arch, shape=sid, kind=kind, seq=seq, gbatch=gbatch,
                mesh=dict(mesh_shape), expert_pad=epad,
                batch_sharded=batch_ok, policy=policy)
    act = None
    if act_sp and tp and seq % tpn == 0 and kind != "decode":
        act = (fsdp if batch_ok else (), "model", None)   # Megatron SP
    # on a dry mesh the inputs are meta tensors; on a real one (a check
    # of the dry cell against the real step) zeros and the synthetic
    # frontend on the mesh's device
    dev = group.device
    if dev.type == "meta":
        enc = frontends.frontend_struct(cfg, gbatch, cfg.cdtype)
    else:
        enc = frontends.synthetic_frontend(cfg, gbatch, dtype=cfg.cdtype,
                                           device=dev)

    def ints(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    if kind == "train":
        from ..train import make_train_state, make_train_step
        state = make_train_state(cfg, device="meta", mesh=mesh, tp=tp,
                                 fsdp=fsdp, expert_pad=epad)
        step = make_train_step(cfg, mesh=mesh, remat=remat, fsdp=fsdp,
                               tp=tp, batch_axes=fsdp, act_sharding=act)
        tok = ints(gbatch, seq)
        return Cell(cfg, kind, step, (state, tok, ints(gbatch, seq), enc),
                    act), meta

    from ..serve import make_serve_steps
    params = sharding.init_shards(cfg, mesh, tp=tp, fsdp=fsdp,
                                  expert_pad=epad)
    prefill, decode, init_cache = make_serve_steps(
        cfg, mesh, max_len=seq, batch=gbatch, tp=tp, batch_axes=fsdp,
        act_sharding=act)
    if kind == "prefill":
        # the cache is made inside the step, as the JAX module's prefill
        # makes it: an output of the step
        def prefill_step(params, tokens, enc=None):
            return prefill(params, tokens, init_cache(), enc)
        return Cell(cfg, kind, prefill_step, (params, ints(gbatch, seq),
                                              enc), act), meta
    if kind == "decode":
        # one token at the cache's last slot: attention over the whole
        # context
        def decode_step(params, cache, tokens):
            return decode(params, tokens, cache, seq - 1)
        return Cell(cfg, kind, decode_step, (params, init_cache(),
                                             ints(gbatch, 1)), act), meta
    raise ValueError(kind)


def model_flops(arch: str, shape) -> dict:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (N = active
    params; D = tokens processed per step)."""
    cfg = get_config(arch)
    _, seq, gbatch, kind = shape_of(shape)
    n_active = transformer.param_count(cfg, active_only=True)
    n_total = transformer.param_count(cfg)
    tokens = gbatch * (seq if kind in ("train", "prefill") else 1)
    mult = 6 if kind == "train" else 2
    return {"n_total": n_total, "n_active": n_active,
            "tokens_per_step": tokens,
            "model_flops": mult * n_active * tokens}
