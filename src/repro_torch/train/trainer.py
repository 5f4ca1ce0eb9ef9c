"""The train step, as ``repro/train/trainer.py``: the LM loss, remat,
microbatch accumulation in float32 and the metrics, on one card or on
this rank's shards over a ``(data, model)`` mesh of ranks.

The state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``: the
model itself (its parameters take gradients) and AdamW's state keyed by
parameter name.  ``make_train_step`` returns the step alone.  With a
``mesh`` (``make_train_state(mesh=)``, ``state_shardings``) the model
holds this rank's shards and ``m``/``v`` their shapes, and the step is
the port of the JAX package's ``build(state_shardings(...))``: the loss
on this rank's rows with the forward's collectives (``models.sharding``,
whose backwards are their adjoints), the gradients of the leaves that
the data axes replicate summed over them, the global norm counting each
element once, and AdamW in place on the shards.  The port has no jit, so
the JAX package's ``build`` has no counterpart: the step checks at each
call that the state is this mesh's shards (``Sharding.check``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.comm import all_reduce_tensor
from ..models import sharding, transformer
from .optimizer import adamw_init, adamw_update, warmup_cosine


def lm_loss(cfg, params, tokens, labels, enc=None, *, remat=True,
            aux_weight=0.01, shard=None, act_sharding=None):
    """Mean next-token NLL (log-softmax of the float32 logits) plus
    ``aux_weight`` times the MoE load-balancing loss.  Returns (loss,
    {"nll", "aux"}).  ``shard``: this rank's part of a sharded step
    (``tokens``, ``labels`` and ``enc`` its rows; the mean is over them);
    ``act_sharding``: its sequence parallelism (``transformer.apply``)."""
    logits, _, aux = transformer.apply(cfg, params, tokens, enc=enc,
                                       mode="train", remat=remat,
                                       shard=shard,
                                       act_sharding=act_sharding)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long())
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_state(cfg, generator=None, *, device=None, expert_pad=1,
                     mesh=None, tp="model", fsdp=("data",)):
    """Random weights (``transformer.init_params``, on the card unless
    asked) with gradients turned on, and AdamW's zero state.  With a
    ``mesh`` (a ``Communicator`` or ``DeviceGroup`` of named axes): this
    rank's shards (``sharding.init_shards``, bitwise the whole init's
    slices; ``generator`` on the mesh's device) and the moments of their
    shapes."""
    if mesh is None:
        model = transformer.init_params(cfg, generator, device=device,
                                        expert_pad=expert_pad)
    else:
        model = sharding.init_shards(cfg, mesh, generator, tp=tp,
                                     fsdp=fsdp, expert_pad=expert_pad)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw_init(dict(
        model.named_parameters()))}


def state_shardings(cfg, state, mesh, *, fsdp=("data",), tp="model"):
    """The storage spec (``sharding.port_specs``) of every leaf of the
    train state, by port name: ``{"params": specs, "opt": {"m": specs,
    "v": specs, "step": ()}}``, the JAX package's ``state_shardings`` with
    a spec where it has a ``NamedSharding``."""
    model = transformer.Transformer(cfg, device="meta",
                                    expert_pad=state["params"].expert_pad)
    specs = sharding.port_specs(cfg, model, sharding._group(mesh).mesh_shape,
                                tp=tp, fsdp=fsdp)
    return {"params": specs, "opt": {"m": dict(specs), "v": dict(specs),
                                     "step": ()}}


def decay_mask(cfg, model) -> dict[str, bool]:
    """Which parameters take AdamW's weight decay: those whose leaf in the
    JAX package's tree has two or more dims.  The JAX package stacks the
    layers of a repeated group and the encoder's layers along a leading
    dim, so there a layer's norm weights are 2-d and decay, while the
    layers of a group of one repeat keep theirs 1-d; the port unrolls the
    layers and keeps that rule, so that both packages train alike."""
    reps = [r for unit, r in transformer.layer_groups(cfg)
            for _ in range(r) for _ in unit]
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = (parts[0] == "encoder" and parts[1] == "layers") or \
            (parts[0] == "layers" and reps[int(parts[1])] > 1)
        out[name] = p.ndim + stacked >= 2
    return out


class _Mesh:
    """What the sharded step needs of the mesh: the data axes (every axis
    but ``tp``), over which each rank's loss is its own, and the spec of
    every leaf."""

    def __init__(self, cfg, mesh, tp, fsdp, batch_axes):
        self.mesh, self.tp, self.fsdp = mesh, tp, tuple(fsdp)
        self.batch_axes = batch_axes
        self.group = sharding._group(mesh)
        self.data_axes = tuple(a for a in self.group.axes if a != tp)
        # each rank's loss is the mean over its rows times this, so that
        # the ranks' losses over the data axes sum to the global mean
        self.scale = 1.0 / math.prod(self.group.mesh_shape[a]
                                     for a in self.data_axes)
        self.subs = {a: self.group.sub(a) for a in self.group.axes}
        self._specs = None
        self.cfg = cfg

    def specs(self, model):
        """The spec of every leaf of ``model``: the one its shard was cut
        by (``pspec``, ``sharding.assemble``), read at the first step."""
        if self._specs is None:
            self._specs = {name: p.pspec
                           for name, p in model.named_parameters()}
        return self._specs

    def sharding(self, rows):
        return sharding.Sharding(self.mesh, tp=self.tp,
                                 batch_axes=self.batch_axes, batch=rows)

    def _sum(self, t, axes, verb):
        for a in axes:
            if self.subs[a].size > 1:
                sharding._count(verb, t)
                t = all_reduce_tensor(t, self.subs[a])
        return t

    def reduce_grads(self, grads, specs) -> None:
        """Sum over the data axes, in place, the gradient of every leaf
        that they replicate (the FSDP gathers' reduce-scatter summed the
        others): one all-reduce per set of axes, every leaf taking part
        on every rank in the parameters' order."""
        packs: dict[tuple, list] = {}
        for name, g in grads.items():
            split = {a for e in specs[name] for a in sharding._axes(e)}
            axes = tuple(a for a in self.data_axes if a not in split)
            if axes:
                packs.setdefault(axes, []).append(name)
        for axes, names in packs.items():
            flat = torch.cat([grads[n].float().reshape(-1) for n in names])
            flat = self._sum(flat, axes, "all_reduce.step")
            for n, piece in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                grads[n].copy_(piece.view_as(grads[n]))

    def sumsq(self, specs):
        """``sumsq(squares)``: the global sum of every gradient's squares
        (name -> this rank's 0-d sum), each element counted once: a leaf
        counts on the ranks at coordinate 0 of every axis it is
        replicated over, and one all-reduce over the mesh sums them."""
        coords = dict(zip(self.group.axes, self.group.coords))

        def counts(name):
            split = {a for e in specs[name] for a in sharding._axes(e)}
            return all(coords[a] == 0 for a in self.group.axes
                       if a not in split)

        def total(squares):
            mine = sum((sq for n, sq in squares.items() if counts(n)),
                       torch.zeros((), device=self.group.device))
            sharding._count("all_reduce.step", mine)
            return all_reduce_tensor(mine, self.group)

        return total

    def mean(self, t):
        """The mean over the data axes of a value that each rank computed
        on its rows (equal on every model rank)."""
        return self._sum(t * self.scale, self.data_axes, "all_reduce.step")


def make_grad_fn(cfg, *, mesh=None, microbatches=1, remat=True,
                 fsdp=("data",), tp="model", batch_axes=("data",),
                 act_sharding=None):
    """``grads(state, tokens, labels, enc=None) -> (loss, metrics,
    grads)``: the gradient of :func:`lm_loss` by parameter name, summed
    over ``microbatches`` slices of the batch in float32 and divided by
    their count, with the loss (0-d tensors, ``metrics`` ``nll`` and
    ``aux``): the train step before its update.  With a ``mesh`` every
    rank passes the global batch, the gradients are this rank's shards'
    (summed over the data axes) and the metrics are the global batch's,
    equal on every rank."""
    on = None if mesh is None else _Mesh(cfg, mesh, tp, fsdp, batch_axes)
    return _grads_fn(cfg, on, microbatches, remat, act_sharding)


def _grads_fn(cfg, on, microbatches, remat, act_sharding=None):
    def one(model, params, tok, lab, enc):
        sh = None
        if on is not None:
            sh = on.sharding(tok.shape[0])
            sh.check(model)
            tok, lab = (sh.take_rows(t).to(sh.device) for t in (tok, lab))
            if enc is not None:
                enc = sh.take_rows(enc).to(sh.device)
        loss, met = lm_loss(cfg, model, tok, lab, enc, remat=remat,
                            shard=sh, act_sharding=act_sharding)
        scaled = loss if on is None else loss * on.scale
        got = torch.autograd.grad(scaled, list(params.values()),
                                  allow_unused=True)
        # a parameter the step does not reach (an encoder without ``enc``)
        # takes a zero gradient, as the JAX package's does
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), got)}
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    def grads_fn(state, tokens, labels, enc=None):
        model = state["params"]
        params = dict(model.named_parameters())
        if microbatches > 1:
            mb = tokens.shape[0] // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            lsum = torch.zeros((), device=model.device)
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                loss, _, g = one(model, params, tokens[rows], labels[rows],
                                 None if enc is None else enc[rows])
                for k in grads:
                    grads[k].add_(g[k].float())
                lsum = lsum + loss
            for g in grads.values():
                g.div_(microbatches)
            loss = lsum / microbatches
            met = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        else:
            loss, met, grads = one(model, params, tokens, labels, enc)
        if on is not None:
            on.reduce_grads(grads, on.specs(model))
            packed = on.mean(torch.stack([loss, met["nll"], met["aux"]]))
            loss, met = packed[0], {"nll": packed[1], "aux": packed[2]}
        return loss, met, grads

    return grads_fn


def make_train_step(cfg, *, mesh=None, base_lr=3e-4, warmup=100,
                    total=10000, microbatches=1, remat=True, fsdp=("data",),
                    tp="model", batch_axes=("data",), act_sharding=None):
    """``step(state, tokens, labels, enc=None) -> (state, metrics)``: the
    gradient of :func:`lm_loss` (summed over ``microbatches`` slices of
    the batch in float32, then divided by their count), one AdamW update
    in place at the schedule's learning rate, and the metrics ``loss``,
    ``gnorm``, ``lr``, ``nll`` and ``aux`` as 0-d tensors.  A
    cross-attention arch's ``enc`` is sliced with the batch.

    ``mesh``: the sharded step (the module's docstring) on the state of
    ``make_train_state(mesh=)`` or ``convert.train_state_from_numpy(
    mesh=)``; every rank passes the global ``tokens``, ``labels`` and
    ``enc``, splits them over ``batch_axes`` where the rows divide (a rank
    runs every row where they do not) and gets the same metrics.
    ``act_sharding`` ``(batch_axes, "model", None)``: the sharded step's
    sequence parallelism (the JAX package's ``act_sharding``)."""
    lr_fn = warmup_cosine(base_lr, warmup, total)
    on = None if mesh is None else _Mesh(cfg, mesh, tp, fsdp, batch_axes)
    grads_fn = _grads_fn(cfg, on, microbatches, remat, act_sharding)

    def step(state, tokens, labels, enc=None):
        model = state["params"]
        loss, met, grads = grads_fn(state, tokens, labels, enc)
        lr = lr_fn(state["opt"]["step"])
        _, _, gnorm = adamw_update(
            dict(model.named_parameters()), grads, state["opt"], lr,
            decay=decay_mask(cfg, model),
            sumsq=None if on is None else on.sumsq(on.specs(model)))
        return state, {"loss": loss, "gnorm": gnorm, "lr": lr, **met}

    return step
