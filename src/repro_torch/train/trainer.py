"""The train step, as ``repro/train/trainer.py``: the LM loss, remat,
microbatch accumulation in float32 and the metrics.

The state is ``{"params": Transformer, "opt": {"m", "v", "step"}}``: the
model itself (its parameters take gradients) and AdamW's state keyed by
parameter name.  ``make_train_step`` returns the step alone, on one
card, as the JAX launcher runs its own.  The parameters' partition specs
and their placement on a mesh of ranks are in (``transformer.param_pspecs``,
``models.sharding``, for serving); the sharded step waits in ROADMAP
Queue 1, item 3: the JAX package's ``build`` and ``state_shardings``,
gradients through the collectives, reduce-scatters over the data axes
and AdamW on shards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import transformer
from .optimizer import adamw_init, adamw_update, warmup_cosine


def lm_loss(cfg, params, tokens, labels, enc=None, *, remat=True,
            aux_weight=0.01):
    """Mean next-token NLL (log-softmax of the float32 logits) plus
    ``aux_weight`` times the MoE load-balancing loss.  Returns (loss,
    {"nll", "aux"})."""
    logits, _, aux = transformer.apply(cfg, params, tokens, enc=enc,
                                       mode="train", remat=remat)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long())
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_state(cfg, generator=None, *, device=None):
    """Random weights (``transformer.init_params``, on the card unless
    asked) with gradients turned on, and AdamW's zero state."""
    model = transformer.init_params(cfg, generator, device=device)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw_init(dict(
        model.named_parameters()))}


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


def make_train_step(cfg, *, base_lr=3e-4, warmup=100, total=10000,
                    microbatches=1, remat=True):
    """``step(state, tokens, labels, enc=None) -> (state, metrics)``: the
    gradient of :func:`lm_loss` (summed over ``microbatches`` slices of
    the batch in float32, then divided by their count), one AdamW update
    in place at the schedule's learning rate, and the metrics ``loss``,
    ``gnorm``, ``lr``, ``nll`` and ``aux`` as 0-d tensors.  A
    cross-attention arch's ``enc`` is sliced with the batch."""
    lr_fn = warmup_cosine(base_lr, warmup, total)

    def grads_of(model, params, tok, lab, enc):
        loss, met = lm_loss(cfg, model, tok, lab, enc, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        # a parameter the step does not reach (an encoder without ``enc``)
        # takes a zero gradient, as the JAX package's does
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    def step(state, tokens, labels, enc=None):
        model = state["params"]
        params = dict(model.named_parameters())
        if microbatches > 1:
            mb = tokens.shape[0] // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            lsum = torch.zeros((), device=tokens.device)
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                loss, _, g = grads_of(model, params, tokens[rows],
                                      labels[rows],
                                      None if enc is None else enc[rows])
                for k in grads:
                    grads[k].add_(g[k].float())
                lsum = lsum + loss
            for g in grads.values():
                g.div_(microbatches)
            loss = lsum / microbatches
            met = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        else:
            loss, met, grads = grads_of(model, params, tokens, labels, enc)
        lr = lr_fn(state["opt"]["step"])
        _, _, gnorm = adamw_update(params, grads, state["opt"], lr,
                                   decay=decay_mask(cfg, model))
        return state, {"loss": loss, "gnorm": gnorm, "lr": lr, **met}

    return step
