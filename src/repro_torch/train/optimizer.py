"""AdamW and its schedule, as ``repro/train/optimizer.py``, on dicts of
tensors.

The state mirrors the parameters, one float32 moment pair a leaf, and a
step counter.  :func:`adamw_update` updates the parameters and the
moments in place under ``torch.no_grad()`` (the JAX package returns new
trees; in place saves a copy of the parameters and both moments).  The
order of the arithmetic is the JAX package's: clip, bias corrections of
the incremented step, ``m / bc1 / (sqrt(v / bc2) + eps)``, then decay on
the leaves of two or more dims, all in float32.  ``torch.optim.AdamW``
decays before the moment step and folds the corrections otherwise, so it
would not give these numbers.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr, warmup, total, min_frac=0.1):
    """Linear warmup over ``warmup`` steps, then a cosine down to
    ``min_frac * base_lr`` at ``total``.  ``lr(step)`` takes an int or a
    0-d tensor and returns a float32 0-d tensor (on the step's device), so
    that a step counter on the card is read without a host sync."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr


def adamw_init(params: dict) -> dict:
    """Zero float32 moments for each parameter and a zero int32 step, on
    the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    some = next(iter(params.values()))
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def _sum(squares: dict):
    return sum(squares.values())


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm, *, sumsq=_sum):
    """Scale every gradient in place by ``min(1, max_norm / norm)``, the
    norm taken over all of them in float32.  Returns (grads, norm).
    ``sumsq`` maps each gradient's sum of squares (by name) to their
    total: the sum here; over the ranks of a mesh, each element counted
    once (``trainer.make_train_step(mesh=)``)."""
    norm = torch.sqrt(sumsq({k: torch.sum(torch.square(g.float()))
                             for k, g in grads.items()}))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, lr, *, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1, clip=1.0, decay=None,
                 sumsq=None):
    """One AdamW step, in place on ``params``, ``state`` and (clipping)
    ``grads``.  Returns (params, state, gnorm): gnorm the global norm
    before clipping, zero without a clip.  ``decay`` (name -> bool) says
    which leaves take weight decay; by default those of two or more dims
    (no decay on norms and biases).  ``sumsq``: the clip's total of the
    squares (:func:`clip_by_global_norm`), for the shards of a mesh."""
    if clip:
        grads, gnorm = clip_by_global_norm(grads, clip,
                                           sumsq=sumsq or _sum)
    else:
        gnorm = torch.zeros((), device=state["step"].device)
    state["step"].add_(1)
    t = state["step"].to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    for name, p in params.items():
        g = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        if weight_decay and (p.ndim >= 2 if decay is None else
                             decay[name]):
            delta = delta + weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, state, gnorm
