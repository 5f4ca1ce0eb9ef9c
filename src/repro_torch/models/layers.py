"""Shared model building blocks, as ``repro/models/layers.py``.

The JAX package keeps every weight in float32 and casts it to the compute
dtype at each use (``wuse``).  The port stores each weight once, in the
dtype its use casts it to (the compute dtype for the projections and the
embedding, float32 where the JAX code computes in float32: the norms and
the RG-LRU gates), so the numbers are the same without a cast of every
weight at every decode step; ``wuse`` is then a no-op on the path.  The
JAX package's ``hint`` (a sharding constraint) has no counterpart: a
sharded step places its tensors itself (``mlp(shard=)``,
``models/sharding.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """The weights of one block under the JAX package's names, so that a
    parameter maps one to one onto the JAX pytree's leaf of that name; a
    module among them is a subtree (MoE's ``experts``, the encoder's
    layers).  They are made without gradients, which the serving path
    never takes; ``train.make_train_state`` turns them on."""

    def __init__(self, **tensors: torch.Tensor | nn.Module):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, t if isinstance(t, nn.Module)
                    else nn.Parameter(t, requires_grad=False))


def wuse(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A weight as its use computes with it (a no-op for a weight stored
    in that dtype)."""
    return w.to(dt)


def dense_init(generator, shape, scale=0.02, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 from ``generator`` and stored
    in ``dtype``; on the meta device only the shape is made."""
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return (scale * x).to(dtype)


def ones(n, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def rms_norm(x, w, eps=1e-6, offset=0.0):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (offset + w.float())
    return y.to(dt)


def rope(x, positions, theta=10000.0):
    """Rotary embedding.  x: (B, H, S, D even), positions: (S,) or
    (B, S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None]
    ang = positions[:, None, :, None].float() * freq     # (B, 1, S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(S, D, offset=0, *, device=None) -> torch.Tensor:
    """(S, D) float32 sinusoidal position embeddings (Whisper's encoder),
    computed in float64 on the host as the JAX package does."""
    pos = np.arange(offset, offset + S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(emb, dtype=torch.float32, device=device)


ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def mlp_params(generator, d_model, d_ff, gated=True, *,
               dtype=torch.float32, device=None) -> Params:
    def init(shape):
        return dense_init(generator, shape, dtype=dtype, device=device)
    p = {"up": init((d_model, d_ff)), "down": init((d_ff, d_model))}
    if gated:
        p["gate"] = init((d_model, d_ff))
    return Params(**p)


def mlp(p, x, act="silu", *, shard=None):
    """The (gated) MLP; with ``shard`` this rank's part of a sharded step:
    ``gate``/``up`` on this rank's columns, ``down`` on its rows, one
    all-reduce."""
    if shard is not None:
        y, partial = mlp_partial(p, x, act, shard)
        return shard.psum(y) if partial else y
    a = ACTS[act]
    h = x @ wuse(p.up, x.dtype)
    if hasattr(p, "gate"):
        h = a(x @ wuse(p.gate, x.dtype)) * h
    else:
        h = a(h)
    return h @ wuse(p.down, x.dtype)


def mlp_partial(p, x, act, shard):
    """``(y, partial)``: the sharded MLP before its all-reduce over the
    model axis (``partial`` when ``y`` is this rank's partial sum)."""
    a = ACTS[act]
    h, split = shard.col(x, p.up)
    if hasattr(p, "gate"):
        g, gsplit = shard.col(x, p.gate)
        if gsplit != split:
            h, g = (shard.gather_model(t, -1) if s else t
                    for t, s in ((h, split), (g, gsplit)))
            split = False
        h = a(g) * h
    else:
        h = a(h)
    return shard.row_partial(h, split, p.down)


def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def sqrt_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d_model) rounded to ``dtype``, as the JAX package scales the
    gemma embeddings (``jnp.asarray(np.sqrt(d), dt)``)."""
    return torch.tensor(math.sqrt(d_model), dtype=dtype)
