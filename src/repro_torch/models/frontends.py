"""Modality frontend STUBS, as ``repro/models/frontends.py``: the
[audio]/[vlm] archs specify the transformer backbone only, and a
frontend's output is given as precomputed frame/patch embeddings.  The
text-only families have none.  ``frontend_struct`` is the dry run's
meta stand-in."""

from __future__ import annotations

import torch

from ..device import resolve_device


def frontend_shape(cfg, batch):
    """(B, T_frontend, d_model) for archs with a frontend; else None."""
    if cfg.encoder_seq:
        return (batch, cfg.encoder_seq, cfg.d_model)
    return None


def frontend_struct(cfg, batch, dtype=torch.bfloat16):
    """An empty ``frontend_shape`` tensor of ``dtype`` on the meta device
    (the dry run's stand-in); None for a text-only family."""
    shp = frontend_shape(cfg, batch)
    return None if shp is None else torch.empty(shp, dtype=dtype,
                                                device="meta")


def synthetic_frontend(cfg, batch, generator=None, dtype=torch.float32,
                       device=None):
    """Deterministic synthetic embeddings ``0.02 N(0, 1)`` of
    ``frontend_shape`` on ``device`` (the card when None), drawn from
    ``generator`` or from one seeded 7; None for a text-only family.  The
    JAX package draws from ``PRNGKey(7)``, which torch cannot reproduce:
    a comparison of the two hands both the same array."""
    shp = frontend_shape(cfg, batch)
    if shp is None:
        return None
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(7)
    x = torch.randn(shp, generator=generator, dtype=torch.float32,
                    device=dev)
    return (0.02 * x).to(dtype)
