"""Modality frontends, as ``repro/models/frontends.py``: the text-only
families have none.  The stubbed audio/vlm frontends come with the
configs that need them (ROADMAP Queue 1, the other LM configs)."""

from __future__ import annotations


def frontend_shape(cfg, batch):
    """(B, T_frontend, d_model) for archs with a frontend; else None."""
    if cfg.encoder_seq:
        return (batch, cfg.encoder_seq, cfg.d_model)
    return None


def synthetic_frontend(cfg, batch, generator=None, dtype=None, device=None):
    """None for a text-only family; raises for the families with a
    frontend, which the port does not run yet."""
    if frontend_shape(cfg, batch) is None:
        return None
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} frontend is not ported yet "
        f"(ROADMAP Queue 1, the other LM configs)")
