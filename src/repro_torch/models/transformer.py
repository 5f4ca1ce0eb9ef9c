"""The decoder stack, as ``repro/models/transformer.py``, in PyTorch idiom.

The JAX package groups layers into runs of a repeating unit and scans over
stacked unit parameters.  The port unrolls the groups: a
:class:`Transformer` holds an ``nn.ModuleList`` of :class:`Layer`, one
per layer in the order the JAX scan visits them (group by group, repeat
by repeat, unit position by unit position), so ``layer_groups`` maps
every JAX parameter leaf onto one port parameter
(``repro_torch.convert.params_from_numpy``).

Functional API beside the module:
  init_params(cfg, generator, device=...)   -> Transformer
  apply(cfg, params, tokens, ...)           -> (logits, new_cache, aux)
  init_cache(cfg, batch, max_len, dtype)    -> one cache dict per layer
  param_count(cfg)                          -> from the config alone

Ported layer kinds: ``attn`` and ``local`` attention and ``rglru``, with
the dense MLP, and the xLSTM blocks ``mlstm`` and ``slstm`` (which carry
their own projections and no MLP).  MoE, MLA, cross-attention and the
encoder raise until their slice; the sharding specs wait for the
multi-rank core.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..device import resolve_device
from . import attention, recurrent
from .layers import mlp, mlp_params, ones, rms_norm, softcap, sqrt_scale, \
    dense_init

ATTN_KINDS = ("attn", "local", "mla", "cross")
# recurrent kind -> (init, apply, state)
_RNN = {
    "rglru": (recurrent.rglru_init, recurrent.rglru_apply,
              recurrent.rglru_state),
    "mlstm": (recurrent.mlstm_init, recurrent.mlstm_apply,
              recurrent.mlstm_state),
    "slstm": (recurrent.slstm_init, recurrent.slstm_apply,
              recurrent.slstm_state),
}
_LATER = "{} is not ported yet (ROADMAP Queue 1, the other LM configs)"


# ---------------------------------------------------------------------------
# layer grouping (verbatim: the parameter map rests on it)
# ---------------------------------------------------------------------------

def layer_sigs(cfg) -> list[tuple[str, str]]:
    return [(k, cfg.ffn_kind(i)) for i, k in enumerate(cfg.layer_kinds())]


def layer_groups(cfg) -> list[tuple[list[tuple[str, str]], int]]:
    """[(unit_signature, n_repeats)] covering all layers in order."""
    sigs = layer_sigs(cfg)
    n = len(sigs)
    u = max(len(cfg.pattern), 1)
    groups = []
    i = 0
    while i < n:
        for ulen in (u, 1):
            unit = sigs[i:i + ulen]
            if len(unit) < ulen:
                continue
            reps = 1
            while sigs[i + reps * ulen: i + (reps + 1) * ulen] == unit:
                reps += 1
            if reps > 1 or ulen == 1:
                groups.append((unit, reps))
                i += ulen * reps
                break
        else:  # pragma: no cover
            groups.append((sigs[i:i + 1], 1))
            i += 1
    return groups


def unrolled_sigs(cfg) -> list[tuple[str, str]]:
    """Each layer's signature in the order of ``layer_groups``."""
    return [sig for unit, reps in layer_groups(cfg) for _ in range(reps)
            for sig in unit]


def _check_ported(cfg) -> None:
    if cfg.n_experts:
        raise NotImplementedError(_LATER.format("MoE"))
    if cfg.encoder_layers or cfg.cross_kind != "none":
        raise NotImplementedError(_LATER.format("the encoder / "
                                                "cross-attention"))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer: norm, mixer (attention or a recurrent block),
    norm, MLP (none after an xLSTM block)."""

    def __init__(self, cfg, sig, *, generator=None, device=None):
        super().__init__()
        kind, ffn = sig
        self.cfg, self.kind, self.ffn = cfg, kind, ffn
        self.norm1 = nn.Parameter(ones(cfg.d_model, device),
                                  requires_grad=False)
        if cfg.post_norm:
            self.norm1_post = nn.Parameter(ones(cfg.d_model, device),
                                           requires_grad=False)
        if kind in ATTN_KINDS:
            self.attn = attention.init(cfg, kind, generator=generator,
                                       device=device)
        elif kind in _RNN:
            self.rnn = _RNN[kind][0](cfg, generator=generator,
                                     device=device)
        else:
            raise ValueError(kind)
        if ffn != "none":
            self.norm2 = nn.Parameter(ones(cfg.d_model, device),
                                      requires_grad=False)
            if cfg.post_norm:
                self.norm2_post = nn.Parameter(ones(cfg.d_model, device),
                                               requires_grad=False)
        if ffn == "mlp":
            self.mlp = mlp_params(generator, cfg.d_model, cfg.d_ff,
                                  gated=cfg.gated_mlp, dtype=cfg.cdtype,
                                  device=device)
        elif ffn == "moe":
            raise NotImplementedError(_LATER.format("MoE"))

    def forward(self, x, mode, *, pos=0, cache=None):
        cfg = self.cfg
        rs = cfg.residual_scale
        new_cache: dict[str, Any] = {}
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind in ATTN_KINDS:
            h, nc = attention.apply(
                cfg, self.attn, h, self.kind, mode, pos=pos,
                cache=None if cache is None else cache.get("attn"))
            if nc is not None:
                new_cache["attn"] = nc
        else:
            h, nc = _RNN[self.kind][1](
                cfg, self.rnn, h, mode,
                state=None if cache is None else cache.get("rnn"), pos=pos)
            if nc is not None:
                new_cache["rnn"] = nc
        if cfg.post_norm:
            h = rms_norm(h, self.norm1_post, cfg.norm_eps)
        x = x + rs * h
        if self.ffn != "none":
            h = mlp(self.mlp, rms_norm(x, self.norm2, cfg.norm_eps), cfg.act)
            if cfg.post_norm:
                h = rms_norm(h, self.norm2_post, cfg.norm_eps)
            x = x + rs * h
        return x, new_cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """Embedding, the unrolled layers, final norm and the (tied) head.
    ``forward`` is the JAX package's ``apply``.  ``device=None`` is the
    card; ``device="meta"`` makes the shapes only."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(
            dense_init(generator, (cfg.vocab, cfg.d_model), 0.02,
                       dtype=cfg.cdtype, device=dev), requires_grad=False)
        self.final_norm = nn.Parameter(ones(cfg.d_model, dev),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                dense_init(generator, (cfg.d_model, cfg.vocab),
                           dtype=cfg.cdtype, device=dev), requires_grad=False)
        self.layers = nn.ModuleList(
            Layer(cfg, sig, generator=generator, device=dev)
            for sig in unrolled_sigs(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, enc=None, mode="train", pos=0, cache=None,
                logits_window=None):
        """tokens: (B, S) integers.  Returns (logits, new_cache, aux).

        ``logits_window``: logits for the last N positions only (prefill
        needs just the final token).  Inside ``registry.plain()`` every
        kernel runs its plain version, for comparisons on the card."""
        if enc is not None:
            raise NotImplementedError(_LATER.format("the encoder"))
        cfg = self.cfg
        dt = cfg.cdtype
        x = self.embed[tokens].to(dt)
        if cfg.embed_scale:
            x = x * sqrt_scale(cfg.d_model, dt)
        new_cache = [] if cache is not None else None
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, mode, pos=pos,
                          cache=None if cache is None else cache[i])
            if new_cache is not None:
                new_cache.append(nc)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if logits_window is not None:
            x = x[:, -logits_window:]
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = softcap((x @ head.to(dt)).float(), cfg.final_softcap)
        return logits, new_cache, torch.zeros((), device=x.device)


def init_params(cfg, generator=None, *, device=None) -> Transformer:
    """Random weights from ``generator`` (a ``torch.Generator`` on the
    target device; seed 0 when None), on the card unless asked."""
    return Transformer(cfg, generator=generator, device=device)


def init_cache(cfg, batch, max_len, dtype, *, device=None) -> list:
    """One cache dict per layer: ``{"attn": {k, v}}``, or the recurrent
    state ``{"rnn": ...}``: ``{h, conv}`` (RG-LRU), ``{C, n, m, conv}``
    (mLSTM) or ``{c, n, m, h}`` (sLSTM)."""
    dev = resolve_device(device)
    caches = []
    for kind, _ in unrolled_sigs(cfg):
        if kind in ATTN_KINDS:
            caches.append({"attn": attention.init_cache(
                cfg, kind, batch, max_len, dtype, device=dev)})
        else:
            caches.append({"rnn": _RNN[kind][2](cfg, batch, dtype,
                                                device=dev)})
    return caches


def apply(cfg, params, tokens, *, enc=None, mode="train", pos=0, cache=None,
          logits_window=None):
    """tokens: (B, S) integers.  Returns (logits, new_cache, aux)."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(tokens, enc=enc, mode=mode, pos=pos, cache=cache,
                  logits_window=logits_window)


def param_count(cfg, active_only=False) -> int:
    """Parameters of the model for ``cfg``, counted on the meta device
    (no weight is made).  ``active_only`` counts the ones a token touches,
    which is all of them without MoE."""
    model = Transformer(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
