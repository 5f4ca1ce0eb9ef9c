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
  apply(cfg, params, tokens, ..., remat=)   -> (logits, new_cache, aux)
  init_cache(cfg, batch, max_len, dtype)    -> one cache dict per layer
  param_count(cfg, active_only)             -> from the config alone

Every layer kind of the JAX package: ``attn``, ``local``, ``mla`` and
``cross`` attention and ``rglru``, each with the dense MLP or the MoE FFN
(the leading dense layers of an MoE config with ``dense_d_ff``), the
xLSTM blocks ``mlstm`` and ``slstm`` (which carry their own projections
and no MLP), whisper's decoder cross-attention (``xnorm``/``xattn``) and
its bidirectional encoder, whose stacked JAX layers the port unrolls into
an ``nn.ModuleList`` in the same order.  ``aux`` is the sum of the MoE
layers' load-balancing losses.  The sharding specs wait for
tensor-parallel serving on the multi-rank core.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import registry
from ..kernels.flash_attention import chunked_attention
from . import attention, moe, recurrent
from .layers import Params, dense_init, mlp, mlp_params, ones, rms_norm, \
    sinusoidal_positions, softcap, sqrt_scale

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


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer: norm, mixer (attention or a recurrent block),
    whisper's cross-attention block, norm, MLP or MoE (none after an xLSTM
    block)."""

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
        if cfg.cross_kind == "decoder":
            self.xnorm = nn.Parameter(ones(cfg.d_model, device),
                                      requires_grad=False)
            self.xattn = attention.init(cfg, "cross", generator=generator,
                                        device=device)
        if ffn != "none":
            self.norm2 = nn.Parameter(ones(cfg.d_model, device),
                                      requires_grad=False)
            if cfg.post_norm:
                self.norm2_post = nn.Parameter(ones(cfg.d_model, device),
                                               requires_grad=False)
        if ffn == "mlp":
            # the leading dense layers of an MoE config take dense_d_ff
            dff = cfg.dense_d_ff if (cfg.n_experts and cfg.dense_d_ff) \
                else cfg.d_ff
            self.mlp = mlp_params(generator, cfg.d_model, dff,
                                  gated=cfg.gated_mlp, dtype=cfg.cdtype,
                                  device=device)
        elif ffn == "moe":
            self.moe = moe.init(cfg, generator, device=device)

    def forward(self, x, mode, *, pos=0, cache=None, enc=None):
        """Returns (x, new_cache, aux): aux the MoE load-balancing loss,
        None without MoE."""
        cfg = self.cfg
        rs = cfg.residual_scale
        new_cache: dict[str, Any] = {}
        aux = None
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        if self.kind in ATTN_KINDS:
            h, nc = attention.apply(
                cfg, self.attn, h, self.kind, mode, pos=pos,
                cache=None if cache is None else cache.get("attn"),
                enc=enc if self.kind == "cross" else None)
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
        if cfg.cross_kind == "decoder":
            h, ncx = attention.apply(
                cfg, self.xattn, rms_norm(x, self.xnorm, cfg.norm_eps),
                "cross", mode, pos=pos,
                cache=None if cache is None else cache.get("xattn"), enc=enc)
            if ncx is not None:
                new_cache["xattn"] = ncx
            x = x + rs * h
        if self.ffn != "none":
            h = rms_norm(x, self.norm2, cfg.norm_eps)
            if self.ffn == "mlp":
                h = mlp(self.mlp, h, cfg.act)
            else:
                h, moe_aux = moe.apply(cfg, self.moe, h)
                aux = moe_aux["lb_loss"]
            if cfg.post_norm:
                h = rms_norm(h, self.norm2_post, cfg.norm_eps)
            x = x + rs * h
        return x, new_cache, aux


# ---------------------------------------------------------------------------
# whisper-style bidirectional encoder
# ---------------------------------------------------------------------------

def _encoder_init(cfg, generator=None, device=None) -> Params:
    """``encoder_layers`` layers (norm1, attn, norm2, an ungated MLP) and a
    final norm; the JAX package stacks the layers, the port lists them."""
    layers = nn.ModuleList(Params(
        norm1=ones(cfg.d_model, device),
        attn=attention.init(cfg, "attn", generator=generator, device=device),
        norm2=ones(cfg.d_model, device),
        mlp=mlp_params(generator, cfg.d_model, cfg.d_ff, gated=False,
                       dtype=cfg.cdtype, device=device))
        for _ in range(cfg.encoder_layers))
    return Params(layers=layers, final_norm=ones(cfg.d_model, device))


def _encoder_apply(cfg, p, frames):
    """frames: (B, T, d) precomputed frontend embeddings (stub); the plain
    ``chunked_attention`` without a mask, as in the JAX package."""
    dt = frames.dtype
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(dt)
    for lp in p.layers:
        h = rms_norm(x, lp.norm1, cfg.norm_eps)
        q = attention._split_heads(h @ lp.attn.wq.to(dt), cfg.n_heads)
        k = attention._split_heads(h @ lp.attn.wk.to(dt), cfg.n_kv_heads)
        v = attention._split_heads(h @ lp.attn.wv.to(dt), cfg.n_kv_heads)
        o = chunked_attention(q, k, v, causal=False)
        x = x + attention._merge_heads(o) @ lp.attn.wo.to(dt)
        x = x + mlp(lp.mlp, rms_norm(x, lp.norm2, cfg.norm_eps), "gelu")
    return rms_norm(x, p.final_norm, cfg.norm_eps)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """Embedding, the unrolled layers, final norm and the (tied) head.
    ``forward`` is the JAX package's ``apply``.  ``device=None`` is the
    card; ``device="meta"`` makes the shapes only."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
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
        if cfg.encoder_layers:
            self.encoder = _encoder_init(cfg, generator, dev)
        self.layers = nn.ModuleList(
            Layer(cfg, sig, generator=generator, device=dev)
            for sig in unrolled_sigs(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, enc=None, mode="train", pos=0, cache=None,
                logits_window=None, remat=False):
        """tokens: (B, S) integers.  Returns (logits, new_cache, aux).

        ``enc``: (B, T_enc, d) frontend embeddings for the cross-attention
        archs (through the encoder where the config has one), None in
        decode, where the cross cache holds them.  ``logits_window``:
        logits for the last N positions only (prefill needs just the final
        token).  ``remat``: in train mode with autograd recording, each
        layer's activations are recomputed in the backward instead of kept
        (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``
        of its scan body).  Inside ``registry.plain()`` every kernel runs
        its plain version, for comparisons on the card."""
        cfg = self.cfg
        dt = cfg.cdtype
        x = self.embed[tokens].to(dt)
        if cfg.embed_scale:
            x = x * sqrt_scale(cfg.d_model, dt)
        if cfg.encoder_layers and enc is not None:
            enc = _encoder_apply(cfg, self.encoder, enc.to(dt))
        elif enc is not None:
            enc = enc.to(dt)
        new_cache = [] if cache is not None else None
        aux_total = torch.zeros((), device=x.device)
        remat = remat and mode == "train" and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, nc, aux = checkpoint(
                    layer, x, mode, pos=pos, enc=enc, cache=None,
                    use_reentrant=False,
                    context_fn=registry.checkpoint_contexts)
            else:
                x, nc, aux = layer(x, mode, pos=pos, enc=enc,
                                   cache=None if cache is None else cache[i])
            if aux is not None:
                aux_total = aux_total + aux
            if new_cache is not None:
                new_cache.append(nc)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if logits_window is not None:
            x = x[:, -logits_window:]
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = softcap((x @ head.to(dt)).float(), cfg.final_softcap)
        return logits, new_cache, aux_total


def init_params(cfg, generator=None, *, device=None) -> Transformer:
    """Random weights from ``generator`` (a ``torch.Generator`` on the
    target device; seed 0 when None), on the card unless asked."""
    return Transformer(cfg, generator=generator, device=device)


def init_cache(cfg, batch, max_len, dtype, *, device=None) -> list:
    """One cache dict per layer: ``{"attn": ...}`` (``{k, v}``, MLA's
    latents ``{ckv, kr}`` or the cross layer's ``{k, v}`` of the encoder
    length), or the recurrent state ``{"rnn": ...}``: ``{h, conv}``
    (RG-LRU), ``{C, n, m, conv}`` (mLSTM) or ``{c, n, m, h}`` (sLSTM);
    with whisper's decoder cross-attention also ``{"xattn": {k, v}}``."""
    dev = resolve_device(device)
    caches = []
    for kind, _ in unrolled_sigs(cfg):
        if kind in ATTN_KINDS:
            c = {"attn": attention.init_cache(cfg, kind, batch, max_len,
                                              dtype, device=dev)}
        else:
            c = {"rnn": _RNN[kind][2](cfg, batch, dtype, device=dev)}
        if cfg.cross_kind == "decoder":
            c["xattn"] = attention.init_cache(cfg, "cross", batch, max_len,
                                              dtype, device=dev)
        caches.append(c)
    return caches


def apply(cfg, params, tokens, *, enc=None, mode="train", pos=0, cache=None,
          logits_window=None, remat=False):
    """tokens: (B, S) integers.  Returns (logits, new_cache, aux).
    ``remat`` recomputes each layer in the backward of a train step."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(tokens, enc=enc, mode=mode, pos=pos, cache=cache,
                  logits_window=logits_window, remat=remat)


def param_count(cfg, active_only=False) -> int:
    """Parameters of the model for ``cfg``, counted on the meta device
    (no weight is made).  ``active_only`` counts the ones a token touches:
    ``top_k / n_experts`` of each routed expert stack, as the JAX package
    counts them."""
    total = 0
    for name, p in Transformer(cfg, device="meta").named_parameters():
        n = p.numel()
        if active_only and "experts" in name.split("."):
            # routed experts: only top_k of n_experts are touched per token
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        total += n
    return total
