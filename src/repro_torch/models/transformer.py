"""The decoder stack, as ``repro/models/transformer.py``, in PyTorch idiom.

The JAX package groups layers into runs of a repeating unit and scans over
stacked unit parameters.  The port unrolls the groups: a
:class:`Transformer` holds an ``nn.ModuleList`` of :class:`Layer`, one
per layer in the order the JAX scan visits them (group by group, repeat
by repeat, unit position by unit position), so ``layer_groups`` maps
every JAX parameter leaf onto one port parameter
(``repro_torch.convert.params_from_numpy``).

Functional API beside the module:
  init_params(cfg, generator, device=..., expert_pad=) -> Transformer
  apply(cfg, params, tokens, ..., remat=, shard=)      -> (logits, new_cache, aux)
  init_cache(cfg, batch, max_len, dtype)               -> one cache dict per layer
  param_pspecs(cfg, params, mesh_shape, tp=, fsdp=)    -> specs, JAX tree form
  cache_pspecs(cfg, cache, mesh_shape, tp=, batch=)    -> specs, JAX tree form
  param_count(cfg, active_only)                        -> from the config alone

Every layer kind of the JAX package: ``attn``, ``local``, ``mla`` and
``cross`` attention and ``rglru``, each with the dense MLP or the MoE FFN
(the leading dense layers of an MoE config with ``dense_d_ff``), the
xLSTM blocks ``mlstm`` and ``slstm`` (which carry their own projections
and no MLP), whisper's decoder cross-attention (``xnorm``/``xattn``) and
its bidirectional encoder, whose stacked JAX layers the port unrolls into
an ``nn.ModuleList`` in the same order.  ``aux`` is the sum of the MoE
layers' load-balancing losses.

The partition specs are the JAX package's rules (FSDP over the data axes,
TP over ``"model"``), computed from shapes alone (a ``device="meta"``
model or cache serves) and returned in the JAX tree's layout, stacked
groups included, so that they compare leaf for leaf.  A spec is a tuple
with an entry per dim (``None``, an axis name or a tuple of names), or
``()`` for a replicated leaf of at most one dim, as ``tuple(P(...))``.
With a ``shard`` (``models.sharding.Sharding``) the forward runs on this
rank's shards over a ``(data, model)`` mesh of ranks
(``models/sharding.py``), every layer kind, with gradients through its
collectives (the sharded train step, ``train.make_train_step(mesh=)``).
``apply(act_sharding=)`` is the JAX package's sequence parallelism, in
the port's tuple form ``(batch_axes, "model", None)``: on shards the
residual stream between the blocks holds this rank's slice of the
sequence over ``"model"`` (``Sharding.seq_parallel``), each block
gathering its input over the sequence and reduce-scattering its output
onto the slice; it changes no result beyond the order of a sum, and
nothing without a ``shard``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import registry
from ..kernels.flash_attention import chunked_attention
from . import attention, moe, recurrent
from .layers import Params, dense_init, mlp, mlp_params, mlp_partial, \
    ones, rms_norm, sinusoidal_positions, softcap, sqrt_scale

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

    def __init__(self, cfg, sig, *, generator=None, device=None,
                 expert_pad=1):
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
            self.moe = moe.init(cfg, generator, pad_to=expert_pad,
                                device=device)

    def forward(self, x, mode, *, pos=0, cache=None, enc=None, shard=None):
        """Returns (x, new_cache, aux): aux the MoE load-balancing loss,
        None without MoE.  ``shard``: this rank's part of a sharded step
        (x holds this rank's batch rows; the weights are shards)."""
        cfg = self.cfg
        rs = cfg.residual_scale
        new_cache: dict[str, Any] = {}
        aux = None
        w = (lambda t: t) if shard is None else shard.norm_weight
        h = rms_norm(x, w(self.norm1), cfg.norm_eps)
        if shard is not None:
            h = shard.seq_in(h)
        if self.kind in ATTN_KINDS:
            h, nc = attention.apply(
                cfg, self.attn, h, self.kind, mode, pos=pos,
                cache=None if cache is None else cache.get("attn"),
                enc=enc if self.kind == "cross" else None, shard=shard)
            if nc is not None:
                new_cache["attn"] = nc
        else:
            h, nc = _RNN[self.kind][1](
                cfg, self.rnn, h, mode,
                state=None if cache is None else cache.get("rnn"), pos=pos,
                shard=shard)
            if nc is not None:
                new_cache["rnn"] = nc
        if cfg.post_norm:
            h = rms_norm(h, w(self.norm1_post), cfg.norm_eps)
        x = x + rs * h
        if cfg.cross_kind == "decoder":
            h = rms_norm(x, w(self.xnorm), cfg.norm_eps)
            if shard is not None:
                h = shard.seq_in(h)
            h, ncx = attention.apply(
                cfg, self.xattn, h, "cross", mode, pos=pos,
                cache=None if cache is None else cache.get("xattn"), enc=enc,
                shard=shard)
            if ncx is not None:
                new_cache["xattn"] = ncx
            x = x + rs * h
        if self.ffn != "none":
            h = rms_norm(x, w(self.norm2), cfg.norm_eps)
            if shard is not None:
                h = shard.seq_in(h)
            if self.ffn == "mlp" and shard is not None:
                h = shard.to_residual(*mlp_partial(self.mlp, h, cfg.act,
                                                   shard))
            elif self.ffn == "mlp":
                h = mlp(self.mlp, h, cfg.act)
            else:
                h, moe_aux = moe.apply(cfg, self.moe, h, shard=shard)
                aux = moe_aux["lb_loss"]
            if cfg.post_norm:
                h = rms_norm(h, w(self.norm2_post), cfg.norm_eps)
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


def _encoder_apply(cfg, p, frames, shard=None):
    """frames: (B, T, d) precomputed frontend embeddings (stub); the plain
    ``chunked_attention`` without a mask, as in the JAX package."""
    dt = frames.dtype
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(dt)
    if shard is not None:
        for lp in p.layers:
            h = rms_norm(x, shard.full(lp.norm1), cfg.norm_eps)
            x = x + attention.encoder_attention(cfg, lp.attn, h, shard)
            x = x + mlp(lp.mlp, rms_norm(x, shard.full(lp.norm2),
                                         cfg.norm_eps), "gelu", shard=shard)
        return rms_norm(x, shard.full(p.final_norm), cfg.norm_eps)
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
    card; ``device="meta"`` makes the shapes only.  ``expert_pad`` pads
    the expert count of each MoE layer to a multiple of it (the JAX
    package's ``init_params(expert_pad=)``)."""

    def __init__(self, cfg, *, generator=None, device=None, expert_pad=1):
        super().__init__()
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        self.cfg = cfg
        self.expert_pad = expert_pad if cfg.n_experts else 1
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
            Layer(cfg, sig, generator=generator, device=dev,
                  expert_pad=self.expert_pad)
            for sig in unrolled_sigs(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, enc=None, mode="train", pos=0, cache=None,
                logits_window=None, remat=False, shard=None,
                act_sharding=None):
        """tokens: (B, S) integers.  Returns (logits, new_cache, aux).

        ``enc``: (B, T_enc, d) frontend embeddings for the cross-attention
        archs (through the encoder where the config has one), None in
        decode, where the cross cache holds them.  ``logits_window``:
        logits for the last N positions only (prefill needs just the final
        token).  ``remat``: in train mode with autograd recording, each
        layer's activations are recomputed in the backward instead of kept
        (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``
        of its scan body); on shards the recomputed forward runs its
        collectives again in the backward, and every rank, building the
        same graph, runs them in the same order.  Inside ``registry.plain()`` every kernel runs
        its plain version, for comparisons on the card.

        ``shard`` (a ``models.sharding.Sharding``): the model holds this
        rank's shards, ``tokens``, ``enc`` and the cache this rank's batch
        rows, and the logits come back whole over the vocabulary for those
        rows.  ``act_sharding`` ``(batch_axes, "model", None)``: with a
        ``shard``, sequence parallelism (``Sharding.seq_parallel``); the
        logits are the same."""
        cfg = self.cfg
        dt = cfg.cdtype
        if shard is not None:
            shard = shard.seq_parallel(act_sharding, tokens.shape[1], mode)
        if shard is None:
            x = self.embed[tokens].to(dt)
        else:
            x = shard.embed(self.embed, tokens).to(dt)
        if cfg.embed_scale:
            x = x * sqrt_scale(cfg.d_model, dt)
        if cfg.encoder_layers and enc is not None:
            enc = _encoder_apply(cfg, self.encoder, enc.to(dt), shard)
        elif enc is not None:
            enc = enc.to(dt)
        new_cache = [] if cache is not None else None
        aux_total = torch.zeros((), device=x.device)
        remat = remat and mode == "train" and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, nc, aux = checkpoint(
                    layer, x, mode, pos=pos, enc=enc, cache=None,
                    shard=shard, use_reentrant=False,
                    context_fn=registry.checkpoint_contexts)
            else:
                x, nc, aux = layer(x, mode, pos=pos, enc=enc,
                                   cache=None if cache is None else cache[i],
                                   shard=shard)
            if aux is not None:
                aux_total = aux_total + aux
            if new_cache is not None:
                new_cache.append(nc)
        w = (lambda t: t) if shard is None else shard.norm_weight
        x = rms_norm(x, w(self.final_norm), cfg.norm_eps)
        if shard is not None and logits_window is not None:
            x = shard.seq_last(x, logits_window)
        elif shard is not None:
            x = shard.seq_in(x)
        elif logits_window is not None:
            x = x[:, -logits_window:]
        if shard is not None:
            logits = shard.logits(x, self.embed if cfg.tie_embeddings
                                  else self.lm_head, cfg.tie_embeddings)
        else:
            head = self.embed.T if cfg.tie_embeddings else self.lm_head
            logits = (x @ head.to(dt)).float()
        return softcap(logits, cfg.final_softcap), new_cache, aux_total


def init_params(cfg, generator=None, *, device=None,
                expert_pad: int = 1) -> Transformer:
    """Random weights from ``generator`` (a ``torch.Generator`` on the
    target device; seed 0 when None), on the card unless asked.
    ``expert_pad``: pad the expert count to a multiple of the TP axis size
    so that the (E, d, f) stacks shard (``launch.mesh.expert_pad_for``);
    the padded experts are masked in the router."""
    return Transformer(cfg, generator=generator, device=device,
                       expert_pad=expert_pad)


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
          logits_window=None, remat=False, shard=None, act_sharding=None):
    """tokens: (B, S) integers.  Returns (logits, new_cache, aux).
    ``remat`` recomputes each layer in the backward of a train step;
    ``shard`` runs this rank's part of a sharded step, ``act_sharding``
    its sequence parallelism (see ``Transformer.forward``)."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(tokens, enc=enc, mode=mode, pos=pos, cache=cache,
                  logits_window=logits_window, remat=remat, shard=shard,
                  act_sharding=act_sharding)


# ---------------------------------------------------------------------------
# parameter/cache partition specs (FSDP over data(+pod), TP over model)
# ---------------------------------------------------------------------------

def _divides(n, axes, mesh_shape):
    size = int(np.prod([mesh_shape[a] for a in axes]))
    return n % size == 0


def _matrix_spec(shape, mesh_shape, tp, fsdp):
    """Shard one dim over TP (prefer last), another over FSDP."""
    nd = len(shape)
    spec = [None] * nd
    tp_dim = None
    if tp is not None:
        for d in reversed(range(nd)):
            if _divides(shape[d], (tp,), mesh_shape) and shape[d] >= 8:
                tp_dim = d
                spec[d] = tp
                break
    for d in reversed(range(nd)):
        if d != tp_dim and fsdp and _divides(shape[d], fsdp, mesh_shape) \
                and shape[d] >= 8:
            spec[d] = fsdp if len(fsdp) > 1 else fsdp[0]
            break
    return tuple(spec)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Size) or hasattr(x, "shape")


def _map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over nested dicts and lists; a list index names
    nothing, as a JAX ``SequenceKey`` has neither key nor name."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        return [_map_with_names(fn, v, names + ("",)) for v in tree]
    return fn(names, tuple(tree if isinstance(tree, torch.Size)
                           else tree.shape))


def param_pspecs(cfg, params, mesh_shape, *, tp="model", fsdp=("data",)):
    """The spec of every parameter, in the JAX tree's layout: ``params`` is
    a :class:`Transformer` (``device="meta"`` will do) or a tree of leaves
    with a ``shape`` in that layout (``convert.params_to_numpy``'s, say);
    ``mesh_shape`` maps axis names to sizes."""
    if isinstance(params, nn.Module):
        from ..convert import shape_tree
        params = shape_tree(cfg, params)
    fsdp = tuple(a for a in fsdp if a in mesh_shape)
    tp_ok = tp in mesh_shape

    def rule(names, shape):
        if len(shape) <= 1:
            return ()
        if "experts" in names:  # (E, din, dout): EP over model, FSDP inside
            if tp_ok and _divides(shape[-3], (tp,), mesh_shape):
                spec = [None] * len(shape)
                spec[-3] = tp
                if _divides(shape[-2], fsdp, mesh_shape):
                    spec[-2] = fsdp if len(fsdp) > 1 else fsdp[0]
                return tuple(spec)
        if names and names[-1] in ("embed", "lm_head"):
            # vocab over TP only (sharded logits), d_model never over FSDP
            vdim = 0 if names[-1] == "embed" else 1
            spec = [None, None]
            if tp_ok and _divides(shape[vdim], (tp,), mesh_shape):
                spec[vdim] = tp
            elif _divides(shape[vdim], fsdp, mesh_shape):
                spec[vdim] = fsdp if len(fsdp) > 1 else fsdp[0]
            return tuple(spec)
        if names and names[-1] in ("wo", "down", "ff_down", "wuv", "wuk"):
            # reduction-side matrices: TP on the contracted (first) dim
            spec = [None] * len(shape)
            if tp_ok and _divides(shape[-2], (tp,), mesh_shape) \
                    and shape[-2] >= 8:
                spec[-2] = tp
            if _divides(shape[-1], fsdp, mesh_shape) and shape[-1] >= 8:
                spec[-1] = fsdp if len(fsdp) > 1 else fsdp[0]
            return tuple(spec)
        sp = _matrix_spec(shape[-2:], mesh_shape, tp if tp_ok else None,
                          fsdp)
        return (None,) * (len(shape) - 2) + sp

    return _map_with_names(rule, params)


def cache_pspecs(cfg, cache, mesh_shape, *, tp="model", batch=("data",),
                 kv_shard="seq"):
    """KV caches: batch over the data axes; the TP axis per ``kv_shard``:
    ``"seq"`` the time dim (each rank attends over its slice of time and
    the softmax partials merge), ``"heads"`` a trailing dim; either falls
    back to a trailing dim that divides.  ``cache`` is the port's cache
    (one dict per layer, ``device="meta"`` will do) or a tree of shapes in
    the JAX layout; the result is in the JAX layout, group by group, so
    that the leading ``reps`` dim of a repeated group is never taken for
    batch."""
    if len(cache) == len(unrolled_sigs(cfg)) and all(
            isinstance(c, dict) and set(c) <= {"attn", "rnn", "xattn"}
            for c in cache):
        from ..convert import cache_shape_tree
        cache = cache_shape_tree(cfg, cache)
    batch = tuple(a for a in batch if a in mesh_shape)
    bspec = batch if len(batch) > 1 else (batch[0] if batch else None)
    tp_ok = tp in mesh_shape

    def leaf_spec(shape, reps, name):
        nd = len(shape)
        spec = [None] * nd
        b_dim = 1 if reps > 1 else 0
        if nd <= b_dim:
            return tuple(spec)
        if bspec is not None and _divides(shape[b_dim], batch, mesh_shape):
            spec[b_dim] = bspec
        if tp_ok:
            # time dim: attn k/v are (B, Hkv, T, hd) -> dim 2 (+reps);
            # MLA latents (B, T, r) -> dim 1 (+reps)
            t_dim = None
            if kv_shard == "seq":
                if name in ("k", "v") and nd - b_dim == 4:
                    t_dim = b_dim + 2
                elif name in ("ckv", "kr") and nd - b_dim == 3:
                    t_dim = b_dim + 1
            if t_dim is not None and \
                    _divides(shape[t_dim], (tp,), mesh_shape):
                spec[t_dim] = tp
                return tuple(spec)
            for d in reversed(range(b_dim + 1, nd)):
                if _divides(shape[d], (tp,), mesh_shape) and shape[d] >= 8:
                    spec[d] = tp
                    break
        return tuple(spec)

    return [_map_with_names(lambda names, shape: leaf_spec(shape, reps,
                                                           names[-1]), gc)
            for (unit, reps), gc in zip(layer_groups(cfg), cache)]


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
