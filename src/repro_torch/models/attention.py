"""Attention layers, as ``repro/models/attention.py``: GQA with global
(``attn``) or sliding-window (``local``) masks, multi-head latent
attention (``mla``: deepseek-v2, minicpm3) and cross-attention
(``cross``: the vlm's interleaved layers, whisper's decoder).

``init(cfg, kind, ...)`` -> a :class:`Params` module;
``apply(cfg, p, x, kind, mode, ...)`` -> (y, new_cache).

Modes:
  train    full sequence, no cache returned
  prefill  full sequence, writes the cache
  decode   single token at position ``pos`` (uniform over batch), reads
           and updates the cache

Cache layouts (per layer):
  attn   {"k", "v": (B, Hkv, T, hd)}     T = max_len
  local  {"k", "v": (B, Hkv, W, hd)}     rolling, slot = t % W
  mla    {"ckv": (B, T, r), "kr": (B, T, rope_dim)}   latent cache
  cross  {"k", "v": (B, Hkv, T_enc, hd)}              static after prefill

Unlike the JAX package, prefill and decode write the cache they are given
in place and return it: the new cache is the old one, updated, so a
decode step moves one token of K and V (or of the latents) and nothing
else; the cross cache's entries are replaced at the prefill.  Prefill of
``attn``, ``local`` and ``mla`` runs ``flash_attention`` (the CUDA kernel
on the card; MLA's with v's own head dim), decode the plain
``decode_attention``; cross-attention runs the plain
``chunked_attention``, as the JAX package does.

With a ``shard`` (``models.sharding.Sharding``) ``apply`` runs this rank's
part of a sharded step: head-local attention where both head counts
divide the model axis (the flash attention kernel on this rank's heads in
a prefill), else the heads gathered over it; the cache split over time, so
that a decode step's softmax partials over each rank's slice merge over
the model axis (``_apply_sharded``, ``_apply_mla_sharded``,
``_apply_cross_sharded``).
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import (chunked_attention, decode_attention,
                                       flash_attention)
from .layers import Params, dense_init, ones, rms_norm, rope, wuse


def init(cfg, kind, *, generator=None, device=None) -> Params:
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(shape):
        return dense_init(generator, shape, dtype=cfg.cdtype, device=device)

    if kind == "mla":
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, ropd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        p = {"wdkv": w((d, r)), "kv_norm": ones(r, device),
             "wkr": w((d, ropd)), "wuk": w((r, H * nope)),
             "wuv": w((r, H * vd)), "wo": w((H * vd, d))}
        if qr:
            p["wdq"] = w((d, qr))
            p["q_norm"] = ones(qr, device)
            p["wuq"] = w((qr, H * (nope + ropd)))
        else:
            p["wq"] = w((d, H * (nope + ropd)))
        return Params(**p)
    p = {"wq": w((d, H * hd)), "wk": w((d, Hkv * hd)),
         "wv": w((d, Hkv * hd)), "wo": w((H * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = ones(hd, device)
        p["k_norm"] = ones(hd, device)
    if kind == "cross":
        # gated cross-attention (vlm): tanh(0) = 0 at init
        p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return Params(**p)


def init_cache(cfg, kind, batch, max_len, dtype, *, device=None):
    hd, Hkv = cfg.hd, cfg.n_kv_heads

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind == "mla":
        return {"ckv": z(batch, max_len, cfg.kv_lora_rank),
                "kr": z(batch, max_len, cfg.qk_rope_dim)}
    if kind == "cross":
        T = cfg.encoder_seq
    else:
        T = min(cfg.window, max_len) if kind == "local" else max_len
    return {"k": z(batch, Hkv, T, hd), "v": z(batch, Hkv, T, hd)}


def _split_heads(x, n):
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1).transpose(1, 2)


def _merge_heads(x):
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd)


def _maybe_qk_norm(cfg, p, q, k):
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k


def apply(cfg, p, x, kind, mode, *, pos=0, cache=None, enc=None,
          shard=None):
    """x: (B, S, d).  Returns (y, new_cache).  ``shard``: this rank's part
    of a sharded step (x holds its batch rows, p and the cache its
    shards)."""
    if shard is not None:
        fn = {"mla": _apply_mla_sharded, "cross": _apply_cross_sharded}.get(
            kind, _apply_sharded)
        return fn(cfg, p, x, kind, mode, pos=pos, cache=cache, enc=enc,
                  sh=shard)
    if kind == "mla":
        return _apply_mla(cfg, p, x, mode, pos=pos, cache=cache)
    if kind == "cross":
        return _apply_cross(cfg, p, x, mode, cache=cache, enc=enc)
    B, S, _ = x.shape
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind == "local" else None
    dt = x.dtype

    q = _split_heads(x @ wuse(p.wq, dt), H)
    k = _split_heads(x @ wuse(p.wk, dt), Hkv)
    v = _split_heads(x @ wuse(p.wv, dt), Hkv)
    q, k = _maybe_qk_norm(cfg, p, q, k)

    positions = _positions(x, mode, pos)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if mode == "decode":
        T = cache["k"].shape[2]
        # the JAX update clamps its start into the cache
        slot = pos % T if kind == "local" else min(pos, T - 1)
        cache["k"][:, :, slot] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v[:, :, 0].to(cache["v"].dtype)
        k_positions = None
        if kind == "local":
            idx = torch.arange(T, device=x.device)
            k_positions = (pos - torch.remainder(pos - idx, T)).expand(B, T)
        o = decode_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                             kv_len=torch.full((B,), pos + 1,
                                               device=x.device),
                             window=window, softcap=cfg.attn_softcap,
                             k_positions=k_positions)
    else:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=window,
                            softcap=cfg.attn_softcap, q_offset=pos)
        if mode == "prefill":
            new_cache = _write_prefill_cache(cfg, kind, cache, k, v, pos, S)

    y = _merge_heads(o) @ wuse(p.wo, dt)
    return y, new_cache


def _write_prefill_cache(cfg, kind, cache, k, v, pos, S):
    """Write prefilled k/v (positions pos..pos+S) into the cache, in
    place."""
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[2]
    if kind == "local" and S >= T:
        # rolling cache: keep the last T positions, slot = t % T
        idx = torch.remainder(pos + S - T + torch.arange(T, device=ck.device),
                              T)
        ck[:, :, idx] = k[:, :, -T:].to(ck.dtype)
        cv[:, :, idx] = v[:, :, -T:].to(cv.dtype)
        return cache
    slot = pos % T if kind == "local" else pos
    slot = max(0, min(slot, T - S))      # the JAX update's clamped start
    ck[:, :, slot:slot + S] = k.to(ck.dtype)
    cv[:, :, slot:slot + S] = v.to(cv.dtype)
    return cache


def _positions(x, mode, pos):
    B, S, _ = x.shape
    if mode == "decode":
        return torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    return (pos + torch.arange(S, device=x.device))[None]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention; deepseek-v2 / minicpm3)
# ---------------------------------------------------------------------------

def _apply_mla(cfg, p, x, mode, *, pos=0, cache=None):
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, ropd = cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    scale = 1.0 / math.sqrt(nope + ropd)

    # -- queries
    if cfg.q_lora_rank:
        cq = rms_norm(x @ wuse(p.wdq, dt), p.q_norm, cfg.norm_eps)
        q = cq @ wuse(p.wuq, dt)
    else:
        q = x @ wuse(p.wq, dt)
    q = _split_heads(q, H)                          # (B, H, S, nope + ropd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    # -- latent kv + shared rope key
    ckv = rms_norm(x @ wuse(p.wdkv, dt), p.kv_norm, cfg.norm_eps)
    kr = (x @ wuse(p.wkr, dt))[:, None]            # (B, 1, S, ropd)
    positions = _positions(x, mode, pos)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kr = rope(kr, positions, cfg.rope_theta)[:, 0]  # (B, S, ropd)

    if mode == "decode":
        T = cache["ckv"].shape[1]
        slot = min(pos, T - 1)           # the JAX update's clamped start
        cache["ckv"][:, slot] = ckv[:, 0].to(cache["ckv"].dtype)
        cache["kr"][:, slot] = kr[:, 0].to(cache["kr"].dtype)
        ckv_ctx, kr_ctx = cache["ckv"].to(dt), cache["kr"].to(dt)
    else:
        ckv_ctx, kr_ctx = ckv, kr
        if mode == "prefill":
            T = cache["ckv"].shape[1]
            slot = max(0, min(pos, T - S))
            cache["ckv"][:, slot:slot + S] = ckv.to(cache["ckv"].dtype)
            cache["kr"][:, slot:slot + S] = kr.to(cache["kr"].dtype)

    # up-project the context latents to per-head keys and values
    T = ckv_ctx.shape[1]
    k_nope = _split_heads(ckv_ctx @ wuse(p.wuk, dt), H)     # (B, H, T, nope)
    vv = _split_heads(ckv_ctx @ wuse(p.wuv, dt), H)         # (B, H, T, vd)
    k_full = torch.cat([k_nope, kr_ctx[:, None].expand(B, H, T, ropd)],
                       dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    if mode == "decode":
        o = decode_attention(q_full, k_full, vv,
                             kv_len=torch.full((B,), pos + 1,
                                               device=x.device),
                             scale=scale)
    else:
        o = flash_attention(q_full, k_full, vv.contiguous(), causal=True,
                            q_offset=pos, scale=scale)
    y = _merge_heads(o) @ wuse(p.wo, dt)
    return y, cache


# ---------------------------------------------------------------------------
# cross attention (vlm interleaved / whisper decoder)
# ---------------------------------------------------------------------------

def _apply_cross(cfg, p, x, mode, *, cache=None, enc=None):
    """enc: (B, T_enc, d) encoder/frontend states (None in decode: the
    cache's)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype

    q = _split_heads(x @ wuse(p.wq, dt), H)
    if enc is not None:
        k = _split_heads(enc.to(dt) @ wuse(p.wk, dt), Hkv)
        v = _split_heads(enc.to(dt) @ wuse(p.wv, dt), Hkv)
        if mode in ("prefill", "decode") and cache is not None:
            cache["k"] = k.to(cache["k"].dtype)
            cache["v"] = v.to(cache["v"].dtype)
    else:
        k, v = cache["k"].to(dt), cache["v"].to(dt)
    q, k = _maybe_qk_norm(cfg, p, q, k)

    o = chunked_attention(q, k, v, causal=False)
    y = _merge_heads(o) @ wuse(p.wo, dt)
    if hasattr(p, "gate"):
        y = torch.tanh(p.gate).to(dt) * y
    return y, cache


# ---------------------------------------------------------------------------
# one rank's part of a sharded step
# ---------------------------------------------------------------------------

def _qkv(sh, p, xq, xkv, H, Hkv, *, need_full):
    """q from ``xq``, k and v from ``xkv`` through the column-split
    projections, heads split: ``(q, k, v, local)``, ``local`` when each
    holds this rank's whole heads (both head counts divide the model
    axis), else every head (gathered over the model axis)."""
    (q, sq), (k, sk), (v, sv) = (sh.col(xq, p.wq), sh.col(xkv, p.wk),
                                 sh.col(xkv, p.wv))
    local = not need_full and sq and sk and sv and H % sh.M == 0 and \
        Hkv % sh.M == 0
    if not local:
        q, k, v = (sh.gather_model(t, -1) if s else t
                   for t, s in ((q, sq), (k, sk), (v, sv)))
    div = sh.M if local else 1
    return (_split_heads(q, H // div), _split_heads(k, Hkv // div),
            _split_heads(v, Hkv // div), local)


def _qk_norm_sharded(cfg, sh, p, q, k, local):
    """The qk norms, whose weights (replicated) enter this rank's heads
    when ``local``."""
    if cfg.qk_norm:
        wq, wk = sh.full(p.q_norm), sh.full(p.k_norm)
        if local:
            wq, wk = sh.enter(wq), sh.enter(wk)
        q = rms_norm(q, wq, cfg.norm_eps)
        k = rms_norm(k, wk, cfg.norm_eps)
    return q, k


def _heads_whole(sh, t, local):
    """Every head of a (B, H, S, hd) tensor (gathered when head-local)."""
    return sh.gather_model(t, 1) if local else t


def encoder_attention(cfg, p, h, sh):
    """Whisper's encoder self-attention (no mask, no cache) on this rank's
    part: the sharded form of the encoder layer's ``chunked_attention``."""
    q, k, v, local = _qkv(sh, p, h, h, cfg.n_heads, cfg.n_kv_heads,
                          need_full=False)
    o = chunked_attention(q, k, v, causal=False)
    return sh.row(_merge_heads(o), local, p.wo)


def _apply_sharded(cfg, p, x, kind, mode, *, pos, cache, enc, sh):
    """``attn`` and ``local`` layers: a prefill runs flash attention on
    this rank's heads (all heads where a head is split) and writes this
    rank's slice of time of every kv head; a decode step writes the new
    k/v on the rank that holds its slot and merges the slices' softmax
    partials."""
    B, S, _ = x.shape
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind == "local" else None
    dt = x.dtype
    decode = mode == "decode"
    q, k, v, local = _qkv(sh, p, x, x, H, Hkv, need_full=decode)
    q, k = _qk_norm_sharded(cfg, sh, p, q, k, local)
    positions = _positions(x, mode, pos)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if decode:
        ck, cv = cache["k"], cache["v"]
        T = sh.time_len(ck, 2)
        slot = pos % T if kind == "local" else min(pos, T - 1)
        idx = torch.tensor([slot])
        sh.write(ck, 2, idx, k)
        sh.write(cv, 2, idx, v)
        kv, lo, partial = sh.time_view(ck, 2)
        vv, _, _ = sh.time_view(cv, 2)
        slots = torch.arange(lo, lo + kv.shape[2], device=x.device)
        if kind == "local":
            k_positions = (pos - torch.remainder(pos - slots, T)).expand(
                B, -1)
        else:
            k_positions = slots.expand(B, -1)
        o = sh.attend(q, kv.to(dt), vv.to(dt), partial,
                      kv_len=torch.full((B,), pos + 1, device=x.device),
                      window=window, softcap=cfg.attn_softcap,
                      k_positions=k_positions)
        return sh.row_out(_merge_heads(o), False, p.wo), cache

    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, window=window, softcap=cfg.attn_softcap,
                        q_offset=pos)
    if mode == "prefill":
        _write_prefill_sharded(sh, kind, cache, _heads_whole(sh, k, local),
                               _heads_whole(sh, v, local), pos, S)
    return sh.row_out(_merge_heads(o), local, p.wo), cache


def _write_prefill_sharded(sh, kind, cache, k, v, pos, S):
    """``_write_prefill_cache``'s slots, each rank writing its own part."""
    ck, cv = cache["k"], cache["v"]
    T = sh.time_len(ck, 2)
    if kind == "local" and S >= T:
        idx = torch.remainder(pos + S - T + torch.arange(T), T)
        k, v = k[:, :, -T:], v[:, :, -T:]
    else:
        slot = pos % T if kind == "local" else pos
        slot = max(0, min(slot, T - S))
        idx = torch.arange(slot, slot + S)
    sh.write(ck, 2, idx, k)
    sh.write(cv, 2, idx, v)


def _apply_mla_sharded(cfg, p, x, kind, mode, *, pos, cache, enc, sh):
    """MLA: the latents ``ckv`` and ``kr`` whole on every rank (their
    projections' columns gathered), the up-projections ``wuk``/``wuv``
    whole for this use; a prefill runs flash attention on this rank's
    heads and writes its slice of the latents, a decode step decompresses
    only this rank's slice of time and merges the partials."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, ropd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = x.dtype
    scale = 1.0 / math.sqrt(nope + ropd)
    decode = mode == "decode"

    if cfg.q_lora_rank:
        cq = rms_norm(sh.proj_full(x, p.wdq), sh.full(p.q_norm),
                      cfg.norm_eps)
        q, split = sh.col(cq, p.wuq)
    else:
        q, split = sh.col(x, p.wq)
    local = not decode and split and H % sh.M == 0
    if split and not local:
        q = sh.gather_model(q, -1)
    hq = H // sh.M if local else H
    q = _split_heads(q, hq)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    ckv = rms_norm(sh.proj_full(x, p.wdkv), sh.full(p.kv_norm),
                   cfg.norm_eps)
    kr = sh.proj_full(x, p.wkr)[:, None]
    positions = _positions(x, mode, pos)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kr = rope(kr, positions, cfg.rope_theta)[:, 0]
    wuk, wuv = sh.full(p.wuk).to(dt), sh.full(p.wuv).to(dt)
    if local:
        # this rank's heads' columns; the latents (replicated) enter them
        wuk, wuv = sh.chunk(wuk, -1), sh.chunk(wuv, -1)
        ckv, kr = sh.enter(ckv), sh.enter(kr)
    q_full = torch.cat([q_nope, q_rope], dim=-1)

    if decode:
        T = sh.time_len(cache["ckv"], 1)
        idx = torch.tensor([min(pos, T - 1)])
        sh.write(cache["ckv"], 1, idx, ckv)
        sh.write(cache["kr"], 1, idx, kr)
        ckv_ctx, lo, partial = sh.time_view(cache["ckv"], 1)
        kr_ctx, _, _ = sh.time_view(cache["kr"], 1)
        ckv_ctx, kr_ctx = ckv_ctx.to(dt), kr_ctx.to(dt)
    else:
        ckv_ctx, kr_ctx = ckv, kr
        if mode == "prefill":
            T = sh.time_len(cache["ckv"], 1)
            slot = max(0, min(pos, T - S))
            idx = torch.arange(slot, slot + S)
            sh.write(cache["ckv"], 1, idx, ckv)
            sh.write(cache["kr"], 1, idx, kr)

    Tc = ckv_ctx.shape[1]
    k_nope = _split_heads(ckv_ctx @ wuk, hq)
    vv = _split_heads(ckv_ctx @ wuv, hq)
    k_full = torch.cat([k_nope, kr_ctx[:, None].expand(B, hq, Tc, ropd)],
                       dim=-1)
    if decode:
        o = sh.attend(q_full, k_full, vv, partial,
                      kv_len=torch.full((B,), pos + 1, device=x.device),
                      scale=scale,
                      k_positions=torch.arange(lo, lo + Tc,
                                               device=x.device).expand(B, -1))
    else:
        o = flash_attention(q_full, k_full, vv.contiguous(), causal=True,
                            q_offset=pos, scale=scale)
    return sh.row_out(_merge_heads(o), local, p.wo), cache


def _apply_cross_sharded(cfg, p, x, kind, mode, *, pos, cache, enc, sh):
    """Cross-attention: with ``enc`` (prefill) this rank's heads over every
    encoder position, and its slice of the encoder positions written to
    the cross cache; in decode each rank's partials over its slice of the
    cache merge."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    if enc is not None:
        q, k, v, local = _qkv(sh, p, x, enc.to(dt), H, Hkv, need_full=False)
        if mode in ("prefill", "decode") and cache is not None:
            idx = torch.arange(k.shape[2])
            sh.write(cache["k"], 2, idx, _heads_whole(sh, k, local))
            sh.write(cache["v"], 2, idx, _heads_whole(sh, v, local))
        q, k = _qk_norm_sharded(cfg, sh, p, q, k, local)
        o = chunked_attention(q, k, v, causal=False)
    else:
        local = False
        qx, split = sh.col(x, p.wq)
        q = _split_heads(sh.gather_model(qx, -1) if split else qx, H)
        k, lo, partial = sh.time_view(cache["k"], 2)
        v, _, _ = sh.time_view(cache["v"], 2)
        k, v = k.to(dt), v.to(dt)
        q, k = _qk_norm_sharded(cfg, sh, p, q, k, False)
        B, T = x.shape[0], sh.time_len(cache["k"], 2)
        o = sh.attend(q, k, v, partial,
                      kv_len=torch.full((B,), T, device=x.device),
                      k_positions=torch.arange(lo, lo + k.shape[2],
                                               device=x.device).expand(B, -1))
    y = sh.row_out(_merge_heads(o), local, p.wo)
    if hasattr(p, "gate"):
        y = torch.tanh(sh.on_residual(sh.full(p.gate))).to(dt) * y
    return y, cache
