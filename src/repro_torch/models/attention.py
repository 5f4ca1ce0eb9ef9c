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


def apply(cfg, p, x, kind, mode, *, pos=0, cache=None, enc=None):
    """x: (B, S, d).  Returns (y, new_cache)."""
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
