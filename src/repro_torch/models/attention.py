"""Attention layers, as ``repro/models/attention.py``: GQA with global
(``attn``) or sliding-window (``local``) masks.

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

Unlike the JAX package, prefill and decode write the cache they are given
in place and return it: the new cache is the old one, updated, so a
decode step moves one token of K and V and nothing else.  Prefill runs
``flash_attention`` (the CUDA kernel on the card), decode the plain
``decode_attention``.  ``mla`` and ``cross`` come with a later slice.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import decode_attention, flash_attention
from .layers import Params, dense_init, ones, rms_norm, rope, wuse

_LATER = ("the {} attention kind is not ported yet: it comes with the "
          "configs that use it (ROADMAP Queue 1, the other LM configs)")


def init(cfg, kind, *, generator=None, device=None) -> Params:
    if kind in ("mla", "cross"):
        raise NotImplementedError(_LATER.format(kind))
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(shape):
        return dense_init(generator, shape, dtype=cfg.cdtype, device=device)

    p = {"wq": w((d, H * hd)), "wk": w((d, Hkv * hd)),
         "wv": w((d, Hkv * hd)), "wo": w((H * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = ones(hd, device)
        p["k_norm"] = ones(hd, device)
    return Params(**p)


def init_cache(cfg, kind, batch, max_len, dtype, *, device=None):
    if kind in ("mla", "cross"):
        raise NotImplementedError(_LATER.format(kind))
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    T = min(cfg.window, max_len) if kind == "local" else max_len
    return {"k": torch.zeros((batch, Hkv, T, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, Hkv, T, hd), dtype=dtype, device=device)}


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
    if kind in ("mla", "cross"):
        raise NotImplementedError(_LATER.format(kind))
    B, S, _ = x.shape
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    window = cfg.window if kind == "local" else None
    dt = x.dtype

    q = _split_heads(x @ wuse(p.wq, dt), H)
    k = _split_heads(x @ wuse(p.wk, dt), Hkv)
    v = _split_heads(x @ wuse(p.wv, dt), Hkv)
    q, k = _maybe_qk_norm(cfg, p, q, k)

    if mode == "decode":
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = (pos + torch.arange(S, device=x.device))[None]
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
