"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` on the
card, its plain PyTorch version on the CPU.

The counterpart of ``repro/kernels/flash_attention/ops.py``:

- ``flash_attention`` is the prefill entry point.  ``impl`` is ``"auto"``
  (the kernel for CUDA tensors, the plain version for CPU tensors) or
  ``"plain"``.  On the card it has two routes, one C entry each and one
  launch a call: bf16 operands go to the tensor-core kernel
  (``flash_attention_bf16``), float32 operands to the CUDA-core kernel
  (``flash_attention_f32``), since TF32 products would not hold the
  float32 path's tolerance.  v has a head dim of its own (MLA's prefill:
  q and k of ``qk_nope + qk_rope``, v of ``v_head``).
- ``chunked_attention`` is the plain version: the online softmax over
  blocks of keys, as the JAX package's ``impl="chunked"``, so it never
  holds the (S, T) scores of more than one block.
- ``decode_attention`` is the single-token decode, plain PyTorch as in the
  JAX package (no Pallas kernel there), including the rolling cache's
  ``k_positions``; ``decode_partial`` gives its running max and sums over
  a slice of the cache, and ``merge_partials`` merges the slices' pieces
  (a cache split over time across ranks).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import registry as kreg
from ..registry import (H100_BF16_FLOPS, KernelSpec, attention_sampler,
                        nbytes, pointers)

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
_TPU = "src/repro/kernels/flash_attention/kernel.py"
_NO_WINDOW = 1 << 62     # the kernel's "no window": past any position
# the C entry of each operand dtype: the tensor cores for bf16, the CUDA
# cores for float32
ROUTES = {torch.bfloat16: "flash_attention_bf16",
          torch.float32: "flash_attention_f32"}
NEG_INF = -1e30

# The JAX spec's feature samples (``flash_attention/ops.py:45-63`` of the
# JAX package): (B, Hq, Hkv, S, T, D, dtype, keywords, tolerance).
FEATURE_CASES = (
    (1, 2, 2, 128, 128, 64, torch.float32, {"causal": True}, 2e-3),
    (2, 4, 2, 128, 256, 64, torch.float32,
     {"causal": True, "q_offset": 128}, 2e-3),
    (1, 4, 4, 256, 256, 64, torch.float32,
     {"causal": True, "window": 64, "softcap": 30.0}, 2e-3),
    (1, 2, 2, 128, 256, 64, torch.float32,
     {"causal": False, "kv_len": 200}, 2e-3),
    (1, 2, 2, 128, 128, 64, torch.bfloat16, {"causal": True}, 2e-2),
)

# v's head dim apart from k's, at the two MLA archs' (D, Dv), small:
# (B, Hq, Hkv, S, T, D, Dv, dtype, keywords, tolerance)
DV_CASES = (
    (1, 2, 2, 128, 128, 96, 64, torch.float32, {"causal": True}, 2e-3),
    (2, 4, 4, 128, 256, 192, 128, torch.float32,
     {"causal": True, "q_offset": 128}, 2e-3),
)
# the MLA prefills of the served archs at a 2048-token prompt, causal, in
# bf16 with the JAX spec's bf16 tolerance: deepseek-v2-lite-16b (16 heads,
# qk_nope 128 + qk_rope 64 against v_head 128) and minicpm3-4b (40 heads,
# 64 + 32 against 64); (name, B, H, S, D, Dv)
MLA_SEQ = 2048
MLA_CASES = (("deepseek-v2-lite-16b", 1, 16, MLA_SEQ, 192, 128),
             ("minicpm3-4b", 1, 40, MLA_SEQ, 96, 64))


def chunked_attention(q, k, v, *, causal=True, window=None, softcap=None,
                      kv_len=None, q_offset=0, scale=None, block_k=512):
    """Online-softmax attention over blocks of ``block_k`` keys, in
    float32; q (B, Hq, S, D), k (B, Hkv, T, D) and v (B, Hkv, T, Dv) ->
    (B, Hq, S, Dv) in q's dtype.  Query head h reads kv head
    h // (Hq // Hkv)."""
    B, Hq, S, D = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[-1]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    eff_len = T if kv_len is None else kv_len
    dev = q.device
    qf = (q.float() * scale).reshape(B, Hkv, g, S, D)
    q_pos = q_offset + torch.arange(S, device=dev)
    m = torch.full((B, Hkv, g, S), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, g, S), device=dev)
    acc = torch.zeros((B, Hkv, g, S, Dv), device=dev)
    for j0 in range(0, T, block_k):
        kj = k[:, :, j0:j0 + block_k].float()
        vj = v[:, :, j0:j0 + block_k].float()
        s = torch.einsum("bhgsd,bhtd->bhgst", qf, kj)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = j0 + torch.arange(kj.shape[2], device=dev)
        mask = (k_pos[None, :] < eff_len).expand(S, -1)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhtd->bhgsd", p,
                                                    vj)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, Hq, S, Dv).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    kv_len=None, q_offset=0, scale=None, impl="auto"):
    """q: (B, Hq, S, D); k: (B, Hkv, T, D); v: (B, Hkv, T, Dv) -> (B, Hq,
    S, Dv).  The kernel takes contiguous float32 or bfloat16 operands of
    one dtype and 0 < D, Dv <= 256; ``kv_len`` and ``q_offset`` are
    ints.

    On the card, with grad mode on and an operand that requires grad, the
    output carries a gradient: the kernel's forward, and the backward of
    ``chunked_attention`` recomputed (``registry.differentiable``)."""
    kw = {"causal": causal, "window": window, "softcap": softcap,
          "kv_len": kv_len, "q_offset": q_offset, "scale": scale}
    if not kreg.use_kernel(impl, q, k, v):
        return chunked_attention(q, k, v, **kw)
    return kreg.differentiable(lambda q, k, v: _launch(q, k, v, **kw),
                               lambda q, k, v: chunked_attention(q, k, v,
                                                                 **kw),
                               q, k, v)


def _launch(q, k, v, *, causal, window, softcap, kv_len, q_offset, scale):
    """One launch of the route of q's dtype, after the operand checks."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q (B, Hq, S, D), k (B, Hkv, T, "
                         f"D) and v (B, Hkv, T, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    _, Hkv, T, Dk = k.shape
    Dv = v.shape[-1]
    if k.shape[0] != B or Dk != D or Hq % Hkv or not 0 < D <= 256 or \
            not 0 < Dv <= 256 or S < 1:
        raise ValueError(f"flash_attention: the kernel takes matching "
                         f"batch, head dims of at most 256 and Hq % Hkv == "
                         f"0, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    dt = q.dtype
    if dt not in ROUTES:
        raise TypeError(f"flash_attention: kernel takes float32 or "
                        f"bfloat16, got {dt}")
    kv_end = T if kv_len is None else max(0, min(int(kv_len), T))
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = q.new_empty((B, Hq, S, Dv))
    *ptrs, s = pointers((q, dt, "q"), (k, dt, "k"), (v, dt, "v"))
    FLASH_ATTENTION.launch(
        *ptrs, out.data_ptr(), B, Hq, Hkv, S, T, D, Dv, scale,
        0.0 if softcap is None else float(softcap), int(bool(causal)),
        _NO_WINDOW if window is None else int(window), kv_end,
        int(q_offset), s, entry=ROUTES[dt],
        work=(q, k, v, {"causal": causal, "window": window,
                        "kv_len": kv_len, "q_offset": q_offset}, None))
    return out


def decode_attention(q, k, v, *, kv_len, window=None, softcap=None,
                     scale=None, k_positions=None):
    """Single-token decode: q (B, Hq, 1, D) against a (B, Hkv, T, D) key
    and a (B, Hkv, T, Dv) value cache.

    By default cache slot t holds absolute position t and positions >=
    kv_len are masked; a rolling (windowed) cache passes ``k_positions``
    (B, T) with -1 for empty slots.  The query's absolute position is
    kv_len - 1; ``kv_len`` is an int or a (B,) tensor."""
    acc, l, _ = decode_partial(q, k, v, kv_len=kv_len, window=window,
                               softcap=softcap, scale=scale,
                               k_positions=k_positions)
    B, Hq = q.shape[:2]
    out = acc / l.clamp(min=1e-30)
    return out.reshape(B, Hq, 1, v.shape[-1]).to(q.dtype)


def decode_partial(q, k, v, *, kv_len, window=None, softcap=None,
                   scale=None, k_positions=None):
    """The unnormalized pieces of ``decode_attention`` over the keys it is
    given: ``(acc, l, m)``, each (B, Hkv, g, .) in float32, with ``m`` the
    row's largest live logit, ``l = sum_t p_t`` and ``acc = sum_t p_t v_t``
    for ``p_t = exp(s_t - m)``.  Partials over disjoint sets of keys (a
    cache split over time) merge exactly into the whole softmax
    (:func:`merge_partials`); ``acc / l`` is ``decode_attention``."""
    B, Hq, _, D = q.shape
    _, Hkv, T, _ = k.shape
    g = Hq // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = (q.float() * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.as_tensor(kv_len, device=dev).to(torch.int64) - 1
    if k_positions is None:
        k_pos = torch.arange(T, device=dev).expand(B, T)
    else:
        k_pos = torch.as_tensor(k_positions, device=dev).to(torch.int64)
    k_pos = k_pos[:, None, None, :]
    qp = q_pos.expand(B).reshape(-1, 1, 1, 1)
    mask = (k_pos >= 0) & (k_pos <= qp)
    if window is not None:
        mask = mask & ((qp - k_pos) < window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    return torch.einsum("bhgt,bhtd->bhgd", p, v.float()), \
        p.sum(-1, keepdim=True), m


def merge_partials(acc, l, m):
    """The softmax of the union of the key sets whose ``decode_partial``
    pieces are stacked on dim 0: each set's sums rescaled to the largest
    max, then normalized once.  A set with no live key (``m`` at
    ``NEG_INF``, ``l`` 0) adds nothing."""
    top = m.amax(0)
    w = torch.exp(m - top)
    return (w * acc).sum(0) / (w * l).sum(0).clamp(min=1e-30)


def live_pairs(S, T, *, causal=True, window=None, kv_len=None,
               q_offset=0) -> int:
    """(query, key) pairs that the mask leaves live, per (batch, head):
    the work the data needs, whatever the kernel's tiles visit."""
    qp = q_offset + np.arange(S, dtype=np.int64)
    hi = np.full(S, T if kv_len is None else min(kv_len, T), np.int64)
    if causal:
        hi = np.minimum(hi, qp + 1)
    lo = (np.zeros(S, np.int64) if window is None
          else np.maximum(qp - window + 1, 0))
    return int(np.maximum(hi - lo, 0).sum())


def _flops(q, k, v, kw, mask) -> int:
    """2 (D + Dv) flops per live pair (2 D for q.k, 2 Dv for p.v) on every
    (batch, query head)."""
    B, Hq, S, D = q.shape
    return 2 * (D + v.shape[-1]) * B * Hq * live_pairs(S, k.shape[2], **{
        key: kw[key] for key in ("causal", "window", "kv_len", "q_offset")
        if key in kw})


def _nbytes(q, k, v, kw, mask) -> int:
    """q, k and v read once and an output of v's head dim written once."""
    return nbytes(q, k, v) + q.numel() // q.shape[-1] * v.shape[-1] * \
        q.element_size()


def _sdpa(q, k, v, kw, mask):
    """The library yardstick: PyTorch's fused attention with the same
    boolean mask and grouped heads (and v's own head dim).  Timed only;
    no path calls it."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


# -- spec: the prefill's shape on the LM path (recurrentgemma-2b's local
# layers at the longest prompt), bytes, flops, yardstick --------------------

FLASH_ATTENTION = kreg.register(KernelSpec(
    name="flash_attention", replaces=f"{_TPU}:100",
    tpu_function="flash_attention_pallas", source=_SOURCE,
    entry=ROUTES[torch.bfloat16],
    argtypes=(_P, _P, _P, _P, _N, _N, _N, _N, _N, _N, _N, ctypes.c_float,
              ctypes.c_float, ctypes.c_int, _N, _N, _N, _P),
    kernel=lambda q, k, v, kw, mask: flash_attention(q, k, v, **kw),
    plain=lambda q, k, v, kw, mask: chunked_attention(q, k, v, **kw),
    # the sample is bf16, the served dtype: held, as the card tests hold
    # the bf16 route, to the JAX spec's bf16 tolerance (its last feature
    # sample's); the tensor cores take P as bf16, where the float32 plain
    # version keeps its low bits
    tol=2e-3, sample_tol=FEATURE_CASES[-1][-1], sample=attention_sampler(),
    nbytes=_nbytes,
    flops=_flops, peak_flops=H100_BF16_FLOPS, library=_sdpa,
    # the bf16 route's tile (kMmaBQ x kMmaBK), fixed by its mma.sync
    # fragments and shared-memory plan: one candidate, compiled in
    block_args=("bq", "bk"), default_block=(64, 64),
))
