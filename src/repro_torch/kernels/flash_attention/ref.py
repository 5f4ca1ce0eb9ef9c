"""O(S^2) oracle for flash attention, for tests only.

The counterpart of ``repro/kernels/flash_attention/ref.py``.  Semantics
shared by every implementation:

- GQA: Hq = g * Hkv, query head h attends with kv head h // g;
- a causal mask on absolute positions: query position q_offset + i;
- an optional sliding window: attend iff q_pos - k_pos < window;
- an optional logit softcap: l = cap * tanh(l / cap);
- an optional kv_len: keys at positions >= kv_len are masked.

Everything accumulates in float32.  A row with no live key averages every
value here (the softmax of a constant row), where the kernels and the
chunked form give 0; the tests never build such a row for this oracle.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  kv_len=None, q_offset=0, scale=None):
    """q: (B, Hq, S, D); k: (B, Hkv, T, D); v: (B, Hkv, T, Dv) -> (B, Hq,
    S, Dv)."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    g = Hq // k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = q_offset + torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhst,bhtd->bhsd", p, vf).to(q.dtype)
