"""Sequential oracle for the RG-LRU linear recurrence, for tests only.

The counterpart of ``repro/kernels/rg_lru/ref.py``:

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(log_a_t)

log_a, b: (B, S, W); h0: (B, W).  Returns (h: (B, S, W), h_last), in b's
dtype, with the state carried in float32.
"""

from __future__ import annotations

import torch


def rg_lru_ref(log_a, b, h0):
    h = h0.float()
    hs = []
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t].float()) * h + b[:, t].float()
        hs.append(h)
    out = (torch.stack(hs, 1) if hs
           else torch.zeros(b.shape, dtype=torch.float32, device=b.device))
    return out.to(b.dtype), h.to(b.dtype)
