"""Sequential oracle for the mLSTM cell (xLSTM), for tests only.

The counterpart of ``repro/kernels/mlstm/ref.py``: the stabilized scan,
one step at a time.  Shapes: q, k (B, H, S, dk); v (B, H, S, dv); log_i,
log_f (B, H, S).  State: C (B, H, dk, dv), n (B, H, dk), m (B, H), stored
scaled so that C_true = C * exp(m).

    m_t = max(log_f_t + m_{t-1}, log_i_t)
    C_t = exp(log_f_t + m_{t-1} - m_t) C_{t-1} + exp(log_i_t - m_t) k_t v_t^T
    n_t = exp(log_f_t + m_{t-1} - m_t) n_{t-1} + exp(log_i_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))

q is scaled by dk^-1/2; everything is float32 inside, h is returned in
v's dtype.
"""

from __future__ import annotations

import torch


def init_state(B, H, dk, dv, *, device=None):
    return (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((B, H, dk), dtype=torch.float32, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def mlstm_ref(q, k, v, log_i, log_f, state=None):
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = init_state(B, H, dk, dv, device=q.device)
    C, n, m = (s.float() for s in state)
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    li, lf = log_i.float(), log_f.float()
    hs = []
    for t in range(S):
        m_new = torch.maximum(lf[..., t] + m, li[..., t])
        fs = torch.exp(lf[..., t] + m - m_new)[..., None]
        is_ = torch.exp(li[..., t] - m_new)[..., None]
        C = fs[..., None] * C + is_[..., None] * \
            kf[..., t, :, None] * vf[..., t, None, :]
        n = fs * n + is_ * kf[..., t, :]
        num = torch.einsum("bhk,bhkv->bhv", qf[..., t, :], C)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", qf[..., t, :],
                                         n).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = (torch.stack(hs, 2) if hs
         else torch.zeros((B, H, 0, dv), device=q.device))
    return h.to(v.dtype), (C, n, m)
