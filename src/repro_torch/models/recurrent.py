"""Recurrent blocks, as ``repro/models/recurrent.py``: the RG-LRU block of
RecurrentGemma/Griffin and the mLSTM and sLSTM blocks of xLSTM.  Same
init/apply contract as ``attention.py``; the "cache" is the recurrent
state (constant memory).

The prefills' scans run ``rg_lru_scan`` and ``mlstm_scan`` (the CUDA
kernels on the card), decode the plain ``rg_lru_step`` and
``mlstm_step``.  The sLSTM has no Pallas kernel in the JAX package: its
prefill is a loop over time of the plain cell, as the JAX package's
``lax.scan``.  The gate products that the JAX package computes in
float32 (RG-LRU ``bx @ wa``, ``bx @ wi``; mLSTM ``c @ wif``; the sLSTM
recurrence) are float32 here too, with their weights stored in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mlstm import init_state as mlstm_init_state
from ..kernels.mlstm import mlstm_scan, mlstm_step
from ..kernels.rg_lru import rg_lru_scan, rg_lru_step
from .layers import ACTS, Params, dense_init, zeros

C_RGLRU = 8.0  # Griffin's gate sharpness constant


def rglru_init(cfg, *, generator=None, device=None) -> Params:
    d, w = cfg.d_model, cfg.rnn_width
    dev = torch.device(device)

    def init(shape, scale=0.02, dtype=cfg.cdtype):
        return dense_init(generator, shape, scale, dtype=dtype, device=dev)

    if dev.type == "meta":
        lam = torch.empty((w,), device=dev)
    else:
        # a = sigmoid(lam) starts between 0.9 and 0.999
        a = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=dev)
        lam = torch.log(a / (1 - a))
    return Params(
        wx=init((d, w)), wy=init((d, w)), conv=init((cfg.conv_width, w), 0.1),
        wa=init((w, w), dtype=torch.float32), ba=zeros((w,), dev),
        wi=init((w, w), dtype=torch.float32), bi=zeros((w,), dev),
        lam=lam, wo=init((w, d)))


def rglru_state(cfg, batch, dtype, *, device=None):
    return {"h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                                dtype=dtype, device=device)}


def _causal_conv(x, w, tail):
    """Depthwise causal conv.  x: (B, S, W), w: (K, W), tail: (B, K-1, W).
    Terms are summed in the JAX package's order."""
    K = w.shape[0]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    new_tail = xp[:, -(K - 1):].contiguous() if K > 1 else tail
    return out, new_tail


def rglru_apply(cfg, p, x, mode, *, state=None, pos=0):
    B, S, d = x.shape
    dt = x.dtype
    if state is None:
        state = rglru_state(cfg, B, dt, device=x.device)
    bx = x @ p.wx.to(dt)
    by = ACTS["gelu"](x @ p.wy.to(dt))
    bx, conv_tail = _causal_conv(bx, p.conv, state["conv"])

    bxf = bx.float()
    r = torch.sigmoid(bxf @ p.wa + p.ba)
    i = torch.sigmoid(bxf @ p.wi + p.bi)
    log_a = -C_RGLRU * F.softplus(p.lam) * r              # (B, S, W)
    gated = i * bxf
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * gated

    if mode == "decode":
        h = rg_lru_step(log_a[:, 0], b[:, 0], state["h"])
        hs = h[:, None]
        new_state = {"h": h.float(), "conv": conv_tail}
    else:
        hs, h_last = rg_lru_scan(log_a, b, state["h"])
        new_state = {"h": h_last.float().contiguous(), "conv": conv_tail}

    y = (hs.to(dt) * by) @ p.wo.to(dt)
    return y, new_state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): up-proj, conv, matrix-memory cell, gated down-proj
# ---------------------------------------------------------------------------

def mlstm_init(cfg, *, generator=None, device=None) -> Params:
    d = cfg.d_model
    di = int(d * cfg.proj_factor)
    H = cfg.rnn_heads
    dev = torch.device(device)

    def init(shape, scale=0.02, dtype=cfg.cdtype):
        return dense_init(generator, shape, scale, dtype=dtype, device=dev)

    bif = torch.cat([torch.zeros((H,), device=dev),
                     3.0 * torch.ones((H,), device=dev)])
    return Params(
        up=init((d, di)), gate=init((d, di)),
        conv=init((cfg.conv_width, di), 0.1),
        wq=init((di, di)), wk=init((di, di)), wv=init((di, di)),
        wif=init((di, 2 * H), 0.1, dtype=torch.float32), bif=bif,
        down=init((di, d)))


def mlstm_state(cfg, batch, dtype, *, device=None):
    di = int(cfg.d_model * cfg.proj_factor)
    H = cfg.rnn_heads
    hd = di // H
    C, n, m = mlstm_init_state(batch, H, hd, hd, device=device)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                                device=device)}


def _heads(x, H):
    """(B, S, H * hd) -> (B, H, S, hd), contiguous for the kernel."""
    B, S, di = x.shape
    return x.reshape(B, S, H, di // H).transpose(1, 2).contiguous()


def mlstm_apply(cfg, p, x, mode, *, state=None, pos=0):
    B, S, d = x.shape
    dt = x.dtype
    H = cfg.rnn_heads
    if state is None:
        state = mlstm_state(cfg, B, dt, device=x.device)
    u = x @ p.up.to(dt)
    z = x @ p.gate.to(dt)
    c, conv_tail = _causal_conv(u, p.conv, state["conv"])
    c_act = ACTS["silu"](c)
    q = _heads(c_act @ p.wq.to(dt), H)
    k = _heads(c_act @ p.wk.to(dt), H)
    v = _heads(u @ p.wv.to(dt), H)
    gates = c_act.float() @ p.wif + p.bif                  # (B, S, 2H)
    log_i = gates[..., :H].transpose(1, 2).contiguous()    # (B, H, S)
    log_f = F.logsigmoid(gates[..., H:]).transpose(1, 2).contiguous()

    st = (state["C"], state["n"], state["m"])
    if mode == "decode":
        h, st = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           log_i[:, :, 0], log_f[:, :, 0], st)
        h = h[:, :, None]
    else:
        h, st = mlstm_scan(q, k, v, log_i, log_f, st)
    hm = h.transpose(1, 2).reshape(B, S, -1)               # merge heads
    y = (hm.to(dt) * ACTS["silu"](z)) @ p.down.to(dt)
    new_state = {"C": st[0], "n": st[1], "m": st[2], "conv": conv_tail}
    return y, new_state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, exp gating, block-diag recurrence
# ---------------------------------------------------------------------------

def slstm_init(cfg, *, generator=None, device=None) -> Params:
    d = cfg.d_model
    H = cfg.rnn_heads
    hd = d // H
    dev = torch.device(device)

    def init(shape, dtype=cfg.cdtype):
        return dense_init(generator, shape, dtype=dtype, device=dev)

    p = {f"w{g}": init((d, d)) for g in "ifzo"}
    p.update({f"r{g}": init((H, hd, hd), torch.float32) for g in "ifzo"})
    p["b"] = torch.cat([torch.zeros((d,), device=dev),
                        3.0 * torch.ones((d,), device=dev),
                        torch.zeros((2 * d,), device=dev)])
    dff = int(d * 4 / 3)
    p["ff_up"] = init((d, dff))
    p["ff_gate"] = init((d, dff))
    p["ff_down"] = init((dff, d))
    return Params(**p)


def slstm_state(cfg, batch, dtype, *, device=None):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return {"c": z, "n": z, "m": z, "h": z}


def _slstm_cell(cfg, r, b, xt, st):
    """One step.  xt: (B, 4d) float32 pre-projections applied outside; r:
    the four recurrence matrices stacked (4, H, hd, hd) in the order i, f,
    z, o, so one product gives the four gates' recurrent terms."""
    H = cfg.rnn_heads
    d = cfg.d_model
    h = st["h"].reshape(-1, H, d // H)
    rec = torch.einsum("bhk,ghkj->bghj", h, r).reshape(-1, 4 * d)
    xi, xf, xz, xo = torch.split(xt + rec + b, d, -1)
    log_i = xi
    log_f = F.logsigmoid(xf)
    m_new = torch.maximum(log_f + st["m"], log_i)
    i = torch.exp(log_i - m_new)
    f = torch.exp(log_f + st["m"] - m_new)
    z = torch.tanh(xz)
    o = torch.sigmoid(xo)
    c = f * st["c"] + i * z
    n = f * st["n"] + i
    h_new = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h_new}


def _stacked_r(p):
    """``p``'s four recurrence matrices stacked (4, H, hd, hd), made on the
    first call and again only after one of them moved or was written (a
    new storage or version), not on every prefill and decode step.  While
    autograd records (a train step) the stack is made afresh: one cached
    from a call without autograd (a served prefill) would carry no
    gradient to the matrices."""
    rs = [getattr(p, f"r{g}") for g in "ifzo"]
    if torch.is_grad_enabled() and any(r.requires_grad for r in rs):
        return torch.stack(rs)
    key = tuple((r.data_ptr(), r._version) for r in rs)
    cached = p.__dict__.get("_r_stacked")
    if cached is None or cached[0] != key:
        cached = (key, torch.stack(rs))
        p.__dict__["_r_stacked"] = cached
    return cached[1]


def slstm_apply(cfg, p, x, mode, *, state=None, pos=0):
    B, S, d = x.shape
    dt = x.dtype
    if state is None:
        state = slstm_state(cfg, B, dt, device=x.device)
    xg = torch.cat([x @ getattr(p, f"w{g}").to(dt) for g in "ifzo"],
                   -1).float()                             # (B, S, 4d)
    r = _stacked_r(p)
    if mode == "decode":
        st = _slstm_cell(cfg, r, p.b, xg[:, 0], state)
        hs = st["h"][:, None]
    else:
        st, hs = state, []
        for t in range(S):
            st = _slstm_cell(cfg, r, p.b, xg[:, t], st)
            hs.append(st["h"])
        hs = torch.stack(hs, 1)
    hs = hs.to(dt)
    ff = (ACTS["silu"](hs @ p.ff_gate.to(dt)) *
          (hs @ p.ff_up.to(dt))) @ p.ff_down.to(dt)
    return ff, st
