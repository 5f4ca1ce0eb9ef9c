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

With a ``shard`` (``models.sharding.Sharding``) each block runs this
rank's part of a sharded step: the up-projections on this rank's columns,
the down-projections on its rows and one all-reduce over the model axis.
The RG-LRU's gates, conv and scan run on this rank's channels of the LRU
width (``rg_lru`` on them); the mLSTM's conv on its channels, and its
cell on its heads where the heads divide the model axis (``mlstm`` on
them), else on every head (the channels gathered); the sLSTM cell (a
plain loop over time) runs whole on every rank.  A serving state is
gathered over the model axis where its split is not the block's, and
each rank keeps its part of the new one (``Sharding.state_get``/
``state_put``); a train step starts from zeros of the block's part.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mlstm import init_state as mlstm_init_state
from ..kernels.mlstm import mlstm_scan, mlstm_step
from ..kernels.rg_lru import rg_lru_scan, rg_lru_step
from .layers import ACTS, Params, dense_init, zeros

C_RGLRU = 8.0  # Griffin's gate sharpness constant
# the matrices drawn at another scale than dense_init's 0.02
DENSE_SCALE = {("rglru", "conv"): 0.1, ("mlstm", "conv"): 0.1,
               ("mlstm", "wif"): 0.1}


def rglru_lam(w, generator, device) -> torch.Tensor:
    """The RG-LRU's ``lam``: a = sigmoid(lam) starts between 0.9 and 0.999.
    The block's init draws it before its matrices."""
    if torch.device(device).type == "meta":
        return torch.empty((w,), device=device)
    a = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=device)
    return torch.log(a / (1 - a))


def mlstm_bif(H, device) -> torch.Tensor:
    """The mLSTM's gate biases: input 0, forget 3, each of H heads."""
    return torch.cat([torch.zeros((H,), device=device),
                      3.0 * torch.ones((H,), device=device)])


def slstm_bias(d, device) -> torch.Tensor:
    """The sLSTM's gate biases (i, f, z, o): the forget gate's 3."""
    return torch.cat([torch.zeros((d,), device=device),
                      3.0 * torch.ones((d,), device=device),
                      torch.zeros((2 * d,), device=device)])


def init_leaf(cfg, kind, leaf, shape, dtype, generator, device):
    """One leaf of a ``kind`` block as the block's init makes it, for an
    init leaf by leaf (``models.sharding.init_shards``), called in the
    init's order; the RG-LRU's ``lam`` is :func:`rglru_lam`'s."""
    if len(shape) >= 2:
        return dense_init(generator, shape,
                          DENSE_SCALE.get((kind, leaf), 0.02), dtype=dtype,
                          device=device)
    if kind == "mlstm" and leaf == "bif":
        return mlstm_bif(cfg.rnn_heads, device)
    if kind == "slstm" and leaf == "b":
        return slstm_bias(cfg.d_model, device)
    return zeros(shape, device)


def rglru_init(cfg, *, generator=None, device=None) -> Params:
    d, w = cfg.d_model, cfg.rnn_width
    dev = torch.device(device)

    def init(shape, scale=0.02, dtype=cfg.cdtype):
        return dense_init(generator, shape, scale, dtype=dtype, device=dev)

    lam = rglru_lam(w, generator, dev)
    return Params(
        wx=init((d, w)), wy=init((d, w)),
        conv=init((cfg.conv_width, w), DENSE_SCALE["rglru", "conv"]),
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


def rglru_apply(cfg, p, x, mode, *, state=None, pos=0, shard=None):
    if shard is not None:
        return _rglru_sharded(cfg, p, x, mode, state, shard)
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

    return Params(
        up=init((d, di)), gate=init((d, di)),
        conv=init((cfg.conv_width, di), DENSE_SCALE["mlstm", "conv"]),
        wq=init((di, di)), wk=init((di, di)), wv=init((di, di)),
        wif=init((di, 2 * H), DENSE_SCALE["mlstm", "wif"],
                 dtype=torch.float32),
        bif=mlstm_bif(H, dev), down=init((di, d)))


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


def mlstm_apply(cfg, p, x, mode, *, state=None, pos=0, shard=None):
    if shard is not None:
        return _mlstm_sharded(cfg, p, x, mode, state, shard)
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
    p["b"] = slstm_bias(d, dev)
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


def slstm_apply(cfg, p, x, mode, *, state=None, pos=0, shard=None):
    if shard is not None:
        return _slstm_sharded(cfg, p, x, mode, state, shard)
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


# ---------------------------------------------------------------------------
# one rank's part of a sharded step
# ---------------------------------------------------------------------------

def _state_in(sh, state, key, dim, make):
    """A state leaf as the block computes on it (this rank's part along
    ``dim``, or whole when None); ``make()`` (zeros) without a state."""
    return make() if state is None else \
        sh.state_get(state[key], dim).contiguous()


def _state_out(sh, state, new, dims):
    """The cache's state updated in place with ``new`` (each leaf this
    rank's part along its entry of ``dims``); None without a state (a
    train step keeps none)."""
    if state is None:
        return None
    with torch.no_grad():
        for k, v in new.items():
            sh.state_put(state[k], v, dims[k])
    return state


def _rglru_sharded(cfg, p, x, mode, state, sh):
    """The RG-LRU block on this rank's channels of the LRU width (all of
    them where the width does not divide the model axis): its columns of
    ``wx``/``wy``, its taps of the conv, its gates (from every channel of
    ``bx``, gathered) and its part of the scan's state; ``wo`` row-split
    and one all-reduce."""
    B, S, _ = x.shape
    dt = x.dtype
    W = cfg.rnn_width
    local = sh.M > 1 and W % sh.M == 0
    w = W // sh.M if local else W
    cdim = 1 if local else None
    bx = sh.col_as(x, p.wx, local)
    by = ACTS["gelu"](sh.col_as(x, p.wy, local))
    tail = _state_in(sh, state, "conv", 2 if local else None, lambda: (
        torch.zeros((B, cfg.conv_width - 1, w), dtype=dt, device=x.device)))
    bx, conv_tail = _causal_conv(bx, sh.part(p.conv, 1, local), tail)

    bxf = bx.float()
    bx_all = sh.gather_model(bxf, -1) if local else bxf
    r = torch.sigmoid(sh.col_as(bx_all, p.wa, local) +
                      sh.part(p.ba, 0, local))
    i = torch.sigmoid(sh.col_as(bx_all, p.wi, local) +
                      sh.part(p.bi, 0, local))
    log_a = -C_RGLRU * F.softplus(sh.part(p.lam, 0, local)) * r
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * bxf)
    h0 = _state_in(sh, state, "h", cdim, lambda: torch.zeros(
        (B, w), dtype=torch.float32, device=x.device))
    if mode == "decode":
        h = rg_lru_step(log_a[:, 0], b[:, 0], h0)
        hs, h_last = h[:, None], h
    else:
        hs, h_last = rg_lru_scan(log_a.contiguous(), b.contiguous(), h0)
    y = sh.row_out(hs.to(dt) * by, local, p.wo)
    return y, _state_out(sh, state, {"h": h_last.float(), "conv": conv_tail},
                         {"h": cdim, "conv": 2 if local else None})


def _mlstm_sharded(cfg, p, x, mode, state, sh):
    """The mLSTM block: ``up``/``gate`` and the conv on this rank's
    channels of the inner width; q, k and v on its heads where the heads
    divide the model axis (the cell, ``mlstm``, on them), else on every
    head; the gates' row-split ``wif`` and ``down`` each with one
    all-reduce."""
    B, S, _ = x.shape
    dt = x.dtype
    H = cfg.rnn_heads
    di = int(cfg.d_model * cfg.proj_factor)
    hd = di // H
    local = sh.M > 1 and di % sh.M == 0
    heads = local and H % sh.M == 0
    Hl = H // sh.M if heads else H
    u = sh.col_as(x, p.up, local)
    z = sh.col_as(x, p.gate, local)
    tail = _state_in(sh, state, "conv", 2 if local else None, lambda: (
        torch.zeros((B, cfg.conv_width - 1, u.shape[-1]), dtype=dt,
                    device=x.device)))
    c, conv_tail = _causal_conv(u, sh.part(p.conv, 1, local), tail)
    c_act = ACTS["silu"](c)
    c_all = sh.gather_model(c_act, -1) if local else c_act
    u_all = sh.gather_model(u, -1) if local else u
    q = _heads(sh.col_as(c_all, p.wq, heads), Hl)
    k = _heads(sh.col_as(c_all, p.wk, heads), Hl)
    v = _heads(sh.col_as(u_all, p.wv, heads), Hl)
    gates = sh.row(c_act.float(), local, p.wif) + sh.full(p.bif)
    log_i = gates[..., :H].transpose(1, 2)                 # (B, H, S)
    log_f = F.logsigmoid(gates[..., H:]).transpose(1, 2)
    if heads:
        log_i, log_f = sh.chunk(log_i, 1), sh.chunk(log_f, 1)
    log_i, log_f = log_i.contiguous(), log_f.contiguous()

    hdim = 1 if heads else None
    zeros = mlstm_init_state(B, Hl, hd, hd, device=x.device)
    st = tuple(_state_in(sh, state, key, hdim, lambda z=z0: z)
               for key, z0 in zip("Cnm", zeros))
    if mode == "decode":
        h, st = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                           log_i[:, :, 0], log_f[:, :, 0], st)
        h = h[:, :, None]
    else:
        h, st = mlstm_scan(q, k, v, log_i, log_f, st)
    hm = h.transpose(1, 2).reshape(B, S, -1)               # merge heads
    if local and not heads:
        hm = sh.chunk(hm, -1)
    y = sh.row_out(hm.to(dt) * ACTS["silu"](z), local, p.down)
    new = {"C": st[0], "n": st[1], "m": st[2], "conv": conv_tail}
    return y, _state_out(sh, state, new, {"C": hdim, "n": hdim, "m": hdim,
                                          "conv": 2 if local else None})


def _slstm_sharded(cfg, p, x, mode, state, sh):
    """The sLSTM block whole on every rank (its cell is a plain loop over
    time): the gate projections' columns gathered, the recurrence whole,
    the feed-forward as the sharded MLP."""
    from types import SimpleNamespace

    from .layers import mlp_partial
    B, S, d = x.shape
    dt = x.dtype
    xg = torch.cat([sh.proj_full(x, getattr(p, f"w{g}")) for g in "ifzo"],
                   -1).float()
    r = torch.stack([sh.full(getattr(p, f"r{g}")) for g in "ifzo"])
    b = sh.full(p.b)
    st = {k: _state_in(sh, state, k, None, lambda: torch.zeros(
        (B, d), dtype=torch.float32, device=x.device)) for k in "cnmh"}
    if mode == "decode":
        st = _slstm_cell(cfg, r, b, xg[:, 0], st)
        hs = st["h"][:, None]
    else:
        hs = []
        for t in range(S):
            st = _slstm_cell(cfg, r, b, xg[:, t], st)
            hs.append(st["h"])
        hs = torch.stack(hs, 1)
    ff = SimpleNamespace(up=p.ff_up, gate=p.ff_gate, down=p.ff_down)
    y = sh.to_residual(*mlp_partial(ff, hs.to(dt), "silu", sh))
    return y, _state_out(sh, state, st, dict.fromkeys("cnmh"))
