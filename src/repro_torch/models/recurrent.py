"""Recurrent blocks, as ``repro/models/recurrent.py``: the RG-LRU block of
RecurrentGemma/Griffin.  Same init/apply contract as ``attention.py``;
the "cache" is the recurrent state (constant memory).

The prefill's scan runs ``rg_lru_scan`` (the CUDA kernel on the card),
decode the plain ``rg_lru_step``.  The gate products ``bx @ wa`` and
``bx @ wi`` are float32 products, as in the JAX package.  The xLSTM
blocks (mLSTM, sLSTM) come with the next slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rg_lru import rg_lru_scan, rg_lru_step
from .layers import ACTS, Params, dense_init, zeros

C_RGLRU = 8.0  # Griffin's gate sharpness constant
_LATER = ("the {} block is not ported yet: it comes with xlstm-350m in the "
          "next slice of the port (ROADMAP)")


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


def _not_ported(kind):
    def fn(*args, **kwargs):
        raise NotImplementedError(_LATER.format(kind))
    return fn


mlstm_init = mlstm_state = mlstm_apply = _not_ported("mlstm")
slstm_init = slstm_state = slstm_apply = _not_ported("slstm")
