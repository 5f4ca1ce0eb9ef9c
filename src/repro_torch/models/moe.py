"""Mixture-of-Experts FFN with sort-based capacity dispatch, as
``repro/models/moe.py``.

Top-k routing -> stable sort by expert -> gather into a per-expert
capacity buffer (E, C, d) -> batched expert matmuls -> gather back and
combine.  FLOPs scale with top_k (not n_experts); overflow tokens beyond
capacity are dropped (GShard policy).  The capacity comes from the real
expert count: padded experts (``init(pad_to=...)``, the JAX package's
padding for expert parallelism) are masked out of the router and receive
no tokens.  The router runs in float32, the experts in the compute dtype,
as there; the expert products are ``torch.einsum`` (batched matmuls), as
the JAX package leaves them to XLA and not to a Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ACTS, Params, dense_init, mlp, mlp_params, mlp_partial


def init(cfg, generator=None, pad_to: int = 1, *, device=None) -> Params:
    """The router (float32, (d, Ep)), the stacked experts ``gate``, ``up``
    (Ep, d, f) and ``down`` (Ep, f, d), and the shared experts' MLPs;
    Ep is n_experts padded up to a multiple of ``pad_to``."""
    d, dff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    Ep = -(-E // pad_to) * pad_to

    def w(shape, dtype=cfg.cdtype):
        return dense_init(generator, shape, dtype=dtype, device=device)

    p = {"router": w((d, Ep), torch.float32),
         "experts": Params(gate=w((Ep, d, dff)), up=w((Ep, d, dff)),
                           down=w((Ep, dff, d)))}
    for i in range(cfg.n_shared_experts):
        p[f"shared{i}"] = mlp_params(generator, d, dff, dtype=cfg.cdtype,
                                     device=device)
    return Params(**p)


def apply(cfg, p, x, *, capacity_factor=None, shard=None):
    """x: (B, S, d) -> (B, S, d), aux metrics {"lb_loss", "dropped"}.
    ``shard``: this rank's part of a sharded step (x its batch rows; the
    gradient through its collectives: ``models/sharding.py``)."""
    dt = x.dtype
    dev = x.device
    xs = x if shard is None else shard.gather_rows(x)
    B, S, d = xs.shape
    k = cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    N = B * S
    # capacity from the REAL expert count (dummies receive no tokens)
    C = max(int(math.ceil(N * k / cfg.n_experts * cf)), 1)

    xf = xs.reshape(N, d)
    if shard is None:
        logits = xf.float() @ p.router
    else:
        logits = shard.proj_full(shard.seq_like(xf.float(), x), p.router)
        # the dispatch computes on every model rank alike
        xf = shard.own(shard.seq_like(xf, x))
    E = logits.shape[1]                         # padded expert count
    emask = torch.arange(E, device=dev) < cfg.n_experts
    logits = torch.where(emask[None], logits, -1e30)
    gates = torch.softmax(logits, dim=-1)
    topw, tope = torch.topk(gates, k, dim=-1)   # (N, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)

    # sort token-assignments by expert -> position within expert group
    flat_e = tope.reshape(-1)                   # (N k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(N * k, device=dev) - seg_start[sorted_e]
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)

    # dispatch as a gather: slot (e, c) pulls sorted assignment
    # seg_start[e] + c
    j = torch.arange(E * C, device=dev)
    e_of = j // C
    idx_sorted = seg_start[e_of] + j % C
    seg_end = torch.cat([seg_start[1:], seg_start.new_tensor([N * k])])
    valid = idx_sorted < seg_end[e_of]
    assign = order[idx_sorted.clamp(max=N * k - 1)]
    buf = torch.where(valid[:, None], xf[assign // k], 0).reshape(E, C, d)

    a = ACTS[cfg.act]
    eg = p.experts
    gate, up, down, lo, split = eg.gate, eg.up, eg.down, 0, False
    if shard is not None:
        # this rank's experts (all of them where the spec does not split
        # the expert dim), gathered over the data axes for this use
        (gate, split), (up, _), (down, _) = (
            shard.use(w, keep=0) for w in (eg.gate, eg.up, eg.down))
        if split:
            lo = shard.r * gate.shape[0]
            buf = shard.chunk(buf, 0)
            # the routing (replicated) enters this rank's experts' outputs
            topw = shard.enter(topw)
    h = a(torch.einsum("ecd,edf->ecf", buf, gate.to(dt))) * \
        torch.einsum("ecd,edf->ecf", buf, up.to(dt))
    out_buf = torch.einsum("ecf,efd->ecd", h, down.to(dt))

    routed = out_buf.reshape(-1, d)
    if split:
        # the other ranks' experts are theirs to add
        routed = torch.nn.functional.pad(
            routed, (0, 0, lo * C, (E - lo) * C - routed.shape[0]))
    padded = torch.cat([routed, routed.new_zeros((1, d))])
    out_sorted = padded[slot.clamp(max=E * C)]
    out_flat = torch.zeros((N * k, d), dtype=dt, device=dev)
    out_flat[order] = out_sorted
    out = (out_flat.reshape(N, k, d) * topw[..., None].to(dt)).sum(1)

    if shard is None:
        for i in range(cfg.n_shared_experts):
            out = out + mlp(getattr(p, f"shared{i}"), xf, cfg.act)
        out = out.reshape(B, S, d)
    else:
        # the partial sums over the model axis go into one all-reduce (a
        # reduce-scatter onto the residual's slices under sequence
        # parallelism)
        parts, out = [], shard.take_rows(out.reshape(B, S, d))
        if split:
            parts, out = [out], None
        for i in range(cfg.n_shared_experts):
            y, partial = mlp_partial(getattr(p, f"shared{i}"), x, cfg.act,
                                     shard)
            if partial:
                parts.append(y)
            else:
                out = y if out is None else out + y
        if out is not None:
            out = shard.to_residual(out, False)
        if parts:
            summed = shard.to_residual(sum(parts[1:], parts[0]), True)
            out = summed if out is None else out + summed

    # load-balancing aux loss (Switch-style)
    density = F.one_hot(tope[:, 0], E).float().mean(0)
    mean_gate = gates.mean(0)
    aux = {"lb_loss": E * torch.sum(density * mean_gate),
           "dropped": (pos_in_e >= C).sum() / (N * k)}
    return out, aux
