"""Gradient compression for the slow (DCN / pod) axis: int8 block
quantization with error feedback, as ``repro/train/grad_compress.py``,
over a :class:`~repro_torch.core.Communicator` (every rank of it calls).

Shared-scale scheme so the reduction stays linear:
  s   = allreduce_max(local absmax) / 127     (one scalar per block)
  q_i = round(g_i / s)  in int8               (per rank)
  g~  = s * allreduce_sum(q_i)                (int32 accumulation)

Error feedback carries the quantization residual into the next step,
which restores convergence to the uncompressed path (1-bit-Adam lineage).
The int32 sum is what goes on the wire here (the JAX package's ``psum``
of int32 too); int8 on the wire would need a reduction that widens.
"""

from __future__ import annotations

import torch


def compressed_psum(g, comm, err=None, block: int = 4096):
    """Returns (reduced grad in float32, new error-feedback state), both
    shaped like ``g``."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    flat = gf.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = comm.allreduce(absmax, op="max") / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq_local = q.float() * scale
    new_err = (blocks - deq_local).reshape(-1)[:n].reshape(g.shape)
    total = comm.allreduce(q.to(torch.int32), op="sum").float() * scale
    out = total.reshape(-1)[:n].reshape(g.shape)
    return out, new_err


def tree_compressed_psum(grads: dict, comm, err_state: dict | None = None):
    """:func:`compressed_psum` of every leaf of a dict of gradients.
    Returns (reduced dict, new error dict)."""
    outs, errs = {}, {}
    for k, g in grads.items():
        outs[k], errs[k] = compressed_psum(
            g, comm, None if err_state is None else err_state[k])
    return outs, errs


def init_error_state(grads: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
