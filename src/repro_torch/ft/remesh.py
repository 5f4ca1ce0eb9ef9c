"""Elastic remesh: continue live streams on a survivor communicator.

The port of ``repro/ft/remesh.py``.  When a rank is marked unhealthy (a
:class:`~repro_torch.ft.DeviceLossFault` from the injector, or a real
health signal), the recovery path is:

  1. every rank of the old group gathers each live Newton carry whole
     (:func:`gather_carry`): ``chat`` is coil-segmented, one segment a
     rank, so the lost ranks take part too;
  2. ``Environment.survivor(comm, lost)`` mints a communicator over the
     ranks that are left (``None`` on a lost rank, which retires);
  3. a new ``Reconstructor`` is built on it (plan keys carry the group
     token, so nothing of the old group is reused);
  4. every carry is re-placed onto the survivor group with
     :func:`migrate_carry`: ``rho`` whole on every rank, ``chat``
     re-segmented with its coil dim zero-padded to the survivor group
     size (zero channels are exact no-ops for every NLINV sum, so the
     continued stream matches the uninterrupted one).

Step 1 is where the port differs from the JAX package, whose devices are
simulated in one process: there ``np.asarray(chat)`` reads every shard,
the lost device's included.  Here the lost rank's segment lives in its
own process, so it must be gathered over the old group before the lost
ranks leave.  That is the reference's semantics, a simulated loss whose
card is still readable.  A card that is really gone takes its segment
with it: the carry then comes back only from a checkpoint
(``resume_or_init`` or ``ckpt.restore_sharded`` of a carry that
:func:`gather_carry` gave to ``ckpt.save``), and a restored carry
migrates exactly like a gathered one.

``NlinvStreamWorkload.remesh`` drives steps 1, 3 and 4 for a whole
scheduler's worth of sessions; this module holds the carry-level
mechanics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.segmented import Policy


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad dim 0 of ``a`` up to ``rows`` (no-op when already
    there)."""
    if a.shape[0] >= rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def gather_carry(comm, u: dict) -> dict:
    """One rank's ``{rho, chat}`` carry on ``comm`` as a whole host tree:
    ``rho`` as this rank holds it (CLONE), ``chat`` all-gathered along the
    coil dim in rank order.  Every rank of ``comm`` must call it."""
    return {"rho": _host(u["rho"]),
            "chat": _host(comm.allgather(u["chat"], dim=0))}


def migrate_carry(rec, u: dict, pad_to: int | None = None) -> dict:
    """Re-place one whole ``{rho, chat}`` Newton carry onto ``rec``'s
    group.

    ``rho`` is replicated (CLONE): every rank keeps it whole, in its
    dtype.  ``chat`` is coil-segmented (NATURAL dim 0): each rank keeps
    its coils, after the coil dim is zero-padded to ``pad_to`` (default:
    the next multiple of the new group size).  The leaves are numpy
    arrays or tensors holding the whole carry (:func:`gather_carry`'s
    output, or a checkpoint's).
    """
    rho = _host(u["rho"])
    chat = _host(u["chat"])
    size = rec.comm.size
    rows = pad_to if pad_to is not None else -(-chat.shape[0] // size) * size
    if rows % size:
        raise ValueError(
            f"carry migration needs the coil dim padded to a multiple of "
            f"the survivor group size {size}; got pad_to={pad_to}")
    chat = pad_rows(chat, rows)
    return {"rho": rec.comm.container(rho, policy=Policy.CLONE).data,
            "chat": rec.put_frame(chat)}
