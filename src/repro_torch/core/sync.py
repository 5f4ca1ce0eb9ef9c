"""Synchronization: the MGPU barrier/fence family (paper §2.5).

The counterpart of ``repro.core.sync``.  PyTorch on the card is
asynchronous like JAX's dispatch:

  fence(x...)        host-blocks until the given tensors are computed:
                     an event recorded on each tensor's current stream,
                     waited on (``cudaEventSynchronize``);
  barrier(group)     every rank of the group reaches this point (a
                     one-element all-reduce on the group's devices);
  barrier_fence()    both, the paper's strongest primitive;
  ordered(x, dep)    JAX's in-graph sequencing fence.  Eager PyTorch runs
                     one stream's work in program order, so ``x`` after
                     ``dep`` needs nothing: it returns ``x``.
"""

from __future__ import annotations

import torch

from .comm import all_reduce_tensor


def fence(*tensors):
    """Block the host until the work producing ``tensors`` is done."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()
    return tensors[0] if len(tensors) == 1 else tensors


def barrier(group) -> None:
    """Every rank of ``group`` (a DeviceGroup or a Communicator) reaches
    this point; a 1-rank group without a process group returns at once."""
    group = getattr(group, "group", group)
    if group.pg is None:
        return
    token = torch.zeros(1, dtype=torch.int32, device=group.device)
    fence(all_reduce_tensor(token, group))


def barrier_fence(*tensors, group):
    """MGPU ``barrier_fence()``: wait for pending work, then barrier."""
    if tensors:
        fence(*tensors)
    barrier(group)
    return tensors[0] if len(tensors) == 1 else (tensors or None)


def ordered(x, dep):
    """``x``, after ``dep``: one stream already runs them in order."""
    del dep
    return x
