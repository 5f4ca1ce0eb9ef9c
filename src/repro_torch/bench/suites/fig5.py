"""Paper Fig. 5: transfer primitives — strong copy, weak copy,
broadcast, reduce.

Measured: wall time of the verb at the scenario's rank count.  Derived:
modeled H100 times (host->HBM over PCIe Gen5 for scatter; the NVLink
ring for reduce) at 1/2/4/8 devices, showing the paper's effects:
strong copy gets FASTER with more devices (parallel PCIe paths), reduce
efficiency decays with P2P hops.
"""

from __future__ import annotations

import numpy as np

from ...core import comm as _comm
from ...core.runtime import HW
from .. import models
from ..registry import scenario

PARAMS = {"tiny": dict(n=128, batch=4), "paper": dict(n=512, batch=8)}


def _payload(ctx, seed=2):
    p = PARAMS[ctx.size]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((p["batch"], p["n"], p["n"]))
         + 1j * rng.standard_normal((p["batch"], p["n"], p["n"])))
    return p, x.astype(np.complex64)


def _model_times(fn_bytes_to_s) -> dict:
    return {f"model_t{G}_us": round(fn_bytes_to_s(G) * 1e6, 1)
            for G in (1, 2, 4, 8)}


@scenario("fig5", "strong_copy")
def strong_copy(ctx):
    """Fixed total payload scattered over the group (strong scaling)."""
    _, x = _payload(ctx)
    t = ctx.measure(lambda: ctx.comm.container(x).data)
    extra = {"nbytes": x.nbytes, "schedule": "host_shard_upload",
             **_model_times(
                 lambda G: models.copy_time(x.nbytes / G, models.PCIE_BW))}
    return {**t.as_dict(), "extra": extra}


@scenario("fig5", "weak_copy")
def weak_copy(ctx):
    """Per-device-constant payload (weak scaling: one slab regardless)."""
    p, x = _payload(ctx)
    one = x[:1]
    t = ctx.measure(lambda: ctx.comm.container(one).data)
    extra = {"nbytes": one.nbytes, "schedule": "host_shard_upload",
             **_model_times(
                 lambda G: models.copy_time(x.nbytes / p["batch"],
                                            models.PCIE_BW))}
    return {**t.as_dict(), "extra": extra}


@scenario("fig5", "broadcast")
def broadcast(ctx):
    """CLONE one matrix to every rank (host upload + NVLink fan-out)."""
    _, x = _payload(ctx)
    one = x[0]
    t = ctx.measure(lambda: ctx.comm.bcast(one).data)
    sched = _comm.bcast_schedule(ctx.comm.group, one.nbytes)
    extra = {"nbytes": one.nbytes, "schedule": sched,
             "threshold_bytes": _comm.BCAST_SCATTER_MIN_BYTES,
             **_model_times(
                 lambda G: models.copy_time(one.nbytes, models.PCIE_BW)
                 + (G - 1) * one.nbytes / HW["nvlink_bw"])}
    return {**t.as_dict(), "extra": extra}


@scenario("fig5", "reduce")
def reduce(ctx):
    """Sum a segmented container (ring reduce + download)."""
    _, x = _payload(ctx)
    sm = ctx.comm.container(x)
    one = x[0].nbytes
    t = ctx.measure(lambda: ctx.comm.reduce(sm))
    sched, nbytes = _comm._reduce_schedule(sm, "sum")
    extra = {"nbytes": one, "schedule": sched,
             "payload_bytes": nbytes,
             "threshold_bytes": _comm.REDUCE_RS_AG_MIN_BYTES,
             **_model_times(
                 lambda G: models.allreduce_time(one, G) / 2
                 + models.copy_time(one, models.PCIE_BW))}
    return {**t.as_dict(), "extra": extra}
