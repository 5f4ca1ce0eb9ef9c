"""Paper Table 1: operator breakdown of F, DF, DF^H, CG.

Asserts the structural op counts of the port's operators against the
paper's table (FFT batches per operator) before timing anything — a
scenario that drifts structurally must fail loudly, not get slowly
slower — then times each operator plus the ``repro_torch.lib.blas``
fused-epilogue rows (one pass over w vs the two-plan form).

The JAX package counts the ``fft`` primitives of a traced program; the
port counts the FFTs its operators dispatch on one call
(``count_ffts``: the ``aten`` FFT ops under a ``TorchDispatchMode``).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ...lib import blas as lblas
from ...nlinv import phantom
from ...nlinv.operators import make_ops, sobolev_weight, uaxpy, udot, uinit
from ..registry import scenario

PARAMS = {"tiny": dict(n=48, J=4), "paper": dict(n=128, J=8)}

# paper Table 1 (ours: FFT batches per operator; DG/DGH include the coil
# transform W; the all-reduce column is the distributed channel sum)
EXPECTED = {
    "F": dict(fft=2, channel_sum=0, allreduce=0),
    "DF": dict(fft=3, channel_sum=0, allreduce=0),
    "DFH": dict(fft=3, channel_sum=1, allreduce=1),
    "CG": dict(scalar_products=2),
}

# every aten op that runs a discrete Fourier transform
_FFT_OPS = frozenset({torch.ops.aten._fft_c2c, torch.ops.aten._fft_r2c,
                      torch.ops.aten._fft_c2r})


class _FFTCounter(TorchDispatchMode):
    """Counts the FFT ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _FFT_OPS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def count_ffts(fn, *args) -> int:
    """The FFTs ``fn(*args)`` dispatches (one batched 2-D transform is
    one)."""
    with _FFTCounter() as counter:
        fn(*args)
    return counter.count


def _setup(ctx):
    p = PARAMS[ctx.size]
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11, frames=1)
    ops = make_ops(d["masks"][0], d["fov"], sobolev_weight(d["grid"]),
                   device=ctx.device)
    u0 = uinit(d["ncoils"], d["grid"], device=ctx.device)
    du = {k: v + 0.1 for k, v in u0.items()}
    r = torch.as_tensor(d["y"][0], device=ctx.device)
    return d, ops, u0, du, r


@scenario("table1", "F")
def F(ctx):
    """Forward model F (2 FFT batches), op counts asserted first."""
    d, ops, u0, du, r = _setup(ctx)
    counts = {"F": count_ffts(ops.G, u0), "DF": count_ffts(ops.DG, u0, du),
              "DFH": count_ffts(ops.DGH, u0, r)}
    for op, n in counts.items():
        if n != EXPECTED[op]["fft"]:
            raise AssertionError(f"table1: {op} dispatches {n} FFTs, the "
                                 f"paper's table {EXPECTED[op]['fft']}")
    t = ctx.measure(ops.G, u0)
    return {**t.as_dict(), "extra": {"grid": d["grid"], "fft": 2,
                                     "pointwise": 4}}


@scenario("table1", "DF")
def DF(ctx):
    """Derivative DF (3 FFT batches, no channel sum)."""
    d, ops, u0, du, _ = _setup(ctx)
    t = ctx.measure(ops.DG, u0, du)
    return {**t.as_dict(), "extra": {"grid": d["grid"], "fft": 3,
                                     "pointwise": 5}}


@scenario("table1", "DFH")
def DFH(ctx):
    """Adjoint DF^H (3 FFT batches + the distributed channel sum)."""
    d, ops, u0, _, r = _setup(ctx)
    t = ctx.measure(ops.DGH, u0, r)
    return {**t.as_dict(), "extra": {"grid": d["grid"], "fft": 3,
                                     "pointwise": 4, "channel_sum": 1,
                                     "allreduce": 1}}


@scenario("table1", "cg_iter")
def cg_iter(ctx):
    """One CG iteration: normal op + 2 scalar products + 3 axpys."""
    d, ops, u0, du, _ = _setup(ctx)

    def it(u, v):
        Ap = ops.normal(u, v, 0.5)
        a = udot(v, Ap).real
        return uaxpy(1.0 / (a + 1.0), Ap, v)

    t = ctx.measure(it, u0, du)
    return {**t.as_dict(), "extra": {"grid": d["grid"], "ab": 6,
                                     "scalar_products": 2}}


@scenario("table1", "axpy_norm2_fused")
def axpy_norm2_fused(ctx):
    """libblas fused epilogue (one pass over w) vs the two-plan form."""
    p = PARAMS[ctx.size]
    d = phantom.make_dataset(n=p["n"], ncoils=p["J"], nspokes=11, frames=1)
    sx = ctx.comm.container(d["y"][0])
    sy = ctx.comm.container(d["y"][0] * 0.5)
    t = ctx.measure(lambda: lblas.axpy_norm2(-0.25, sx, sy)[1])
    t_split = ctx.measure(lambda: lblas.norm2(lblas.axpy(-0.25, sx, sy)))
    # the attributable plan-cache evidence is t.plan_cache (per-region
    # deltas); the process-global plan_stats() would depend on whatever
    # scenarios happened to run earlier in this child.
    return {**t.as_dict(),
            "extra": {"grid": d["grid"],
                      "split_steady_ms": t_split.steady_ms}}
