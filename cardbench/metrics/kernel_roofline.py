"""The port's kernels' share of their roofline, in %: the summed bound of
their calls in the traced stretch (the frozen formulas of ``_kernels``
on each call's operands) over the device time of every port kernel in
the trace.  A kernel the formulas do not know adds its time and no
bound, and is listed in the result line under ``unknown_kernels``."""

from ._kernels import is_port_kernel


def read(ctx):
    if ctx.trace_record is None or ctx.kernels is None:
        return None
    bound = sum(r["bound_s"] for r in ctx.kernels["known"].values())
    us = sum(d for name, _, d in ctx.trace_record["device"]
             if is_port_kernel(name))
    if bound <= 0 or us <= 0:
        return None
    return 100.0 * bound / (us / 1e6)
