"""Frozen operations and bytes of the port's NLINV kernels.

A copy of the registry's ``KernelSpec.nbytes`` and ``flops`` of the
kernels the NLINV frame launches, kept here so that a later change to the
program cannot move the yardstick: each input read once and each output
written once, counted on the call's own operands.  ``frozen_counts``
puts them in the place of the program's formulas for the length of a
traced stretch, inside the registry's ``count()`` (the program's counter
of kernel calls, which hands each call's operands to ``flops`` and
``nbytes``), and adds each call's bound to a table by kernel.  A kernel
the copy does not know keeps the program's formulas; its calls are
listed under ``unknown`` and its device time stays in the roofline's
denominator.
"""

from __future__ import annotations

import contextlib

from ._peaks import F32_FLOPS, bound_s


def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# name: (nbytes(*work), flops(*work)) -- all float32 / complex64 operands
FORMULAS = {
    "coil_forward": (lambda c, x: _nb(c, x, c),
                     lambda c, x: 6 * c.numel()),
    "coil_lincomb": (lambda a, x, b, y, s: _nb(a, x, b, y, s, x),
                     lambda a, x, b, y, s: 16 * x.numel()),
    "coil_scale_mult": (lambda a, x, s: _nb(a, x, s, x),
                        lambda a, x, s: 8 * x.numel()),
    "plane_mult": (lambda z, m: _nb(z, m, z),
                   lambda z, m: 2 * z.numel()),
    "coil_adjoint": (lambda c, z: _nb(c, z, c[..., 0, :, :]),
                     lambda c, z: 8 * c.numel()),
    "cg_update": (lambda a, p, ap, x, r: _nb(a, p, ap, x, r, x, r, a),
                  lambda a, p, ap, x, r: 12 * p.numel()),
    "xpby": (lambda x, y, b: _nb(b, x, y, x),
             lambda x, y, b: 4 * x.numel()),
    "xpby_dot": (lambda x, y, b: _nb(b, x, y, x, b),
                 lambda x, y, b: 8 * x.numel()),
    "masked_sum": (lambda p, m: _nb(p, m, p[0]),
                   lambda p, m: 2 * p.numel()),
}

# the CUDA functions of the port's NLINV kernels (``csrc/coil_mult.cu``,
# ``cg_fused.cu``, ``masked_allreduce.cu``); a spec's call may launch
# more than one (``cg_update`` sums its partials in a second kernel)
KERNEL_NAMES = ("coil_forward_kernel", "coil_forward_pairs_kernel",
                "coil_lincomb_kernel", "coil_scale_mult_kernel",
                "plane_mult_kernel", "coil_adjoint_kernel",
                "cg_update_kernel", "sum_partials_kernel", "xpby_kernel",
                "xpby_dot_kernel", "masked_sum_kernel")


def _frozen(name, table):
    nbytes, flops = FORMULAS[name]

    def count_bytes(*work):
        b, f = nbytes(*work), flops(*work)
        row = table.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0,
                                      "bound_s": 0.0})
        row["calls"] += 1
        row["bytes"] += b
        row["flops"] += f
        row["bound_s"] += bound_s(f, b, F32_FLOPS)
        return b

    return count_bytes, flops


@contextlib.contextmanager
def frozen_counts(registry):
    """Count the kernel calls inside the block with the frozen formulas:
    yields ``{"known": {name: {calls, bytes, flops, bound_s}}, "unknown":
    {name: calls}}``, filled when the block ends."""
    table: dict = {}
    out = {"known": table, "unknown": {}}
    saved = {}
    for spec in registry.specs():
        if spec.name in FORMULAS:
            saved[spec.name] = (spec, spec.nbytes, spec.flops)
            spec.nbytes, spec.flops = _frozen(spec.name, table)
    try:
        with registry.count() as counts:
            yield out
    finally:
        for spec, nbytes, flops in saved.values():
            spec.nbytes, spec.flops = nbytes, flops
    out["unknown"] = {name: c["calls"] for name, c in counts.items()
                      if name not in FORMULAS}


def is_port_kernel(name: str) -> bool:
    """A device op that is one of the port's hand-written kernels: a
    known NLINV kernel, or any kernel of an anonymous namespace outside
    PyTorch's (where every ``csrc/*.cu`` source keeps its kernels)."""
    if any(k in name for k in KERNEL_NAMES):
        return True
    base = name[5:] if name.startswith("void ") else name
    return base.startswith("(anonymous namespace)::")


def base_name(name: str) -> str:
    """A kernel's function name, without its namespace, template and
    arguments."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()[:120]


def unknown_port_kernels(device_ops) -> dict:
    """{name: launches} of the port's kernels the formulas do not know."""
    out: dict = {}
    for name, _, _ in device_ops:
        if is_port_kernel(name) and not any(k in name for k in KERNEL_NAMES):
            key = base_name(name)
            out[key] = out.get(key, 0) + 1
    return out
