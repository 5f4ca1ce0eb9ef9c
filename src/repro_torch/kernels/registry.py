"""Registry of the port's hand-written CUDA kernels.

The counterpart of ``repro/kernels/registry.py``, without its autotuner.
Each :class:`KernelSpec` names the TPU kernel it replaces, its C entry in
the library that ``_build`` compiles, its plain PyTorch version and the
JAX spec's tolerance, and carries a plain-int launch counter and a maker
of inputs at the shapes of the path that runs it (the NLINV frame, or the
radial gridding pass).  ``chip_smoke.py`` walks the specs to hold every
kernel against its plain version on the card, to time both, and to show
from the counters that each path ran its kernels.

Dispatch rule, shared by every wrapper (:func:`use_kernel`): a tensor on
the CPU takes the plain version; a tensor on a CUDA device launches the
kernel, and a wrapper that cannot launch it raises.  There is no fallback
from the card to the plain version, except when the caller asks for it
with ``impl="plain"``.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path
from typing import Callable

import torch

from . import _build

FAMILIES = ("coil_mult", "cg_fused", "gridding")

# The main path's shapes: the paper's matrix n = 384 on the doubled grid
# 768 x 768 with J = 8 compressed coils (bench/suites/fig6.py:169-171 of
# the JAX package), and 11 golden-angle spokes per frame.
MAIN_NCOILS = 8
MAIN_GRID = 768
MAIN_SPOKES = 11

# Published peaks of one H100 SXM at 700 W, for the bound of a kernel:
# device-memory rate and float32 rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12


@dataclasses.dataclass(eq=False)
class KernelSpec:
    name: str
    replaces: str            # "file:line" of the Pallas TPU kernel
    tpu_function: str        # the function defined at that line
    source: str              # the CUDA source, relative to the repo root
    entry: str               # C entry point in the built library
    argtypes: tuple          # its ctypes argument types
    kernel: Callable         # kernel(*sample) through the wrapper
    plain: Callable          # plain(*sample): the plain PyTorch version
    tol: float               # the JAX spec's tolerance
    sample: Callable         # sample(device, generator) -> main-path args
    nbytes: Callable         # bytes the function must move for these args
    flops: Callable          # float operations it does on these args
    library: Callable | None = None   # one PyTorch call, timed as yardstick
    launches: int = 0

    def launch(self, *args) -> None:
        """Call the C entry, raise if the launch failed, and count it."""
        fn = _build.function(self.entry, self.argtypes)
        _build.check(fn(*args), self.entry)
        self.launches += 1

    def bound_ms(self, *args) -> tuple[float, str]:
        """The least time the card could take for this work and what sets
        it: bytes over the memory rate, or flops over the float32 rate."""
        t_bytes = self.nbytes(*args) / H100_BYTES_PER_S * 1e3
        t_ops = self.flops(*args) / H100_F32_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


_SPECS: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    _SPECS[spec.name] = spec
    return spec


def _order(spec: KernelSpec):
    """Family order, then the TPU kernel's line: the kernel table's rows."""
    path, line = spec.replaces.rsplit(":", 1)
    return FAMILIES.index(Path(path).parent.name), int(line)


def specs() -> list[KernelSpec]:
    for fam in FAMILIES:
        importlib.import_module(f"{__package__}.{fam}.ops")
    return sorted(_SPECS.values(), key=_order)


def get(name: str) -> KernelSpec:
    specs()
    return _SPECS[name]


def reset_launches() -> None:
    for s in specs():
        s.launches = 0


def launches() -> dict[str, int]:
    return {s.name: s.launches for s in specs()}


def use_kernel(impl: str, *tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its kernel: the operands lie on a
    CUDA device and the caller did not ask for ``impl="plain"``."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on more than one device: {devices}")
    (device,) = devices
    if impl == "plain" or device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel and no plain path for device {device}")


# -- operand checks shared by the wrappers ---------------------------------

def ptr(t: torch.Tensor | None, dtype: torch.dtype, name: str) -> int | None:
    """Device address of an operand the kernel takes as it is: the right
    dtype, contiguous, with no pending lazy conjugation.  ``None`` stays
    ``None`` (a null pointer, for optional planes)."""
    if t is None:
        return None
    if t.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
    if t.is_conj():
        raise ValueError(f"{name}: resolve the lazy conjugation first "
                         f"(torch.conj_physical)")
    return t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sampler(*kinds):
    """A spec's input maker: ``"stack"`` is a complex (J, G, G) stack,
    ``"plane"`` a complex (G, G) plane, ``"real"`` a float32 plane in
    [0, 1), and a float a float32 device scalar of that value.  The
    shapes default to the main path's."""
    def make(device, gen, ncoils=MAIN_NCOILS, grid=MAIN_GRID):
        shapes = {"stack": (ncoils, grid, grid), "plane": (grid, grid)}
        out = []
        for k in kinds:
            if isinstance(k, float):
                out.append(torch.tensor(k, dtype=torch.float32,
                                        device=device))
            elif k == "real":
                out.append(torch.rand(shapes["plane"], device=device,
                                      generator=gen))
            else:
                out.append(torch.randn(shapes[k], dtype=torch.complex64,
                                       device=device, generator=gen))
        return tuple(out)
    return make


def radial_sampler(kind: str, make_op: Callable):
    """A gridding spec's input maker on the radial path's geometry.

    ``make_op(grid, nspokes, nsamp, device)`` gives the interpolation
    operator of frame 0's trajectory (``nsamp=None``: the trajectory's
    default ``2 * grid`` samples a spoke, 16896 samples at the main path's
    width).  ``kind`` ``"grid"`` gives a complex (J, G, G) k-space grid,
    ``"samples"`` complex (J, Sp) samples with the padded rows zero.
    Returns ``(x, op, m)``, ``m`` the operator as a sparse CSR matrix
    (forward for a grid, adjoint for samples) for the library
    yardstick."""
    def make(device, gen, ncoils=MAIN_NCOILS, grid=MAIN_GRID,
             nspokes=MAIN_SPOKES, nsamp=None):
        op = make_op(grid, nspokes, nsamp, device)
        shape = ((ncoils, grid, grid) if kind == "grid"
                 else (ncoils, op.nsamp_padded))
        x = torch.randn(shape, dtype=torch.complex64, device=device,
                        generator=gen)
        if kind == "samples":
            x[:, op.nsamp:] = 0
        return x, op, op.as_sparse(adjoint=kind == "samples")
    return make


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
