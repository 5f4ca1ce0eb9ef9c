"""Registry of the port's hand-written CUDA kernels.

The counterpart of ``repro/kernels/registry.py``, without its autotuner.
Each :class:`KernelSpec` names the TPU kernel it replaces, its C entry in
the library that ``_build`` compiles, its plain PyTorch version and the
JAX spec's tolerance, and carries a plain-int launch counter and a maker
of inputs at the shapes of the path that runs it (the NLINV frame, one
rank's share of the distributed frame and the segmented BLAS, or the
radial gridding pass).  ``chip_smoke.py`` walks the specs to hold every
kernel against its plain version on the card, to time both, and to show
from the counters that each path ran its kernels.  The LM serving path's
kernels (flash attention, the RG-LRU scan, the chunkwise mLSTM) take
their sample shapes from constants here, not from the model modules above
this layer.

Dispatch rule, shared by every wrapper (:func:`use_kernel`): a tensor on
the CPU takes the plain version; a tensor on a CUDA device launches the
kernel, and a wrapper that cannot launch it raises.  There is no fallback
from the card to the plain version, except when the caller asks for it:
with ``impl="plain"`` at one wrapper, or for every wrapper called inside
a ``with plain():`` block (how a whole model runs its plain versions on
the card, to be held against its kernel path).

Inside a :func:`dry` block a tensor on the ``meta`` device takes the
card's branch: the wrapper checks its operands and allocates its outputs
and scratch as on the card, and nothing is launched (``pointers`` gives
no stream), so that a step traced on meta (``launch.dryrun``) holds what
the card would hold and keeps, for autograd, what the card keeps.
Outside one a meta tensor has no path, as any device but the CPU and the
card.  Inside :func:`count` every
kernel call adds its spec's flops and bytes (the formulas of its bound),
on the card and on meta alike.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import importlib
from pathlib import Path
from typing import Callable

import torch

from . import _build

FAMILIES = ("coil_mult", "cg_fused", "masked_allreduce", "gridding",
            "flash_attention", "rg_lru", "mlstm")

# The main path's shapes: the paper's matrix n = 384 on the doubled grid
# 768 x 768 with J = 8 compressed coils (bench/suites/fig6.py:169-171 of
# the JAX package), and 11 golden-angle spokes per frame.
MAIN_NCOILS = 8
MAIN_GRID = 768
MAIN_SPOKES = 11
# The distributed frame splits the coils over 4 ranks (2 each), and its
# channel sum gathers the ranks' 384 x 384 FOV windows.
MAIN_RANKS = 4

# The LM serving path's shapes: recurrentgemma-2b (arXiv:2402.19427) at
# its published widths, 10 query heads on one kv head of dim 256, a local
# attention window of 2048 and an RG-LRU width of 2560, prefilling the
# longest prompt that chip_smoke.py serves (3072 tokens, past the window).
LM_SEQ = 3072
LM_HEADS = 10
LM_KV_HEADS = 1
LM_HEAD_DIM = 256
LM_WINDOW = 2048
LM_LRU_WIDTH = 2560

# xlstm-350m (arXiv:2405.04517) at its published widths: 4 heads over the
# mLSTM's inner width of 2048 (d_model 1024, proj_factor 2), so a head dim
# of 512 for q, k and v, prefilling the same longest prompt.
XLSTM_SEQ = 3072
XLSTM_HEADS = 4
XLSTM_HEAD_DIM = 512

# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 data sheet,
# dense rates), for the bound of a kernel: device-memory rate, float32
# rate outside the tensor cores, and the bf16 tensor-core rate.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12


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
    # parts(*sample) -> {name: call()}: parts of the kernel's work and their
    # yardsticks, each timed alone beside the kernel; no path runs them
    parts: Callable | None = None
    peak_flops: float = H100_F32_FLOPS  # the card's rate for its operands
    # the main-path sample's tolerance where its dtype holds it to another
    # than ``tol`` (a bf16 sample: the JAX spec's bf16 tolerance)
    sample_tol: float | None = None
    # the kernel takes a leading batch of clients (the batched NLINV
    # frame): ``sample(..., width=B)`` gives its inputs at width B, which
    # ``kernel``, ``plain``, ``nbytes`` and ``flops`` take as they are
    batched: bool = False
    launches: int = 0
    # launches by C entry, of the launches that name theirs: a kernel with
    # more than one route (entries of the same arguments) names each
    entry_launches: dict = dataclasses.field(default_factory=dict)
    _bound: dict = dataclasses.field(default_factory=dict, repr=False)

    def launch(self, *args, entry: str | None = None,
               work: tuple | None = None) -> None:
        """Call the C entry (``entry``, or the spec's own) with ``args``,
        raise if the launch failed, and count it.  The entry is looked up
        and its argument types declared once, at its first launch.
        ``work``: the call's operands in the form ``flops`` and ``nbytes``
        take, added to an open :func:`count`.  The stream, always the last
        argument, is None for operands on the meta device (``pointers``):
        then nothing is launched and the launch counter stays."""
        if _COUNT is not None and work is not None:
            got = _COUNT.setdefault(self.name, {"calls": 0, "flops": 0,
                                                "bytes": 0})
            got["calls"] += 1
            got["flops"] += int(self.flops(*work))
            got["bytes"] += int(self.nbytes(*work))
        if args[-1] is None:
            return
        name = self.entry if entry is None else entry
        fn = self._bound.get(name)
        if fn is None:
            fn = self._bound[name] = _build.function(name, self.argtypes)
        err = fn(*args)
        if err:
            _build.check(err, name)
        self.launches += 1
        if entry is not None:
            self.entry_launches[entry] = self.entry_launches.get(entry, 0) + 1

    def bound_ms(self, *args) -> tuple[float, str]:
        """The least time the card could take for this work and what sets
        it: bytes over the memory rate, or flops over the card's peak rate
        for the operands' type (``peak_flops``)."""
        t_bytes = self.nbytes(*args) / H100_BYTES_PER_S * 1e3
        t_ops = self.flops(*args) / self.peak_flops * 1e3
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
        s.entry_launches.clear()


def launches() -> dict[str, int]:
    return {s.name: s.launches for s in specs()}


_PLAIN = contextvars.ContextVar("repro_torch_plain", default=False)

# the kernel calls' work inside ``count()`` (a global, not a context
# variable: autograd's backward runs on a thread of its own on the card);
# None outside it
_COUNT: dict | None = None
# inside ``dry()``: meta tensors take the card's branch (a global too)
_DRY = False


@contextlib.contextmanager
def dry():
    """Within this block a wrapper given meta tensors takes the card's
    branch and launches nothing: its outputs and scratch are allocated on
    meta, and :func:`count` gets its work."""
    global _DRY
    outer, _DRY = _DRY, True
    try:
        yield
    finally:
        _DRY = outer


@contextlib.contextmanager
def count():
    """Count the work of every kernel call inside the block, on the card
    and on the meta device alike: yields a dict that gets ``{name:
    {"calls", "flops", "bytes"}}``, each call adding its spec's
    ``flops`` and ``nbytes`` of its operands.  Counts nest: an outer
    block gets the inner block's calls too."""
    global _COUNT
    outer, _COUNT = _COUNT, {}
    try:
        yield _COUNT
    finally:
        if outer is not None:
            for name, c in _COUNT.items():
                o = outer.setdefault(name, {"calls": 0, "flops": 0,
                                            "bytes": 0})
                for k, v in c.items():
                    o[k] += v
        _COUNT = outer


def count_totals(counts: dict) -> dict:
    """The calls, flops and bytes of a :func:`count` in all."""
    return {k: sum(c[k] for c in counts.values())
            for k in ("calls", "flops", "bytes")}


@contextlib.contextmanager
def plain():
    """Within this block every wrapper runs its plain version, on the
    card too; launch counters stay where they are."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def checkpoint_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation of a
    checkpointed block runs in the backward, on CUDA in the autograd
    engine's own thread, where the context variable that :func:`plain`
    sets is not seen; the recomputation runs inside a :func:`plain` block
    when the forward ran inside one, so that both take the same path."""
    return contextlib.nullcontext(), (plain() if _PLAIN.get()
                                      else contextlib.nullcontext())


def use_kernel(impl: str, *tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its kernel: its first operand
    lies on a CUDA device (or on the meta device inside :func:`dry`, the
    card's branch without a launch) and the caller asked for the plain
    version neither with ``impl="plain"`` nor with :func:`plain`.  On that
    branch
    the other operands' device is checked where the kernel takes their
    addresses (:func:`pointers`); on every other branch it is checked
    here, so that an operand on the card never runs the plain version
    because another lies on the CPU."""
    if impl != "auto" and impl != "plain":
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    first = tensors[0]
    if first is None:
        first = next(t for t in tensors if t is not None)
    wanted = impl == "auto" and not _PLAIN.get()
    if wanted and (first.is_cuda or (first.is_meta and _DRY)):
        return True
    device = first.device
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(f"operands on more than one device: {device} "
                             f"and {t.device}")
    if wanted and not first.is_cpu:
        raise ValueError(f"no kernel and no plain path for device {device}")
    return False


# -- gradients through a kernel -------------------------------------------

class _PlainGrad(torch.autograd.Function):
    """The kernel in the forward; in the backward the gradient of the
    plain version, recomputed on the saved inputs.  ``kernel`` and
    ``plain`` take the same tensors and return one tensor or a flat tuple
    of them."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        out = kernel(*inputs)
        return out if isinstance(out, tuple) else (out,)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in
                  zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            live = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in live], [x for x, n in zip(xs, need) if n],
                [g for _, g in live], allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


def differentiable(kernel: Callable, plain: Callable, *inputs):
    """``kernel(*inputs)``, with a gradient where autograd asks for one.

    When grad mode is on and an input requires grad, the call goes
    through an autograd function: its forward launches the kernel as it
    is, its backward recomputes ``plain(*inputs)`` on detached inputs and
    returns ``torch.autograd.grad`` of it, which is exactly the
    derivative of the function the JAX package differentiates (its
    Pallas kernels have no backward kernel either).  Otherwise the kernel
    runs with no autograd node.  A tensor output of the kernel stays one
    tensor."""
    if not (torch.is_grad_enabled() and
            any(t.requires_grad for t in inputs)):
        return kernel(*inputs)
    out = _PlainGrad.apply(kernel, plain, *inputs)
    return out[0] if len(out) == 1 else out


# -- operand checks shared by the wrappers ---------------------------------

def pointers(*operands) -> list:
    """The device addresses of a kernel's operands and, last, the raw
    handle of their device's current stream, in one pass.

    Each operand is ``(tensor, dtype, name)``: the tensor must have that
    dtype, be contiguous (with a fourth element ``True``: rows
    contiguous, the outer strides free) and carry no lazy conjugation,
    and every tensor must lie on one CUDA device.  A ``None`` tensor
    gives a null pointer (an optional plane).  Outputs that the wrapper
    allocates itself on the operands' device need no check: it passes
    their ``data_ptr()``.  Operands on the meta device pass the same
    checks and give null addresses and a None stream: nothing to launch
    (``KernelSpec.launch``)."""
    out = []
    device = None
    for op in operands:
        t = op[0]
        if t is None:
            out.append(None)
            continue
        if t.dtype != op[1]:
            raise TypeError(f"{op[2]}: kernel takes {op[1]}, got {t.dtype}")
        if not (t.stride(-1) == 1 if len(op) > 3 else t.is_contiguous()):
            raise ValueError(f"{op[2]}: kernel takes contiguous "
                             f"{'rows' if len(op) > 3 else 'tensors'}, got "
                             f"strides {t.stride()}")
        if t.is_conj():
            raise ValueError(f"{op[2]}: resolve the lazy conjugation first "
                             f"(torch.conj_physical)")
        d = "meta" if t.is_meta else t.get_device()
        if device is None:
            device = d
        elif d != device:
            raise ValueError(f"{op[2]}: operands on more than one device "
                             f"({device} and {d})")
        out.append(t.data_ptr())
    if device == "meta":
        return [None if p is None else 0 for p in out] + [None]
    if device is None or device < 0:
        raise ValueError("a kernel's operands must lie on a CUDA device")
    out.append(current_stream(device))
    return out


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current CUDA stream: the
    kernels launch on it, as PyTorch's own operations do.  Of the public
    routes, ``current_stream`` with the device's index is the cheapest
    (``profile_frame.py --part launch`` times each): a ``torch.device``
    costs it another index lookup, and every route builds a ``Stream``."""
    return torch.cuda.current_stream(index).cuda_stream


def sampler(*kinds, ncoils=MAIN_NCOILS):
    """A spec's input maker: ``"stack"`` is a complex (J, G, G) stack,
    ``"plane"`` a complex (G, G) plane, ``"real"`` and ``"row"`` float32
    planes in [0, 1), and a float a float32 device scalar of that value.
    The shapes default to the main path's (``ncoils`` coils: one rank's
    segment where the path splits them).

    With ``width=B`` it makes the batched frame's inputs, B rows: stacks
    (B, J, G, G), complex planes (B, G, G), a ``"row"`` plane (B, G, G)
    (the sampling mask, one a client), a ``"real"`` plane (G, G), shared
    by the rows (the FOV, the Sobolev weight), and a float a (B,) vector
    of distinct values, ``k * (1 + 0.1 b)`` in row b, so that a kernel
    that reads another row's scalar disagrees."""
    default_ncoils = ncoils

    def make(device, gen, ncoils=default_ncoils, grid=MAIN_GRID,
             width=None):
        lead = () if width is None else (width,)
        shapes = {"stack": lead + (ncoils, grid, grid),
                  "plane": lead + (grid, grid), "real": (grid, grid),
                  "row": lead + (grid, grid)}
        out = []
        for k in kinds:
            if isinstance(k, float) and width is None:
                out.append(torch.tensor(k, dtype=torch.float32,
                                        device=device))
            elif isinstance(k, float):
                out.append(k * (1 + 0.1 * torch.arange(
                    width, dtype=torch.float32, device=device)))
            elif k in ("real", "row"):
                out.append(torch.rand(shapes[k], device=device,
                                      generator=gen))
            else:
                out.append(torch.randn(shapes[k], dtype=torch.complex64,
                                       device=device, generator=gen))
        return tuple(out)
    return make


def window_sampler():
    """The masked sum's input maker on the distributed frame's channel
    sum: the ranks' gathered FOV windows, a complex (G, W, W) stack with
    G = 4 and W = 384 by default, and a 0/1 float32 (W, W) mask (a
    uniform draw above 0.4, as in the JAX spec's samples).  With
    ``width=B`` the batched frame's stack, (G, B, W, W), under the one
    mask."""
    def make(device, gen, nparts=MAIN_RANKS, size=MAIN_GRID // 2,
             width=None):
        lead = (nparts,) if width is None else (nparts, width)
        p = torch.randn(lead + (size, size), dtype=torch.complex64,
                        device=device, generator=gen)
        m = (torch.rand((size, size), device=device, generator=gen)
             > 0.4).to(torch.float32)
        return p, m
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


def attention_sampler():
    """The flash-attention spec's input maker on the LM path's prefill:
    q (1, 10, 3072, 256), k and v (1, 1, 3072, 256) in bf16, causal with
    the 2048-key window.  Returns ``(q, k, v, kw, mask)``: ``kw`` the
    keywords of the call, ``mask`` the same mask as an (S, T) boolean
    tensor for the library yardstick."""
    def make(device, gen):
        def rnd(h):
            return torch.randn((1, h, LM_SEQ, LM_HEAD_DIM), device=device,
                               generator=gen).to(torch.bfloat16)
        q, k, v = rnd(LM_HEADS), rnd(LM_KV_HEADS), rnd(LM_KV_HEADS)
        pos = torch.arange(LM_SEQ, device=device)
        d = pos[:, None] - pos[None, :]
        mask = (d >= 0) & (d < LM_WINDOW)
        return q, k, v, {"causal": True, "window": LM_WINDOW}, mask
    return make


def scan_sampler():
    """The RG-LRU spec's input maker on the LM path's prefill: float32
    log_a and b (1, 3072, 2560), h0 (1, 2560), with log_a = -0.1 |N(0, 1)|
    as in the JAX spec's samples."""
    def make(device, gen):
        def rnd(*shape):
            return torch.randn(shape, device=device, generator=gen)
        return (-0.1 * rnd(1, LM_SEQ, LM_LRU_WIDTH).abs(),
                rnd(1, LM_SEQ, LM_LRU_WIDTH), rnd(1, LM_LRU_WIDTH))
    return make

