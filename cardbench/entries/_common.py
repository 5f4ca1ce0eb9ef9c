"""What the entries share: fences, the peak, the seeded sample of
snapshots, the traced stretch and the reference's comparisons."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import trace as tr
from ..metrics import _kernels
from ..reference import nlinv as ref


def fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def since(t0: float) -> float:
    return time.perf_counter() - t0


class Reservoir:
    """A uniform sample of ``size`` of the boundaries offered, drawn from
    the seed while the window runs (reservoir sampling), so that only
    ``size`` snapshots are ever held."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 0x5A17])
        self.seen = 0
        self.slots: list = []

    def offer(self) -> int | None:
        """The slot a boundary's snapshot goes into, or None."""
        self.seen += 1
        if len(self.slots) < self.size:
            self.slots.append(None)
            return len(self.slots) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None


@contextlib.contextmanager
def stretch(ctx, registry):
    """The traced stretch: the profiler and the frozen kernel counts."""
    with tr.traced(ctx.device) as rec, \
            _kernels.frozen_counts(registry) as kernels:
        yield
    ctx.trace_record = rec
    ctx.kernels = kernels


@contextlib.contextmanager
def reference_precision():
    """The reference's float32: TF32 off for its products."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compare_chain(label, data, first, count, u, x_ref, got, cfg,
                  control=None):
    """The reference's images of ``count`` frames of a scanner's cycle
    from frame ``first`` on, from the carry ``u`` / ``x_ref``, against
    the program's images ``got``: [(label, relative error), ...].  Given
    a list ``control``, the control (the reference stored in bfloat16)
    is held against the reference on the same frames, into it."""
    C = data["y"].shape[0]
    idx = [(first + i) % C for i in range(count)]

    def chain(rnd):
        return ref.frames(data["y"][idx], data["masks"][idx], data["fov"],
                          u, x_ref, newton=cfg["newton"],
                          cg_iters=cfg["cg_iters"], damping=cfg["damping"],
                          rnd=rnd)

    want = list(chain(ref.fp32))
    if control is not None:
        control += [(f"{label}+{i}", ref.rel_err(c, w))
                    for i, (c, w) in enumerate(zip(chain(ref.bf16), want))]
    return [(f"{label}+{i}", ref.rel_err(g.to(w.device), w))
            for i, (g, w) in enumerate(zip(got, want))]


def cg_frames(cg_log, newton: int) -> list[list[int]]:
    """The program's CG log, one iteration count a solve, as each frame's
    counts: ``newton`` solves a frame."""
    return [list(cg_log[i:i + newton])
            for i in range(0, len(cg_log) - newton + 1, newton)]
