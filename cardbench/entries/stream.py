"""One scanner's movie through ``FrameStream.run``, frame after frame.

The closed loop of the paper's real-time reconstruction: NLINV's carry
makes each frame depend on the one before, so a frame is handed over
when the last image is out.  The window hands each frame of the
scanner's cycle (replayed in order) to a ``FrameStream.run`` call of its
own, resuming from the last call's carry (``carry=``), until
``--seconds`` have passed.  A frame's latency is the benchmark's own
clock, from the call that hands the frame over to its image fenced on
the card: it pays the frame's upload and the call's host work.

Compared with the reference: the first ``start`` frames from the initial
carry, and ``samples`` later frames drawn from the seed, from the
program's carry before that frame (cloned when it is drawn; x_ref is
worked out again by the reference).
"""

from __future__ import annotations

import time

import torch

from ..data import traffic
from ..reference import nlinv as ref
from . import _common as cm


def make_reconstructor(cfg, device):
    from repro_torch.nlinv.recon import Reconstructor
    return Reconstructor(device=device, newton=cfg["newton"],
                         cg_iters=cfg["cg_iters"],
                         channel_sum=cfg["channel_sum"], fused=cfg["fused"])


def stream_window(ctx, rec, data):
    """Set-up's warm-up, the window and, with ``--trace 1``, the traced
    stretch.  Returns what the comparison needs: (start images, {slot:
    [frame, u, image]})."""
    from repro_torch.kernels import registry
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.stream import FrameStream
    cfg, tf = ctx.config, ctx.traffic
    dev = rec.device
    y, masks, fov = data["y"], data["masks"], data["fov"]
    C = y.shape[0]
    # the grid's weight, made once as a caller that streams frame by
    # frame would (``run`` makes it on every call it is not given)
    weight = sobolev_weight(data["grid"])
    stream = FrameStream(rec, damping=cfg["damping"])

    def frame(f, carry):
        """Hand frame ``f`` of the cycle over; its image once fenced."""
        img, _ = stream.run(y[f:f + 1], masks[f:f + 1], fov, weight=weight,
                            carry=carry)
        cm.fence(dev)
        return img[0]

    # set-up: the stream's first frames, which build the frame's plans
    carry = None
    for f in range(tf["warmup"]):
        frame(f, carry)
        carry = stream.last_carry
    ctx.setup_s = cm.since(ctx.t0)

    rec.cg_log.clear()
    sample = cm.Reservoir(tf["samples"], ctx.seed)
    snaps: dict = {}
    start: list = []
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    carry, n = None, 0
    t_start = time.perf_counter()
    while True:
        f = n % C
        slot = sample.offer() if n else None
        if slot is not None:
            snaps[slot] = [n, {k: v.clone()
                               for k, v in carry["u"].items()}, None]
        t0 = time.perf_counter()
        img = frame(f, carry)
        ctx.latency_ms.append((time.perf_counter() - t0) * 1e3)
        carry = stream.last_carry
        bad += (~torch.isfinite(img)).any()
        if slot is not None:
            snaps[slot][2] = img.clone()
        if len(start) < tf["start"]:
            start.append(img.clone())
        n += 1
        if cm.since(t_start) >= ctx.seconds:
            break
    cm.fence(dev)
    ctx.window_s = cm.since(t_start)
    ctx.frames = ctx.attempted = n
    ctx.failed = int(bad)
    ctx.cg_frames = cm.cg_frames(rec.cg_log, cfg["newton"])
    ctx.memory_peak_bytes = cm.peak_bytes(dev)
    if ctx.trace:
        with cm.stretch(ctx, registry):
            for i in range(tf["traced_frames"]):
                frame((n + i) % C, carry)
                carry = stream.last_carry
        ctx.traced_frames = tf["traced_frames"]
    return start, snaps


def compare(ctx, data, start, snaps, device):
    """The reference's frames against the program's (run once the
    program's state is freed)."""
    cfg = ctx.config
    C = data["y"].shape[0]
    control = ctx.control_compared if ctx.control else None
    with cm.reference_precision():
        u0 = ref.initial_carry(cfg["ncoils"], data["grid"], device)
        x0 = {k: v.clone() for k, v in u0.items()}
        ctx.compared += cm.compare_chain("frame0", data, 0, len(start), u0,
                                         x0, start, cfg, control)
        for n, u, img in sorted(snaps.values(), key=lambda s: s[0]):
            u = {k: v.to(device) for k, v in u.items()}
            x_ref = {k: cfg["damping"] * v for k, v in u.items()}
            ctx.compared += cm.compare_chain(
                f"frame{n}", data, n % C, 1, u, x_ref, [img], cfg, control)


def run(ctx) -> None:
    data = traffic.cycle(ctx.config, ctx.traffic, ctx.seed, ctx.device)
    rec = make_reconstructor(ctx.config, ctx.device)
    start, snaps = stream_window(ctx, rec, data)
    del rec
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    compare(ctx, data, start, snaps, ctx.device)
