"""The traced stretch: ``torch.profiler`` over a few frames, reduced to a
plain record that the per-layer readers take.

A record is a dict that ``json`` can write (the CPU tests read a recorded
one):

  window_us     [start, end] of the stretch on the profiler's clock
  frames        frames delivered in the stretch
  device        [[name, start_us, dur_us], ...]: every operation that ran
                on the card (kernels, copies, sets)
  host          [[name, start_us, dur_us], ...]: the host's CUDA runtime
                calls

Only the card's activity is traced (CUPTI: its operations and the
runtime calls that issued them), not PyTorch's operators: recording every
operator costs the host more than a frame's launches do, and the frame
is paced by the host's CG loop, so an operator trace would mostly
measure itself.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def traced(device):
    """Profile the block on the host and the card; yields a dict that
    gets the record when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    card = torch.device(device).type == "cuda"

    def fence():
        if card:
            torch.cuda.synchronize(device)

    out: dict = {}
    fence()
    activities = [ProfilerActivity.CUDA] if card else \
        [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield out
        fence()
        wall = time.perf_counter() - t0
    out.update(reduce(prof), wall_s=wall)


def reduce(prof) -> dict:
    """The profile as a record; the window runs from the first recorded
    event to the last (the stretch's first launch to its closing
    fence)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        start = float(e.time_range.start)
        dur = float(e.time_range.elapsed_us())
        if getattr(e, "is_user_annotation", False):
            continue
        (device if e.device_type == DeviceType.CUDA else host).append(
            [e.name, start, dur])
    spans = [(s, s + d) for _, s, d in device + host]
    window = [min(s for s, _ in spans), max(e for _, e in spans)] \
        if spans else [0.0, 0.0]
    return {"window_us": window, "device": device, "host": host}


def busy_intervals(record) -> list[list[float]]:
    """The union of the device operations' intervals inside the window,
    merged, in time order."""
    lo, hi = record["window_us"]
    spans = sorted((max(s, lo), min(s + d, hi))
                   for _, s, d in record["device"])
    merged: list[list[float]] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(record) -> float:
    return sum(e - s for s, e in busy_intervals(record))


def window_us(record) -> float:
    lo, hi = record["window_us"]
    return hi - lo


def idle_gaps(record) -> list[tuple[float, float]]:
    """The stretches of the window in which nothing ran on the card."""
    lo, hi = record["window_us"]
    gaps, at = [], lo
    for s, e in busy_intervals(record):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def device_ops(record, top: int = 10) -> list[list]:
    """The device operations that took most time, [[name, seconds]]."""
    by: dict[str, float] = {}
    for name, _, dur in record["device"]:
        by[name] = by.get(name, 0.0) + dur
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], us / 1e6] for name, us in rows]


def gaps_by_host(record, top: int = 10) -> list[list]:
    """The device's idle time by what the host was doing: each gap named
    after the innermost runtime call that covers its middle, summed by
    name, [[name, seconds]]."""
    gaps = sorted(idle_gaps(record), key=lambda g: (g[0] + g[1]) / 2)
    host = sorted((s, s + d, name) for name, s, d in record["host"])
    by: dict[str, float] = {}
    active: list[tuple[float, float, str]] = []
    i = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active \
            else "(host between CUDA calls)"
        by[name] = by.get(name, 0.0) + (b - a)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], us / 1e6] for name, us in rows]
