"""Timing harness: first-call cost separated from the steady state.

The follow-up MRI paper (Schaetz et al. 2017) makes the point that
speed-up claims are only reproducible when one-time setup (kernel builds
and block sweeps, plan builds) is measured apart from the steady-state
per-call cost.  ``measure`` enforces that discipline for every scenario:

  * the FIRST call is timed alone and fenced (``fence``: a CUDA launch
    returns before the card has run it, so every timed region ends in
    ``torch.cuda.synchronize``) — that is ``compile_ms`` (it includes the
    kernels' block sweeps and any plan-cache builds the call triggers);
  * ``warmup - 1`` further fenced calls settle caches/allocators;
  * ``iters`` fenced calls form the steady-state sample, summarized with
    the same percentile machinery as the streaming engine's
    ``LatencyReport`` (``repro_torch.nlinv.stream.latency_stats``);
    ``steady_ms`` is the BEST (minimum) sample — scheduler interference
    only inflates samples, so the floor tracks the true cost, while a
    genuine slowdown shifts the floor itself (p50/p95/jitter still
    describe the distribution);
  * the plan-cache counter deltas for the setup and steady regions are
    recorded (``PlanCache.delta``) — a healthy steady state has
    ``steady.builds == 0``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Callable

import torch

from ..lib.plan import PlanCache, default_cache
from ..nlinv.stream import latency_stats

# steady-state sampling defaults per problem size
SIZE_DEFAULTS = {"tiny": dict(warmup=1, iters=5),
                 "paper": dict(warmup=2, iters=7)}


def fence(device=None) -> None:
    """Wait until ``device`` has run everything queued on it (every
    stream of this process).  ``None`` is the current card when this
    process has used one; the CPU has nothing to wait for."""
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Timing:
    """One measured scenario: setup cost + steady-state distribution."""

    wall_ms: float       # total wall clock of the measurement
    compile_ms: float    # first call: block sweeps + plan builds + run
    steady_ms: float     # steady-state per-call BEST (minimum) sample
    p50_ms: float
    p95_ms: float
    jitter_ms: float     # std dev of the steady samples
    iters: int
    warmup: int
    plan_cache: dict     # {"setup": delta, "steady": delta} counter deltas

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def measure(fn: Callable, *args, warmup: int = 1, iters: int = 5,
            cache: PlanCache | None = None, device=None, **kw) -> Timing:
    """Measure ``fn(*args, **kw)`` with warmup discipline, each call
    fenced on ``device`` (``fence``); see the module docstring."""
    if warmup < 1 or iters < 1:
        raise ValueError("measure needs warmup >= 1 and iters >= 1")
    cache = default_cache() if cache is None else cache
    t_all = time.perf_counter()

    s0 = cache.snapshot()
    t0 = time.perf_counter()
    fn(*args, **kw)
    fence(device)
    compile_ms = (time.perf_counter() - t0) * 1e3
    setup = cache.delta(s0)

    for _ in range(warmup - 1):
        fn(*args, **kw)
        fence(device)

    s1 = cache.snapshot()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        fence(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    steady = cache.delta(s1)

    stats = latency_stats(samples)
    return Timing(
        wall_ms=round((time.perf_counter() - t_all) * 1e3, 3),
        compile_ms=round(compile_ms, 3),
        steady_ms=round(min(samples), 3),
        p50_ms=stats["p50_ms"],
        p95_ms=stats["p95_ms"],
        jitter_ms=stats["jitter_ms"],
        iters=iters, warmup=warmup,
        plan_cache={"setup": setup, "steady": steady})


def calibrate(iters: int = 5) -> float:
    """Machine-speed reference (ms): best-of-N over a fixed numpy
    FFT+matmul workload on the host.

    Stamped into every artifact so ``repro_torch.bench.compare`` can
    normalize steady states by relative machine speed: on shared hosts,
    neighbor contention slows a whole sweep invisibly — it moves this
    reference and the scenarios together, while a genuine code regression
    moves only the scenario.
    """
    import numpy as np
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    c = (a + 1j * a).astype(np.complex64)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(4):
            np.fft.fft2(c)
            a @ a
        best = min(best, time.perf_counter() - t0)
    return round(best * 1e3, 3)


@dataclasses.dataclass
class BenchContext:
    """Everything a scenario needs: the sweep point + a bound harness.

    ``comm`` is this rank's Communicator over ``devices`` ranks (the
    runner builds it as ``env.subgroup(devices)`` in each rank process);
    ``device`` is the rank's device, the one every input goes to and
    every timed call is fenced on (``None``: the communicator's);
    ``out_dir`` is where scenarios may drop side artifacts (e.g. the
    streaming latency report, written by rank 0).
    """

    size: str
    devices: int
    comm: Any
    out_dir: pathlib.Path
    warmup: int = 1
    iters: int = 3
    device: Any = None

    def __post_init__(self):
        self.device = torch.device(self.comm.device if self.device is None
                                   else self.device)

    def measure(self, fn: Callable, *args, warmup: int | None = None,
                iters: int | None = None, **kw) -> Timing:
        return measure(fn, *args,
                       warmup=self.warmup if warmup is None else warmup,
                       iters=self.iters if iters is None else iters,
                       device=self.device, **kw)
