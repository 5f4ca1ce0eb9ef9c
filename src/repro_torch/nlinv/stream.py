"""Real-time streaming frame engine.

Temporal regularization makes frame f+1 depend on the damped solution of
frame f, so frames are solved one after another, but the host-to-device
upload of the next acquisition can overlap the solve of the current one.
``FrameStream``:

  * double-buffers the upload (``DoubleBuffer``): on the card, frame f+1
    is copied from page-locked host memory on a side CUDA stream, and the
    solver's stream waits on that copy's event only when it takes the
    frame.  The CG loop syncs the host once per iteration, so frame f+1 is
    staged before the solve of frame f starts, not after it returns;
  * updates the Newton carry in place (``Reconstructor.fn_donate_carry``);
  * records per-frame wall-clock latency into a ``LatencyReport``, with
    the plans each frame built (``frame_plan_builds``) and the run's
    plan-cache counters (``plan_stats``): frame 0 builds the FFT plans of
    its geometry, and the steady state must build nothing.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from ..lib.plan import default_cache
from .operators import sobolev_weight
from .recon import Reconstructor


def latency_stats(samples_ms) -> dict:
    """Steady-state latency statistics over per-call wall-clock samples
    (milliseconds)."""
    arr = np.asarray(list(samples_ms), dtype=np.float64)
    if arr.size == 0:
        arr = np.zeros(1)
    mean = float(arr.mean())
    if arr.size < 2:
        # one sample has no spread: the percentiles are the sample
        one = round(float(arr[0]), 3)
        p50, p95, jitter = one, one, 0.0
    else:
        p50 = round(float(np.percentile(arr, 50)), 3)
        p95 = round(float(np.percentile(arr, 95)), 3)
        jitter = round(float(arr.std()), 3)
    return {
        "mean_ms": round(mean, 3),
        "p50_ms": p50,
        "p95_ms": p95,
        "jitter_ms": jitter,
        "fps": round(1e3 / max(mean, 1e-9), 2),
    }


def upload_frame(rec: Reconstructor, y, mask):
    """Stage one acquisition on the solver's device: coil data and its
    sampling mask."""
    return rec.put_frame(y), rec.put_const(mask)


class DoubleBuffer:
    """One-slot-ahead host-to-device staging.

    ``stage`` issues the upload of the next item; ``take`` hands over the
    staged tensors (exactly once).  With a CUDA ``device`` the upload runs
    on a side stream and records an event; ``take`` makes the current
    stream wait on that event and marks the tensors as used on it
    (``record_stream``), so the allocator does not recycle them while the
    solver still reads them.  Without the wait the solver could read a
    half-uploaded frame."""

    def __init__(self, upload, device=None):
        self._upload = upload
        self._slot = None
        dev = None if device is None else torch.device(device)
        self._stream = torch.cuda.Stream(dev) \
            if dev is not None and dev.type == "cuda" else None

    @property
    def ready(self) -> bool:
        return self._slot is not None

    def stage(self, *args) -> None:
        if self._slot is not None:
            raise RuntimeError("DoubleBuffer.stage: slot already staged "
                               "(take() the in-flight item first)")
        if self._stream is None:
            self._slot = (self._upload(*args), None)
            return
        with torch.cuda.stream(self._stream):
            out = self._upload(*args)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._slot = (out, done)

    def take(self):
        if self._slot is None:
            raise RuntimeError("DoubleBuffer.take: nothing staged")
        (out, done), self._slot = self._slot, None
        if done is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
        return out


@dataclasses.dataclass
class LatencyReport:
    """Per-frame wall-clock of one streaming run (milliseconds)."""

    frame_ms: list[float]
    devices: int
    grid: int
    ncoils: int
    frame_plan_builds: list[int] = dataclasses.field(default_factory=list)
    plan_stats: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        """The first frame pays set-up; steady-state stats exclude it."""
        completed = self.frame_ms or [0.0]
        steady = completed[1:] if len(completed) > 1 else completed
        out = {
            "frames": len(self.frame_ms),
            "devices": self.devices,
            "grid": self.grid,
            "ncoils": self.ncoils,
            "first_frame_ms": round(completed[0], 3),
            **latency_stats(steady),
            "frame_ms": [round(t, 3) for t in self.frame_ms],
        }
        if self.frame_plan_builds:
            out["plan_cache"] = dict(
                self.plan_stats,
                frame_builds=list(self.frame_plan_builds),
                steady_builds=int(sum(self.frame_plan_builds[1:])))
        return out

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.summary(), indent=2) + "\n")
        return path


def _fence(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


class FrameStream:
    """Streaming movie reconstruction over a ``Reconstructor``."""

    def __init__(self, recon: Reconstructor, *, damping: float = 0.9,
                 donate_carry: bool = True):
        self.recon = recon
        self.damping = damping
        self.donate_carry = donate_carry
        self.last_carry = None      # {"u", "x_ref"} after run()

    def _damp(self, u):
        return {k: self.damping * v for k, v in u.items()}

    def run(self, y, masks, fov, *, weight=None, carry=None,
            report_path=None) -> tuple[torch.Tensor, LatencyReport]:
        """Reconstruct a movie: y (F, J, X, Y), masks (F, X, Y), numpy.

        Returns (images (F, X, Y), LatencyReport).  ``carry`` resumes
        from a previous run's ``last_carry`` (tensors on the solver's
        device, see ``repro_torch.convert``); with ``donate_carry`` its
        ``u`` tensors are overwritten in place.
        """
        rec = self.recon
        y = np.asarray(y)
        F, J, g = y.shape[0], y.shape[1], y.shape[-1]
        if weight is None:
            weight = sobolev_weight(g)
        fov_d = rec.put_const(fov)
        w_d = rec.put_const(weight)
        if carry is None:
            u = rec.init_carry(J, g)
            x_ref = {k: v.clone() for k, v in u.items()}
        else:
            u, x_ref = carry["u"], carry["x_ref"]
        fn = rec.fn_donate_carry if self.donate_carry else rec.fn

        cache = default_cache()
        run_start = cache.snapshot()
        images, frame_ms, frame_builds = [], [], []
        buf = DoubleBuffer(lambda f: upload_frame(rec, y[f], masks[f]),
                           rec.device)
        buf.stage(0)
        for f in range(F):
            t0 = time.perf_counter()
            builds0 = cache.builds
            yd, md = buf.take()
            if f + 1 < F:
                buf.stage(f + 1)    # before the solve: CG blocks the host
            u, img = fn(yd, md, fov_d, w_d, u, x_ref)
            x_ref = self._damp(u)
            _fence(img)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            frame_builds.append(cache.builds - builds0)
            images.append(img)

        self.last_carry = {"u": u, "x_ref": x_ref}
        # the run's own counter movement, not the process's totals
        report = LatencyReport(frame_ms, 1, g, J,
                               frame_plan_builds=frame_builds,
                               plan_stats=cache.delta(run_start))
        if report_path is not None:
            report.save(report_path)
        return torch.stack(images), report


def stream_movie(data, *, newton=7, cg_iters=30, damping=0.9,
                 channel_sum="crop", fused=True, report_path=None,
                 device=None):
    """Dataset dict -> (images, LatencyReport) through ``FrameStream``."""
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        channel_sum=channel_sum, fused=fused)
    return FrameStream(rec, damping=damping).run(
        data["y"], data["masks"], data["fov"], report_path=report_path)
