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
  * runs on every rank of the ``Reconstructor``'s communicator alike:
    each rank uploads only its own coils (``put_frame``) and keeps its
    segment of the carry, updated in place;
  * records per-frame wall-clock latency into a ``LatencyReport``, with
    the plans each frame built (``frame_plan_builds``) and the run's
    plan-cache counters (``plan_stats``): frame 0 builds the FFT plans of
    its geometry, and the steady state must build nothing.

``FramePipeline`` runs the same movie as a task graph a frame
(``frame_graph``: upload, solve, damp, readout) through a rolling
``repro_torch.task.Pipeline``, with up to ``inflight`` frames queued on
the card; it can also drop a frame whose dispatch fails and freeze the
movie on the last good image.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from ..task import Executor, Pipeline, TaskGraph
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
    """Stage one acquisition on the solver's device: this rank's coils
    of the frame and its sampling mask."""
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
    # frames the pipeline DROPPED (dispatch failure under ``drop_failed``):
    # frozen in the movie, left out of the latency statistics (a dropped
    # frame has no latency, it has an error)
    dropped: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        """The first frame pays set-up; steady-state stats exclude it, and
        dropped frames, which never completed."""
        gone = set(self.dropped)
        completed = [t for i, t in enumerate(self.frame_ms)
                     if i not in gone] or [0.0]
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
        if self.dropped:
            out["dropped"] = list(self.dropped)
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
        """Reconstruct a movie: y (F, J, X, Y), masks (F, X, Y), numpy,
        the same on every rank.

        Returns (images (F, X, Y), LatencyReport), the images whole on
        every rank.  ``carry`` resumes from a previous run's
        ``last_carry`` (this rank's tensors on the solver's device, see
        ``repro_torch.convert``); with ``donate_carry`` its ``u`` tensors
        are overwritten in place.
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

        cache = rec.plan_cache
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
        report = LatencyReport(frame_ms, rec.comm.size, g, J,
                               frame_plan_builds=frame_builds,
                               plan_stats=cache.delta(run_start))
        if report_path is not None:
            report.save(report_path)
        return torch.stack(images), report


def frame_graph(rec: Reconstructor, take_upload, damp) -> TaskGraph:
    """One streamed frame of the NLINV program as a :class:`TaskGraph`.

    Four nodes, all placed on the reconstructor's group:

      ``upload``  (copy edge) host-to-device staging of the acquisition:
                  takes the double-buffered slot and stages the next
                  frame before the solve is dispatched;
      ``solve``   the Newton/CG stage (``Reconstructor.fn_solve``, which
                  leaves ``u_prev`` as it was: with several frames in
                  flight, frame f-1's ``u`` is still an input of ``damp``);
      ``damp``    the temporal-regularization reference for frame f+1;
      ``crop``    the readout (``Reconstructor.fn_image``).

    Cross-frame dependencies enter as feeds: ``u_prev``/``xref_prev`` are
    the previous frame's (possibly still queued) ``u``/``xref``, plus the
    constants ``fov``/``weight``."""
    g = TaskGraph()
    g.copy("upload", take_upload, outputs=("y", "mask"), group=rec.comm)
    g.add("solve", rec.fn_solve,
          inputs=("y", "mask", "fov", "weight", "u_prev", "xref_prev"),
          outputs=("u",), group=rec.comm)
    g.add("damp", damp, inputs=("u",), outputs=("xref",), group=rec.comm)
    g.add("crop", rec.fn_image, inputs=("mask", "fov", "weight", "u"),
          outputs=("img",), group=rec.comm)
    return g


class FramePipeline:
    """Task-graph pipelined streaming reconstruction.

    The same contract as :class:`FrameStream`, ``run(y, masks, fov) ->
    (images, LatencyReport)`` and the same movie, but each frame runs as
    a :func:`frame_graph` through a rolling :class:`repro_torch.task.Pipeline`:
    up to ``inflight`` frames' graphs stay dispatched and unfenced, so the
    host does not wait on frame f before it issues the upload and the
    solve of the next.  Frames still depend on each other (frame f+1's
    solve reads frame f's damped carry), so the card's work does not
    overlap across frames; what the window removes is the per-frame fence.
    The port's CG loop syncs the host once per iteration, so here the
    window hides at most the upload, ``damp`` and readout of one frame
    behind the next.

    ``frame_ms`` is completion-to-completion time (the throughput view):
    with several frames in flight a dispatch-to-ready latency would count
    overlapped work twice.

    ``retry`` (a restart policy, see :class:`repro_torch.task.Executor`)
    arms the executor's transient-task retry; ``drop_failed=True`` turns a
    frame whose dispatch still fails into a DROP: the movie repeats the
    last good image at that index, the carry stays at the last good frame
    (the next solve regularizes against it), and ``report.dropped`` lists
    the indices.  A real-time consumer prefers a repeated frame to a dead
    stream.
    """

    def __init__(self, recon: Reconstructor, *, damping: float = 0.9,
                 inflight: int = 2, retry=None, drop_failed: bool = False):
        self.recon = recon
        self.damping = damping
        self.inflight = inflight
        self.retry = retry
        self.drop_failed = drop_failed
        self.last_carry = None      # {"u", "x_ref"} after run()

    def _damp(self, u):
        return {k: self.damping * v for k, v in u.items()}

    def run(self, y, masks, fov, *, weight=None, carry=None,
            report_path=None) -> tuple[torch.Tensor, LatencyReport]:
        """As :meth:`FrameStream.run`; ``carry`` is read, never written."""
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

        cache = rec.plan_cache
        run_start = cache.snapshot()
        buf = DoubleBuffer(lambda f: upload_frame(rec, y[f], masks[f]),
                           rec.device)
        buf.stage(0)
        pipe = Pipeline(Executor(retry=self.retry), inflight=self.inflight,
                        drop_failed=self.drop_failed)
        images: dict[int, torch.Tensor] = {}
        frame_ms = [0.0] * F
        frame_builds = [0] * F
        last = time.perf_counter()
        prev = {"u": u, "xref": x_ref}

        def retire(steps):
            nonlocal last
            for f_done, vals in steps:
                now = time.perf_counter()
                frame_ms[f_done] = (now - last) * 1e3
                last = now
                images[f_done] = vals["img"]

        for f in range(F):
            def take_upload(f=f):
                yd, md = buf.take()
                if f + 1 < F:
                    buf.stage(f + 1)    # before the solve: CG blocks the host
                return yd, md

            builds0 = cache.builds
            # the step's uploads stay in its values, so that they live in
            # the window until the step retires
            vals, done = pipe.push(
                frame_graph(rec, take_upload, self._damp),
                feeds={"fov": fov_d, "weight": w_d,
                       "u_prev": prev["u"], "xref_prev": prev["xref"]},
                tag=f, outputs=("u", "xref", "img", "y", "mask"))
            frame_builds[f] = cache.builds - builds0
            if vals is None:
                # frame f dropped: the fault may have hit before or after
                # the upload node ran, so resync the double buffer to hold
                # exactly frame f+1's acquisition; prev still points at the
                # last good carry
                if buf.ready:
                    buf.take()
                if f + 1 < F:
                    buf.stage(f + 1)
                continue
            prev = {"u": vals["u"], "xref": vals["xref"]}
            retire(done)
        retire(pipe.flush())
        self.last_carry = {"u": prev["u"], "x_ref": prev["xref"]}

        dropped = [f for f, _ in pipe.dropped]
        if len(dropped) == F:
            raise RuntimeError(
                f"every frame dropped ({F} dispatch failures): nothing to "
                f"freeze on; first: {pipe.dropped[0][1]!r}")
        # freeze-frame: a dropped index repeats the last delivered image
        # (leading drops repeat zeros: no frame shipped yet)
        shaped = next(img for _, img in sorted(images.items()))
        prev_img = torch.zeros_like(shaped)
        movie = []
        for f in range(F):
            prev_img = images.get(f, prev_img)
            movie.append(prev_img)

        report = LatencyReport(frame_ms, rec.comm.size, g, J,
                               frame_plan_builds=frame_builds,
                               plan_stats=cache.delta(run_start),
                               dropped=dropped)
        if report_path is not None:
            report.save(report_path)
        return torch.stack(movie), report


def stream_movie(data, *, newton=7, cg_iters=30, damping=0.9,
                 channel_sum="crop", fused=True, report_path=None,
                 device=None, comm=None, pipelined=False, inflight=2):
    """Dataset dict -> (images, LatencyReport) through ``FrameStream``, or
    through ``FramePipeline`` (``inflight`` frames queued) with
    ``pipelined=True``, on one rank or on every rank of ``comm``."""
    rec = Reconstructor(comm, device=device, newton=newton,
                        cg_iters=cg_iters, channel_sum=channel_sum,
                        fused=fused)
    if pipelined:
        eng = FramePipeline(rec, damping=damping, inflight=inflight)
    else:
        eng = FrameStream(rec, damping=damping)
    return eng.run(data["y"], data["masks"], data["fov"],
                   report_path=report_path)
