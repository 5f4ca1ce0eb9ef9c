"""Each per-layer reader on a recorded trace fixture (2.5 ms of a traced
stretch of ``rt768.stream`` on the card), and the trace's reductions."""

import json

import numpy as np
import pytest

from cardbench import run as bench
from cardbench import trace as tr
from cardbench.metrics._kernels import is_port_kernel
from conftest import ROOT

FIXTURE = ROOT / "cardbench" / "tests" / "fixtures" / "trace_slice.json"


@pytest.fixture
def ctx():
    rec = json.loads(FIXTURE.read_text())
    c = bench.Context(name="rt768.stream", config={"grid": 768,
                                                   "ncoils": 8},
                      traffic={}, seed=0, seconds=1.0, trace=True,
                      device="cuda", chips=1)
    c.trace_record = rec
    c.traced_frames = rec["frames"]
    c.window_s, c.frames = 2.0, 8
    c.cg_frames = [[30] * 7] * 8
    c.trace_record["wall_s"] = 0.003
    c.kernels = {"known": {"cg_update": {"calls": 4, "bytes": 0, "flops": 0,
                                         "bound_s": 1e-4}},
                 "unknown": {}}
    return c


def _sum_us(rec, pred):
    return sum(d for name, _, d in rec["device"] if pred(name))


def test_launches(ctx):
    got = bench.reader("launches_per_frame")(ctx)
    assert got == len(ctx.trace_record["device"]) > 50


def test_rolls_and_cufft(ctx):
    rec = ctx.trace_record
    roll = bench.reader("roll_ms_per_frame")(ctx)
    fft = bench.reader("cufft_ms_per_frame")(ctx)
    assert roll == pytest.approx(
        _sum_us(rec, lambda n: "roll_cuda_kernel" in n) / 1e3)
    assert fft == pytest.approx(
        _sum_us(rec, lambda n: "regular_fft" in n) / 1e3)
    assert 0 < roll and 0 < fft


def test_kernel_roofline(ctx):
    us = _sum_us(ctx.trace_record, is_port_kernel)
    assert us > 0
    got = bench.reader("kernel_roofline")(ctx)
    assert got == pytest.approx(100 * 1e-4 / (us / 1e6))
    ctx.kernels = {"known": {}, "unknown": {}}
    assert bench.reader("kernel_roofline")(ctx) is None


def test_idle_share(ctx):
    rec = ctx.trace_record
    busy = tr.busy_us(rec)
    assert 0 < busy <= tr.window_us(rec) == pytest.approx(2500.0)
    # a traced frame's busy time over the untraced window's time a frame
    got = bench.reader("device_idle_share")(ctx)
    assert got == pytest.approx(100 * (1 - busy / 1e6 / (2.0 / 8)))
    ctx.window_s = busy / 1e6 * ctx.frames / 0.8
    assert bench.reader("device_idle_share")(ctx) == pytest.approx(20.0)
    # the gaps and the busy time tile the stretch
    gaps = sum(b - a for a, b in tr.idle_gaps(rec))
    assert gaps + busy == pytest.approx(2500.0)
    named = tr.gaps_by_host(rec)
    assert sum(s for _, s in named) == pytest.approx(gaps / 1e6)
    assert len(tr.device_ops(rec)) == 10


def test_traced_frame_ms(ctx):
    assert bench.reader("traced_frame_ms")(ctx) == pytest.approx(3.0)
    del ctx.trace_record["wall_s"]
    assert bench.reader("traced_frame_ms")(ctx) is None


def test_frame_mfu(ctx):
    from cardbench.metrics._work import frames_bound_s
    got = bench.reader("frame_mfu")(ctx)
    assert got == pytest.approx(100 * frames_bound_s(768, 8, ctx.cg_frames)
                                / 2.0)
    assert 0 < got < 100


@pytest.mark.parametrize("name", ["launches_per_frame", "roll_ms_per_frame",
                                  "cufft_ms_per_frame", "kernel_roofline",
                                  "device_idle_share",
                                  "traced_frame_ms"])
def test_nothing_to_read_gives_nothing(ctx, name):
    ctx.trace_record = None
    assert bench.reader(name)(ctx) is None


def test_busy_union_merges_overlaps():
    rec = {"window_us": [0.0, 10.0], "host": [["cudaStreamSynchronize",
                                                5.0, 3.0]],
           "device": [["a", 1.0, 2.0], ["b", 2.0, 2.0], ["c", 9.0, 5.0]]}
    assert tr.busy_intervals(rec) == [[1.0, 4.0], [9.0, 10.0]]
    assert tr.idle_gaps(rec) == [(0.0, 1.0), (4.0, 9.0)]
    named = dict(tr.gaps_by_host(rec))
    assert named["cudaStreamSynchronize"] == pytest.approx(5e-6)


def test_end_to_end_statistics():
    c = bench.Context(name="x", config={}, traffic={}, seed=0, seconds=1,
                      trace=False, device="cpu", chips=1)
    c.latency_ms = list(np.arange(1, 101, dtype=float))
    c.window_s, c.frames, c.setup_s = 4.0, 100, 3.0
    got = bench.end_to_end(c)
    assert got == {"setup_s": 3.0, "frames_per_s": 25.0,
                   "frame_latency_p95_ms": pytest.approx(95.05)}
