#!/usr/bin/env python3
"""Where one full-width NLINV frame of the PyTorch/CUDA port spends its
time, on one card.

    python3 profile_frame.py

At the main path's configuration (n = 384, grid 768, J = 8, 11 spokes,
newton 7, cg 30), after a warm-up frame:

1. wall time of one frame solve through the CUDA kernels (``impl="auto"``)
   and through their plain PyTorch versions (``impl="plain"``), in turns
   plain, kernel, kernel, plain, with the CG iterations each ran;
2. ``torch.profiler`` over one kernel-path frame: the device's busy time
   (sum of the kernels' device time) against the frame's wall time, the
   idle share, and device time by kernel and by group (the port's CUDA
   kernels, cuFFT, PyTorch's elementwise and reduction kernels);
3. the radial path's frame at the same width (frame 0's 11 spokes of
   1536 samples, plan already built): ``RadialOps.forward`` of the coil
   images then ``gridding_recon_radial`` under ``torch.profiler``, broken
   down the same way, and each gridding kernel alone over 20 back-to-back
   calls: host wall time per call against the kernel's device time per
   launch.

Prints a summary, then the whole result as one JSON object on the last
line.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, NCOILS, SPOKES, NEWTON, CG_ITERS = 384, 8, 11, 7, 30
FRAMES_PER_TURN = 2      # frames timed per arm in each turn of the A/B
PORT_KERNELS = ("coil_forward_kernel", "coil_lincomb_kernel",
                "coil_scale_mult_kernel", "plane_mult_kernel",
                "coil_adjoint_kernel", "cg_update_kernel",
                "sum_partials_kernel", "xpby_kernel", "degrid_kernel",
                "grid_adjoint_kernel")
REPS = 20                # back-to-back calls per gridding kernel


def _group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels"
    if "fft" in low:
        return "cuFFT"
    if "reduce" in low or "dot" in low:
        return "PyTorch reductions"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "PyTorch elementwise"


def _device_times(prof) -> dict[str, tuple[float, int]]:
    """Device ms and launch count by kernel name.  Device-side events
    only: the operator events that launched them carry the same device
    time again."""
    from torch.autograd import DeviceType
    return {evt.key: (evt.self_device_time_total / 1e3, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA}


def _breakdown(label, by_kernel, wall_ms, card) -> dict:
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    groups = {}
    for name, (ms, count) in by_kernel.items():
        grp = groups.setdefault(_group(name), [0.0, 0])
        grp[0] += ms
        grp[1] += count
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    print(f"{label}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms if wall_ms else float('nan'):.4f} "
          f"[{card}]", flush=True)
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {name}: {ms:.3f} ms device, {count} launches",
              flush=True)
    for name, (ms, count) in top:
        print(f"  {ms:9.3f} ms {count:6d}x  {name[:110]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "groups": {k: {"device_ms": v[0], "launches": v[1]}
                       for k, v in groups.items()},
            "top": [{"name": n, "device_ms": v[0], "launches": v[1]}
                    for n, v in top]}


def profile_radial(data, card, device="cuda") -> dict:
    """Part 3: the radial path's frame and its two kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.gridding import degrid, grid_adjoint
    from repro_torch.nlinv.gridding import gridding_recon_radial, radial_ops
    g = data["grid"]
    coils = torch.as_tensor(data["coils"], device=device)
    fov = torch.as_tensor(data["fov"], device=device)
    coil_imgs = torch.as_tensor(data["rho"][0], device=device)[None] * coils
    ops = radial_ops(g, SPOKES, frame=0, device=device)

    def radial_frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = ops.forward(coil_imgs)
        img = gridding_recon_radial(y, g, SPOKES, fov, frame=0,
                                    device=device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, y, img

    _, y, _ = radial_frame()                # warm-up
    walls = [radial_frame()[0] for _ in range(5)]
    print(f"radial frame wall (forward + recon, no profiler): "
          f"{[round(t, 4) for t in walls]} ms [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, _, _ = radial_frame()
    out = {"frame_wall_ms": walls,
           "profiled": _breakdown("profiled radial frame",
                                  _device_times(prof), wall_ms, card)}

    kernels = {"degrid": (lambda: degrid(coil_imgs, ops.plan.interp),
                          "degrid_kernel"),
               "grid_adjoint": (lambda: grid_adjoint(y, ops.plan.interp),
                                "grid_adjoint_kernel")}
    out["kernels"] = {}
    for name, (call, kernel) in kernels.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / REPS
        dev_ms, count = next(v for k, v in _device_times(prof).items()
                             if kernel in k)
        out["kernels"][name] = {"host_wall_ms_per_call": wall,
                                "device_ms_per_launch": dev_ms / count,
                                "launches": count}
        print(f"{name}: {REPS} back-to-back calls under the profiler, "
              f"wall {wall:.4f} ms per call, device {dev_ms / count:.4f} ms "
              f"per launch ({count} launches) [{card}]", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load()
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=1, seed=0)
    g = data["grid"]

    def make(impl):
        rec = Reconstructor(newton=NEWTON, cg_iters=CG_ITERS, impl=impl)
        inputs = (rec.put_frame(data["y"][0]),
                  rec.put_const(data["masks"][0]),
                  rec.put_const(data["fov"]),
                  rec.put_const(sobolev_weight(g)))
        return rec, inputs

    def frame(rec, inputs):
        u0 = rec.init_carry(NCOILS, g)
        x_ref = {k: v.clone() for k, v in u0.items()}
        torch.cuda.synchronize()
        rec.cg_log.clear()
        t0 = time.perf_counter()
        rec(*inputs, u0, x_ref)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, sum(rec.cg_log)

    arms = {impl: make(impl) for impl in ("plain", "auto")}
    for impl in arms:                       # warm-up: cuFFT plans, allocator
        frame(*arms[impl])
    ab = {"plain": [], "auto": []}
    iters = {}
    for impl in ("plain", "auto", "auto", "plain"):
        for _ in range(FRAMES_PER_TURN):
            ms, it = frame(*arms[impl])
            ab[impl].append(ms)
            iters[impl] = it
    for impl, samples in ab.items():
        print(f"frame wall ({impl}): {[round(t, 3) for t in samples]} ms, "
              f"min {min(samples):.3f} ms, cg iterations {iters[impl]} "
              f"[{card}]", flush=True)

    rec, inputs = arms["auto"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, it = frame(rec, inputs)
    print(f"cg iterations of the profiled frame: {it}", flush=True)
    profiled = _breakdown("profiled frame", _device_times(prof), wall_ms,
                          card)

    out = {"card": card, "config": {"n": N, "grid": g, "ncoils": NCOILS,
                                    "spokes": SPOKES, "newton": NEWTON,
                                    "cg_iters": CG_ITERS},
           "frame_wall_ms": ab, "cg_iterations": iters,
           "profiled": dict(profiled, cg_iterations=it),
           "radial": profile_radial(data, card)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
