#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. device and build: needs a CUDA device; prints the card's name and
   power limit as ``nvidia-smi`` reports them, and builds the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``, into
   ``build/repro_torch/``);
2. kernels: every kernel of the registry, at the main path's shapes
   (J = 8 coils on the 768 x 768 grid), held against its plain PyTorch
   version within the JAX spec's tolerance, then timed with CUDA events
   beside the plain version, the one-call PyTorch yardstick where there
   is one, and its bound (bytes or flops over the H100's peak rates);
3. main path: ``FrameStream(Reconstructor(newton=7, cg_iters=30))`` over 4
   frames of the paper's full width (n = 384, grid 768, J = 8, 11
   golden-angle spokes), with the launch counters set to 0 just before and
   read just after, and required to equal the counts that the CG
   iterations run imply; the images must be finite; then the host time
   of one ``plan_fft2`` cache hit, and of a frame's lookups;
4. kernel path against plain path at newton 3 / cg 10 on the card (relative
   L2 of the image within 1e-4), the kernel path against itself (bitwise),
   and the repo's quality criterion on a small input (NLINV's NRMSE below
   0.12 and below 0.6 x gridding's, as ``tests/test_nlinv.py`` asks);
5. radial gridding: frames 0-3 at full width (grid 768, J = 8, 11
   golden-angle spokes of 1536 samples) through ``radial_ops`` (a plan
   miss per frame, built on the host) -> ``RadialOps.forward`` of the
   phantom's coil images -> ``gridding_recon_radial``, with the launch
   counters set to 0 just before and required to show one ``degrid`` per
   forward and one ``grid_adjoint`` per recon; a second pass over the
   same frames must be 4 plan hits and 0 builds.  Then the kernel path
   against the plain path on frame 0 (relative L2 of the image within
   1e-4), ``grid_adjoint`` against itself (bitwise), the adjoint dot test
   on the card, the radial NRMSE beside the Cartesian gridding NRMSE of
   the same frames, and the repo's radial quality criterion on a small
   input (NRMSE below 0.35, as ``tests/test_gridding.py`` asks).

Each kernel's ``launches`` in the ``kernels`` line is its count from the
phase that drives its path: the frame (phase 3) for the NLINV kernels,
the radial pass (phase 5) for ``degrid`` and ``grid_adjoint``.

The line before the last is the ``kernels`` JSON object; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, NCOILS, SPOKES, FRAMES = 384, 8, 11, 4
NEWTON, CG_ITERS, DAMPING = 7, 30, 0.9
SHALLOW_NEWTON, SHALLOW_CG = 3, 10
PATH_TOL = 1e-4          # kernel path vs plain path, relative L2 of image
TIMING_REPS = 20
PLAN_LOOKUPS = 1000      # plan_fft2 cache hits timed on the host


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, args, reps=TIMING_REPS) -> float:
    """Mean time of ``fn(*args)`` on the card, from CUDA events around
    ``reps`` back-to-back calls after one warm-up call."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, tuple) else (x,)


def _agree(got, want, tol) -> tuple[bool, float, float]:
    """allclose in the JAX registry harness's form (rtol = 10 tol,
    atol = tol) over every output, with the largest absolute error and
    the largest error relative to its output's largest value."""
    import torch
    pairs = list(zip(_outputs(got), _outputs(want)))
    err = max(float((g - w).abs().max()) for g, w in pairs)
    rel = max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
              for g, w in pairs)
    ok = all(torch.allclose(g, w, rtol=10 * tol, atol=tol)
             for g, w in pairs)
    return ok, err, rel


def phase_kernels(device, card) -> list[dict]:
    import torch
    from repro_torch.kernels import registry
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for spec in registry.specs():
        args = spec.sample(device, gen)
        ok, err, rel = _agree(spec.kernel(*args), spec.plain(*args),
                              spec.tol)
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"{spec.name}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        lib_ms = None
        if spec.library is not None:
            lib_ok, lib_err, _ = _agree(spec.library(*args),
                                        spec.plain(*args), spec.tol)
            if not lib_ok:
                raise AssertionError(f"{spec.name}: library yardstick "
                                     f"computes another function "
                                     f"({lib_err})")
            lib_ms = time_ms(spec.library, args)
        ms = time_ms(spec.kernel, args)
        plain_ms = time_ms(spec.plain, args)
        bound, bound_by = spec.bound_ms(*args)
        rows.append({
            "name": spec.name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": 0,
            "max_abs_err": err, "max_rel_err": rel, "tol": spec.tol,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
        print(f"kernel {spec.name}: max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tol {spec.tol}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound:.4f} ms ({bound_by}, "
              f"{spec.nbytes(*args) / 1e6:.1f} MB) [{card}]", flush=True)
        del args
    return rows


def expected_launches(cg_log, frames, newton) -> dict[str, int]:
    """Launches of each kernel implied by the CG iterations that ran.

    Per CG iteration: DG_fused (1 coil_lincomb, 1 plane_mult), DGH_fused
    (2 plane_mult, 1 coil_adjoint, 1 coil_forward), 2 cg_update and 2
    xpby (one per leaf).  Per Newton step outside CG: G_fused (1
    coil_scale_mult, 1 plane_mult) and the rhs DGH_fused (2 plane_mult,
    1 coil_adjoint, 1 coil_forward).  Per frame: y masked once."""
    steps = len(cg_log)
    if steps != frames * newton:
        raise AssertionError(f"{steps} CG solves logged, expected "
                             f"{frames * newton}")
    it = sum(cg_log)
    return {"coil_forward": it + steps, "coil_lincomb": it,
            "coil_scale_mult": steps,
            "plane_mult": 3 * it + 3 * steps + frames,
            "coil_adjoint": it + steps, "cg_update": 2 * it,
            "xpby": 2 * it}


def nrmse(img, truth, fov) -> float:
    import numpy as np
    m = np.asarray(fov) > 0
    a = np.abs(np.asarray(img))[m]
    b = np.abs(np.asarray(truth))[m]
    a = a / max(a.max(), 1e-9)
    b = b / max(b.max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def fft_plan_lookup_us(device, grid) -> float:
    """Host time of one ``plan_fft2`` lookup of the frame's FFT geometry
    that hits the cache: the mean over ``PLAN_LOOKUPS`` lookups timed
    with ``time.perf_counter``.  It launches nothing."""
    import torch
    from repro_torch.lib.fft import plan_fft2
    shape = (NCOILS, grid, grid)
    plan_fft2(shape, torch.complex64, device=device, centered=True)
    t0 = time.perf_counter()
    for _ in range(PLAN_LOOKUPS):
        plan_fft2(shape, torch.complex64, device=device, centered=True)
    return (time.perf_counter() - t0) * 1e6 / PLAN_LOOKUPS


def phase_main_path(device, card, data) -> dict[str, int]:
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.gridding import gridding_recon
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    g = data["grid"]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    stream = FrameStream(rec, damping=DAMPING)
    registry.reset_launches()
    movie, report = stream.run(data["y"], data["masks"], data["fov"])
    torch.cuda.synchronize()
    counts = registry.launches()
    if tuple(movie.shape) != (FRAMES, g, g):
        raise AssertionError(f"movie shape {tuple(movie.shape)}")
    if not bool(torch.isfinite(movie).all()):
        raise AssertionError("main path produced non-finite images")
    want = expected_launches(rec.cg_log, FRAMES, NEWTON)
    frame_counts = {k: counts[k] for k in want}
    if frame_counts != want:
        raise AssertionError(f"launch counts {frame_counts} != expected "
                             f"{want}")
    missing = [k for k, v in frame_counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    stray = {k: v for k, v in counts.items() if k not in want and v}
    if stray:
        raise AssertionError(f"the frame launched other kernels: {stray}")
    s = report.summary()
    pc = s.get("plan_cache")
    if (pc is None or pc["steady_builds"] != 0
            or len(pc["frame_builds"]) != FRAMES):
        raise AssertionError(f"plan cache report: {pc}")
    e_nlinv = [nrmse(movie[f].cpu().numpy(), data["rho"][f], data["fov"])
               for f in range(FRAMES)]
    fov_d = rec.put_const(data["fov"])
    e_grid = [nrmse(gridding_recon(rec.put_frame(data["y"][f]),
                                   rec.put_const(data["masks"][f]),
                                   fov_d).cpu().numpy(),
                    data["rho"][f], data["fov"]) for f in range(FRAMES)]
    print(f"main path: n={N} grid={g} J={NCOILS} spokes={SPOKES} "
          f"frames={FRAMES} newton={NEWTON} cg={CG_ITERS}: cg iterations "
          f"{rec.cg_log}", flush=True)
    print(f"main path latency: first frame {s['first_frame_ms']:.3f} ms, "
          f"steady {s['mean_ms']:.3f} ms/frame (p50 {s['p50_ms']:.3f}, "
          f"p95 {s['p95_ms']:.3f}), {s['fps']:.3f} fps, frame_ms "
          f"{s['frame_ms']}; NRMSE nlinv {[round(e, 4) for e in e_nlinv]} "
          f"gridding {[round(e, 4) for e in e_grid]} [{card}]", flush=True)
    print(f"main path launches: {json.dumps(frame_counts)}", flush=True)
    print(f"main path plan cache: {json.dumps(pc)}", flush=True)
    lookup_us = fft_plan_lookup_us(device, g)
    per_frame = pc["hits"] / FRAMES
    print(f"fft2 plan lookup: {lookup_us:.3f} us of host time (mean of "
          f"{PLAN_LOOKUPS} cache hits); the frames made {per_frame:.2f} "
          f"lookups each, {lookup_us * per_frame / 1e3:.4f} ms of host time "
          f"a frame [{card}]", flush=True)
    return frame_counts


def _solve(device, data, frame, *, newton, cg_iters, impl="auto"):
    import torch
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        impl=impl)
    J, g = data["y"].shape[1], data["grid"]
    u0 = rec.init_carry(J, g)
    x_ref = {k: v.clone() for k, v in u0.items()}
    u, img = rec(rec.put_frame(data["y"][frame]),
                 rec.put_const(data["masks"][frame]),
                 rec.put_const(data["fov"]), rec.put_const(sobolev_weight(g)),
                 u0, x_ref)
    torch.cuda.synchronize()
    return u, img


def phase_parity(device, card, data) -> None:
    import torch
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.gridding import gridding_recon
    kw = dict(newton=SHALLOW_NEWTON, cg_iters=SHALLOW_CG)
    u_k, img_k = _solve(device, data, 0, **kw)
    _, img_p = _solve(device, data, 0, impl="plain", **kw)
    u_k2, img_k2 = _solve(device, data, 0, **kw)
    rel = float(torch.linalg.vector_norm(img_k - img_p) /
                torch.linalg.vector_norm(img_p))
    bitwise = torch.equal(img_k, img_k2) and all(
        torch.equal(u_k[k], u_k2[k]) for k in u_k)
    print(f"kernel vs plain path (newton {SHALLOW_NEWTON}, cg {SHALLOW_CG}, "
          f"grid {data['grid']}): image relative L2 {rel:.3e} "
          f"(limit {PATH_TOL}); repeat bitwise identical: {bitwise} "
          f"[{card}]", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"kernel path drifts from plain path: {rel}")
    if not bitwise:
        raise AssertionError("kernel path is not bitwise repeatable")

    small = phantom.make_dataset(n=32, ncoils=4, nspokes=9, frames=1, seed=1)
    _, img = _solve(device, small, 0, newton=8, cg_iters=30)
    e_nlinv = nrmse(img.cpu().numpy(), small["rho"][0], small["fov"])
    grid_img = gridding_recon(
        torch.as_tensor(small["y"][0], device=device),
        torch.as_tensor(small["masks"][0], dtype=torch.float32,
                        device=device),
        torch.as_tensor(small["fov"], device=device))
    e_grid = nrmse(grid_img.cpu().numpy(), small["rho"][0], small["fov"])
    print(f"small-input quality (n=32, J=4, 9 spokes, newton 8): NRMSE "
          f"nlinv {e_nlinv:.4f}, gridding {e_grid:.4f}", flush=True)
    if not (e_nlinv < 0.12 and e_nlinv < 0.6 * e_grid):
        raise AssertionError(f"NLINV quality check failed: {e_nlinv} vs "
                             f"gridding {e_grid}")


def _rel_l2(a, b) -> float:
    import torch
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def phase_radial(device, card, data) -> dict[str, int]:
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.gridding import degrid, grid_adjoint
    from repro_torch.lib.plan import default_cache
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.gridding import (gridding_recon,
                                            gridding_recon_radial,
                                            radial_ops)
    g = data["grid"]
    cache = default_cache()
    coils = torch.as_tensor(data["coils"], device=device)
    fov = torch.as_tensor(data["fov"], device=device)
    rho = [torch.as_tensor(data["rho"][f], device=device)
           for f in range(FRAMES)]
    torch.cuda.synchronize()

    build_ms, recon_ms, images, samples, plan_misses = [], [], [], [], []
    registry.reset_launches()
    first = cache.snapshot()
    for f in range(FRAMES):
        t0 = time.perf_counter()
        misses0 = cache.misses
        ops = radial_ops(g, SPOKES, frame=f, device=device)
        build_ms.append((time.perf_counter() - t0) * 1e3)
        plan_misses.append(cache.misses - misses0)
        y = ops.forward(rho[f][None] * coils)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = gridding_recon_radial(y, g, SPOKES, fov, frame=f,
                                    device=device)
        end.record()
        end.synchronize()
        recon_ms.append(start.elapsed_time(end))
        images.append(img)
        samples.append(y)
    counts = registry.launches()
    d_first = cache.delta(first)
    second = cache.snapshot()
    lookup_ms = []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        radial_ops(g, SPOKES, frame=f, device=device)
        lookup_ms.append((time.perf_counter() - t0) * 1e3)
    d_second = cache.delta(second)

    want = {k: 0 for k in counts}
    want.update(degrid=FRAMES, grid_adjoint=FRAMES)
    if counts != want:
        raise AssertionError(f"radial launch counts {counts} != {want}")
    if plan_misses != [1] * FRAMES:
        raise AssertionError(f"first radial pass: plan misses per frame "
                             f"{plan_misses}, expected one each")
    if d_second["hits"] != FRAMES or d_second["builds"] != 0 \
            or d_second["misses"] != 0:
        raise AssertionError(f"second radial pass: {d_second}, expected "
                             f"{FRAMES} hits and 0 builds")
    for img in images:
        if tuple(img.shape) != (g, g) or not bool(torch.isfinite(img).all()):
            raise AssertionError("radial recon produced a bad image")
    plan = radial_ops(g, SPOKES, frame=0, device=device).plan
    print(f"radial path: grid={g} J={NCOILS} spokes={SPOKES} samples "
          f"{plan.nsamp} (padded {plan.nsamp_padded}) frames={FRAMES}: plan "
          f"build ms {[round(t, 3) for t in build_ms]} (host), recon ms "
          f"{[round(t, 4) for t in recon_ms]} (CUDA events), second-pass "
          f"lookup ms {[round(t, 4) for t in lookup_ms]}; plan device bytes "
          f"{plan.device_bytes()} [{card}]", flush=True)
    print(f"radial plan cache: radial_ops misses per frame {plan_misses}; "
          f"first pass {json.dumps(d_first)}; second "
          f"pass {json.dumps(d_second)}", flush=True)
    print(f"radial launches: {json.dumps(counts)}", flush=True)

    # kernel path against plain path, frame 0
    ops_p = radial_ops(g, SPOKES, frame=0, device=device, impl="plain")
    y_p = ops_p.forward(rho[0][None] * coils)
    img_p = gridding_recon_radial(y_p, g, SPOKES, fov, frame=0,
                                  device=device, impl="plain")
    rel = _rel_l2(images[0], img_p)
    rel_y = _rel_l2(samples[0], y_p)
    # grid_adjoint repeats bit for bit
    k1 = grid_adjoint(samples[0], plan.interp)
    k2 = grid_adjoint(samples[0], plan.interp)
    bitwise = torch.equal(k1, k2)
    # adjoint dot test on the card
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    gg = torch.randn((NCOILS, g, g), dtype=torch.complex64, device=device,
                     generator=gen)
    yy = torch.randn((NCOILS, plan.nsamp_padded), dtype=torch.complex64,
                     device=device, generator=gen)
    lhs = complex(torch.vdot(degrid(gg, plan.interp).reshape(-1),
                             yy.reshape(-1)))
    rhs = complex(torch.vdot(gg.reshape(-1),
                             grid_adjoint(yy, plan.interp).reshape(-1)))
    dot_rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    torch.cuda.synchronize()
    print(f"radial kernel vs plain path (frame 0): image relative L2 "
          f"{rel:.3e}, samples relative L2 {rel_y:.3e} (limit {PATH_TOL}); "
          f"grid_adjoint repeat bitwise identical: {bitwise}; adjoint dot "
          f"test relative error {dot_rel:.3e} (limit 1e-3) [{card}]",
          flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"radial kernel path drifts from plain: {rel}")
    if not bitwise:
        raise AssertionError("grid_adjoint is not bitwise repeatable")
    if not dot_rel <= 1e-3:
        raise AssertionError(f"adjoint dot test failed: {lhs} vs {rhs}")

    e_rad = [nrmse(images[f].cpu().numpy(), data["rho"][f], data["fov"])
             for f in range(FRAMES)]
    e_cart = [nrmse(gridding_recon(
        torch.as_tensor(data["y"][f], device=device),
        torch.as_tensor(data["masks"][f], dtype=torch.float32,
                        device=device), fov).cpu().numpy(),
        data["rho"][f], data["fov"]) for f in range(FRAMES)]
    print(f"full-width NRMSE in the FOV: radial gridding "
          f"{[round(e, 4) for e in e_rad]}, Cartesian gridding "
          f"{[round(e, 4) for e in e_cart]}", flush=True)

    small = phantom.make_dataset(n=32, ncoils=4, nspokes=13, frames=1,
                                 seed=5)
    ops_s = radial_ops(small["grid"], 13, device=device)
    y_s = ops_s.forward(torch.as_tensor(small["rho"][0][None] *
                                        small["coils"], device=device))
    img_s = ops_s.recon(y_s, torch.as_tensor(small["fov"], device=device))
    e_small = nrmse(img_s.cpu().numpy(), small["rho"][0], small["fov"])
    print(f"small-input radial quality (n=32, J=4, 13 spokes, seed 5): "
          f"NRMSE {e_small:.4f} (limit 0.35)", flush=True)
    if not (e_small < 0.35 and np.isfinite(img_s.cpu().numpy()).all()):
        raise AssertionError(f"radial quality check failed: {e_small}")
    return {k: counts[k] for k in ("degrid", "grid_adjoint")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.nlinv import phantom

    device = resolve_device(None)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s "
          f"(compiled this run: {_build.build_seconds is not None})",
          flush=True)
    print(lib.with_suffix(".log").read_text(), flush=True)

    rows = phase_kernels(device, card)

    t0 = time.perf_counter()
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=FRAMES, seed=0)
    print(f"dataset: {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    counts = phase_main_path(device, card, data)
    phase_parity(device, card, data)
    counts.update(phase_radial(device, card, data))
    for row in rows:
        row["launches"] = counts[row["name"]]

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
