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
   is one, and its bound (bytes or flops over the H100's peak rates),
   and its device time alone from ``torch.profiler`` (``device_ms``, and
   the yardstick's ``library_device_ms``: a small kernel behind a Python
   wrapper can leave the card waiting on the host, which the events then
   measure), split by CUDA kernel where a wrapper launches several, and
   the times of the parts that its spec names (``KernelSpec.parts``:
   ``grid_adjoint``'s fill and gather each alone, ``torch.zeros`` of the
   grid beside its fill, and ``degrid``'s launch of one sample, the
   floor of a launch); flash attention at every JAX feature
   sample through the route of its dtype and again in bf16 through the
   tensor cores, with a bitwise repeat at the LM sample;
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

6. LM serving: recurrentgemma-2b at its published widths and depth (26
   layers, d_model 2560, 10 heads on one kv head of dim 256, d_ff 7680,
   vocab 256000, RG-LRU width 2560, window 2048, bf16) with random weights
   from a seeded generator on the card, behind
   ``repro_torch.serve.Engine(batch=2, max_len=4096)``: 4 requests with
   prompts of 3072, 2049, 512 and 1 tokens (numpy's ``default_rng(0)``)
   and max_new 16, 12, 8 and 4.  The launch counters are set to 0 just
   before the first submit and must read 8 ``flash_attention`` and 18
   ``rg_lru`` launches per prefill (32 and 72) and none in any decode
   step; every request must return its max_new tokens.  Prefill ms per
   request and decode ms per token come from CUDA events (after one
   warm-up prefill outside the count).  Then the same four requests
   through an ``Engine`` inside ``registry.plain()``, both paths' greedy
   tokens printed with the first position where they differ (and a note
   where every request repeats one token, which the random init can
   give, so that equal tokens are not read as agreement); and the
   same weights in float32 compute, whose four prefills through the
   kernels and through the plain versions must agree within
   ``LM_PATH_TOL_F32`` (relative L2 of the last-token logits), while in
   bf16 the kernel path must be no further from the float32 logits than
   ``LM_BF16_RATIO`` times the plain path.  The kernels phase also holds
   both LM kernels against their plain versions at the JAX specs' feature
   samples, and ``rg_lru`` against itself at the served shape (bitwise).
7. xlstm-350m served: the same phase for xlstm-350m at its published
   widths and depth (24 layers: 21 mLSTM and 3 sLSTM blocks, d_model
   1024, 4 heads of dim 512 over the mLSTM's inner width 2048, vocab
   50304, bf16), random weights from a generator seeded 0, behind
   ``Engine(batch=2, max_len=4096)`` with the same four prompts and
   max_new: 21 ``mlstm`` launches per prefill (84), none in decode, the
   same float32 and bf16 checks, and the share of a 3072-token prefill
   that its sLSTM loops take (CUDA events around the layers).  The kernels phase
   holds ``mlstm`` against ``mlstm_chunkwise`` at the served shape from a
   zero and a nonzero state and at every ``FEATURE_CASES`` entry (zero and
   nonzero state, a ragged S) in float32 and in bf16, within 2e-3, each
   through the route of its dtype, and requires a bitwise repeat.
8. the multi-rank core: four rank processes (``run_ranks``: spawned, one
   ``FileStore``, gloo, all on the one card) run
   ``FrameStream(Reconstructor(comm=4 ranks, channel_sum="crop"))`` over
   phase 3's 4 full-width frames (J = 8, 2 coils a rank, newton 7, cg 30),
   with the counters set to 0 just before and read just after on every
   rank: one ``masked_sum`` per channel-sum call (newton + the CG
   iterations, a frame) and the other frame kernels as
   ``expected_launches`` gives them for the rank's coils.  ``rho``, the CG
   log and the images must be bitwise equal on every rank; the 4-rank
   image within ``PATH_TOL`` of the 1-rank image at newton 3 / cg 10, and
   at full depth each frame's NRMSE within ``DEPTH_NRMSE_TOL`` of phase
   3's.  Then the segmented BLAS on full-width CG-state containers
   (``rho`` CLONE 768 x 768, ``chat`` NATURAL 8 x 768 x 768 from a numpy
   seed): ``xpby_dot``, ``cg_update``, ``axpy_dot`` and
   ``dot_allreduce`` held against the plain computation on the gathered
   arrays (the spec tolerance), one ``xpby_dot`` launch per leaf.  Last, a
   1-rank NCCL group runs frame 0 of the same program.  Times of this
   phase are times of a host-staged transport (gloo) on one shared card:
   they say nothing of four cards.

Each kernel's ``launches`` in the ``kernels`` line is its count from the
phase that drives its path: the frame (phase 3) for the NLINV kernels,
the 4-rank frame (phase 8, rank 0) for ``masked_sum`` and the segmented
BLAS (phase 8) for ``xpby_dot``, the radial pass (phase 5) for
``degrid`` and ``grid_adjoint``, the served requests (phase 6) for
``flash_attention`` and ``rg_lru`` and (phase 7) for ``mlstm``.  The
served bf16 prefills must take the tensor-core routes of
``flash_attention`` and ``mlstm`` and the float32 ones their CUDA-core
routes.  A kernel whose operands are
bf16 (flash attention, the mLSTM) is bounded by the bf16 tensor-core
rate; its row also carries ``f32_core_bound_ms``, the same flops over the
float32 CUDA-core rate (the float32 routes of both compute on the CUDA
cores).

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
# back-to-back calls timed per kernel: the first call waits on the host
# from an idle card, a share that 100 calls make small
TIMING_REPS = 100
PLAN_LOOKUPS = 1000      # plan_fft2 cache hits timed on the host
LM_ARCH = "recurrentgemma-2b"
LM_PROMPTS = (3072, 2049, 512, 1)
LM_MAX_NEW = (16, 12, 8, 4)
LM_BATCH, LM_MAX_LEN = 2, 4096
# kernel path vs plain path, last-token prefill logits (relative L2): in
# float32 compute; in bf16 (the served dtype) each path's distance from
# the float32 plain logits, the kernel path's at most this multiple of
# the plain path's (bf16 rounding alone puts either path about 2e-2 from
# float32 at this depth, so a fixed bf16 bound would test the rounding)
LM_PATH_TOL_F32 = 1e-4
LM_BF16_RATIO = 1.5
# the float32 feature samples of flash attention, cast to bf16 for the
# tensor-core route: the JAX spec's tolerance of its bf16 sample
BF16_FEATURE_TOL = 2e-2
XLSTM_ARCH = "xlstm-350m"
XLSTM_PROMPTS = (3072, 2049, 512, 1)
XLSTM_MAX_NEW = (16, 12, 8, 4)
DIST_RANKS = 4            # phase 8: ranks sharing the one card (gloo)
DIST_TIMEOUT_S = 400      # phase 8: the ranks' deadline, collectives too
# phase 8, full depth: the 4-rank frames' NRMSE against the 1-rank frames'
# (the depth-drift rule of the frame's earlier slices)
DEPTH_NRMSE_TOL = 1e-3
BLAS_SEED = 7
# the port's kernel for each layer kind that prefills through one
KIND_KERNEL = {"attn": "flash_attention", "local": "flash_attention",
               "rglru": "rg_lru", "mlstm": "mlstm"}
ATTN = ("attn", "local")


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


def device_ms(fn, args, reps=TIMING_REPS) -> tuple[float | None, dict]:
    """Mean device time of ``fn(*args)``: the CUDA kernels'
    ``torch.profiler`` time over ``reps`` calls after one warm-up call,
    and the same by kernel name (a wrapper may launch several).  Where
    the host cannot keep the card busy (small launches behind a Python
    wrapper), ``time_ms`` measures the host and this the card.  ``None``
    when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_name(e.key)
            by_name[name] = (by_name.get(name, 0.0) +
                             e.self_device_time_total / 1e3 / reps)
    total = sum(by_name.values())
    return (total if total else None), by_name


def _kernel_name(key: str) -> str:
    """The port's kernel key without its return type, namespace and
    arguments: "void (anonymous namespace)::k<float>(float const*)" is
    "k<float>".  Names that share a stem share a sum; the total holds."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0]


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


def _time_parts(spec, args, card) -> dict:
    """Events and device ms of each of ``spec.parts``: parts of a kernel's
    work, timed alone, and their yardsticks."""
    out = {}
    for name, call in spec.parts(*args).items():
        dev, split = device_ms(call, ())
        out[name] = {"ms": time_ms(call, ()), "device_ms": dev,
                     "device_ms_by_kernel": split}
        print(f"kernel {spec.name} part {name}: {out[name]['ms']:.4f} ms "
              f"(device {'n/a' if dev is None else f'{dev:.5f}'}; "
              f"{ {k: round(v, 5) for k, v in split.items()} }) [{card}]",
              flush=True)
    return out


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
        lib_ms = lib_dev_ms = None
        if spec.library is not None:
            lib_ok, lib_err, _ = _agree(spec.library(*args),
                                        spec.plain(*args), spec.tol)
            if not lib_ok:
                raise AssertionError(f"{spec.name}: library yardstick "
                                     f"computes another function "
                                     f"({lib_err})")
            lib_ms = time_ms(spec.library, args)
            lib_dev_ms = device_ms(spec.library, args)[0]
        ms = time_ms(spec.kernel, args)
        dev_ms, dev_split = device_ms(spec.kernel, args)
        plain_ms = time_ms(spec.plain, args)
        bound, bound_by = spec.bound_ms(*args)
        rows.append({
            "name": spec.name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": 0,
            "max_abs_err": err, "max_rel_err": rel, "tol": spec.tol,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms,
        })
        if len(dev_split) > 1:
            rows[-1]["device_ms_by_kernel"] = dev_split
        if spec.peak_flops != registry.H100_F32_FLOPS:
            rows[-1]["f32_core_bound_ms"] = (spec.flops(*args) /
                                             registry.H100_F32_FLOPS * 1e3)
        print(f"kernel {spec.name}: max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tol {spec.tol}) "
              f"kernel {ms:.4f} ms (device "
              f"{'n/a' if dev_ms is None else f'{dev_ms:.4f}'}), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} (device "
              f"{'n/a' if lib_dev_ms is None else f'{lib_dev_ms:.4f}'}), "
              f"bound "
              f"{bound:.4f} ms ({bound_by}, "
              f"{spec.nbytes(*args) / 1e6:.1f} MB) [{card}]", flush=True)
        if len(dev_split) > 1:
            print(f"kernel {spec.name} device ms by CUDA kernel: "
                  f"{ {k: round(v, 4) for k, v in dev_split.items()} }",
                  flush=True)
        if spec.parts is not None:
            rows[-1]["parts"] = _time_parts(spec, args, card)
        del args
    return rows


def phase_lm_features(device, card) -> None:
    """The LM kernels against their plain versions at the JAX specs'
    feature samples, each within its sample's tolerance (the mLSTM within
    its spec's, with a bitwise repeat, and at the served shape)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import (FEATURE_CASES, ROUTES,
                                                     chunked_attention,
                                                     flash_attention)
    from repro_torch.kernels.rg_lru import FEATURE_CASES as LRU_CASES
    from repro_torch.kernels.rg_lru import rg_lru_scan, rg_lru_scan_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(500)
    spec = registry.get("flash_attention")
    for B, Hq, Hkv, S, T, D, dtype, kw, tol in FEATURE_CASES:
        x = [torch.randn(sh, device=device, generator=gen)
             for sh in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]
        # the sample in its own dtype, and every sample's bf16 form on the
        # tensor cores, held to the JAX spec's bf16 tolerance
        forms = [(dtype, tol)] + ([(torch.bfloat16, BF16_FEATURE_TOL)]
                                  if dtype != torch.bfloat16 else [])
        for dt, tl in forms:
            q, k, v = (t.to(dt) for t in x)
            route = ROUTES[dt]
            before = spec.entry_launches.get(route, 0)
            ok, err, _ = _agree(flash_attention(q, k, v, **kw).float(),
                                chunked_attention(q, k, v, **kw).float(), tl)
            print(f"flash_attention feature sample {kw} {dt} ({route}): "
                  f"max_abs_err {err:.3e} (tol {tl})", flush=True)
            if not ok:
                raise AssertionError(f"flash_attention disagrees at {kw} "
                                     f"in {dt}")
            if spec.entry_launches.get(route, 0) != before + 1:
                raise AssertionError(f"{dt} did not take {route}")
    q, k, v, kw, _ = spec.sample(device, gen)
    first, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v,
                                                                   **kw)
    if not torch.equal(first, again):
        raise AssertionError("flash_attention_bf16 is not bitwise "
                             "repeatable at the LM sample")
    print("flash_attention_bf16 at the LM sample: repeat bitwise identical",
          flush=True)
    for B, S, W, dtype, tol in LRU_CASES:
        la = (-0.1 * torch.randn((B, S, W), device=device,
                                 generator=gen).abs()).to(dtype)
        b = torch.randn((B, S, W), device=device, generator=gen).to(dtype)
        h0 = torch.randn((B, W), device=device, generator=gen).to(dtype)
        got = tuple(x.float() for x in rg_lru_scan(la, b, h0))
        want = tuple(x.float() for x in rg_lru_scan_plain(la, b, h0))
        ok, err, _ = _agree(got, want, tol)
        print(f"rg_lru feature sample {(B, S, W)} {dtype}: max_abs_err "
              f"{err:.3e} (tol {tol})", flush=True)
        if not ok:
            raise AssertionError(f"rg_lru disagrees at {(B, S, W)}")
    la, b, h0 = registry.get("rg_lru").sample(device, gen)
    first, again = rg_lru_scan(la, b, h0), rg_lru_scan(la, b, h0)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError("rg_lru is not bitwise repeatable at the "
                             "served shape")
    print(f"rg_lru at the served shape {tuple(b.shape)}: repeat bitwise "
          f"identical", flush=True)
    del la, b, h0, first, again
    phase_mlstm_features(device, gen)
    torch.cuda.synchronize()


def phase_mlstm_features(device, gen) -> None:
    """``mlstm`` against ``mlstm_chunkwise`` at the served shape from a
    zero and from a nonzero state, and at every feature case (zero and
    nonzero state, a ragged S) in float32 and in bf16, within its
    tolerance, each through the route of its dtype, with a bitwise
    repeat."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.mlstm import (FEATURE_CASES, gated_inputs,
                                           mlstm_chunkwise, mlstm_scan)
    from repro_torch.kernels.mlstm.ops import ROUTES, scratch_bytes
    spec = registry.get("mlstm")
    tol = spec.tol
    served = (1, registry.XLSTM_HEADS, registry.XLSTM_SEQ,
              registry.XLSTM_HEAD_DIM, registry.XLSTM_HEAD_DIM)
    cases = [(spec.sample(device, gen), 128, "served shape"),
             (gated_inputs(*served, nonzero_state=True, dtype=torch.bfloat16,
                           device=device, generator=gen), 128,
              "served shape nonzero state")]
    for B, H, S, dk, dv, chunk, nonzero in FEATURE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = gated_inputs(B, H, S, dk, dv, nonzero_state=nonzero,
                                dtype=dtype, device=device, generator=gen)
            cases.append((args, chunk, f"feature sample {(B, H, S, dk, dv)}"
                          f" chunk {chunk}"
                          f"{' nonzero state' if nonzero else ''} {dtype}"))
    print(f"mlstm scratch at the served shape {served}: "
          f"{scratch_bytes(*served)} bytes", flush=True)
    for args, chunk, label in cases:
        route = ROUTES[args[0].dtype]
        before = spec.entry_launches.get(route, 0)
        h, state = mlstm_scan(*args, chunk=chunk)
        if spec.entry_launches.get(route, 0) != before + 1:
            raise AssertionError(f"mlstm at the {label} did not take "
                                 f"{route}")
        h2, state2 = mlstm_scan(*args, chunk=chunk)
        want_h, want_state = mlstm_chunkwise(*args, chunk=chunk)
        got = tuple(x.float() for x in (h, *state))
        ok, err, _ = _agree(got, tuple(x.float() for x in (want_h,
                                                            *want_state)),
                            tol)
        bitwise = all(torch.equal(a, b) for a, b in zip((h, *state),
                                                        (h2, *state2)))
        print(f"mlstm {label} ({route}): max_abs_err {err:.3e} (tol "
              f"{tol}); repeat bitwise identical: {bitwise}", flush=True)
        if not ok:
            raise AssertionError(f"mlstm disagrees at the {label}")
        if not bitwise:
            raise AssertionError(f"mlstm is not bitwise repeatable at the "
                                 f"{label}")


def expected_launches(cg_log, frames, newton,
                      collective=False) -> dict[str, int]:
    """Launches of each kernel implied by the CG iterations that ran, on
    one rank (the same on every rank of a group).

    Per CG iteration: DG_fused (1 coil_lincomb, 1 plane_mult), DGH_fused
    (2 plane_mult, 1 coil_adjoint, 1 coil_forward, and, with a
    ``collective`` channel sum, 1 masked_sum), 2 cg_update and 2 xpby (one
    per leaf).  Per Newton step outside CG: G_fused (1 coil_scale_mult, 1
    plane_mult) and the rhs DGH_fused (2 plane_mult, 1 coil_adjoint, 1
    coil_forward, 1 masked_sum with ``collective``).  Per frame: y masked
    once.  A group without a process group sums no channels across
    ranks, so it launches no masked_sum."""
    steps = len(cg_log)
    if steps != frames * newton:
        raise AssertionError(f"{steps} CG solves logged, expected "
                             f"{frames * newton}")
    it = sum(cg_log)
    want = {"coil_forward": it + steps, "coil_lincomb": it,
            "coil_scale_mult": steps,
            "plane_mult": 3 * it + 3 * steps + frames,
            "coil_adjoint": it + steps, "cg_update": 2 * it, "xpby": 2 * it}
    if collective:
        want["masked_sum"] = it + steps
    return want


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


def phase_main_path(device, card, data) -> tuple[dict[str, int], dict]:
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
    return frame_counts, {"nrmse": e_nlinv, "frame_ms": s["frame_ms"],
                          "frame0": movie[0].clone()}


def _solve(device, data, frame, *, newton, cg_iters, impl="auto",
           comm=None):
    import torch
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    rec = Reconstructor(comm, device=device, newton=newton,
                        cg_iters=cg_iters, impl=impl)
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


def _timed(fn, times: list, launches: list, logits: list | None = None):
    """``fn`` with each call's CUDA-event time appended to ``times``, the
    launch counters' movement during the call to ``launches``, and a copy
    of its logits to ``logits``."""
    import torch
    from repro_torch.kernels import registry

    def call(*args, **kwargs):
        before = registry.launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        after = registry.launches()
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
        if logits is not None:
            logits.append(out[0][0].float().clone())
        return out
    return call


def _paths(plain: bool):
    """The kernel path, or every kernel's plain version (``plain``)."""
    import contextlib
    from repro_torch.kernels import registry
    return registry.plain() if plain else contextlib.nullcontext()


def _serve(cfg, params, prompts, max_new, device, plain: bool):
    """The requests through one Engine; returns (outputs in rid order,
    prefill ms, prefill launches, decode ms, decode launches, prefill
    logits, wall seconds)."""
    import torch
    from repro_torch.serve import Engine
    eng = Engine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN,
                 device=device)
    wl = eng.workload
    pf_ms, pf_launch, dec_ms, dec_launch, logits = [], [], [], [], []
    wl._prefill = _timed(wl._prefill, pf_ms, pf_launch, logits)
    wl._decode = _timed(wl._decode, dec_ms, dec_launch)
    t0 = time.perf_counter()
    with _paths(plain):
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new=m)
        done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [r.out for r in sorted(done, key=lambda r: r.rid)]
    return outs, pf_ms, pf_launch, dec_ms, dec_launch, logits, wall


def _prefill_logits(cfg, params, prompts, device, plain: bool) -> list:
    """Last-token logits of one prefill of each prompt."""
    import torch
    from repro_torch.serve import make_serve_steps
    prefill, _, init_cache = make_serve_steps(
        cfg, max_len=LM_MAX_LEN, batch=1, device=device)
    out = []
    with _paths(plain):
        for p in prompts:
            tok = torch.tensor([p], dtype=torch.int64, device=device)
            logits, _ = prefill(params, tok, init_cache())
            out.append(logits[0].float().clone())
    return out


def _slstm_share(cfg, params, prompt, device) -> tuple[list, float]:
    """One kernel-path prefill of ``prompt`` with CUDA events around it and
    around each sLSTM layer (forward hooks): (ms of each sLSTM layer, ms
    of the prefill).  The sLSTM loop keeps the card idle between its
    small launches, so its events measure the host's loop."""
    import torch
    from repro_torch.serve import make_serve_steps
    layers = [m for m in params.layers if m.kind == "slstm"]
    if not layers:
        return [], 0.0
    marks = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    hooks = [h for m in layers for h in (m.register_forward_pre_hook(mark),
                                         m.register_forward_hook(mark))]
    prefill, _, init_cache = make_serve_steps(
        cfg, max_len=LM_MAX_LEN, batch=1, device=device)
    tok = torch.tensor([prompt], dtype=torch.int64, device=device)
    cache = init_cache()
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prefill(params, tok, cache)
        end.record()
        end.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return ([a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])],
            start.elapsed_time(end))


def phase_lm(device, card, arch, prompts_len, max_new) -> dict[str, int]:
    """Serve ``arch`` at its published widths and depth through Engine;
    the LM phase (6) for recurrentgemma-2b and the xLSTM phase (7)."""
    import collections
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import ROUTES as ATTN_ROUTES
    from repro_torch.kernels.mlstm.ops import ROUTES as MLSTM_ROUTES
    from repro_torch.models import transformer
    # the kernels with a route per dtype: bf16 prefills take the tensor
    # cores, float32 ones the CUDA cores
    routed = {"flash_attention": ATTN_ROUTES, "mlstm": MLSTM_ROUTES}
    cfg = get_config(arch)
    kinds = [k for k, _ in transformer.unrolled_sigs(cfg)]
    per_prefill = dict(collections.Counter(KIND_KERNEL[k] for k in kinds
                                           if k in KIND_KERNEL))
    tag = "lm" if arch == LM_ARCH else "xlstm"
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    heads = (f"{cfg.n_heads} heads on {cfg.n_kv_heads} kv of dim {cfg.hd}"
             if any(k in ATTN for k in kinds) else
             f"{cfg.rnn_heads} mLSTM heads of dim "
             f"{int(cfg.d_model * cfg.proj_factor) // cfg.rnn_heads}")
    print(f"{tag}: {arch} {cfg.n_layers} layers "
          f"({dict(collections.Counter(kinds))}), d_model {cfg.d_model}, "
          f"{heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"window {cfg.window}, {cfg.compute_dtype}: {n_params} "
          f"parameters, {n_bytes / 1e9:.3f} GB on the card, random init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in prompts_len]
    # warm-up (cuBLAS, the allocator, module loading), outside the count
    t0 = time.perf_counter()
    _prefill_logits(cfg, params, prompts[:1], device, plain=False)
    torch.cuda.synchronize()
    print(f"{tag} warm-up prefill ({prompts_len[0]} tokens): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms of host time",
          flush=True)

    registry.reset_launches()
    outs, pf_ms, pf_launch, dec_ms, dec_launch, logits, wall = _serve(
        cfg, params, prompts, max_new, device, plain=False)
    counts = registry.launches()
    want = {k: 0 for k in counts}
    want.update({k: v * len(prompts) for k, v in per_prefill.items()})
    if counts != want:
        raise AssertionError(f"{tag} launch counts {counts} != {want}")
    if any(d != per_prefill for d in pf_launch):
        raise AssertionError(f"launches per prefill {pf_launch}")
    if any(dec_launch):
        raise AssertionError(f"decode steps launched kernels: {dec_launch}")
    for name, routes in routed.items():
        taken = dict(registry.get(name).entry_launches)
        if name in per_prefill and \
                taken != {routes[torch.bfloat16]: counts[name]}:
            raise AssertionError(f"bf16 prefills took the routes {taken}")
    if [len(o) for o in outs] != list(max_new):
        raise AssertionError(f"output lengths {[len(o) for o in outs]} != "
                             f"{list(max_new)}")
    for lg in logits:
        if lg.shape != (cfg.vocab,) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("prefill logits are not finite")
    n_tok = len(dec_ms)
    print(f"{tag} serve (kernel path): {len(prompts)} requests, prompts "
          f"{list(prompts_len)}, max_new {list(max_new)}, batch "
          f"{LM_BATCH} slots, max_len {LM_MAX_LEN}; wall {wall:.3f} s "
          f"[{card}]", flush=True)
    print(f"{tag} prefill ms per request (CUDA events): "
          f"{[round(t, 3) for t in pf_ms]} for prompts {list(prompts_len)}; "
          f"decode ms per token: mean {sum(dec_ms) / n_tok:.3f}, p50 "
          f"{sorted(dec_ms)[n_tok // 2]:.3f}, min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f} over {n_tok} steps [{card}]", flush=True)
    print(f"{tag} launches: {json.dumps(counts)}; per prefill "
          f"{json.dumps(pf_launch[0])}; decode steps launched none",
          flush=True)
    slstm_ms, total_ms = _slstm_share(cfg, params, prompts[0], device)
    if slstm_ms:
        print(f"{tag} sLSTM loop in a prefill of {prompts_len[0]} tokens "
              f"(CUDA events): layers {[round(t, 3) for t in slstm_ms]} ms, "
              f"{sum(slstm_ms):.3f} of {total_ms:.3f} ms, share "
              f"{sum(slstm_ms) / total_ms:.4f} [{card}]", flush=True)

    outs_p, pf_ms_p, pf_launch_p, dec_ms_p, _, logits_p, _ = _serve(
        cfg, params, prompts, max_new, device, plain=True)
    if any(pf_launch_p):
        raise AssertionError(f"the plain path launched kernels: "
                             f"{pf_launch_p}")
    print(f"{tag} plain path prefill ms: {[round(t, 3) for t in pf_ms_p]}; "
          f"decode ms per token mean {sum(dec_ms_p) / len(dec_ms_p):.3f} "
          f"[{card}]", flush=True)
    for i, (a, b) in enumerate(zip(outs, outs_p)):
        diff = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        print(f"{tag} request {i} (prompt {prompts_len[i]}): kernel tokens "
              f"{a}, plain tokens {b}, first difference at "
              f"{'none' if diff is None else diff}", flush=True)
    if all(len(set(o)) == 1 for o in outs + outs_p):
        # under this random init greedy decoding can repeat one token for
        # every request: then equal tokens test nothing, and only the
        # float32 and bf16 logits checks below hold the two paths
        print(f"{tag} greedy tokens: every request repeats one token on "
              f"both paths, so their agreement tests nothing here; the "
              f"logits checks below hold the paths", flush=True)

    # the same weights (the bf16 values) computing in float32: the
    # reference both bf16 paths are measured against, and the comparison
    # that sees the kernels rather than bf16's rounding
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32 = transformer.Transformer(cfg32, device="meta").to_empty(
        device=device)
    with torch.no_grad():
        for p32, p16 in zip(params32.parameters(), params.parameters()):
            p32.copy_(p16)
    del params
    torch.cuda.empty_cache()
    before = registry.launches()
    logits32 = _prefill_logits(cfg32, params32, prompts, device, plain=False)
    moved = {k: v - before[k] for k, v in registry.launches().items()
             if v != before[k]}
    if moved != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"float32 prefills launched {moved}")
    for name, routes in routed.items():
        taken = registry.get(name).entry_launches
        if name in per_prefill and \
                taken.get(routes[torch.float32], 0) != want[name]:
            raise AssertionError(f"float32 prefills took the routes {taken}")
    logits32_p = _prefill_logits(cfg32, params32, prompts, device, plain=True)
    rel32 = [_rel_l2(a, b) for a, b in zip(logits32, logits32_p)]
    rel16 = [_rel_l2(a, b) for a, b in zip(logits, logits_p)]
    err_k = [_rel_l2(a, b) for a, b in zip(logits, logits32_p)]
    err_p = [_rel_l2(a, b) for a, b in zip(logits_p, logits32_p)]
    print(f"{tag} float32 kernel vs plain path: last-token logits relative "
          f"L2 {[f'{r:.3e}' for r in rel32]} (limit {LM_PATH_TOL_F32})",
          flush=True)
    print(f"{tag} bf16 kernel vs plain path: {[f'{r:.3e}' for r in rel16]}; "
          f"each bf16 path against the float32 plain path: kernel "
          f"{[f'{r:.3e}' for r in err_k]}, plain "
          f"{[f'{r:.3e}' for r in err_p]} (limit: kernel <= "
          f"{LM_BF16_RATIO} x plain)", flush=True)
    if not all(r <= LM_PATH_TOL_F32 for r in rel32):
        raise AssertionError(f"{tag} kernel path drifts from plain in "
                             f"float32: {rel32}")
    if not all(k <= LM_BF16_RATIO * p for k, p in zip(err_k, err_p)):
        raise AssertionError(f"{tag} bf16 kernel path is further from "
                             f"float32 than the plain path: {err_k} vs "
                             f"{err_p}")
    del params32
    torch.cuda.empty_cache()
    return {k: counts[k] for k in per_prefill}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _blas_inputs(comm):
    """Full-width CG-state containers from one numpy seed, the same on
    every rank: x, y, z, w = {rho CLONE (768, 768), chat NATURAL (8, 768,
    768)}, and the scalars."""
    import numpy as np
    from repro_torch.core import Policy
    rng = np.random.default_rng(BLAS_SEED)
    g = 2 * N

    def c(*shape):
        return (rng.standard_normal(shape, np.float32) +
                1j * rng.standard_normal(shape, np.float32)).astype(
                    np.complex64)

    trees = {}
    for name in "xyzw":
        trees[name] = {"rho": comm.container(c(g, g), policy=Policy.CLONE),
                       "chat": comm.container(c(NCOILS, g, g))}
    return trees, 0.37, 0.61


def _blas_check(comm) -> dict:
    """The segmented BLAS on full-width containers against the plain
    computation on the gathered arrays; launches of ``xpby_dot`` (one a
    leaf) counted from 0."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.lib import blas
    trees, a, b = _blas_inputs(comm)
    full = {n: {k: v.gather() for k, v in t.items()}
            for n, t in trees.items()}
    x, y, z, w = (trees[n] for n in "xyzw")
    X, Y, Z, W = (full[n] for n in "xyzw")
    beta = torch.tensor(b, device=comm.device)
    registry.reset_launches()
    wv, d = blas.xpby_dot(x, y, beta)
    x2, r2, rs = blas.cg_update(a, x, y, z, w)
    wa, da = blas.axpy_dot(a, x, y, z)
    dar = blas.dot_allreduce(x["chat"], y["chat"])
    torch.cuda.synchronize()
    counts = registry.launches()

    def vd(u, v):
        return torch.vdot(u.reshape(-1), v.reshape(-1))

    keys = ("chat", "rho")
    want = {
        "xpby_dot": ({k: X[k] + b * Y[k] for k in keys},
                     sum(torch.real(vd(X[k] + b * Y[k], X[k] + b * Y[k]))
                         for k in keys)),
        "cg_update": ({k: Z[k] + a * X[k] for k in keys},
                      {k: W[k] - a * Y[k] for k in keys},
                      sum(torch.real(vd(W[k] - a * Y[k], W[k] - a * Y[k]))
                          for k in keys)),
        "axpy_dot": ({k: a * X[k] + Y[k] for k in keys},
                     sum(vd(Z[k], a * X[k] + Y[k]) for k in keys)),
        "dot_allreduce": (vd(X["chat"], Y["chat"]),)}
    got = {"xpby_dot": (wv, d), "cg_update": (x2, r2, rs),
           "axpy_dot": (wa, da), "dot_allreduce": (dar,)}
    tol = registry.get("xpby_dot").tol
    errs = {}
    for op, outs in got.items():
        pairs = []
        for g_, w_ in zip(outs, want[op]):
            if isinstance(g_, dict):
                pairs += [(g_[k].gather(), w_[k]) for k in keys]
            else:
                pairs.append((g_.reshape(1), torch.as_tensor(
                    w_, device=comm.device).reshape(1)))
        ok, err, rel = _agree(tuple(p[0] for p in pairs),
                              tuple(p[1] for p in pairs), tol)
        errs[op] = (ok, err, rel)
    return {"errs": errs, "launches": counts}


def dist_rank(env, data, shallow_only=False) -> dict:
    """One rank of phase 8: the 4-frame stream at full depth with its
    launch counts, the shallow frame, the segmented BLAS and a
    ``masked_sum`` repeat.  ``shallow_only`` runs frame 0 at full depth
    and nothing else (the 1-rank NCCL run).  Arrays come back as numpy
    (a tensor would reach the parent through a file descriptor that ends
    with the rank)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    comm = env.world
    out = {"rank": comm.rank, "size": comm.size, "backend": comm.backend,
           "transport": comm.group.p2p_transport, "device": str(comm.device)}
    if shallow_only:
        u, img = _solve(comm.device, data, 0, newton=NEWTON,
                        cg_iters=CG_ITERS, comm=comm)
        out.update(img=img.cpu().numpy(), rho=_digest(u["rho"]))
        return out
    rec = Reconstructor(comm, newton=NEWTON, cg_iters=CG_ITERS,
                        channel_sum="crop")
    stream = FrameStream(rec, damping=DAMPING)
    registry.reset_launches()
    movie, report = stream.run(data["y"], data["masks"], data["fov"])
    torch.cuda.synchronize()
    out["counts"] = registry.launches()
    out["cg_log"] = list(rec.cg_log)
    out["frame_ms"] = report.summary()["frame_ms"]
    out["devices"] = report.summary()["devices"]
    out["rho"] = _digest(stream.last_carry["u"]["rho"])
    out["movie"] = _digest(movie)
    out["finite"] = bool(torch.isfinite(movie).all())
    out["shape"] = tuple(movie.shape)
    out["nrmse"] = [nrmse(movie[f].cpu().numpy(), data["rho"][f],
                          data["fov"]) for f in range(FRAMES)]
    u, img = _solve(comm.device, data, 0, newton=SHALLOW_NEWTON,
                    cg_iters=SHALLOW_CG, comm=comm)
    out["shallow"] = img.cpu().numpy() if comm.rank == 0 else None
    out["shallow_rho"] = _digest(u["rho"])
    out["shallow_img"] = _digest(img)
    out["blas"] = _blas_check(comm)
    spec = registry.get("masked_sum")
    gen = torch.Generator(device=comm.device).manual_seed(11)
    p, m = spec.sample(comm.device, gen)
    first, again = spec.kernel(p, m), spec.kernel(p, m)
    torch.cuda.synchronize()
    out["masked_sum_repeat"] = bool(torch.equal(first, again))
    out["masked_sum_bits"] = _digest(first)
    return out


def phase_multirank(device, card, data, one_rank) -> dict[str, int]:
    """Phase 8: the multi-rank core on the card (see the module's
    docstring)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import Environment, run_ranks
    from repro_torch.kernels import registry
    frames = {k: data[k] for k in ("y", "masks", "fov", "rho", "grid")}
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_RANKS, backend="gloo",
                      shared_card=True, args=(frames,),
                      timeout=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"multi-rank: {DIST_RANKS} ranks, backend {r0['backend']} "
          f"(p2p {r0['transport']}), every rank on {r0['device']}; "
          f"{wall:.2f} s for the ranks' whole run, start-up included "
          f"[{card}]", flush=True)
    for key in ("cg_log", "rho", "movie", "shallow_rho", "shallow_img",
                "masked_sum_bits", "counts"):
        if any(r[key] != r0[key] for r in ranks[1:]):
            raise AssertionError(f"ranks disagree on {key}: "
                                 f"{[r[key] for r in ranks]}")
    if r0["shape"] != (FRAMES, data["grid"], data["grid"]) or \
            not all(r["finite"] for r in ranks) or r0["devices"] != DIST_RANKS:
        raise AssertionError(f"4-rank movie: shape {r0['shape']}, finite "
                             f"{[r['finite'] for r in ranks]}, devices "
                             f"{r0['devices']}")
    want = expected_launches(r0["cg_log"], FRAMES, NEWTON, collective=True)
    frame_counts = {k: r0["counts"][k] for k in want}
    stray = {k: v for k, v in r0["counts"].items() if k not in want and v}
    if frame_counts != want or stray:
        raise AssertionError(f"4-rank launch counts {r0['counts']} != "
                             f"expected {want}")
    print(f"multi-rank frame: cg iterations {r0['cg_log']} (the same on "
          f"every rank); rho, CG log and movie bitwise equal on all "
          f"{DIST_RANKS} ranks", flush=True)
    print(f"multi-rank launches (each rank): {json.dumps(frame_counts)}",
          flush=True)
    def steady(ms):
        return sum(ms[1:]) / max(len(ms) - 1, 1)

    print(f"multi-rank frame_ms per rank: "
          f"{[r['frame_ms'] for r in ranks]}; steady mean "
          f"{steady(r0['frame_ms']):.3f} ms/frame on 4 ranks against "
          f"{steady(one_rank['frame_ms']):.3f} on 1 rank (phase 3, "
          f"{one_rank['frame_ms']}) [{card}; gloo, host-staged, one shared "
          f"card]", flush=True)
    drift = [abs(a - b) for a, b in zip(r0["nrmse"], one_rank["nrmse"])]
    print(f"multi-rank full depth: NRMSE {[round(e, 5) for e in r0['nrmse']]}"
          f" against 1 rank's {[round(e, 5) for e in one_rank['nrmse']]} "
          f"(difference at most {max(drift):.2e}, limit "
          f"{DEPTH_NRMSE_TOL})", flush=True)
    if max(drift) > DEPTH_NRMSE_TOL:
        raise AssertionError(f"4-rank frames drift from 1 rank: {drift}")
    _, img1 = _solve(device, data, 0, newton=SHALLOW_NEWTON,
                     cg_iters=SHALLOW_CG)
    rel = _rel_l2(torch.from_numpy(r0["shallow"]).to(device), img1)
    print(f"multi-rank vs 1 rank (newton {SHALLOW_NEWTON}, cg {SHALLOW_CG}):"
          f" image relative L2 {rel:.3e} (limit {PATH_TOL})", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"4-rank frame drifts from 1 rank: {rel}")
    if not all(r["masked_sum_repeat"] for r in ranks):
        raise AssertionError("masked_sum is not bitwise repeatable")
    print("masked_sum: bitwise repeatable, the same bits on every rank",
          flush=True)
    blas_counts = r0["blas"]["launches"]
    for r in ranks:
        for op, (ok, err, rel_err) in r["blas"]["errs"].items():
            if not ok:
                raise AssertionError(f"rank {r['rank']}: blas.{op} "
                                     f"disagrees with the gathered plain "
                                     f"computation ({err})")
        if r["blas"]["launches"]["xpby_dot"] != 2 or \
                r["blas"]["launches"]["cg_update"] != 2:
            raise AssertionError(f"rank {r['rank']}: blas launches "
                                 f"{r['blas']['launches']}, expected one "
                                 f"xpby_dot and one cg_update a leaf")
    errs = {op: f"{e[1]:.3e}" for op, e in r0["blas"]["errs"].items()}
    print(f"segmented blas (rho CLONE {2 * N}x{2 * N}, chat NATURAL "
          f"{NCOILS}x{2 * N}x{2 * N}, {DIST_RANKS} ranks) against the "
          f"gathered plain computation: max abs err {errs} (tol "
          f"{registry.get('xpby_dot').tol}, relative 10x); launches on each "
          f"rank {json.dumps({k: v for k, v in blas_counts.items() if v})}",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        env = Environment(0, 1, store=dist.FileStore(f"{tmp}/store", 1),
                          backend="nccl", timeout=DIST_TIMEOUT_S)
        try:
            t0 = time.perf_counter()
            nccl = dist_rank(env, frames, shallow_only=True)
            nccl_ms = (time.perf_counter() - t0) * 1e3
        finally:
            env.close()
    img_nccl = torch.from_numpy(nccl["img"]).to(device)
    rel = _rel_l2(img_nccl, one_rank["frame0"])
    print(f"1-rank NCCL group: backend {nccl['backend']}, frame 0 at newton "
          f"{NEWTON} / cg {CG_ITERS} in {nccl_ms:.3f} ms (first call on the "
          f"group), image relative L2 {rel:.3e} from phase 3's frame 0 "
          f"(bitwise equal: {torch.equal(img_nccl, one_rank['frame0'])})"
          f" [{card}]", flush=True)
    if not rel <= PATH_TOL:
        raise AssertionError(f"1-rank NCCL frame drifts: {rel}")
    return {"masked_sum": frame_counts["masked_sum"],
            "xpby_dot": blas_counts["xpby_dot"]}


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
    phase_lm_features(device, card)

    t0 = time.perf_counter()
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=FRAMES, seed=0)
    print(f"dataset: {time.perf_counter() - t0:.2f} s on the host",
          flush=True)
    counts, one_rank = phase_main_path(device, card, data)
    phase_parity(device, card, data)
    counts.update(phase_radial(device, card, data))
    counts.update(phase_lm(device, card, LM_ARCH, LM_PROMPTS, LM_MAX_NEW))
    counts.update(phase_lm(device, card, XLSTM_ARCH, XLSTM_PROMPTS,
                           XLSTM_MAX_NEW))
    counts.update(phase_multirank(device, card, data, one_rank))
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
