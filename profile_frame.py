#!/usr/bin/env python3
"""Where one full-width NLINV frame of the PyTorch/CUDA port spends its
time, on one card.

    python3 profile_frame.py

At the main path's configuration (n = 384, grid 768, J = 8, 11 spokes,
newton 7, cg 30), after a warm-up frame:

1. wall time of one frame solve through the CUDA kernels (``impl="auto"``)
   and through their plain PyTorch versions (``impl="plain"``), in turns
   plain, kernel, kernel, plain, with the CG iterations each ran;
2. ``torch.profiler`` over ``PROFILED_FRAMES`` kernel-path frames, one
   profiler each: every frame's wall time and idle share (the device's
   busy time, the sum of the kernels' device time, against the wall
   time), and for the frame of median wall time the device time by
   kernel and by group (the port's CUDA kernels, cuFFT, PyTorch's
   elementwise and reduction kernels);
3. the radial path's frame at the same width (frame 0's 11 spokes of
   1536 samples, plan already built): ``RadialOps.forward`` of the coil
   images then ``gridding_recon_radial`` under ``torch.profiler``, broken
   down the same way, and each gridding kernel alone over 20 back-to-back
   calls: host wall time per call against the kernel's device time per
   launch.

4. the LM path's prefill: recurrentgemma-2b at its published widths
   (random weights, as ``chip_smoke.py`` serves it), one warm-up prefill
   of the 3072-token prompt, then one under ``torch.profiler``, split into
   flash attention, the RG-LRU scan, cuBLAS and PyTorch's elementwise
   kernels; then ``DECODE_STEPS`` decode steps unprofiled (wall ms each)
   and one under the profiler, split likewise, with its launches per
   layer and the unprofiled step's host µs per launch.  ``--arch`` and
   ``--prompt`` take another served arch (the frontend embeddings of
   ``chip_smoke.py`` for one with an encoder);
5. the same for xlstm-350m (the mLSTM kernel's two passes, cuBLAS,
   elementwise), and one sLSTM layer's prefill loop on its own under the
   profiler: the loop's device time, launches and idle share.

6. the multi-rank frame (``--part multirank`` only): four rank processes
   (gloo, all on the one card) run the same frame with 2 coils a rank,
   after a warm-up frame: one frame's wall time untouched; one with every
   collective timed on the host after a ``torch.cuda.synchronize()`` (so
   its time is the transport's alone, host-staged, apart from the card's
   queued work); and one under ``torch.profiler`` on rank 0, whose
   kernels' device time against the wall time gives that rank's idle
   share on the shared card.

7. the host side of a launch (``--part launch`` only): three wrappers
   (``coil_forward``, ``plane_mult``, ``xpby``) and their one-call
   PyTorch yardsticks, host µs per call at a size where the card outruns
   the host (J = 1 on an 8 x 8 grid), and CUDA-event and device time per
   call at the main path's shapes (``chip_smoke.py``'s timers); and the
   host µs of each route to the current stream's raw handle (the public
   ones, and PyTorch's private raw getter for comparison).  It calls the
   wrappers by their public signatures alone, so a copy of this file at
   the root of another commit's checkout measures that commit's
   wrappers: run the two in turns to compare them on one card.  Where the
   wrappers take a ``block`` (the launch shape a plan resolves and passes
   to every launch), the host µs a call are timed once more with the
   spec's default block passed, as the NLINV frame's plans pass theirs.

8. the NLINV service (``--part service`` only): 3 full-width clients
   through ``StreamScheduler(NlinvStreamWorkload(rec), buckets (1, 2,
   4))``, after a warm-up tick: one width-4 tick (3 clients and a padded
   row) and the same 4 rows solved one after another through the
   unbatched frame, each unprofiled (wall) and under ``torch.profiler``
   (busy ms, idle share, launches, and the host syncs: the runtime's
   synchronize calls the profiler records, beside the count the CG logs
   imply).

9. the frame's wall time alone (``--part frames`` only), for comparing
   two commits' checkouts in turns, as part 7: one rank runs
   ``STREAM_FRAMES`` frames of dataset seed 0 twice over (after the first,
   which builds the plans and sweeps), each timed on the host after a
   synchronize; then the 4-rank stream of ``chip_smoke.py``'s phase 8
   (``FrameStream`` over ``Reconstructor`` on four gloo rank processes
   sharing the card, ``channel_sum="crop"``), each frame's wall time on
   rank 0.  Only public entry points that both commits have are called.

    python3 profile_frame.py --part lm         # part 4 only
    python3 profile_frame.py --part lm --arch llama3.2-3b --prompt 2048
    python3 profile_frame.py --part xlstm      # part 5 only
    python3 profile_frame.py --part nlinv      # parts 1-3 only
    python3 profile_frame.py --part multirank  # part 6 only
    python3 profile_frame.py --part launch     # part 7 only
    python3 profile_frame.py --part service    # part 8 only
    python3 profile_frame.py --part frames     # part 9 only

Prints a summary, then the whole result as one JSON object on the last
line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, NCOILS, SPOKES, NEWTON, CG_ITERS = 384, 8, 11, 7, 30
RANKS = 4                # parts 6 and 9: ranks sharing the one card
STREAM_FRAMES = 4        # part 9: frames of the dataset
DAMPING = 0.9            # part 9: x_ref = DAMPING * u, frame to frame
RANKS_TIMEOUT_S = 300
FRAMES_PER_TURN = 2      # frames timed per arm in each turn of the A/B
# The profiler's host cost varies from frame to frame far more than the
# frame itself does, so one profiled frame does not give the idle share.
PROFILED_FRAMES = 5
PORT_KERNELS = ("coil_forward_kernel", "coil_forward_pairs_kernel",
                "coil_lincomb_kernel",
                "coil_scale_mult_kernel", "plane_mult_kernel",
                "coil_adjoint_kernel", "cg_update_kernel",
                "sum_partials_kernel", "xpby_kernel", "xpby_dot_kernel",
                "masked_sum_kernel", "degrid_kernel", "grid_adjoint_kernel")
REPS = 20                # back-to-back calls per gridding kernel
LM_ARCH, LM_PROMPT, LM_MAX_LEN = "recurrentgemma-2b", 3072, 4096
DECODE_STEPS = 8         # part 4: unprofiled decode steps timed
XLSTM_ARCH, XLSTM_PROMPT = "xlstm-350m", 3072
# the kernels of each LM scan: the mLSTM's tensor-core route (a state walk
# and the output pass, on wgmma) and its float32 route (three passes); the
# RG-LRU's chunk summaries and its chunks' walk
MLSTM_KERNELS = ("mlstm_state_walk_wgmma_kernel",
                 "mlstm_chunk_out_wgmma_kernel", "chunk_state_kernel",
                 "state_scan_kernel", "chunk_out_kernel")
RG_LRU_KERNELS = ("rg_lru_kernel",)


def _group(name: str) -> str:
    low = name.lower()
    if "flash_attention_bf16_kernel" in name or \
            "flash_attention_f32_kernel" in name:
        return "port CUDA kernel: flash attention"
    if any(k in name for k in RG_LRU_KERNELS):
        return "port CUDA kernel: RG-LRU scan"
    if any(k in name for k in MLSTM_KERNELS):
        return "port CUDA kernel: mLSTM"
    if any(k in name for k in PORT_KERNELS):
        return "port CUDA kernels"
    if "fft" in low:
        return "cuFFT"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "cuBLAS"
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
    launches = sum(count for _, count in by_kernel.values())
    groups = {}
    for name, (ms, count) in by_kernel.items():
        grp = groups.setdefault(_group(name), [0.0, 0])
        grp[0] += ms
        grp[1] += count
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    print(f"{label}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms if wall_ms else float('nan'):.4f}, "
          f"{launches} launches [{card}]", flush=True)
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  group {name}: {ms:.3f} ms device, {count} launches",
              flush=True)
    for name, (ms, count) in top:
        print(f"  {ms:9.3f} ms {count:6d}x  {name[:110]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "launches": launches,
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


def profile_lm(card, device="cuda", arch=LM_ARCH,
               prompt=LM_PROMPT) -> dict:
    """Parts 4 and 5: one profiled prefill of the longest served prompt
    and one profiled decode step of ``arch``; for xlstm-350m also one
    sLSTM layer's prefill loop alone."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import frontends, transformer
    from repro_torch.serve import make_serve_steps
    cfg = get_config(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    prefill, decode, init_cache = make_serve_steps(
        cfg, max_len=LM_MAX_LEN, batch=1, device=device)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, prompt)), device=device)
    enc = frontends.synthetic_frontend(cfg, 1, device=device)

    def run_prefill():
        cache = init_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, tok, cache, enc=enc)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, logits, cache

    run_prefill()                           # warm-up: cuBLAS, allocator
    walls = [run_prefill()[0] for _ in range(2)]
    print(f"{arch} prefill wall ({prompt} tokens, no profiler): "
          f"{[round(t, 3) for t in walls]} ms [{card}]", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, logits, cache = run_prefill()
    out = {"arch": arch, "prompt": prompt, "prefill_wall_ms": walls,
           "prefill": _breakdown(f"{arch} profiled prefill ({prompt} "
                                 f"tokens)", _device_times(prof), wall_ms,
                                 card)}
    nxt = logits.argmax(-1)[:, None]
    decode(params, nxt, cache, prompt)     # warm-up
    torch.cuda.synchronize()
    steps = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        decode(params, nxt, cache, prompt + 1 + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(params, nxt, cache, prompt + 1 + DECODE_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["decode"] = _breakdown(f"{arch} profiled decode step",
                               _device_times(prof), wall_ms, card)
    step_ms = sorted(steps)[len(steps) // 2]
    launches = out["decode"]["launches"]
    per_launch = step_ms * 1e3 / launches if launches else float("nan")
    out["decode"].update(
        unprofiled_ms=steps, layers=cfg.n_layers,
        launches_per_layer=launches / cfg.n_layers,
        host_us_per_launch=per_launch)
    print(f"{arch} decode step unprofiled: {[round(t, 3) for t in steps]} "
          f"ms; {launches} launches a step, "
          f"{launches / cfg.n_layers:.1f} a layer over {cfg.n_layers} "
          f"layers; median step {step_ms:.3f} ms, {per_launch:.2f} us a "
          f"launch [{card}]", flush=True)
    slstm = [m for m in params.layers if m.kind == "slstm"]
    if slstm:
        x = torch.randn((1, prompt, cfg.d_model), device=device,
                        generator=gen).to(cfg.cdtype)
        with torch.no_grad():
            slstm[0](x[:, :8], "prefill")      # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                slstm[0](x, "prefill")
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        out["slstm_layer"] = dict(_breakdown(
            f"{arch} one sLSTM layer's prefill loop ({prompt} steps; "
            f"{len(slstm)} such layers a prefill)", _device_times(prof),
            wall_ms, card), layers=len(slstm))
    return out


def _timed_collectives(log: list):
    """Wrap ``torch.distributed``'s collectives so that each call first
    waits for the card's queued work and then logs ``(name, seconds)`` of
    the call itself.  Returns the undo function."""
    import torch
    import torch.distributed as dist
    names = ("all_gather", "all_reduce", "broadcast")
    saved = {n: getattr(dist, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((name, time.perf_counter() - t0))
            return out
        return call

    for n in names:
        setattr(dist, n, wrap(n, saved[n]))
    return lambda: [setattr(dist, n, f) for n, f in saved.items()]


def multirank_rank(env, data) -> dict:
    """One rank of part 6 (see the module's docstring); numbers only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    comm = env.world
    g = data["grid"]
    rec = Reconstructor(comm, newton=NEWTON, cg_iters=CG_ITERS)
    inputs = (rec.put_frame(data["y"][0]), rec.put_const(data["masks"][0]),
              rec.put_const(data["fov"]), rec.put_const(sobolev_weight(g)))

    def frame():
        u0 = rec.init_carry(NCOILS, g)
        x_ref = {k: v.clone() for k, v in u0.items()}
        torch.cuda.synchronize()
        rec.cg_log.clear()
        t0 = time.perf_counter()
        rec(*inputs, u0, x_ref)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    frame()                                  # warm-up
    out = {"rank": comm.rank, "backend": comm.backend,
           "wall_ms": frame(), "cg_iterations": sum(rec.cg_log)}
    log: list = []
    undo = _timed_collectives(log)
    try:
        out["timed_wall_ms"] = frame()
    finally:
        undo()
    out["collectives"] = {n: {"calls": sum(1 for k, _ in log if k == n),
                              "ms": sum(t for k, t in log if k == n) * 1e3}
                          for n in {k for k, _ in log}}
    if comm.rank == 0:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = frame()
        by_kernel = _device_times(prof)
        out["profiled"] = {"wall_ms": wall, "by_kernel": by_kernel}
    else:
        frame()
    return out


def profile_multirank(data, card) -> dict:
    from repro_torch.core import run_ranks
    ranks = run_ranks(multirank_rank, RANKS, backend="gloo",
                      shared_card=True, args=(data,),
                      timeout=RANKS_TIMEOUT_S)
    r0 = ranks[0]
    print(f"multi-rank frame ({RANKS} ranks, {r0['backend']}, one shared "
          f"card, 2 coils a rank): wall {[round(r['wall_ms'], 3) for r in ranks]}"
          f" ms, cg iterations {r0['cg_iterations']} [{card}]", flush=True)
    for r in ranks:
        total = sum(c["ms"] for c in r["collectives"].values())
        print(f"  rank {r['rank']}: collectives timed alone "
              f"{json.dumps({k: {'calls': v['calls'], 'ms': round(v['ms'], 3)} for k, v in sorted(r['collectives'].items())})}"
              f", {total:.3f} ms of the frame's {r['timed_wall_ms']:.3f} ms "
              f"({total / r['timed_wall_ms']:.4f})", flush=True)
    prof = r0["profiled"]
    rank0 = _breakdown("rank 0's frame under the profiler",
                       prof["by_kernel"], prof["wall_ms"], card)
    return {"ranks": [{k: v for k, v in r.items() if k != "profiled"}
                      for r in ranks], "rank0_profiled": rank0}


LAUNCH_CALLS = 2000      # part 7: calls timed on the host per wrapper
LAUNCH_REPS = 100        # part 7: back-to-back calls under CUDA events


def profile_launch(card, device="cuda") -> dict:
    """Part 7: each wrapper's host µs per call (a tiny size; with the
    block a plan passes too, where the wrappers take one), and its events
    and device ms per call at the main path's shapes, beside its
    yardstick's; then the host µs of each route to the current stream."""
    import inspect

    import torch

    from chip_smoke import device_ms, time_ms
    from repro_torch.kernels.cg_fused import xpby_dot
    from repro_torch.kernels.coil_mult import coil_forward, plane_mult
    takes_block = "block" in inspect.signature(plane_mult).parameters
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def inputs(ncoils, grid):
        def c(*shape):
            return torch.randn(shape, dtype=torch.complex64, device=dev,
                               generator=gen)
        stack, plane = c(ncoils, grid, grid), c(grid, grid)
        real = torch.rand((grid, grid), device=dev, generator=gen)
        # beta on the card, as the CG loop keeps it (a Python float would
        # time a host-to-device copy a call)
        beta = torch.tensor(0.61, device=dev)
        return {"coil_forward": ((lambda s, p: coil_forward(s, p)),
                                 (lambda s, p: torch.mul(s, p)),
                                 (stack, plane)),
                "plane_mult": ((lambda s, m: plane_mult(s, m)),
                               (lambda s, m: torch.mul(s, m)),
                               (stack, real)),
                "xpby": ((lambda x, y: xpby_dot(x, y, beta,
                                                with_dot=False)[0]),
                         (lambda x, y: torch.add(x, y, alpha=0.61)),
                         (stack, c(ncoils, grid, grid)))}

    def host_us(fn, args=()):
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCH_CALLS):
            fn(*args)
        us = (time.perf_counter() - t0) / LAUNCH_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    def with_block(name, args):
        """The wrapper called with its spec's default block passed."""
        from repro_torch.kernels import registry
        blk = registry.get(name).default_block
        if name == "coil_forward":
            return host_us(lambda s, p: coil_forward(s, p, block=blk), args)
        if name == "plane_mult":
            return host_us(lambda s, m: plane_mult(s, m, block=blk), args)
        beta = torch.tensor(0.61, device=dev)
        return host_us(lambda x, y: xpby_dot(x, y, beta, with_dot=False,
                                             block=blk)[0], args)

    out = {}
    tiny, full = inputs(1, 8), inputs(NCOILS, 2 * N)
    for name, (kernel, library, args) in tiny.items():
        _, _, big = full[name]
        row = {"host_us": host_us(kernel, args),
               "host_us_block": (with_block(name, args) if takes_block
                                 else None),
               "library_host_us": host_us(library, args),
               "events_ms": time_ms(kernel, big, LAUNCH_REPS),
               "library_events_ms": time_ms(library, big, LAUNCH_REPS),
               "device_ms": device_ms(kernel, big, LAUNCH_REPS)[0],
               "library_device_ms": device_ms(library, big,
                                              LAUNCH_REPS)[0]}
        out[name] = row
        ms = {k: "n/a" if v is None else f"{v:.4f}" for k, v in row.items()}
        blk = "n/a" if row["host_us_block"] is None else \
            f"{row['host_us_block']:.3f}"
        print(f"launch {name}: host {row['host_us']:.3f} us a call, "
              f"{blk} with the block passed "
              f"(yardstick {row['library_host_us']:.3f}); at the main "
              f"shape events {ms['events_ms']} ms, device "
              f"{ms['device_ms']} (yardstick {ms['library_events_ms']}, "
              f"device {ms['library_device_ms']}) [{card}]", flush=True)
    idx = torch.cuda.current_device()
    routes = {
        "current_stream(device)": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "current_stream(index)": lambda: torch.cuda.current_stream(
            idx).cuda_stream,
        "current_stream()": lambda: torch.cuda.current_stream().cuda_stream,
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        routes["_cuda_getCurrentRawStream (private)"] = lambda: raw(idx)
    out["stream_routes_us"] = {k: host_us(fn) for k, fn in routes.items()}
    print(f"current stream, host us a call: "
          f"{json.dumps(out['stream_routes_us'])} [{card}]", flush=True)
    return out


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _host_syncs(prof) -> int:
    """The host's waits on the card that the profiler recorded: the CUDA
    runtime's synchronize calls (``bool``/``item`` of a device tensor, an
    event's ``synchronize``)."""
    return sum(evt.count for evt in prof.key_averages()
               if evt.key in SYNC_CALLS)


def _implied_syncs(cg_log, cg_iters, per_solve=0, per_run=0) -> int:
    """Host syncs the CG logs imply: a stop test each iteration and one
    more where a solve stopped before ``cg_iters`` (each batched solve
    also reads its row counts back, ``per_solve``), plus ``per_run``."""
    n = 0
    for c in cg_log:
        it = max(c) if isinstance(c, tuple) else c
        n += it + (it < cg_iters) + per_solve
    return n + per_run


def profile_service(card, device="cuda") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    datas = [phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                  frames=3, seed=s) for s in range(3)]
    g = datas[0]["grid"]
    rec = Reconstructor(device=device, newton=NEWTON, cg_iters=CG_ITERS)
    sched = StreamScheduler(NlinvStreamWorkload(rec),
                            ServeConfig(buckets=(1, 2, 4)))
    ss = [sched.open(client=f"c{k}", grid=g, ncoils=NCOILS, fov=d["fov"])
          for k, d in enumerate(datas)]

    def tick(f):
        """Frame f of every client submitted (uploaded); the job runs the
        tick."""
        for s, d in zip(ss, datas):
            sched.submit(s, (d["y"][f], d["masks"][f]))
        return sched.tick

    # the 4 rows of a width-4 tick (3 clients and the padded repeat of the
    # last) one after another through the unbatched frame
    fov, w = rec.put_const(datas[0]["fov"]), rec.put_const(sobolev_weight(g))
    inputs = [(rec.put_frame(datas[k]["y"][1]),
               rec.put_const(datas[k]["masks"][1])) for k in (0, 1, 2, 2)]

    def sequential():
        for y, m in inputs:
            u0 = rec.init_carry(NCOILS, g)
            rec.fn_donate_carry(y, m, fov, w, u0,
                                {k: v.clone() for k, v in u0.items()})
            torch.cuda.current_stream().synchronize()

    def measure(job, profiled):
        torch.cuda.synchronize()
        rec.cg_log.clear()
        if not profiled:
            t0 = time.perf_counter()
            job()
            return (time.perf_counter() - t0) * 1e3, None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            job()
            wall = (time.perf_counter() - t0) * 1e3
        return wall, prof

    measure(tick(0), False)                 # warm-up: plans, allocator
    measure(sequential, False)
    out = {}
    # host syncs besides the CG loops': a batched solve reads its rows'
    # counts back; a tick checks health and fences once; each sequential
    # frame synchronizes once
    for label, jobs, per_solve, per_run in (
            ("tick", (tick(1), tick(2)), 1, 2),
            ("sequential", (sequential, sequential), 0, len(inputs))):
        wall, _ = measure(jobs[0], False)
        log = list(rec.cg_log)
        pwall, prof = measure(jobs[1], True)
        plog = list(rec.cg_log)
        res = _breakdown(f"service {label} (width 4 / 4 frames)",
                         _device_times(prof), pwall, card)
        syncs = _host_syncs(prof)
        implied = _implied_syncs(plog, CG_ITERS, per_solve, per_run)
        print(f"service {label}: unprofiled wall {wall:.3f} ms (cg "
              f"iterations {log}); profiled: host syncs {syncs} recorded, "
              f"{implied} implied by the CG logs {plog} [{card}]",
              flush=True)
        out[label] = dict(res, unprofiled_wall_ms=wall, host_syncs=syncs,
                          implied_host_syncs=implied, cg_log=plog,
                          idle_share=1 - res["device_busy_ms"] / pwall)
    return out


def frames_rank(env, data) -> dict:
    """One rank of part 9: phase 8's stream, each frame's wall ms."""
    import torch
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    rec = Reconstructor(env.world, newton=NEWTON, cg_iters=CG_ITERS,
                        channel_sum="crop")
    _, report = FrameStream(rec, damping=DAMPING).run(
        data["y"], data["masks"], data["fov"])
    torch.cuda.synchronize()
    return {"frame_ms": report.summary()["frame_ms"],
            "cg_log": list(rec.cg_log)}


def profile_frames(card) -> dict:
    """Part 9: one rank's steady ms a frame, then the 4-rank stream's."""
    import torch

    from repro_torch.core import run_ranks
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=STREAM_FRAMES, seed=0)
    rec = Reconstructor(newton=NEWTON, cg_iters=CG_ITERS)
    g = data["grid"]
    fov, w = rec.put_const(data["fov"]), rec.put_const(sobolev_weight(g))
    u = rec.init_carry(NCOILS, g)
    x_ref, one = u, []
    for f in list(range(STREAM_FRAMES)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, _ = rec(rec.put_frame(data["y"][f]),
                   rec.put_const(data["masks"][f]), fov, w, u, x_ref)
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t0) * 1e3)
        x_ref = {k: DAMPING * v for k, v in u.items()}
    frames = {k: data[k] for k in ("y", "masks", "fov", "grid")}
    ranks = run_ranks(frames_rank, RANKS, backend="gloo", shared_card=True,
                      args=(frames,), timeout=RANKS_TIMEOUT_S)
    four = ranks[0]["frame_ms"]
    out = {"one_rank_frame_ms": one,
           "one_rank_steady_ms": sum(one[1:]) / (len(one) - 1),
           "ranks_frame_ms": four,
           "ranks_steady_ms": sum(four[1:]) / (len(four) - 1),
           "ranks_cg_alike": all(r["cg_log"] == ranks[0]["cg_log"]
                                 for r in ranks)}
    print(f"frames: one rank {[round(t, 3) for t in one]} ms (steady mean "
          f"{out['one_rank_steady_ms']:.3f}); {RANKS} gloo ranks on the card,"
          f" rank 0 {[round(t, 3) for t in four]} ms (steady mean "
          f"{out['ranks_steady_ms']:.3f}) [{card}]", flush=True)
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("all", "nlinv", "lm", "xlstm",
                                       "multirank", "launch", "service",
                                       "frames"),
                    default="all")
    ap.add_argument("--arch", default=LM_ARCH,
                    help="the arch of --part lm")
    ap.add_argument("--prompt", type=int, default=LM_PROMPT,
                    help="the prompt length of --part lm")
    args = ap.parse_args()
    part = args.part
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
    if part == "lm":
        print(json.dumps({"card": card, "lm": profile_lm(
            card, arch=args.arch, prompt=args.prompt)}), flush=True)
        return 0
    if part == "launch":
        print(json.dumps({"card": card, "launch": profile_launch(card)}),
              flush=True)
        return 0
    if part == "service":
        print(json.dumps({"card": card, "service": profile_service(card)}),
              flush=True)
        return 0
    if part == "frames":
        print(json.dumps({"card": card, "frames": profile_frames(card)}),
              flush=True)
        return 0
    if part == "xlstm":
        print(json.dumps({"card": card, "xlstm": profile_lm(
            card, arch=XLSTM_ARCH, prompt=XLSTM_PROMPT)}), flush=True)
        return 0
    data = phantom.make_dataset(n=N, ncoils=NCOILS, nspokes=SPOKES,
                                frames=1, seed=0)
    g = data["grid"]
    if part == "multirank":
        frames = {k: data[k] for k in ("y", "masks", "fov", "grid")}
        print(json.dumps({"card": card,
                          "multirank": profile_multirank(frames, card)}),
              flush=True)
        return 0

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
    runs = []
    for _ in range(PROFILED_FRAMES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms, it = frame(rec, inputs)
        by_kernel = _device_times(prof)
        runs.append((wall_ms, sum(ms for ms, _ in by_kernel.values()),
                     by_kernel))
    walls = [round(w, 3) for w, _, _ in runs]
    idle = [round(1 - b / w, 4) for w, b, _ in runs]
    print(f"profiled frames (cg iterations {it}): wall {walls} ms, idle "
          f"share {idle} [{card}]", flush=True)
    wall_ms, _, by_kernel = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    profiled = _breakdown("profiled frame of median wall", by_kernel,
                          wall_ms, card)
    profiled.update(walls_ms=walls, idle_shares=idle)

    out = {"card": card, "config": {"n": N, "grid": g, "ncoils": NCOILS,
                                    "spokes": SPOKES, "newton": NEWTON,
                                    "cg_iters": CG_ITERS},
           "frame_wall_ms": ab, "cg_iterations": iters,
           "profiled": dict(profiled, cg_iterations=it),
           "radial": profile_radial(data, card)}
    if part == "all":
        out["lm"] = profile_lm(card)
        out["xlstm"] = profile_lm(card, arch=XLSTM_ARCH, prompt=XLSTM_PROMPT)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
