"""Per-architecture LM step benchmarks (SMOKE configs): one train step
and one decode step for every assigned arch, on one rank.

These are paper-size only and opt-in (``--only lm`` or ``--only all``):
they build every architecture and are far heavier than the
paper-figure scenarios.  The train step's attention, mLSTM and RG-LRU
layers launch their CUDA kernels (the kernel forward through
``registry.differentiable``); a decode step runs without autograd.  The
derived column carries the single-pod roofline bound from the port's
own dry-run records (``python -m repro_torch.launch.dryrun``, the
(32, 8) H100 mesh) when present.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

from ..registry import scenario

# where ``python -m repro_torch.launch.dryrun`` writes by default
RESULTS = pathlib.Path(__file__).resolve().parents[4] / "results" / \
    "dryrun_torch"


def _derived(arch: str, shape: str) -> str:
    from ...launch.dryrun import MESH_NAMES
    fn = RESULTS / f"{arch}__{shape}__{MESH_NAMES[False]}.json"
    if not fn.exists():
        return "dryrun=pending"
    d = json.loads(fn.read_text())
    if "skipped" in d:
        return "skipped"
    r = d["roofline"]
    return (f"bound={r['dominant']};step_bound_ms="
            f"{r['step_time_bound_s'] * 1e3:.1f}")


def _steps(ctx, mode: str) -> dict:
    # heavy imports stay inside the scenario: registering "lm" must not
    # pull the model zoo into every bench child
    import numpy as np
    import torch

    from ...configs import ARCH_IDS, get_smoke
    from ...models import frontends, transformer
    from ...train import make_train_state, make_train_step

    dev = ctx.device
    per_arch, steady = {}, []
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        state = make_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        tok = torch.randint(0, cfg.vocab, (2, 32), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
        enc = frontends.synthetic_frontend(cfg, 2, device=dev)
        if mode == "train":
            step_fn = make_train_step(cfg, remat=False)
            t = ctx.measure(step_fn, state, tok, tok, enc)
            shape = "train_4k"
        else:
            params = state["params"]
            with torch.no_grad():
                cache = transformer.init_cache(cfg, 2, 64, cfg.cdtype,
                                               device=dev)
                _, cache, _ = transformer.apply(cfg, params, tok[:, :16],
                                                enc=enc, mode="prefill",
                                                pos=0, cache=cache)

            @torch.no_grad()
            def dec(p, c, t, pos):
                lg, c2, _ = transformer.apply(cfg, p, t, mode="decode",
                                              pos=pos, cache=c)
                return lg, c2

            t = ctx.measure(dec, params, cache, tok[:, :1], 16)
            shape = "decode_32k"
        per_arch[arch] = {"steady_ms": t.steady_ms,
                          "compile_ms": t.compile_ms,
                          "derived": _derived(arch, shape)}
        steady.append(t.steady_ms)
    return {"wall_ms": round(float(sum(steady)), 3),
            "compile_ms": round(max(a["compile_ms"] for a in
                                    per_arch.values()), 3),
            "steady_ms": round(float(np.median(steady)), 3),
            "extra": {"mode": mode, "per_arch": per_arch}}


@scenario("lm", "train_step", sizes=("paper",), devices=(1,))
def train_step(ctx):
    """One train step per assigned architecture (median steady state)."""
    return _steps(ctx, "train")


@scenario("lm", "decode_step", sizes=("paper",), devices=(1,))
def decode_step(ctx):
    """One decode step per assigned architecture (median steady state)."""
    return _steps(ctx, "decode")
