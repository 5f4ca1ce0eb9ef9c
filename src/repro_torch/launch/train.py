"""Training launcher, the port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 6 --ckpt-dir /tmp/ckpt

Runs on the card unless ``--device cpu`` (or a caller's
``main(..., device="cpu")``) asks otherwise.  The loop is the JAX
package's: the ``TokenPipeline`` batch of each step, ``make_train_state``
then ``make_train_step`` (``remat=False``), the straggler watchdog,
periodic async checkpoints and the preemption flush, resume from the
latest checkpoint, the whole inside ``run_with_restarts``.  ``--mesh``
takes one rank: the JAX launcher also runs its step without shardings,
and a larger mesh waits for the sharded train step (ROADMAP Queue 1,
item 3; tensor-parallel serving is in: ``make_serve_steps(mesh=)``).
``--layers`` (not in the JAX launcher) cuts the depth, for a full-width
run whose checkpoints stay small.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from ..ckpt import latest_step, restore_sharded, save
from ..configs import ARCH_IDS, get_config, get_smoke
from ..data import TokenPipeline
from ..device import resolve_device
from ..ft import (PreemptionGuard, RestartPolicy, StragglerWatchdog,
                  run_with_restarts)
from ..train import make_train_state, make_train_step


def build(args):
    """The config of ``--arch`` (``--smoke``: the reduced one) in
    ``--dtype``, cut to ``--layers`` when given; raises for a mesh of more
    than one rank."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else (1,)
    if math.prod(shape) != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one rank; the sharded "
            f"train step waits (ROADMAP Queue 1, item 3)")
    return cfg


def _load(state, tree) -> None:
    """Copy a restored tree (``restore_sharded``'s) into the train state
    in place."""
    state["params"].load_state_dict(tree["params"])
    opt = state["opt"]
    with torch.no_grad():
        for k in ("m", "v"):
            for name, t in tree["opt"][k].items():
                opt[k][name].copy_(t)
        opt["step"].copy_(tree["opt"]["step"])


def main(argv=None, *, device=None, step_hook=None):
    """Parse ``argv`` and train.  ``device`` overrides ``--device``;
    ``step_hook(step, metrics)``, when given, runs after each step (a
    raise there is a failed step, which the restart envelope catches).
    Returns ``{"step", "losses", "step_s", "state", "resumed"}``: the final
    step, each step's loss and seconds (a step redone after a restart
    keeps its last run's), the final train state and the steps that the
    loop resumed from."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="", help="one rank: 1 (or 1x1)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers, widths and vocab kept "
                         "(0: the config's own)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)

    cfg = build(args)
    dev = resolve_device(args.device if device is None else device)
    step_fn = make_train_step(
        cfg, base_lr=args.lr, warmup=min(20, args.steps // 10 + 1),
        total=args.steps, microbatches=args.microbatches, remat=False)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)
    watchdog = StragglerWatchdog()
    out = {"step": 0, "losses": {}, "step_s": {}, "state": None,
           "resumed": []}
    pending = []                        # the async save in flight

    def join():
        while pending:
            pending.pop().join()

    def train_loop(_start):
        join()
        out["state"] = None             # a failed entry's state goes
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        state = make_train_state(cfg, gen, device=dev)
        start = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            tree, start = restore_sharded(args.ckpt_dir, state, dev)
            _load(state, tree)
            del tree
            out["resumed"].append(start)
            print(f"resumed from step {start}", flush=True)
        out["state"] = state
        for step in range(start, args.steps):
            t0 = time.time()
            tok, lab = pipe.batch_at(step)
            state, metrics = step_fn(state, torch.from_numpy(tok).to(dev),
                                     torch.from_numpy(lab).to(dev))
            loss = float(metrics["loss"])
            dt = time.time() - t0
            out["losses"][step] = loss
            out["step_s"][step] = dt
            if watchdog.record(dt):
                print(f"[straggler] step {step}: {dt:.2f}s "
                      f"(median {watchdog.median:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                join()
                pending.append(save(args.ckpt_dir, step + 1, state,
                                    blocking=False))
            if args.ckpt_dir and guard.maybe_flush(args.ckpt_dir, step + 1,
                                                   state):
                join()
                print("preempted: checkpoint flushed", flush=True)
                out["step"] = step + 1
                return step + 1
            if step % args.log_every == 0 or step == args.steps - 1:
                tput = args.batch * args.seq / dt
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{tput:,.0f} tok/s", flush=True)
            if step_hook is not None:
                step_hook(step, metrics)
        join()
        if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps:
            save(args.ckpt_dir, args.steps, state, blocking=True)
        if out["losses"]:
            print(f"final loss {out['losses'][args.steps - 1]:.4f} (start "
                  f"{out['losses'][min(out['losses'])]:.4f})", flush=True)
        out["step"] = args.steps
        return args.steps

    guard = PreemptionGuard()
    try:
        run_with_restarts(train_loop, policy=RestartPolicy(max_restarts=3))
    finally:
        join()
        guard.close()
    return out


if __name__ == "__main__":
    main()
