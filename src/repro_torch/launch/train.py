"""Training launcher, the port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 6 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --mesh 1x4 --layers 8 --steps 20

Runs on the card unless ``--device cpu`` (or a caller's
``main(..., device="cpu")``) asks otherwise.  The loop is the JAX
package's: the ``TokenPipeline`` batch of each step, ``make_train_state``
then ``make_train_step`` (``remat=False``), the straggler watchdog,
periodic async checkpoints and the preemption flush, resume from the
latest checkpoint, the whole inside ``run_with_restarts``.

``--mesh DxM`` (``("data", "model")``; ``N`` is ``("data",)``): a mesh of
more than one rank starts its rank processes with ``core.run_ranks``, one
card each over NCCL, or, where the host has fewer cards than ranks, every
rank on the one card over gloo (the launcher says so); on the CPU, gloo.
Each rank draws the step's global batch (``TokenPipeline`` of one host,
as the JAX launcher on one host with several devices), makes its shards
(``make_train_state(mesh=)``, bitwise the whole init's slices) and runs
the sharded step on its rows.  Checkpoints stay group-agnostic: rank 0
writes every leaf of the state whole, gathered over the mesh, and a
resume reads it whole and keeps this rank's slice, so a run saved on
(2, 2) resumes on (1, 4) or on one rank.  A mesh that pads an MoE
config's experts (``launch.mesh.expert_pad_for``) writes the first
``n_experts`` experts and router columns, the JAX launcher's layout (it
never pads), and a resume pads them again as ``moe.init(pad_to=)`` lays
them out, the padded slots kept as the fresh init holds them.  Each
rank runs its loop inside its own restart envelope; a step hook runs on
every rank (a raise on one rank alone leaves the others waiting in a
collective until the ranks' timeout).  ``--mesh 1`` (the default) is one rank in this process.
``--layers`` (not in the JAX launcher) cuts the depth, for a full-width
run whose checkpoints stay small.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from ..ckpt import latest_step, restore, save
from ..configs import ARCH_IDS, get_config, get_smoke
from ..data import TokenPipeline
from ..device import resolve_device
from ..ft import (PreemptionGuard, RestartPolicy, StragglerWatchdog,
                  run_with_restarts)
from ..train import make_train_state, make_train_step, state_shardings

AXES = ("data", "model")


def build(args):
    """The config of ``--arch`` (``--smoke``: the reduced one) in
    ``--dtype``, cut to ``--layers`` when given, and the mesh's shape and
    axes from ``--mesh``."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh \
        else (1,)
    if len(shape) > len(AXES):
        raise ValueError(f"--mesh {args.mesh}: at most {len(AXES)} axes")
    return cfg, shape, AXES[:len(shape)]


def _expert_dim(name: str) -> int | None:
    """The expert dim of an MoE leaf as ``moe.init`` lays it out (the
    stacked experts' rows, the router's columns); None for other leaves."""
    if ".moe.experts." in name:
        return 0
    return 1 if name.endswith(".moe.router") else None


def _load(state, host, specs=None, group=None) -> None:
    """Copy a restored host tree (``ckpt.restore``'s, every leaf whole)
    into the train state in place: each leaf whole, or on a mesh
    (``group``) this rank's slice of it by ``specs`` (``state_shardings``'s
    ``"params"``, which ``m`` and ``v`` share).  An MoE leaf holds
    ``n_experts`` experts; where the state pads them, its padded slots
    keep what the fresh init put there."""
    from ..models.sharding import local_slices
    model, opt = state["params"], state["opt"]
    pad = model.expert_pad
    with torch.no_grad():
        for name, p in model.named_parameters():
            shape = list(host["params"][name].shape)
            d = _expert_dim(name)
            if d is not None:
                shape[d] = -(-shape[d] // pad) * pad
            cut = tuple(slice(0, n) for n in shape) if group is None \
                else local_slices(tuple(shape), specs[name], group)
            if d is not None:
                # the real experts of this rank's slice, from its start
                lo = cut[d].start
                keep = max(0, min(cut[d].stop, model.cfg.n_experts) - lo)
                cut = cut[:d] + (slice(lo, lo + keep),) + cut[d + 1:]
            for t, leaf in ((p, host["params"][name]),
                            (opt["m"][name], host["opt"]["m"][name]),
                            (opt["v"][name], host["opt"]["v"][name])):
                part = torch.from_numpy(np.array(leaf[cut]))
                dst = t if d is None else t.narrow(d, 0, part.shape[d])
                dst.copy_(part)
        opt["step"].copy_(torch.from_numpy(np.array(host["opt"]["step"])))


def _whole(state, specs, comm):
    """The train state's leaves whole, gathered over the mesh leaf by
    leaf by ``specs`` (every rank takes part), as host arrays on rank 0
    (None elsewhere), in the tree layout a one-rank run saves: an MoE
    leaf's first ``n_experts`` experts, the padded ones left out."""
    from ..models.sharding import whole
    rank0 = comm.rank == 0
    n_experts = state["params"].cfg.n_experts
    out = {"params": {}, "opt": {"m": {}, "v": {}}}
    for name, p in state["params"].named_parameters():
        d = _expert_dim(name)
        for key, t in (("params", p), ("m", state["opt"]["m"][name]),
                       ("v", state["opt"]["v"][name])):
            w = whole(t.detach(), specs[name], comm)
            if d is not None:
                w = w.narrow(d, 0, n_experts)
            if rank0:
                (out["params"] if key == "params" else out["opt"][key])[
                    name] = w.float().cpu().numpy()
    out["opt"]["step"] = state["opt"]["step"].cpu().numpy()
    return out if rank0 else None


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 (data x model); 1: one rank")
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
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="a mesh's ranks: seconds for the whole run, every "
                         "collective's wait included")
    return ap


def main(argv=None, *, device=None, step_hook=None):
    """Parse ``argv`` and train.  ``device`` overrides ``--device``;
    ``step_hook(step, metrics)``, when given, runs after each step (a
    raise there is a failed step, which the restart envelope catches; on
    a mesh it runs on every rank, so it must pickle).  Returns ``{"step",
    "losses", "step_s", "state", "resumed"}``: the final step, each step's
    loss and seconds (a step redone after a restart keeps its last run's),
    the final train state (None on a mesh: it lives in the ranks) and the
    steps that the loop resumed from; on a mesh, rank 0's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    cfg, shape, axes = build(args)
    dev = resolve_device(args.device if device is None else device)
    n = math.prod(shape)
    if n == 1:
        return _train(args, cfg, dev, step_hook)
    from ..core import run_ranks
    shared = False
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        shared = cards < n
        if shared:
            print(f"--mesh {args.mesh}: {n} ranks share {cards} card(s) "
                  f"over gloo (NCCL takes one rank a card)", flush=True)
    ranks = run_ranks(_rank_main, n,
                      backend="nccl" if dev.type == "cuda" and not shared
                      else "gloo",
                      device="cpu" if dev.type == "cpu" else None,
                      shared_card=shared, args=(argv, step_hook),
                      timeout=args.rank_timeout)
    return ranks[0]


def _rank_main(env, argv, step_hook):
    """One rank of a mesh: its group of the mesh and its loop."""
    args = _parser().parse_args(argv)
    cfg, shape, axes = build(args)
    comm = env.group(shape, axes)
    return _train(args, cfg, comm.device, step_hook, comm)


def _train(args, cfg, dev, step_hook, comm=None):
    """The loop on one rank (``comm`` None) or on this rank of a mesh."""
    rank0 = comm is None or comm.rank == 0
    log = print if rank0 else (lambda *a, **k: None)
    mesh_kw = {}
    if comm is not None:
        from .mesh import expert_pad_for, mesh_axes
        fsdp, tp = mesh_axes(comm)
        mesh_kw = dict(mesh=comm, fsdp=fsdp, tp=tp or "model")
    step_fn = make_train_step(
        cfg, base_lr=args.lr, warmup=min(20, args.steps // 10 + 1),
        total=args.steps, microbatches=args.microbatches, remat=False,
        **mesh_kw)
    # every rank draws the global batch; the step keeps its rows
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed, n_hosts=1, host_id=0)
    watchdog = StragglerWatchdog()
    out = {"step": 0, "losses": {}, "step_s": {}, "state": None,
           "resumed": []}
    pending = []                        # the async save in flight

    def join():
        while pending:
            pending.pop().join()
        if comm is not None:
            # every rank sees what rank 0 has written
            comm.barrier()

    def checkpoint(step, state, blocking):
        tree = state if comm is None else _whole(
            state, state_shardings(cfg, state, comm, fsdp=mesh_kw["fsdp"],
                                   tp=mesh_kw["tp"])["params"], comm)
        if rank0:
            writer = save(args.ckpt_dir, step, tree, blocking=blocking)
            if writer is not None:
                pending.append(writer)

    def preempted():
        flag = guard.preempted
        if comm is not None:
            # a signal reaches one rank; every rank flushes with it
            from ..core.comm import all_reduce_tensor
            t = torch.tensor([float(flag)], device=dev)
            flag = bool(all_reduce_tensor(t, comm.group, op="max")[0])
        return flag

    def train_loop(_start):
        join()
        out["state"] = None             # a failed entry's state goes
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        if comm is None:
            state = make_train_state(cfg, gen, device=dev)
        else:
            state = make_train_state(cfg, gen, expert_pad=expert_pad_for(
                cfg, comm), **mesh_kw)
        start = 0
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            tree, start = restore(args.ckpt_dir, state)
            if comm is None:
                _load(state, tree)
            else:
                _load(state, tree, state_shardings(
                    cfg, state, comm, fsdp=mesh_kw["fsdp"],
                    tp=mesh_kw["tp"])["params"], comm.group)
            del tree
            out["resumed"].append(start)
            log(f"resumed from step {start}", flush=True)
        if comm is None:
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
                log(f"[straggler] step {step}: {dt:.2f}s "
                    f"(median {watchdog.median:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                join()
                checkpoint(step + 1, state, blocking=False)
            if args.ckpt_dir and preempted():
                join()
                checkpoint(step + 1, state, blocking=True)
                log("preempted: checkpoint flushed", flush=True)
                out["step"] = step + 1
                return step + 1
            if step % args.log_every == 0 or step == args.steps - 1:
                tput = args.batch * args.seq / dt
                log(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['gnorm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"{tput:,.0f} tok/s", flush=True)
            if step_hook is not None:
                step_hook(step, metrics)
        join()
        if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps:
            checkpoint(args.steps, state, blocking=True)
        if out["losses"]:
            log(f"final loss {out['losses'][args.steps - 1]:.4f} (start "
                f"{out['losses'][min(out['losses'])]:.4f})", flush=True)
        out["step"] = args.steps
        return args.steps

    guard = PreemptionGuard()
    try:
        run_with_restarts(train_loop, policy=RestartPolicy(max_restarts=3))
    finally:
        while pending:
            pending.pop().join()
        guard.close()
    return out


if __name__ == "__main__":
    main()
