"""The multi-stream reconstruction service of the PyTorch port, after
``examples/mri_service.py``: synthetic scanner clients with staggered
arrivals streaming through one ``StreamScheduler``, every tick one
batched frame over all ready clients.  Prints the per-client latency/SLO
table and the aggregate throughput.

    PYTHONPATH=src python examples/torch_mri_service.py --frames 6 --n 32
    PYTHONPATH=src python examples/torch_mri_service.py --device cpu \\
        --devices 4 --clients 2 --frames 3 --n 16

On the card unless ``--device cpu`` (the kernels' plain versions).
``--devices N`` > 1 splits the coils over N rank processes
(``core.run_ranks``: NCCL with a card a rank, gloo when they share one or
on the CPU); rank 0 prints.
"""

import argparse

import torch

from repro_torch.core import Communicator, run_ranks
from repro_torch.nlinv import phantom
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.serve import NlinvStreamWorkload, ServeConfig, StreamScheduler


def serve(comm, args, datas):
    """Every client's frames through the scheduler on ``comm``; returns
    the lines to print."""
    out = []
    K = args.clients
    rec = Reconstructor(comm, newton=args.newton, cg_iters=args.cg,
                        channel_sum="crop")
    sched = StreamScheduler(
        NlinvStreamWorkload(rec, damping=0.9),
        ServeConfig(max_concurrency=2 * K,
                    budget_ms=args.budget_ms or None,
                    buckets=(1, 2, 4, 8)))

    # staggered arrivals: client k connects at tick k, so the batch
    # width ramps 1 -> 2 -> ... -> K and a plan is built only at each new
    # bucket width
    sessions = {}
    next_frame = {}
    tick = 0
    while True:
        if tick < K:
            k = tick
            d = datas[k]
            sessions[k] = sched.open(client=f"scanner{k}", grid=d["grid"],
                                     ncoils=args.coils, fov=d["fov"])
            next_frame[k] = 0
            out.append(f"tick {tick}: scanner{k} connected")
        for k, sess in sessions.items():
            f = next_frame[k]
            if f < args.frames:
                sched.submit(sess, (datas[k]["y"][f], datas[k]["masks"][f]))
                next_frame[k] = f + 1
        if sched.tick() == 0 and all(f >= args.frames
                                     for f in next_frame.values()):
            break
        tick += 1

    if not args.budget_ms and len(sched.tick_ms) > 1:
        # auto-budget for the SLO column: 2x the best steady tick
        budget = 2.0 * min(sched.tick_ms[1:])
        sched.config = ServeConfig(max_concurrency=2 * K,
                                   budget_ms=budget, buckets=(1, 2, 4, 8))
    rep = sched.report()

    out.append(f"\n{'client':<10} {'frames':>6} {'p50 ms':>8} "
               f"{'p95 ms':>8} {'jitter':>8} {'SLO met':>8}")
    for name, row in sorted(rep["clients"].items()):
        slo = row.get("slo", {})
        met = f"{100 * slo['met']:.0f}%" if slo else "-"
        out.append(f"{name:<10} {row['frames']:>6} {row['p50_ms']:>8.1f} "
                   f"{row['p95_ms']:>8.1f} {row['jitter_ms']:>8.2f} "
                   f"{met:>8}")
    agg = rep["aggregate"]
    budget = sched.config.budget_ms
    out.append(f"\naggregate: {agg['frames']} frames in {agg['ticks']} "
               f"ticks, {agg['fps']:.1f} fps"
               + (f" (SLO budget {budget:.1f} ms/frame)" if budget else ""))
    return out


def _rank(env, args, datas):
    return serve(env.world, args, datas)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6,
                    help="frames per client")
    ap.add_argument("--n", type=int, default=32, help="matrix size")
    ap.add_argument("--coils", type=int, default=8)
    ap.add_argument("--newton", type=int, default=4)
    ap.add_argument("--cg", type=int, default=10)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="per-frame SLO budget (0 = auto: 2x the first "
                         "steady tick)")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")

    K, ndev = args.clients, max(args.devices, 1)
    print(f"service: {K} clients, {args.frames} frames each "
          f"(n={args.n}, J={args.coils}), {ndev} rank(s)")
    datas = [phantom.make_dataset(n=args.n, ncoils=args.coils, nspokes=11,
                                  frames=args.frames, seed=k)
             for k in range(K)]
    if ndev > 1:
        shared = args.device != "cpu" and torch.cuda.device_count() < ndev
        lines = run_ranks(
            _rank, ndev, backend="nccl" if args.device != "cpu" and
            not shared else "gloo", shared_card=shared,
            device="cpu" if args.device == "cpu" else None,
            args=(args, datas), timeout=3600)[0]
    else:
        lines = serve(Communicator.single(args.device), args, datas)
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
