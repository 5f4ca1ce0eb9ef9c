"""End-to-end driver of the PyTorch port (the paper's §3 application), after
``examples/mri_realtime.py``: real-time MRI movie reconstruction with
NLINV, streaming frames with temporal regularization through
``FrameStream``, the gridding baseline, per-frame latency and jitter.

    PYTHONPATH=src python examples/torch_mri_realtime.py --frames 5 --n 48
    PYTHONPATH=src python examples/torch_mri_realtime.py --device cpu \\
        --devices 4 --frames 3 --n 32

On the card unless ``--device cpu`` (the kernels' plain versions).
``--devices N`` > 1 splits the coils over N rank processes
(``core.run_ranks``: NCCL with a card a rank, gloo when they share one or
on the CPU); rank 0 prints.
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.core import Communicator, run_ranks
from repro_torch.nlinv import phantom
from repro_torch.nlinv.gridding import gridding_recon
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.nlinv.stream import FrameStream


def nrmse(img, truth, fov):
    m = np.asarray(fov) > 0
    a = np.abs(np.asarray(img))[m]
    b = np.abs(np.asarray(truth))[m]
    a /= max(a.max(), 1e-9)
    b /= max(b.max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def reconstruct(comm, args, data):
    """The movie through ``FrameStream`` on ``comm``: (movie as numpy,
    the latency report's summary)."""
    rec = Reconstructor(comm, newton=args.newton, cg_iters=20,
                        channel_sum=args.channel_sum)
    engine = FrameStream(rec, damping=0.9)
    movie, report = engine.run(data["y"], data["masks"], data["fov"],
                               report_path=args.report or None)
    return movie.cpu().numpy(), report.summary()


def _rank(env, args, data):
    return reconstruct(env.world, args, data)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--n", type=int, default=48, help="matrix size")
    ap.add_argument("--coils", type=int, default=8)
    ap.add_argument("--spokes", type=int, default=11)
    ap.add_argument("--newton", type=int, default=7)
    ap.add_argument("--devices", type=int, default=1,
                    help=">1: channel-split distributed reconstruction")
    ap.add_argument("--channel-sum", default="crop", choices=("full", "crop"))
    ap.add_argument("--report", default="",
                    help="write the latency report JSON here")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")

    print(f"acquiring {args.frames} frames (n={args.n}, J={args.coils}, "
          f"{args.spokes} spokes, golden-angle)")
    data = phantom.make_dataset(n=args.n, ncoils=args.coils,
                                nspokes=args.spokes, frames=args.frames)

    ndev = max(args.devices, 1)
    if ndev > 1:
        print(f"distributed: {ndev} ranks, coils NATURAL-segmented, "
              f"{args.channel_sum} channel sum "
              f"(paper kern_all_red_p2p_2d when cropped)")
        shared = args.device != "cpu" and torch.cuda.device_count() < ndev
        movie, s = run_ranks(
            _rank, ndev, backend="nccl" if args.device != "cpu" and
            not shared else "gloo", shared_card=shared,
            device="cpu" if args.device == "cpu" else None,
            args=(args, data), timeout=3600)[0]
    else:
        movie, s = reconstruct(Communicator.single(args.device), args, data)
    print(f"reconstructed {args.frames} frames: first (warm-up) "
          f"{s['first_frame_ms']:.0f} ms, steady {s['mean_ms']:.1f} ms/frame "
          f"(p95 {s['p95_ms']:.1f}, jitter {s['jitter_ms']:.2f} ms, "
          f"{s['fps']:.1f} fps)")
    pc = s.get("plan_cache", {})
    print(f"plan cache: frame builds {pc.get('frame_builds')}, "
          f"steady builds {pc.get('steady_builds')}, "
          f"hit rate {pc.get('hit_rate')}")
    if args.report:
        print(f"latency report -> {args.report}")
    else:
        print("latency report:", json.dumps(s))

    dev = torch.device(args.device)
    fov = torch.as_tensor(data["fov"], device=dev)
    errs, gerrs = [], []
    for f in range(args.frames):
        errs.append(nrmse(movie[f], data["rho"][f], data["fov"]))
        gr = gridding_recon(torch.as_tensor(data["y"][f], device=dev),
                            torch.as_tensor(data["masks"][f], device=dev),
                            fov)
        gerrs.append(nrmse(gr.cpu().numpy(), data["rho"][f], data["fov"]))
    print(f"NRMSE nlinv  : {np.mean(errs):.4f}  (per-frame {np.round(errs,3)})")
    print(f"NRMSE gridding: {np.mean(gerrs):.4f}")
    print("nlinv beats gridding:", np.mean(errs) < np.mean(gerrs))


if __name__ == "__main__":
    main()
