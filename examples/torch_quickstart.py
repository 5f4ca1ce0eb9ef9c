"""Quickstart of the PyTorch port: the MGPU-style core API, after
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --ranks 4

Walks the paper's §2 verbs on ``--ranks N`` rank processes started by
``repro_torch.core.run_ranks``: create an environment, bind a communicator
to its group, build segmented containers, move data with the MPI-like verb
methods (collectives and point-to-point), call the segmented FFT and
BLAS, and launch a function on every rank.  Rank 0 prints.  The ranks run
on the card (NCCL with a card a rank, gloo when they share one) unless
``--device cpu`` (gloo).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import Policy, run_ranks
from repro_torch.lib import blas, fft, plan_stats


def walk(env):
    """The §2 walk on one rank; returns the lines rank 0 prints."""
    out = []
    say = out.append
    comm = env.world                       # every rank, one "data" axis
    say(f"environment: {env}; communicator: {comm}")

    # -- segmented containers (paper §2.2) -------------------------------
    rng = np.random.default_rng(0)         # the same x on every rank
    x = (rng.standard_normal((8, 64, 64)) +
         1j * rng.standard_normal((8, 64, 64))).astype(np.complex64)
    seg = comm.container(x)                # natural split
    say(f"segments: {seg.segments()[0]} x {seg.nseg}")
    comm.bcast(x[0])                       # CLONE policy
    blocks = comm.container(x, policy=Policy.BLOCK, block=2)
    assert np.allclose(comm.gather(blocks).cpu().numpy(), x)

    # -- MPI-like communication (paper §2.3, Fig. 3) ---------------------
    summed = comm.reduce(seg)              # one matrix: sum over segments
    seg.allreduce()                        # ... CLONEd on every rank
    say(f"reduce == sum: "
        f"{np.allclose(summed.cpu().numpy(), x.sum(0), atol=1e-4)}")
    full = seg.allgather()                 # MPI_Allgather -> CLONE
    say(f"allgather: {np.allclose(full.data.cpu().numpy(), x, atol=0)}")

    # -- point-to-point (the paper's P2P path) ---------------------------
    ring = seg.shift(1)                    # each segment to the next rank
    say(f"shift ring: {tuple(comm.gather(ring).shape)} (segments rotated "
        f"by 1)")
    pairs = [(0, 1), (1, 0)] if comm.size > 1 else [(0, 0)]
    swapped = comm.send_recv(seg, pairs)   # pairwise exchange
    say(f"send_recv: {swapped.global_shape}")

    # -- ported libraries (paper §2.4/§4: plan once, call many) ----------
    k = fft.fft2_batched(seg, centered=True)          # builds the plan
    img = fft.fft2_batched(k, inverse=True, centered=True)
    say(f"fft roundtrip: "
        f"{np.allclose(comm.gather(img).cpu().numpy(), x, atol=1e-4)}")
    y = comm.container((rng.standard_normal((8, 64, 64)) +
                        0j).astype(np.complex64))
    blas.axpy(2.0 + 1j, seg, y)                       # a*X + Y
    say(f"dot <x,y> = {complex(blas.dot(seg, y))}")
    blas.axpy_dot(0.5, seg, y, y)                     # fused epilogue
    say(f"plan cache: {plan_stats()}")                # hits/builds

    # -- invoke (paper §2.5) ---------------------------------------------
    def my_kernel(xl, yl):                 # receives local ranges
        return torch.abs(xl) ** 2 + torch.abs(yl) ** 2

    power = comm.invoke_all(my_kernel, seg, y)
    say(f"invoke_all -> {power.global_shape} {power.data.dtype}")
    say("quickstart OK")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args()
    if args.device == "cpu":
        kw = dict(backend="gloo", device="cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no card: pass --device cpu")
        shared = torch.cuda.device_count() < args.ranks
        kw = dict(backend="gloo" if shared else "nccl", shared_card=shared)
    for line in run_ranks(walk, args.ranks, timeout=600, **kw)[0]:
        print(line)


if __name__ == "__main__":
    main()
