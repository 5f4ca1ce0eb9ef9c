"""Calibrated analytic performance models for the ``derived`` columns.

The measured columns time the port on the sweep's ranks; the multi-rank
scaling columns are DERIVED from the roofline/alpha-beta model, with
the H100's published rates (``core.runtime.HW``) or with the paper's own
2013 testbed constants to validate its claims (semantics are tested,
counts are asserted, scaling comes from the model).
"""

from __future__ import annotations

import numpy as np

from ..core.runtime import HW

# The paper's 2013 testbed (Tyan FT72-B7015, 8x GTX 580): used to
# validate the paper's OWN speedup claims (1.7x @ 2 GPUs, 2.1x @ 4);
# the H100 columns show how the port behaves on a current card.
PAPER_HW = dict(
    peak_flops=0.79e12,      # GTX 580 fp32, ~50% achievable
    mem_bw=150e9,            # GDDR5 effective
    p2p_bw=6e9,              # PCIe 2.0 peer-to-peer (same IOH)
    host_bw=5e9,             # staged through host (cross IOH)
    latency=10e-6,
)

PCIE_BW = 64e9          # host->device, one direction: the H100 SXM's
                        # published PCIe Gen5 x16 host link (128 GB/s
                        # both ways, NVIDIA's data sheet)


def allreduce_time(nbytes: int, ndev: int, bw: float | None = None,
                   latency: float = 1e-6) -> float:
    """Ring all-reduce seconds for one device's payload (NVLink by
    default)."""
    if ndev <= 1:
        return 0.0
    bw = bw or HW["nvlink_bw"]
    return 2 * nbytes * (ndev - 1) / ndev / bw + 2 * (ndev - 1) * latency


def copy_time(nbytes: int, bw: float, latency: float = 5e-6) -> float:
    return nbytes / bw + latency


def speedup_model(grid: int, J: int, newton=7, cg_iters=6, hw="paper",
                  crop=True) -> dict:
    """Modeled NLINV speedup for G devices, calibrated on op counts.

    hw="paper": GTX-580/PCIe constants -> validates the paper's claims.
    hw="h100":  the H100's rates (``core.runtime.HW``: bf16 peak, HBM,
                NVLink) -> the port's scaling.
    Per CG iteration: DF + DF^H = 6 FFT batches over the J local
    channels + ~9 pointwise passes + 1 all-reduce of rho (cropped FOV
    quarter when ``crop``); ~7% non-scaling CG overhead (scalar products
    + host sync, per the paper's CG row of Table 1)."""
    if hw == "paper":
        peak, bw, p2p, lat = (PAPER_HW["peak_flops"], PAPER_HW["mem_bw"],
                              PAPER_HW["p2p_bw"], PAPER_HW["latency"])
    elif hw == "h100":
        peak, bw, p2p, lat = (HW["peak_flops_bf16"], HW["hbm_bw"],
                              HW["nvlink_bw"], 1e-6)
    else:
        raise ValueError(f"hw must be paper|h100: {hw!r}")
    flop_fft = 2 * 5 * grid * grid * np.log2(grid * grid)   # per channel
    bytes_img = grid * grid * 8                             # complex64
    t_fft = 3 * J * flop_fft / peak
    t_pw = 9 * J * bytes_img / bw
    t_serial = 0.07 * (t_fft + t_pw)
    ar_bytes = bytes_img // 4 if crop else bytes_img
    out = {}
    t1 = t_fft + t_pw + t_serial
    for G in (1, 2, 3, 4, 8):
        t_comp = (t_fft + t_pw) / G
        t_ar = allreduce_time(ar_bytes, G, bw=p2p, latency=lat) \
            if G > 1 else 0.0
        if hw == "paper":
            if G >= 4:
                t_ar *= G / 2.0     # shared PCIe switches: ring contention
                                    # (paper Fig.9: DF^H slows at 4 GPUs)
            if G > 4:
                t_ar *= 3.0         # cross-IOH: host-staged, no P2P
        out[G] = t1 / (t_comp + t_ar + t_serial)
    return out
