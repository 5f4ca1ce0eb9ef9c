"""Plain PyTorch version of the masked partial-image reduction (paper
§3.2: ``kern_all_red_p2p_2d`` with the M_Omega mask applied right after).

The CPU path of the wrapper in ``ops.py`` and the oracle its CUDA kernel
is held against on the card."""

import torch


def masked_sum_ref(partials, mask):
    """partials: (G, X, Y) complex partial images, or (G, B, X, Y) for B
    rows; mask: (X, Y) real, shared by the rows -> mask * Sum_g
    partials_g, (X, Y) or (B, X, Y)."""
    return mask * torch.sum(partials, dim=0)
