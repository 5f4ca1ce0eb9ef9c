"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and asking for ``"cuda"`` on a machine
without a card raises instead of quietly running elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA card; ``"cpu"`` only when asked for.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is
    present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def rank_device(local_rank: int, *, shared: bool = False,
                device=None) -> torch.device:
    """The device of one rank of a process group on one host.

    ``device=None`` means the card: ``cuda:{local_rank}``, one card per
    rank, or ``cuda:0`` for every rank when ``shared`` (ranks that share
    one card).  ``device="cpu"`` puts every rank on the CPU.  Raises when
    the host has fewer cards than the ranks need."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = 0 if shared else local_rank
    if dev.index is not None and dev.index != index:
        raise ValueError(f"rank {local_rank} asked for {dev}, but its card "
                         f"is cuda:{index}")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {local_rank} needs cuda:{index}; this host "
                           f"has {torch.cuda.device_count()} card(s) (ranks "
                           f"that share one card pass shared=True)")
    return torch.device("cuda", index)
