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
