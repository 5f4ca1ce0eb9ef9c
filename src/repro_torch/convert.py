"""Carry state across between the JAX package and the port.

NLINV has no weights: what a run carries is the Newton state, the
``{"u": {rho, chat}, "x_ref": {rho, chat}}`` of ``FrameStream.last_carry``
(or one ``{rho, chat}`` dict).  Both packages meet in numpy: turn a JAX
carry into arrays with ``np.asarray`` leaf by leaf, hand it to
:func:`carry_from_numpy`, and get it back with :func:`carry_to_numpy`.
Frame constants (mask, fov, weight) go through the same helper.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def carry_from_numpy(tree, device=None):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``
    (the card when None), dtypes kept.  Always copies, so an in-place
    update of the carry never writes into the caller's arrays."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: carry_from_numpy(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


def carry_to_numpy(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: carry_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
