"""Tree-level BLAS over the ``{rho, chat}`` state: the counterparts of
``repro.lib.blas.tree_axpy`` and ``tree_vdot``.

A tree is a tensor or a dict of tensors.  Dict leaves are visited in
sorted key order, which is JAX's pytree order (``chat`` before ``rho``),
so sums over leaves add in the same order as the JAX package.
"""

from __future__ import annotations

import torch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def tree_axpy(a, x, y):
    """``a*x + y`` leaf by leaf."""
    if isinstance(x, dict):
        if set(x) != set(y):
            raise ValueError(f"tree_axpy operands differ in structure: "
                             f"{sorted(x)} vs {sorted(y)}")
        return {k: a * x[k] + y[k] for k in x}
    return a * x + y


def tree_vdot(x, y):
    """Conjugating inner product summed over all leaves (complex)."""
    if isinstance(x, dict) != isinstance(y, dict) or (
            isinstance(x, dict) and set(x) != set(y)):
        raise ValueError("tree_vdot operands differ in structure")
    return sum(torch.vdot(a.reshape(-1), b.reshape(-1))
               for a, b in zip(_leaves(x), _leaves(y)))
