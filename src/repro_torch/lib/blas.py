"""libblas port: the segmented level-1 BLAS (paper §4, Fig. 4).

The counterpart of ``repro.lib.blas``.  The operands are pytrees (a
``SegmentedArray`` or a dict of them, visited in sorted key order, JAX's
pytree order).  Each leaf runs its local form (the ``cg_fused`` kernels
for ``cg_update`` and ``xpby_dot``) on this rank's segment; the per-leaf
partials of a reduction add in leaf order, and then ONE collective
reduces them by policy: the segmented leaves' sum is all-reduced, the
CLONE leaves' counts once (the rule of ``Communicator.vdot``).  So every
rank gets the same scalar.  Nothing is compiled per layout, so unlike
the JAX package's forms these are not plan-cached.

``tree_axpy``/``tree_vdot`` are the plain-tensor forms the NLINV solver
uses on one rank's state.  The level-3 forms: ``gemm_batched`` over the
segmented batch dim (no communication) and ``gemm_ksplit`` with the
contraction dim segmented (a local product and one reduction, by
``gemm_ksplit_schedule``).  Their local products are ``torch.matmul``,
as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..core import comm as _comm
from ..core.comm import all_reduce_tensor
from ..core.segmented import Policy, SegmentedArray
from ..kernels.cg_fused import cg_update as _cg_update
from ..kernels.cg_fused import sq_norm
from ..kernels.cg_fused import xpby_dot as _xpby_dot


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


# ---------------------------------------------------------------------------
# segmented pytrees
# ---------------------------------------------------------------------------

def _seg_leaves(tree, name) -> list[SegmentedArray]:
    leaves = _leaves(tree)
    if not leaves or not all(isinstance(l, SegmentedArray) for l in leaves):
        raise ValueError(f"{name} operands must be (dicts of) "
                         f"SegmentedArrays")
    return leaves


def _same_structure(name, *trees):
    keys = [sorted(t) if isinstance(t, dict) else None for t in trees]
    if any(k != keys[0] for k in keys):
        raise ValueError(f"{name} operands differ in structure: {keys}")


def _like(tree, datas):
    """``tree``'s containers with new local data, in leaf order."""
    if isinstance(tree, dict):
        return {k: tree[k].with_data(d) for k, d in zip(sorted(tree), datas)}
    return tree.with_data(datas[0])


def _reduce(parts, leaves):
    """Merge per-leaf partials by the leaves' policies: the segmented
    ones (added in leaf order) take one all-reduce, the CLONE ones count
    once."""
    shard = clone_sum = None
    for v, leaf in zip(parts, leaves):
        if leaf.policy is Policy.CLONE:
            clone_sum = v if clone_sum is None else clone_sum + v
        else:
            shard = v if shard is None else shard + v
    total = None if shard is None else all_reduce_tensor(shard,
                                                         leaves[0].group)
    if clone_sum is not None:
        total = clone_sum if total is None else total + clone_sum
    return total


def axpy(a, x, y):
    """``a*X + Y``, segment-local (the strong-scaling op of Fig. 4)."""
    _same_structure("axpy", x, y)
    xl, yl = _seg_leaves(x, "axpy"), _seg_leaves(y, "axpy")
    return _like(y, [a * u.data + v.data for u, v in zip(xl, yl)])


def dot(x, y) -> torch.Tensor:
    """``<x, y>`` (conjugating) with one reduction across segments."""
    _same_structure("dot", x, y)
    xl, yl = _seg_leaves(x, "dot"), _seg_leaves(y, "dot")
    return _reduce([torch.vdot(u.data.reshape(-1), v.data.reshape(-1))
                    for u, v in zip(xl, yl)], xl)


def norm2(x) -> torch.Tensor:
    """``||x||^2 = Re <x, x>`` (real float32)."""
    xl = _seg_leaves(x, "norm2")
    return _reduce([sq_norm(u.data) for u in xl], xl)


def axpy_dot(a, x, y, z):
    """Fused ``w = a*x + y`` and ``<z, w>``.  Returns ``(w, <z, w>)``."""
    _same_structure("axpy_dot", x, y, z)
    xl, yl, zl = (_seg_leaves(t, "axpy_dot") for t in (x, y, z))
    ws = [a * u.data + v.data for u, v in zip(xl, yl)]
    d = _reduce([torch.vdot(c.data.reshape(-1), w.reshape(-1))
                 for c, w in zip(zl, ws)], xl)
    return _like(y, ws), d


def axpy_norm2(a, x, y):
    """Fused ``w = a*x + y`` and ``||w||^2`` (the CG residual update)."""
    _same_structure("axpy_norm2", x, y)
    xl, yl = _seg_leaves(x, "axpy_norm2"), _seg_leaves(y, "axpy_norm2")
    ws = [a * u.data + v.data for u, v in zip(xl, yl)]
    return _like(y, ws), _reduce([sq_norm(w) for w in ws], xl)


def cg_update(alpha, p, ap, x, r):
    """The fused single-pass CG update over (dicts of) containers:
    ``x' = x + alpha*p``, ``r' = r - alpha*Ap`` and ``rs = sum |r'|^2``,
    one ``cg_update`` kernel per leaf and one reduction of the leaves'
    ``rs``.  Returns ``(x', r', rs)``."""
    _same_structure("cg_update", p, ap, x, r)
    pl, apl, xl, rl = (_seg_leaves(t, "cg_update") for t in (p, ap, x, r))
    outs = [_cg_update(alpha, *(l.data for l in leaf))
            for leaf in zip(pl, apl, xl, rl)]
    return (_like(x, [o[0] for o in outs]), _like(r, [o[1] for o in outs]),
            _reduce([o[2] for o in outs], xl))


def xpby_dot(x, y, beta):
    """Fused ``w = x + beta*y`` with the ``sum |w|^2`` epilogue over
    (dicts of) containers, the CG search-direction step in one pass: one
    ``xpby_dot`` kernel per leaf and one reduction of the leaves' ``d``.
    Returns ``(w, d)``."""
    _same_structure("xpby_dot", x, y)
    xl, yl = _seg_leaves(x, "xpby_dot"), _seg_leaves(y, "xpby_dot")
    outs = [_xpby_dot(u.data, v.data, beta) for u, v in zip(xl, yl)]
    return _like(x, [o[0] for o in outs]), _reduce([o[1] for o in outs], xl)


def dot_allreduce(x: SegmentedArray, y: SegmentedArray) -> torch.Tensor:
    """``<x, y>`` of two containers as the shard-local partial product and
    one explicit all-reduce across segments (none for CLONE): the
    paper's 'one inter-device reduction' per scalar product."""
    if not (isinstance(x, SegmentedArray) and isinstance(y, SegmentedArray)):
        raise ValueError("dot_allreduce takes two SegmentedArrays")
    return _reduce([torch.vdot(x.data.reshape(-1), y.data.reshape(-1))], [x])


# ---------------------------------------------------------------------------
# level 3: batched and k-split GEMM
# ---------------------------------------------------------------------------

def gemm_batched(a: SegmentedArray, b: SegmentedArray) -> SegmentedArray:
    """Batched matmul ``(B, I, J) @ (B, J, K)`` over the segmented batch
    dim: no communication (paper Fig. 4 splits 12 square matrices over
    the cards)."""
    if a.dim != 0 or b.dim != 0 or a.policy is not b.policy:
        raise ValueError("gemm_batched takes two containers segmented "
                         "alike on the batch dim 0")
    out = torch.matmul(a.data, b.data)
    shape = (a.global_shape[0], *out.shape[1:])
    return SegmentedArray(out, a.comm, a.policy, 0, shape, a.orig_len,
                          a.block, a.halo)


def gemm_ksplit_schedule(a: SegmentedArray, b: SegmentedArray) -> str:
    """The reduction ``gemm_ksplit`` takes: ``rs_ag`` (reduce-scatter +
    all-gather: each rank sums 1/G of the product) where the ranks'
    memories are apart and the product is at least
    ``comm.REDUCE_RS_AG_MIN_BYTES``, else ``psum``;
    ``comm.REDUCE_SCHEDULE`` forces one (its rows must tile)."""
    nseg = a.nseg
    rows = a.global_shape[0]
    itemsize = torch.empty(0, dtype=torch.promote_types(a.dtype, b.dtype)
                           ).element_size()
    nbytes = rows * b.global_shape[1] * itemsize
    eligible = nseg > 1 and rows % nseg == 0
    if _comm.REDUCE_SCHEDULE is not None:
        return ("rs_ag" if _comm.REDUCE_SCHEDULE == "rs_ag" and eligible
                else "psum")
    if (eligible and not a.group.unified_memory
            and nbytes >= _comm.REDUCE_RS_AG_MIN_BYTES):
        return "rs_ag"
    return "psum"


def gemm_ksplit(a: SegmentedArray, b: SegmentedArray) -> SegmentedArray:
    """``A @ B`` with the contraction dim segmented (``A`` on dim 1, ``B``
    on dim 0, their padding zeros): the local partial product and one
    reduction, the paper's non-scaling A·B case.  Returns a CLONE
    container."""
    if a.dim != 1 or b.dim != 0 or a.global_shape[1] != b.global_shape[0]:
        raise ValueError("gemm_ksplit takes A segmented on dim 1 and B on "
                         "dim 0, of one contraction length")
    schedule = gemm_ksplit_schedule(a, b)
    part = torch.matmul(a.data, b.data)
    out = _comm._psum_rs_ag(part, a.group) if schedule == "rs_ag" \
        else all_reduce_tensor(part, a.group)
    return _comm._clone_container(out, a.comm)
