"""MPI-like communication verbs over segmented containers (paper §2.3).

The counterpart of ``repro.core.comm``.  The JAX verbs lower to
``shard_map`` bodies with ``lax`` collectives inside; the port runs one
process per rank, so a verb is the shard-local program of one rank and
its collective is a ``torch.distributed`` call on the group's explicit
process group (``DeviceGroup.pg``).  A group without a process group has
one rank, and its collectives are no-ops: the same program.

Every reduction verb has the JAX package's two calling forms: eagerly on
a :class:`SegmentedArray` (the communicator comes with it), or on this
rank's local tensor with ``comm=`` (the form the NLINV frame uses, like
the JAX verbs inside a ``shard_map`` body).

Ported here: ``all_reduce``/``reduce``, ``all_reduce_window``,
``all_reduce_overlap`` (the psum schedule, with the extras packed into
the window's payload: one collective a call; and the gathered schedule
whose local half is the ``masked_sum`` kernel), ``vdot`` with policies,
``broadcast``, ``scatter``, ``all_gather``, ``send_recv``, ``shift`` and
``ring_perm``.  The p2p ring all-reduce, the hierarchical psum, ``copy``
with its routes, ``all_to_all``, ``reduce_scatter`` and the broadcast
and reduce schedules are later work (ROADMAP Queue 1 item 6).

Complex tensors go on the wire as their real view (``view_as_real``),
which every backend takes and which sums the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.masked_allreduce import masked_sum
from .segmented import (Policy, SegmentedArray, local_segment,
                        physical_layout, segment, upload)
from .segmented import gather as _gather

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# re-export container-level scatter/gather under the verb names (Fig. 3)
gather = _gather


# ---------------------------------------------------------------------------
# the collectives of one rank, on a DeviceGroup
# ---------------------------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as the backends take it: complex as its real
    view (the same memory)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _check_op(op: str) -> None:
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}, not {op!r}")


def all_reduce_tensor(t: torch.Tensor, group, op: str = "sum"):
    """``op`` of ``t`` over the group's ranks, as a new tensor on every
    rank (``t`` is left alone); a group without a process group returns
    ``t``."""
    _check_op(op)
    if group.pg is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_wire(out), op=_OPS[op], group=group.pg)
    return out


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``(G, *t.shape)`` on
    every rank; a group without a process group gives ``t[None]``."""
    if group.pg is None:
        return t[None]
    t = t.contiguous()
    out = t.new_empty((group.size, *t.shape))
    dist.all_gather([_wire(o) for o in out.unbind(0)], _wire(t),
                    group=group.pg)
    return out


def broadcast_tensor(t: torch.Tensor, group, src: int = 0):
    """Rank ``src``'s ``t`` on every rank, as a new tensor."""
    if group.pg is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.broadcast(_wire(out), src=group.global_rank(src), group=group.pg)
    return out


def _local_reduce(x: torch.Tensor, dim: int, op: str) -> torch.Tensor:
    _check_op(op)
    if op == "sum":
        return torch.sum(x, dim=dim)
    return torch.amax(x, dim=dim) if op == "max" else torch.amin(x, dim=dim)


def _window_index(ndim: int, window, axes=None) -> tuple:
    """Slice tuple selecting ``window`` ((lo, hi) pairs) on the trailing
    dims of a rank-``ndim`` array (or on explicit ``axes``)."""
    if axes is None:
        axes = tuple(range(ndim - len(window), ndim))
    idx: list = [slice(None)] * ndim
    for ax, (lo, hi) in zip(axes, window):
        idx[ax] = slice(lo, hi)
    return tuple(idx)


def _clone_container(data: torch.Tensor, comm, dim: int = 0):
    return SegmentedArray(data, comm, Policy.CLONE, dim, tuple(data.shape),
                          data.shape[dim] if data.ndim else None)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def all_reduce(seg: SegmentedArray, op: str = "sum") -> SegmentedArray:
    """Like ``reduce`` but the result is a CLONE container on every rank
    (the paper's Σ ρ_g all-reduce)."""
    return all_reduce_window(seg, None, op=op)


def reduce(seg: SegmentedArray, op: str = "sum") -> torch.Tensor:
    """Merge the segments elementwise into one local array (paper Fig.
    3/5): the segmented dim is reduced away, the result on every rank."""
    return all_reduce(seg, op).data


def all_reduce_window(x, window=None, *, op: str = "sum",
                      reduce_dim: int | None = None, window_axes=None,
                      comm=None):
    """Windowed all-reduce, the paper's ``kern_all_red_p2p_2d`` as a
    primitive: reduce ``reduce_dim`` locally, all-reduce only
    ``window`` ((lo, hi) per trailing dim, or on ``window_axes``) and
    return it scattered back into zeros.  ``window=None`` is a plain
    all-reduce.

    Eager form: ``x`` is a SegmentedArray, its segmented dim is reduced
    and the result is a CLONE container.  Local form: ``x`` is this
    rank's tensor and ``comm`` the communicator."""
    if isinstance(x, SegmentedArray):
        rdim = x.dim if reduce_dim is None else reduce_dim
        if rdim != x.dim:
            raise ValueError(f"eager all_reduce_window reduces the segmented "
                             f"dim ({x.dim}); got reduce_dim={rdim}")
        out = _window_local(x.data, window, op, rdim, window_axes, x.group)
        return _clone_container(out, x.comm)
    return _window_local(x, window, op, reduce_dim, window_axes, comm.group)


def _window_local(x, window, op, reduce_dim, window_axes, group):
    if window is not None and op != "sum":
        # the scatter-back fill is zeros, which is only the identity of +
        raise NotImplementedError(
            f"windowed all-reduce supports op='sum' only, got {op!r}")
    if reduce_dim is not None:
        x = _local_reduce(x, reduce_dim, op)
    if window is None:
        return all_reduce_tensor(x, group, op)
    idx = _window_index(x.ndim, window, window_axes)
    out = torch.zeros_like(x)
    out[idx] = all_reduce_tensor(x[idx], group, op)
    return out


def all_reduce_overlap(x, window=None, *, op: str = "sum",
                       reduce_dim: int | None = None, window_axes=None,
                       extras: tuple = (), compute=None, mask=None,
                       comm=None, impl: str = "auto"):
    """Windowed all-reduce fused with scalar piggybacks and the caller's
    independent compute: the communication half of the fused NLINV DGᴴ.

    * ``extras``: scalar partials reduced in the SAME collective as the
      window (packed into its payload, complex or real as each extra is).
    * ``compute``: independent work, run before the collective is issued
      (on the card it is queued ahead of the transfer).
    * ``mask``: a real plane over the window.  Without it the schedule
      is the JAX package's psum: one all-reduce of the packed payload.
      With it the schedule is the paper's ``kern_all_red_p2p_2d``: one
      all-gather of every rank's packed window, then the ``masked_sum``
      kernel sums the G windows in rank order and masks them (``impl``
      goes to it), so every rank computes the same bits.

    Returns ``(reduced, extras_out, compute_out)``; ``compute_out`` is
    ``None`` without ``compute``.  The p2p ring and hierarchical
    schedules are later work."""
    group = comm.group
    if window is not None and op != "sum":
        raise NotImplementedError(
            f"windowed all-reduce supports op='sum' only, got {op!r}")
    if mask is not None and op != "sum":
        raise ValueError("the masked schedule sums; op must be 'sum'")
    if reduce_dim is not None:
        x = _local_reduce(x, reduce_dim, op)
    extras = tuple(torch.as_tensor(e, device=x.device) for e in extras)
    idx = None if window is None else _window_index(x.ndim, window,
                                                    window_axes)
    xw = x if idx is None else x[idx]
    # the independent branch first: nothing after it depends on it
    out = compute() if compute is not None else None
    full = None if idx is None else torch.zeros_like(x)
    if mask is not None:
        # masked_sum writes straight into the zero-filled image's window
        red, ex = _gathered_masked_sum(
            xw, extras, mask, group, impl,
            out=None if full is None else full[idx])
    else:
        red, ex = _psum_packed(xw, extras, op, group)
        if full is not None:
            full[idx] = red
    return (red if full is None else full), ex, out


def _packed(xw, extras):
    """The window and the extras as one flat payload of their common
    type (the JAX package's ``comm.py:700-712`` packing)."""
    dt = xw.dtype
    for e in extras:
        dt = torch.promote_types(dt, e.dtype)
    return torch.cat([xw.reshape(-1).to(dt)] +
                     [e.reshape(1).to(dt) for e in extras])


def _unpack_extras(values, extras):
    """Each extra back in its own type: complex as it is, real from the
    real part (``comm.py:718-720``)."""
    return tuple(values[i] if e.is_complex()
                 else torch.real(values[i]).to(e.dtype)
                 for i, e in enumerate(extras))


def _psum_packed(xw, extras, op, group):
    if group.pg is None:
        return xw, extras
    if not extras:
        return all_reduce_tensor(xw, group, op), ()
    packed = all_reduce_tensor(_packed(xw, extras), group, op)
    n = xw.numel()
    return (packed[:n].reshape(xw.shape).to(xw.dtype),
            _unpack_extras(packed[n:], extras))


def _gathered_masked_sum(xw, extras, mask, group, impl, out=None):
    if group.pg is None:
        return masked_sum(xw[None], mask, impl=impl, out=out), extras
    n = xw.numel()
    rows = all_gather_stack(_packed(xw, extras), group)     # (G, n + k)
    stack = rows[:, :n].view(group.size, *xw.shape)
    if stack.dtype != xw.dtype:
        stack = stack.to(xw.dtype)
    red = masked_sum(stack, mask, impl=impl, out=out)
    ex = _unpack_extras(torch.sum(rows[:, n:], dim=0), extras) \
        if extras else ()
    return red, ex


def vdot(x, y, *, policies=None, comm=None):
    """Segmented inner product ⟨x, y⟩ over mixed CLONE/NATURAL pytrees
    (dicts, in sorted key order), the CG 'scalar products of all data'
    of paper Table 1.

    Eager form: leaves are SegmentedArrays and carry their policies.
    Local form: leaves are this rank's tensors, ``policies`` a matching
    pytree of ``Policy`` (or ``(Policy, dim)``) leaves, ``comm`` the
    communicator.  The per-leaf partials add in leaf order; the
    segmented ones then take one all-reduce, and the CLONE ones count
    once."""
    xl, yl = _leaves(x), _leaves(y)
    if _structure(x) != _structure(y):
        raise ValueError("vdot operands differ in structure")
    if xl and all(isinstance(a, SegmentedArray) for a in xl):
        pols = [a.policy for a in xl]
        group = xl[0].group
        xl, yl = [a.data for a in xl], [b.data for b in yl]
    else:
        pols = ([Policy.NATURAL] * len(xl) if policies is None
                else _leaves(policies))
        if len(pols) != len(xl):
            raise ValueError("policies pytree does not match operands")
        group = comm.group
    clone_part = shard_part = None
    for a, b, p in zip(xl, yl, pols):
        pol = p[0] if isinstance(p, tuple) else p
        v = torch.vdot(a.reshape(-1), b.reshape(-1))
        if pol is Policy.CLONE:
            clone_part = v if clone_part is None else clone_part + v
        else:
            shard_part = v if shard_part is None else shard_part + v
    total = None
    if shard_part is not None:
        total = all_reduce_tensor(shard_part, group)
    if clone_part is not None:
        total = clone_part if total is None else total + clone_part
    return total


def _leaves(tree) -> list:
    """Leaves of nested dicts (sorted keys, JAX's pytree order) and
    lists; a ``(Policy, dim)`` tuple is one leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


# ---------------------------------------------------------------------------
# replication
# ---------------------------------------------------------------------------

def broadcast(x, comm, *, src: int = 0) -> SegmentedArray:
    """Rank ``src``'s array on every rank (-> CLONE container).  Every
    rank passes an array of the same shape and type; only ``src``'s
    values count."""
    data = broadcast_tensor(upload(x, comm.device), comm.group, src)
    return _clone_container(data, comm)


def scatter(x, comm, *, policy: Policy = Policy.NATURAL, dim: int = 0,
            block: int | None = None, src: int = 0) -> SegmentedArray:
    """Split rank ``src``'s array across the group: the other ranks may
    pass ``None``.  Rank ``src`` lays the array out (padding, the
    block-cyclic order), broadcasts the layout, and every rank keeps its
    own segment."""
    group = comm.group
    if group.pg is None:
        return segment(x, comm, policy=policy, dim=dim, block=block)
    meta = [None]
    if comm.rank == src:
        t = upload(x, comm.device)
        layout, orig = physical_layout(t, comm.size, policy, dim, block)
        meta = [(tuple(layout.shape), layout.dtype, orig)]
    dist.broadcast_object_list(meta, src=group.global_rank(src),
                               group=group.pg,
                               device=comm.device
                               if group.backend == "nccl" else None)
    shape, dtype, orig = meta[0]
    if comm.rank != src:
        layout = torch.empty(shape, dtype=dtype, device=comm.device)
    layout = broadcast_tensor(layout, group, src)
    mine = local_segment(layout, comm.rank, comm.size, policy, dim)
    return SegmentedArray(mine.contiguous(), comm, policy, dim, shape, orig,
                          block if policy is Policy.BLOCK else None)


def all_gather(x, *, dim: int | None = None, comm=None):
    """MPI_Allgather.  Eager: a container -> CLONE container of its
    logical array (padding stripped, block-cyclic order undone), along
    its own segmented dim.  Local: every rank's tensor concatenated along
    ``dim`` (default 0) in rank order."""
    if isinstance(x, SegmentedArray):
        if dim is not None and dim != x.dim:
            raise ValueError(f"eager all_gather concatenates the container's "
                             f"segmented dim ({x.dim}); got dim={dim}")
        return _clone_container(_gather(x), x.comm, x.dim)
    stack = all_gather_stack(x, comm.group)
    return torch.cat(list(stack.unbind(0)), dim=0 if dim is None else dim)


# ---------------------------------------------------------------------------
# point to point (the paper's P2P transfer path)
# ---------------------------------------------------------------------------

def ring_perm(nseg: int, offset: int = 1,
              wrap: bool = True) -> list[tuple[int, int]]:
    """(src, dst) pairs shifting every rank by ``offset`` around the ring.
    ``wrap=False`` drops the wrap-around edges (their receivers get
    zeros)."""
    if wrap:
        return [(i, (i + offset) % nseg) for i in range(nseg)]
    return [(i, i + offset) for i in range(nseg) if 0 <= i + offset < nseg]


def _send_recv_local(t: torch.Tensor, perm, group) -> torch.Tensor:
    perm = [tuple(p) for p in perm]
    bad = [p for p in perm if not all(0 <= r < group.size for r in p)]
    if bad:
        raise ValueError(f"send_recv perm pairs {bad} out of range for a "
                         f"{group.size}-rank group")
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"send_recv perm sends twice to one rank: {perm}")
    rank = group.rank
    src_of_me = [s for s, d in perm if d == rank]
    if group.pg is None:
        return t.clone() if src_of_me else torch.zeros_like(t)
    staged = group.p2p_transport == "host-staged"
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.zeros_like(send)
    ops = []
    for s, d in perm:
        if s == rank and d != rank:
            ops.append(dist.P2POp(dist.isend, _wire(send),
                                  group.global_rank(d), group=group.pg))
        if d == rank and s != rank:
            ops.append(dist.P2POp(dist.irecv, _wire(recv),
                                  group.global_rank(s), group=group.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if src_of_me and src_of_me[0] == rank:
        recv = send.clone()
    return recv.to(t.device) if staged else recv


def send_recv(x, perm, *, comm=None):
    """MPI_Sendrecv over segments: for every ``(src, dst)`` pair, rank
    ``src``'s segment goes to rank ``dst``; ranks no pair sends to
    receive zeros (``lax.ppermute``'s rule).  Eager on a container (the
    metadata is kept) or on this rank's tensor with ``comm``.  With gloo
    on the card the segments are staged through the host
    (``DeviceGroup.p2p_transport``)."""
    if isinstance(x, SegmentedArray):
        return x.with_data(_send_recv_local(x.data, perm, x.group))
    return _send_recv_local(x, perm, comm.group)


def shift(x, offset: int = 1, *, wrap: bool = True, comm=None):
    """Ring shift: rank ``i``'s segment moves to rank ``i + offset``
    (modulo the group size when ``wrap``; otherwise the edge ranks
    receive zeros)."""
    size = x.nseg if isinstance(x, SegmentedArray) else comm.size
    return send_recv(x, ring_perm(size, offset, wrap), comm=comm)
