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

Reduction schedules of ``all_reduce_window``/``all_reduce_overlap``:

  psum          one all-reduce of the payload (the extras packed in);
  gathered      (``mask=``) one all-gather of every rank's packed
                window, then the ``masked_sum`` kernel sums the G
                windows in rank order and masks them;
  p2p           the paper's ``kern_all_red_p2p_2d`` transfer schedule:
                G - 1 rounds of ring ``shift``s, with ``compute`` issued
                after the first.  The ring assembles every rank's
                payload in a (G, ...) stack in rank order, and the stack
                is summed in one fixed order (by ``masked_sum`` with
                ``mask=``), so every rank gets the same bits whatever
                ``chunks`` is: the ranks steer their CG loops by them.
                The stack costs G payloads of memory (the JAX ring's
                accumulator and buffer: 2);
  hierarchical  ``hierarchical_psum``: reduce-scatter over the ICI
                axes, all-reduce over the DCN axes, all-gather over
                ICI; the flat sum where the group has no DCN or no ICI
                axis or the leading dim does not tile.

Transfer schedules (the JAX package's are compiled programs in its plan
cache; here a plan is the schedule decision, nothing is compiled per
layout): ``broadcast`` above ``BCAST_SCATTER_MIN_BYTES`` scatters 1/G of
the payload from the source and replicates it with ``BCAST_CHUNKS``
all-gathers; ``reduce``/``all_reduce`` above ``REDUCE_RS_AG_MIN_BYTES``
run reduce-scatter + all-gather; ``copy`` picks a direct collective per
layout pair (``copy_route``).  The decomposed schedules fire only where
the ranks' memories are apart (``DeviceGroup.unified_memory`` False);
``BCAST_SCHEDULE``/``REDUCE_SCHEDULE`` force a choice, as the JAX
module's flags do.

With gloo on the card, the verbs gloo does not take on CUDA tensors
(``runtime.GLOO_CARD_VERBS``) stage through the host, by rule; each such
call is counted in ``STAGED``.

``record()`` lists every collective this process issues inside it, the
verbs' schedules broken down to the collectives they run (one entry a
call: its kind, its bytes, its group size and the mesh axes its line
spans), for the ring model of ``launch.roofline``.  Outside it a
collective pays one call that reads a global.

On a dry group (``DeviceGroup.dry``: a rank of a mesh with no processes,
on the ``meta`` device) each collective notes itself as a real group's
would and returns a meta result of the shape a real group gives.

Complex tensors go on the wire as their real view (``view_as_real``),
which every backend takes and which sums the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from ..kernels.masked_allreduce import masked_sum
from .plan import Plan
from .segmented import (Policy, SegmentedArray, _pad_to, local_segment,
                        physical_layout, segment, upload)
from .segmented import gather as _gather

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# schedule size thresholds (bytes), as the JAX package's
BCAST_SCATTER_MIN_BYTES = 1 << 16   # below: one broadcast from the source
REDUCE_RS_AG_MIN_BYTES = 1 << 16    # below: one flat all-reduce
BCAST_CHUNKS = 4                    # all-gathers of the scattered payload

# Schedule overrides (None = the auto choice above).  Tests and
# experiments force a schedule by setting these module flags:
#   comm.BCAST_SCHEDULE  in {None, "device_put", "scatter_allgather"}
#   comm.REDUCE_SCHEDULE in {None, "psum", "rs_ag"}
BCAST_SCHEDULE: str | None = None
REDUCE_SCHEDULE: str | None = None

# verb -> calls of it that went through the host (gloo on the card)
STAGED: dict[str, int] = {}

# re-export container-level scatter/gather under the verb names (Fig. 3)
gather = _gather

# the collectives issued inside ``record()``; None outside it
_RECORD: list | None = None


@contextlib.contextmanager
def record():
    """Record the collectives this process issues inside the block: yields
    a list that gets one dict a call, ``{"kind", "bytes", "group",
    "axes"}``.
    ``kind`` is ``all_reduce``, ``all_gather``, ``reduce_scatter``,
    ``all_to_all``, ``broadcast``, ``scatter`` or ``send_recv``; ``bytes``
    the buffer the JAX package's HLO shape of it would give (the payload;
    an all-gather's and a reduce-scatter's result; a send's payload);
    ``group`` its ranks; ``axes`` the mesh axes the group's line spans
    (``DeviceGroup.axes``).  A group without a process group issues
    none.
    Records nest: an outer block gets the inner block's entries too."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        if outer is not None:
            outer.extend(_RECORD)
        _RECORD = outer


def _note(kind: str, t: torch.Tensor, group) -> None:
    """One collective of ``t``'s bytes into the open record, if any."""
    if _RECORD is not None:
        _RECORD.append({"kind": kind, "group": group.size,
                        "bytes": t.numel() * t.element_size(),
                        "axes": tuple(group.axes)})


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


def _staged(group, verb: str, fn: Callable, *tensors):
    """``fn(*tensors)`` where the group's backend takes ``verb``: with a
    ``"host-staged"`` transport (``DeviceGroup.transport``) the tensors
    go to the host first and the results come back to their device.
    ``fn`` builds its outputs like its inputs."""
    if group.transport(verb) != "host-staged":
        return fn(*tensors)
    STAGED[verb] = STAGED.get(verb, 0) + 1
    dev = tensors[0].device
    out = fn(*(t.cpu() for t in tensors))
    if isinstance(out, (list, tuple)):
        return type(out)(o.to(dev) for o in out)
    return out.to(dev)


def all_reduce_tensor(t: torch.Tensor, group, op: str = "sum"):
    """``op`` of ``t`` over the group's ranks, as a new tensor on every
    rank (``t`` is left alone); a group without a process group returns
    ``t``."""
    _check_op(op)
    if group.pg is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    _note("all_reduce", out, group)
    if not group.is_dry:
        dist.all_reduce(_wire(out), op=_OPS[op], group=group.pg)
    return out


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``(G, *t.shape)`` on
    every rank; a group without a process group gives ``t[None]``."""
    if group.pg is None:
        return t[None]
    t = t.contiguous()
    out = t.new_empty((group.size, *t.shape))
    _note("all_gather", out, group)
    if not group.is_dry:
        dist.all_gather([_wire(o) for o in out.unbind(0)], _wire(t),
                        group=group.pg)
    return out


def all_gather_tiled(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order."""
    return all_gather_stack(t, group).reshape(-1, *t.shape[1:])


def broadcast_tensor(t: torch.Tensor, group, src: int = 0):
    """Rank ``src``'s ``t`` on every rank, as a new tensor."""
    if group.pg is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    _note("broadcast", out, group)
    if not group.is_dry:
        dist.broadcast(_wire(out), src=group.global_rank(src),
                       group=group.pg)
    return out


def all_to_all_tensor(t: torch.Tensor, group) -> torch.Tensor:
    """MPI_Alltoall of a ``(G, ...)`` stack: ``t[j]`` goes to rank ``j``,
    and row ``i`` of the result came from rank ``i``."""
    if t.shape[0] != group.size:
        raise ValueError(f"all_to_all takes a ({group.size}, ...) stack, "
                         f"got {tuple(t.shape)}")
    if group.pg is None:
        return t
    _note("all_to_all", t, group)

    def run(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        if not group.is_dry:
            dist.all_to_all_single(_wire(out), _wire(x), group=group.pg)
        return out

    return _staged(group, "all_to_all", run, t)


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` splits into G equal chunks
    along ``split_dim``, chunk ``j`` goes to rank ``j``, and the chunks
    received are concatenated along ``concat_dim`` in rank order."""
    n = group.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"tile over {n} ranks")
    if group.pg is None:
        return x
    recv = all_to_all_tensor(torch.stack(x.tensor_split(n, split_dim)),
                             group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


def reduce_scatter_tensor(t: torch.Tensor, group, op: str = "sum"):
    """``op`` of ``t`` over the ranks, of which rank ``i`` keeps the
    ``i``-th of G equal chunks along dim 0 (MPI_Reduce_scatter, tiled).
    ``sum`` is the backend's reduce-scatter; ``max``/``min`` send the
    chunks with one all-to-all and reduce them in rank order."""
    _check_op(op)
    n = group.size
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not tile over "
                         f"{n} ranks")
    if group.pg is None:
        return t
    if op != "sum":
        recv = all_to_all_tensor(t.reshape(n, -1, *t.shape[1:]), group)
        return _local_reduce(recv, 0, op)

    _note("reduce_scatter", t.chunk(n)[0], group)

    def run(x):
        parts = [_wire(c) for c in x.contiguous().chunk(n)]
        out = torch.empty_like(parts[0])
        if not group.is_dry:
            dist.reduce_scatter(out, parts, op=_OPS[op], group=group.pg)
        return torch.view_as_complex(out) if x.is_complex() else out

    return _staged(group, "reduce_scatter", run, t)


def scatter_tensor(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``i``'s ``i``-th of G equal chunks of rank ``src``'s ``t``
    along dim 0 (MPI_Scatter); every rank passes a ``t`` of the shape."""
    n = group.size
    if group.pg is None:
        return t
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not tile over "
                         f"{n} ranks")
    _note("scatter", t, group)

    def run(x):
        x = x.contiguous()
        parts = [_wire(c) for c in x.chunk(n)]
        out = torch.empty_like(x.chunk(n)[0])
        if not group.is_dry:
            dist.scatter(_wire(out), parts if group.rank == src else None,
                         src=group.global_rank(src), group=group.pg)
        return out

    return _staged(group, "scatter", run, t)


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


def _clone_container(data: torch.Tensor, comm, dim: int = 0,
                     orig_len: int | None = None):
    if orig_len is None and data.ndim:
        orig_len = data.shape[dim]
    return SegmentedArray(data, comm, Policy.CLONE, dim, tuple(data.shape),
                          orig_len)


def _plan(op: str, key: tuple, fn: Callable, meta: dict) -> Plan:
    """A transfer plan: the schedule decision and the function that runs
    it.  Nothing is compiled per layout, so it is not cached."""
    return Plan(key=("transfer", op) + key, fn=fn, lib="core", op=op,
                meta=meta)


# ---------------------------------------------------------------------------
# the ring, the hierarchy and the Rabenseifner decomposition
# ---------------------------------------------------------------------------

def _ring_stack(leaves, group, chunks: int = 1, compute=None):
    """Every rank's ``leaves`` assembled in ``(G, *leaf.shape)`` stacks in
    rank order by G - 1 rounds of ring shifts (rank ``r`` receives rank
    ``r - k``'s payload in round ``k``), each leaf's leading dim split in
    ``chunks`` payloads of one round.  ``compute()`` runs after the first
    round.  Returns ``(stacks, compute_out)``."""
    n, rank = group.size, group.rank
    pieces = [list(l.tensor_split(chunks, 0))
              if chunks > 1 and l.ndim and l.shape[0] >= chunks else [l]
              for l in leaves]
    flat = [p.contiguous() for ps in pieces for p in ps]
    rows = [[None] * n for _ in flat]
    for i, p in enumerate(flat):
        rows[i][rank] = p
    out = None
    bufs = flat
    perm = ring_perm(n, 1)
    for step in range(1, n):
        bufs = _send_recv_many(bufs, perm, group)
        for i, b in enumerate(bufs):
            rows[i][(rank - step) % n] = b
        if step == 1 and compute is not None:
            out = compute()
    if compute is not None and n == 1:
        out = compute()
    stacks, k = [], 0
    for ps in pieces:
        parts = [torch.stack(rows[k + j]) for j in range(len(ps))]
        stacks.append(parts[0] if len(parts) == 1
                      else torch.cat(parts, dim=1))
        k += len(ps)
    return stacks, out


def ring_allreduce(x, op: str = "sum", *, chunks: int = 1,
                   compute: Callable | None = None, comm=None):
    """All-reduce as G - 1 rounds of ring ``shift``s: the transfer
    schedule of the paper's ``kern_all_red_p2p_2d``.  ``x`` is a tensor
    or a tuple/list of them (every leaf rides the same rounds).
    ``chunks > 1`` splits each leaf's leading dim into that many payloads
    a round.  ``compute`` is independent work issued after the first
    round; with it the result is ``(reduced, compute_out)``.

    Every rank's payload is assembled in rank order and reduced in one
    fixed order, so every rank gets the same bits, and the bits do not
    depend on ``chunks`` (the JAX ring accumulates in ring order, its
    replicas may differ in the last ulp)."""
    _check_op(op)
    group = comm.group
    if len(group.axes) > 1:
        raise ValueError("p2p ring reduction is single-axis")
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    leaves = [torch.as_tensor(l) for l in leaves]
    stacks, out = _ring_stack(leaves, group, chunks, compute)
    red = [_local_reduce(s, 0, op) for s in stacks]
    red = type(x)(red) if isinstance(x, (tuple, list)) else red[0]
    return red if compute is None else (red, out)


def _hier_axes(x: torch.Tensor, group):
    """The (ICI, DCN) axes ``hierarchical_psum`` stages over, or ``None``
    where it takes the flat sum (no DCN or no ICI axis of extent > 1, or
    a leading dim that does not tile over the ICI ranks)."""
    ici = [a for a in group.ici_axes if group.axis_size(a) > 1]
    dcn = [a for a in group.dcn_axes if group.axis_size(a) > 1]
    n_ici = math.prod(group.axis_size(a) for a in ici)
    if not dcn or not ici or x.ndim == 0 or x.shape[0] % n_ici:
        return None
    return ici, dcn


def hierarchical_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group decomposed by topology: reduce-scatter over
    the ICI axes, all-reduce over the DCN axes, all-gather back over ICI,
    so each slow (DCN) link carries 1/n_ici of the payload.  The flat
    all-reduce where that does not apply (``_hier_axes``)."""
    axes = _hier_axes(x, group)
    if axes is None:
        return all_reduce_tensor(x, group)
    ici, dcn = axes
    for a in ici:
        x = reduce_scatter_tensor(x, group.sub(a))
    for a in dcn:
        x = all_reduce_tensor(x, group.sub(a))
    for a in reversed(ici):
        x = all_gather_tiled(x, group.sub(a))
    return x


def _psum_rs_ag(x: torch.Tensor, group) -> torch.Tensor:
    """The sum decomposed Rabenseifner-style: reduce-scatter then
    all-gather along dim 0 (each link carries about 2 (G - 1) / G of one
    payload); dim 0 must tile over the group."""
    return all_gather_tiled(reduce_scatter_tensor(x, group), group)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_schedule(seg: SegmentedArray, op: str) -> tuple[str, int]:
    """The reduction schedule for a merged payload: ``rs_ag`` where the
    ranks' memories are apart, the payload is big enough and its leading
    dim tiles over the group, else ``psum``.  ``REDUCE_SCHEDULE`` forces
    a choice (tiling still required).  Returns (schedule, bytes)."""
    merged = [d for i, d in enumerate(seg.global_shape) if i != seg.dim]
    nbytes = int(math.prod(merged)) * seg.data.element_size()
    eligible = (op == "sum" and seg.nseg > 1 and bool(merged)
                and merged[0] % seg.nseg == 0)
    if REDUCE_SCHEDULE is not None:
        return (("rs_ag" if REDUCE_SCHEDULE == "rs_ag" and eligible
                 else "psum"), nbytes)
    if (eligible and not seg.group.unified_memory
            and nbytes >= REDUCE_RS_AG_MIN_BYTES):
        return "rs_ag", nbytes
    return "psum", nbytes


def plan_reduce(seg: SegmentedArray, op: str = "sum") -> Plan:
    """The eager ``reduce`` of this layout: a local reduce of the
    segmented dim, then ``psum`` or ``rs_ag`` (``_reduce_schedule``);
    ``meta`` records the choice."""
    schedule, nbytes = _reduce_schedule(seg, op)

    def fn(s):
        return _window_local(s.data, None, op, s.dim, None, s.group,
                             rs_ag=schedule == "rs_ag")

    return _plan("reduce", (op, schedule), fn,
                 {"schedule": schedule, "payload_bytes": nbytes,
                  "threshold_bytes": REDUCE_RS_AG_MIN_BYTES})


def reduce(seg: SegmentedArray, op: str = "sum") -> torch.Tensor:
    """Merge the segments elementwise into one local array (paper Fig.
    3/5): the segmented dim is reduced away, the result on every rank."""
    return plan_reduce(seg, op)(seg)


def all_reduce(seg: SegmentedArray, op: str = "sum",
               hierarchical: bool = False,
               p2p: bool = False) -> SegmentedArray:
    """Like ``reduce`` but the result is a CLONE container on every rank
    (the paper's Σ ρ_g all-reduce).  ``p2p=True`` runs it as the ring of
    ``shift``s, ``hierarchical=True`` staged by topology."""
    return all_reduce_window(seg, None, op=op, hierarchical=hierarchical,
                             p2p=p2p)


def all_reduce_window(x, window=None, *, op: str = "sum",
                      reduce_dim: int | None = None, window_axes=None,
                      hierarchical: bool = False, p2p: bool = False,
                      comm=None):
    """Windowed all-reduce, the paper's ``kern_all_red_p2p_2d`` as a
    primitive: reduce ``reduce_dim`` locally, all-reduce only
    ``window`` ((lo, hi) per trailing dim, or on ``window_axes``) and
    return it scattered back into zeros.  ``window=None`` is a plain
    all-reduce; ``p2p`` and ``hierarchical`` pick those schedules.

    Eager form: ``x`` is a SegmentedArray, its segmented dim is reduced
    and the result is a CLONE container (a plain one takes
    ``_reduce_schedule``).  Local form: ``x`` is this rank's tensor and
    ``comm`` the communicator."""
    if isinstance(x, SegmentedArray):
        rdim = x.dim if reduce_dim is None else reduce_dim
        if rdim != x.dim:
            raise ValueError(f"eager all_reduce_window reduces the segmented "
                             f"dim ({x.dim}); got reduce_dim={rdim}")
        plain = window is None and not p2p and not hierarchical
        rs_ag = plain and _reduce_schedule(x, op)[0] == "rs_ag"
        out = _window_local(x.data, window, op, rdim, window_axes, x.group,
                            hierarchical, p2p, rs_ag)
        return _clone_container(out, x.comm)
    return _window_local(x, window, op, reduce_dim, window_axes, comm.group,
                         hierarchical, p2p)


def _check_schedules(p2p: bool, hierarchical: bool) -> None:
    if p2p and hierarchical:
        raise ValueError("p2p and hierarchical are mutually exclusive "
                         "reduction schedules")


def _window_local(x, window, op, reduce_dim, window_axes, group,
                  hierarchical=False, p2p=False, rs_ag=False):
    _check_schedules(p2p, hierarchical)
    if window is not None and op != "sum":
        # the scatter-back fill is zeros, which is only the identity of +
        raise NotImplementedError(
            f"windowed all-reduce supports op='sum' only, got {op!r}")
    if p2p and len(group.axes) > 1:
        raise ValueError("p2p ring reduction is single-axis")
    if reduce_dim is not None:
        x = _local_reduce(x, reduce_dim, op)

    def part(v):
        if group.pg is None:
            return v
        if p2p:
            return _local_reduce(_ring_stack([v], group)[0][0], 0, op)
        if hierarchical and op == "sum":
            return hierarchical_psum(v, group)
        if rs_ag and op == "sum":
            return _psum_rs_ag(v, group)
        return all_reduce_tensor(v, group, op)

    if window is None:
        return part(x)
    idx = _window_index(x.ndim, window, window_axes)
    out = torch.zeros_like(x)
    out[idx] = part(x[idx].contiguous())
    return out


def all_reduce_overlap(x, window=None, *, op: str = "sum",
                       reduce_dim: int | None = None, window_axes=None,
                       extras: tuple = (), compute=None, mask=None,
                       p2p: bool = False, chunks: int = 2,
                       hierarchical: bool = False, comm=None,
                       impl: str = "auto", block=None):
    """Windowed all-reduce fused with scalar piggybacks and the caller's
    independent compute: the communication half of the fused NLINV DGᴴ.

    ``x`` may carry a leading batch of B rows (the batched frame's
    clients, (B, X, Y)): the window is taken on the trailing dims, and
    the rows share one collective (one rendezvous for all B, as the JAX
    package's vmapped frame coalesces its psums).

    * ``extras``: scalar partials, or (B,) vectors a row each, reduced
      with the window (packed into its payload, complex or real as each
      extra is, summed in rank order with the gathered schedule; in a sum
      of their own under ``hierarchical``).
    * ``compute``: independent work, issued before the collective (on
      the card it is queued ahead of the transfer), or after the ring's
      first round with ``p2p``.
    * ``mask``: a real plane over the window that the sum is masked by
      (every row by the same plane), in the ``masked_sum`` kernel, one
      launch for all rows (``impl`` and ``block`` go to it).
    * the schedule (module docstring): psum, or with ``mask`` the
      gathered one; ``p2p=True`` the ring in ``chunks`` payloads a
      round, whose stack ``masked_sum`` (or the sum) reduces, bitwise
      the gathered schedule; ``hierarchical=True`` the staged sum, then
      ``mask`` applied by ``masked_sum`` over a stack of one (where the
      staged sum does not apply: the schedule without it).

    Returns ``(reduced, extras_out, compute_out)``; ``compute_out`` is
    ``None`` without ``compute``."""
    group = comm.group
    _check_schedules(p2p, hierarchical)
    if window is not None and op != "sum":
        raise NotImplementedError(
            f"windowed all-reduce supports op='sum' only, got {op!r}")
    if mask is not None and op != "sum":
        raise ValueError("the masked schedule sums; op must be 'sum'")
    if p2p and len(group.axes) > 1:
        raise ValueError("p2p ring reduction is single-axis")
    if reduce_dim is not None:
        x = _local_reduce(x, reduce_dim, op)
    extras = tuple(torch.as_tensor(e, device=x.device) for e in extras)
    idx = None if window is None else _window_index(x.ndim, window,
                                                    window_axes)
    xw = x if idx is None else x[idx]
    full = None if idx is None else torch.zeros_like(x)
    target = None if full is None else full[idx]
    out = None
    if p2p:
        if mask is not None:
            # the gathered schedule with the ring assembling the rows
            red, ex, out = _stacked_masked_sum(
                xw, extras, mask, group, impl, target,
                lambda t: _ring_stack([t], group, chunks, compute), block)
        else:
            payload = (xw.contiguous(), *extras)
            if compute is None:
                packed = ring_allreduce(payload, op, chunks=chunks,
                                        comm=comm)
            else:
                packed, out = ring_allreduce(payload, op, chunks=chunks,
                                             compute=compute, comm=comm)
            red, ex = packed[0], tuple(packed[1:])
    else:
        # the independent branch first: nothing after it depends on it
        out = compute() if compute is not None else None
        # a leading batch of rows stages as more rows of the window, so
        # that it tiles over the ICI ranks whenever one window does
        rows2d = xw.reshape(-1, xw.shape[-1]) if xw.ndim > 2 else xw
        hier = hierarchical and op == "sum" and group.pg is not None and \
            _hier_axes(rows2d, group) is not None
        if hier:
            red = hierarchical_psum(rows2d.contiguous(),
                                    group).view(xw.shape)
            if mask is not None:
                red = masked_sum(red[None], mask, impl=impl, out=target,
                                 block=block)
            ex = _unpack_extras(all_reduce_tensor(
                _packed(xw.new_empty(0), extras), group), extras) \
                if extras else ()
        elif mask is not None:
            # masked_sum writes straight into the zero-filled image's window
            red, ex, _ = _stacked_masked_sum(
                xw, extras, mask, group, impl, target,
                lambda t: ([all_gather_stack(t, group)], None), block)
        else:
            red, ex = _psum_packed(xw, extras, op, group)
    if full is not None and red is not target:
        full[idx] = red
    return (red if full is None else full), ex, out


def _packed(xw, extras):
    """The window and the extras as one flat payload of their common
    type (the JAX package's ``comm.py:700-712`` packing)."""
    dt = xw.dtype
    for e in extras:
        dt = torch.promote_types(dt, e.dtype)
    return torch.cat([xw.reshape(-1).to(dt)] +
                     [e.reshape(-1).to(dt) for e in extras])


def _unpack_extras(values, extras):
    """Each extra back in its own shape and type (a scalar, or a (B,)
    vector a row each): complex as it is, real from the real part
    (``comm.py:718-720``)."""
    out, i = [], 0
    for e in extras:
        v = values[i:i + e.numel()].reshape(e.shape)
        i += e.numel()
        out.append(v if e.is_complex() else torch.real(v).to(e.dtype))
    return tuple(out)


def _rank_sum(rows):
    """The sum over dim 0 of a (G, ...) stack, added in rank order
    ``((r0 + r1) + r2) + ...``: one association whatever the rows' shape,
    so that a batched payload's row sums to the unbatched payload's bits."""
    acc = rows[0]
    for g in range(1, rows.shape[0]):
        acc = acc + rows[g]
    return acc


def _psum_packed(xw, extras, op, group):
    if group.pg is None:
        return xw, extras
    if not extras:
        return all_reduce_tensor(xw, group, op), ()
    packed = all_reduce_tensor(_packed(xw, extras), group, op)
    n = xw.numel()
    return (packed[:n].reshape(xw.shape).to(xw.dtype),
            _unpack_extras(packed[n:], extras))


def _stacked_masked_sum(xw, extras, mask, group, impl, out, stack_rows,
                        block=None):
    """Every rank's packed window and extras stacked in rank order by
    ``stack_rows(payload) -> ([(G, n + k) rows], compute_out)``; the
    windows (one, or a leading batch of B) summed and masked by one
    ``masked_sum`` launch in rank order, the extras summed in rank order.
    Returns ``(reduced, extras, compute_out)``."""
    if group.pg is None:
        rows, cout = stack_rows(xw.reshape(-1))
        return (masked_sum(xw[None], mask, impl=impl, out=out, block=block),
                extras, cout)
    n = xw.numel()
    (rows,), cout = stack_rows(_packed(xw, extras))         # (G, n + k)
    stack = rows[:, :n].view(group.size, *xw.shape)
    if stack.dtype != xw.dtype:
        stack = stack.to(xw.dtype)
    red = masked_sum(stack, mask, impl=impl, out=out, block=block)
    ex = _unpack_extras(_rank_sum(rows[:, n:]), extras) if extras else ()
    return red, ex, cout


def vdot(x, y, *, policies=None, comm=None, batched: bool = False):
    """Segmented inner product ⟨x, y⟩ over mixed CLONE/NATURAL pytrees
    (dicts, in sorted key order), the CG 'scalar products of all data'
    of paper Table 1.

    Eager form: leaves are SegmentedArrays and carry their policies.
    Local form: leaves are this rank's tensors, ``policies`` a matching
    pytree of ``Policy`` (or ``(Policy, dim)``) leaves, ``comm`` the
    communicator.  The per-leaf partials add in leaf order; the
    segmented ones then take one all-reduce, and the CLONE ones count
    once.

    ``batched`` (local form): every leaf carries a leading batch of B
    rows (a segmented leaf's split one dim further in, as the JAX
    package's ``U_POLICIES_BATCHED`` has it), and the result is (B,), one
    product a row, each row's partial the bits of the unbatched row's;
    the rows' segmented partials share one all-reduce."""
    xl, yl = _leaves(x), _leaves(y)
    if _structure(x) != _structure(y):
        raise ValueError("vdot operands differ in structure")
    if xl and all(isinstance(a, SegmentedArray) for a in xl):
        if batched:
            raise ValueError("batched vdot takes this rank's tensors")
        pols = [a.policy for a in xl]
        group = xl[0].group
        xl, yl = [a.data for a in xl], [b.data for b in yl]
    else:
        pols = ([Policy.NATURAL] * len(xl) if policies is None
                else _leaves(policies))
        if len(pols) != len(xl):
            raise ValueError("policies pytree does not match operands")
        group = comm.group

    def dot(a, b):
        if not batched:
            return torch.vdot(a.reshape(-1), b.reshape(-1))
        return torch.stack([torch.vdot(a[r].reshape(-1), b[r].reshape(-1))
                            for r in range(a.shape[0])])

    clone_part = shard_part = None
    for a, b, p in zip(xl, yl, pols):
        pol = p[0] if isinstance(p, tuple) else p
        v = dot(a, b)
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

def bcast_schedule(group, nbytes: int) -> str:
    """The broadcast schedule for this group and payload:
    ``scatter_allgather`` where the ranks' memories are apart and the
    payload is at least ``BCAST_SCATTER_MIN_BYTES``, else ``device_put``
    (one broadcast from the source).  ``BCAST_SCHEDULE`` forces a
    choice; one rank always takes ``device_put``."""
    if group.size == 1:
        return "device_put"
    if BCAST_SCHEDULE is not None:
        return BCAST_SCHEDULE
    if group.unified_memory or nbytes < BCAST_SCATTER_MIN_BYTES:
        return "device_put"
    return "scatter_allgather"


def plan_broadcast(shape, dtype, comm, src: int = 0) -> Plan:
    """The scatter + all-gather broadcast of a payload of ``shape``: rank
    ``src`` scatters 1/G of the flattened (zero-padded) payload to every
    rank, and ``chunks`` all-gathers, each of a slice of every rank's
    share, replicate it; the slices are re-interleaved into order."""
    group = comm.group
    n = group.size
    size = int(math.prod(shape))
    shard = math.ceil(size / n)
    chunks = next(c for c in (BCAST_CHUNKS, 2, 1)
                  if shard % c == 0 and c <= shard)

    def fn(t):
        flat = t.reshape(-1)
        if shard * n != size:
            flat = torch.cat([flat, flat.new_zeros(shard * n - size)])
        mine = scatter_tensor(flat, group, src)
        parts = [all_gather_stack(p.contiguous(), group)
                 for p in mine.chunk(chunks)]
        return torch.cat(parts, dim=1).reshape(-1)[:size].reshape(shape)

    return _plan("bcast", (tuple(shape), str(dtype), n, src), fn,
                 {"schedule": "scatter_allgather", "chunks": chunks,
                  "threshold_bytes": BCAST_SCATTER_MIN_BYTES})


def broadcast(x, comm, *, src: int = 0) -> SegmentedArray:
    """Rank ``src``'s array on every rank (-> CLONE container).  Every
    rank passes an array of the same shape and type; only ``src``'s
    values count.  The schedule is ``bcast_schedule``'s."""
    t = upload(x, comm.device)
    nbytes = t.numel() * t.element_size()
    if t.ndim == 0 or bcast_schedule(comm.group, nbytes) == "device_put":
        data = broadcast_tensor(t, comm.group, src)
    else:
        data = plan_broadcast(t.shape, t.dtype, comm, src)(t)
    return _clone_container(data, comm)


def scatter(x, comm, *, policy: Policy = Policy.NATURAL, dim: int = 0,
            block: int | None = None, halo: int = 0,
            src: int = 0) -> SegmentedArray:
    """Split rank ``src``'s array across the group: the other ranks may
    pass ``None``.  Rank ``src`` lays the array out (padding, the
    block-cyclic order), broadcasts the layout, and every rank keeps its
    own segment."""
    group = comm.group
    if group.pg is None:
        return segment(x, comm, policy=policy, dim=dim, block=block,
                       halo=halo)
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
                          block if policy is Policy.BLOCK else None,
                          halo if policy is Policy.OVERLAP2D else 0)


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
# copy (paper Fig. 3): re-segmentation by a direct collective per layout
# ---------------------------------------------------------------------------

_SPLIT = (Policy.NATURAL, Policy.OVERLAP2D)


def _copy_resolve(src, policy, dim, block, halo):
    """Fill defaults from ``src`` and validate the destination layout."""
    policy = src.policy if policy is None else policy
    dim = src.dim if dim is None else dim
    if policy is Policy.BLOCK:
        block = src.block if block is None else block
        if block is None:
            raise ValueError("copy to BLOCK requires block=")
    else:
        block = None
    if halo is not None and policy is not Policy.OVERLAP2D:
        raise ValueError("halo= is only meaningful for OVERLAP2D targets")
    if halo is None and policy is Policy.OVERLAP2D:
        halo = src.halo
    halo = halo if policy is Policy.OVERLAP2D else 0
    return policy, dim, block, halo


def _block_aligned(total: int, nseg: int, block: int) -> bool:
    """Can NATURAL<->BLOCK re-segmentation run as one uniform all-to-all?
    The padded length must tile into ``nseg * block`` and the blocks a
    rank holds into ``nseg``."""
    if total % (nseg * block) != 0:
        return False
    return (total // (nseg * block)) % nseg == 0


def _copy_route(src: SegmentedArray, policy, dim, block, halo) -> str:
    sp = src.policy
    unpadded = (src.orig_len is None
                or src.orig_len == src.global_shape[src.dim])
    if sp is Policy.CLONE:
        if policy is Policy.CLONE:
            if dim == src.dim:
                return "alias"
            return "meta" if unpadded else "rebuild"
        return "clone_split"                  # local slice, no collective
    if policy is Policy.CLONE:
        return "replicate" if sp in _SPLIT and dim == src.dim else "rebuild"
    if sp in _SPLIT and policy in _SPLIT:
        return "meta" if dim == src.dim else "alltoall"
    if dim != src.dim:
        return "rebuild"                      # BLOCK endpoint + dim change
    total = src.global_shape[dim]
    if sp in _SPLIT and policy is Policy.BLOCK:
        return ("block_pack" if _block_aligned(total, src.nseg, block)
                else "rebuild")
    if sp is Policy.BLOCK and policy in _SPLIT:
        return ("block_unpack" if _block_aligned(total, src.nseg, src.block)
                else "rebuild")
    if sp is Policy.BLOCK and policy is Policy.BLOCK:
        return "alias" if block == src.block else "rebuild"
    return "rebuild"


def copy_route(src: SegmentedArray, *, policy: Policy | None = None,
               dim: int | None = None, block: int | None = None,
               halo: int | None = None) -> str:
    """The transfer schedule ``copy`` picks for this re-segmentation:

    ``alias``         same layout: metadata only, nothing moves
    ``meta``          a layout-compatible relabel (NATURAL<->OVERLAP2D,
                      a halo-only change, an unpadded CLONE's dim)
    ``clone_split``   CLONE -> split: every rank slices its own segment
    ``replicate``     split -> CLONE: one all-gather
    ``alltoall``      a change of segmented dim: one all-to-all
    ``block_pack``    NATURAL -> BLOCK, aligned: one uniform all-to-all
    ``block_unpack``  BLOCK -> NATURAL, aligned: one uniform all-to-all
    ``rebuild``       through the logical array (gather, re-segment)
    """
    policy, dim, block, halo = _copy_resolve(src, policy, dim, block, halo)
    return _copy_route(src, policy, dim, block, halo)


def _clone_split(src, policy, dim, block, halo):
    x = src.data
    if src.orig_len is not None and src.orig_len != x.shape[src.dim]:
        x = x.narrow(src.dim, 0, src.orig_len)
    layout, orig = physical_layout(x, src.nseg, policy, dim, block)
    mine = local_segment(layout, src.rank, src.nseg, policy, dim)
    return SegmentedArray(mine.contiguous(), src.comm, policy, dim,
                          tuple(layout.shape), orig, block, halo)


def _block_exchange(src, policy, block, halo, pack: bool):
    """Aligned NATURAL<->BLOCK as one uniform all-to-all: with ``m``
    blocks a rank (``m % G == 0``), a NATURAL rank's local block ``j``
    goes to rank ``j % G`` and lands source-major; unpacking sends
    contiguous chunks of ``m / G`` blocks and interleaves them back."""
    n, dim = src.nseg, src.dim
    b = block if pack else src.block
    m = src.global_shape[dim] // (n * b)            # blocks a rank
    xm = torch.movedim(src.data, dim, 0)
    rest = xm.shape[1:]
    if pack:
        t = xm.reshape(m // n, n, b, *rest).movedim(1, 0)
        r = all_to_all_tiled(t.reshape(m * b, *rest), 0, 0, src.group)
    else:
        r = all_to_all_tiled(xm, 0, 0, src.group)
        r = r.reshape(n, m // n, b, *rest).movedim(0, 1).reshape(m * b,
                                                                 *rest)
    orig = src.orig_len if src.orig_len is not None else \
        src.global_shape[dim]
    return SegmentedArray(torch.movedim(r, 0, dim).contiguous(), src.comm,
                          policy, dim, src.global_shape, orig, block, halo)


def copy(src: SegmentedArray, *, policy: Policy | None = None,
         dim: int | None = None, block: int | None = None,
         halo: int | None = None) -> SegmentedArray:
    """Segmented-to-segmented copy (paper Fig. 3), i.e. re-segmentation,
    by the route ``copy_route`` names.  The direct routes keep the
    source's physical padding (``orig_len`` stays truthful); only
    global relayouts (unaligned block-cyclic, a padded CLONE's dim
    change) go through the logical array."""
    policy, dim, block, halo = _copy_resolve(src, policy, dim, block, halo)
    route = _copy_route(src, policy, dim, block, halo)
    if route == "rebuild":
        return segment(gather(src), src.comm, policy=policy, dim=dim,
                       block=block, halo=halo)
    if route == "alias":
        return dataclasses.replace(src, policy=policy, dim=dim, block=block,
                                   halo=halo)
    if route == "meta":
        if src.policy is Policy.CLONE:        # CLONE dim change (unpadded)
            return dataclasses.replace(src, dim=dim,
                                       orig_len=src.global_shape[dim])
        return dataclasses.replace(src, policy=policy, halo=halo)
    if route == "clone_split":
        return _clone_split(src, policy, dim, block, halo)
    if route == "replicate":
        full = all_gather_stack(src.data, src.group)
        full = torch.cat(list(full.unbind(0)), dim=src.dim)
        return _clone_container(full, src.comm, dim, src.orig_len)
    if route == "alltoall":
        work = src if src.policy is Policy.NATURAL else \
            dataclasses.replace(src, policy=Policy.NATURAL, halo=0)
        res = all_to_all(work, dim)
        return dataclasses.replace(res, policy=policy, halo=halo)
    return _block_exchange(src, policy, block, halo, route == "block_pack")


def plan_all_to_all(seg: SegmentedArray, new_dim: int) -> Plan:
    """The all-to-all re-segmentation of this layout: ``new_dim`` padded
    to tile over the group, one all-to-all, the old dim's padding (now
    local to every rank) sliced away."""
    sdim, sorig, n = seg.dim, seg.orig_len, seg.nseg

    def fn(x):
        x, _ = _pad_to(x, new_dim, n)
        y = all_to_all_tiled(x, new_dim, sdim, seg.group)
        if sorig is not None and sorig != y.shape[sdim]:
            y = y.narrow(sdim, 0, sorig)
        return y.contiguous()

    return _plan("all_to_all", (int(new_dim),), fn,
                 {"schedule": "all_to_all"})


def all_to_all(seg: SegmentedArray, new_dim: int) -> SegmentedArray:
    """Re-segment a NATURAL container from ``seg.dim`` to ``new_dim``
    with an all-to-all (MPI_Alltoall; the FFT transposes use it).
    ``new_dim`` is padded to tile over the group and its pre-padding
    length becomes ``orig_len``; the old dim's padding is sliced away."""
    if seg.policy is not Policy.NATURAL:
        raise ValueError(f"all_to_all requires a NATURAL container, "
                         f"got {seg.policy}")
    if new_dim == seg.dim:
        return seg
    data = plan_all_to_all(seg, new_dim)(seg.data)
    shape = list(seg.global_shape)
    shape[new_dim] = data.shape[new_dim] * seg.nseg
    shape[seg.dim] = data.shape[seg.dim]
    return dataclasses.replace(seg, data=data, dim=new_dim,
                               global_shape=tuple(shape),
                               orig_len=seg.global_shape[new_dim])


_REDUCE_SCATTER_OPS = ("sum", "max", "min")


def plan_reduce_scatter(seg: SegmentedArray, op: str = "sum") -> Plan:
    """The reduce-scatter of this layout: a local reduce of the
    segmented dim, dim 0 of the rest padded to tile, then the backend's
    reduce-scatter (``sum``) or one all-to-all and a local reduce in rank
    order (``max``/``min``)."""
    if op not in _REDUCE_SCATTER_OPS:
        raise ValueError(f"reduce_scatter supports {_REDUCE_SCATTER_OPS}, "
                         f"got {op!r}")

    def fn(x):
        x = _local_reduce(x, seg.dim, op)
        x, _ = _pad_to(x, 0, seg.nseg)
        return reduce_scatter_tensor(x, seg.group, op)

    return _plan("reduce_scatter", (op,), fn,
                 {"schedule": ("psum_scatter" if op == "sum"
                               else f"alltoall_{op}")})


def reduce_scatter(seg: SegmentedArray, op: str = "sum") -> SegmentedArray:
    """Reduce the segments and leave the result segmented along dim 0 of
    the merged array (MPI_Reduce_scatter); ``op`` is ``sum``, ``max`` or
    ``min``."""
    merged = [d for i, d in enumerate(seg.global_shape) if i != seg.dim]
    data = plan_reduce_scatter(seg, op)(seg.data)
    shape = (data.shape[0] * seg.nseg, *merged[1:])
    return SegmentedArray(data, seg.comm, Policy.NATURAL, 0, shape,
                          merged[0])


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


def _send_recv_many(ts, perm, group) -> list[torch.Tensor]:
    """``send_recv`` of several tensors in one batch of transfers (a tag
    each), by one permutation."""
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
        return [t.clone() if src_of_me else torch.zeros_like(t) for t in ts]
    if any(s == rank and d != rank for s, d in perm):
        for t in ts:
            _note("send_recv", t, group)

    def run(*sends):
        sends = [t.contiguous() for t in sends]
        recvs = [torch.zeros_like(t) for t in sends]
        ops = []
        for s, d in ([] if group.is_dry else perm):
            for tag, (snd, rcv) in enumerate(zip(sends, recvs)):
                if s == rank and d != rank:
                    ops.append(dist.P2POp(dist.isend, _wire(snd),
                                          group.global_rank(d),
                                          group=group.pg, tag=tag))
                if d == rank and s != rank:
                    ops.append(dist.P2POp(dist.irecv, _wire(rcv),
                                          group.global_rank(s),
                                          group=group.pg, tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if src_of_me and src_of_me[0] == rank:
            recvs = [t.clone() for t in sends]
        return recvs

    return _staged(group, "send_recv", run, *ts)


def send_recv(x, perm, *, comm=None):
    """MPI_Sendrecv over segments: for every ``(src, dst)`` pair, rank
    ``src``'s segment goes to rank ``dst``; ranks no pair sends to
    receive zeros (``lax.ppermute``'s rule).  Eager on a container (the
    metadata is kept) or on this rank's tensor with ``comm``.  With gloo
    on the card the segments are staged through the host
    (``DeviceGroup.p2p_transport``)."""
    if isinstance(x, SegmentedArray):
        return x.with_data(_send_recv_many([x.data], perm, x.group)[0])
    return _send_recv_many([x], perm, comm.group)[0]


def shift(x, offset: int = 1, *, wrap: bool = True, comm=None):
    """Ring shift: rank ``i``'s segment moves to rank ``i + offset``
    (modulo the group size when ``wrap``; otherwise the edge ranks
    receive zeros).  Halo exchange is two ``shift``s with
    ``wrap=False``."""
    size = x.nseg if isinstance(x, SegmentedArray) else comm.size
    return send_recv(x, ring_perm(size, offset, wrap), comm=comm)
