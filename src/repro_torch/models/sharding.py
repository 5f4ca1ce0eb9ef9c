"""Tensor-parallel serving and training on the multi-rank core: the
weights, KV caches and recurrent states of an LM split over a ``(data,
model)`` mesh of ``torch.distributed`` ranks by the JAX package's own
specs (``transformer.param_pspecs``, ``cache_pspecs``).

The JAX package places its parameters and caches with ``NamedSharding``
and lets GSPMD choose the collectives (``repro/serve/engine.py:45-63``,
``repro/train/trainer.py:39-102``).  The port runs one process per rank,
so this module says what a rank holds and what a step does with it.

Storage follows the spec: a rank holds the slice of each leaf that the
spec gives its coordinates on the mesh, and nothing else
(:func:`assemble`, :func:`shard_params`, :func:`init_shards`).  At use,
:class:`Sharding` gathers a weight over the FSDP axes (``"data"``, and
``"pod"`` on a 3-axis mesh) for that one use and drops it after, as GSPMD
does with ``fsdp=batch_axes``; over ``"model"`` the step computes on the
local shard where the layer allows:

- column-split projections (the spec puts ``"model"`` on the last dim:
  ``wq``/``wk``/``wv``, ``gate``/``up``, the router, the recurrent blocks'
  up-projections) give this rank's columns; row-split ones
  (``wo``/``down``/``wuv``/``wuk``) take this rank's rows and one
  all-reduce over ``"model"`` sums the partials;
- the vocabulary-split ``embed``/``lm_head``: a masked lookup and an
  all-reduce, and local logits and an all-gather;
- the experts split over ``"model"``: each rank runs its own experts on
  the dispatch of every token (the capacity is the unsharded one, so the
  MoE layer gathers its tokens over the data axes), and the outputs are
  summed over ``"model"`` with the shared experts' partials;
- attention runs head-local where both ``n_heads`` and ``n_kv_heads``
  divide the model axis; where the spec splits a head the step gathers
  that activation over ``"model"`` and every rank runs all heads;
- the RG-LRU runs on this rank's channels of the LRU width and the mLSTM
  on its heads where they divide the model axis (all heads, gathered,
  where they do not); the sLSTM cell, a loop over time with no kernel,
  runs whole on every rank;
- the KV cache is split over time (``kv_shard="seq"``): a prefill writes
  each rank's own slice, a decode step writes the new k/v on the rank
  whose slice holds the slot, and each rank's softmax partials over its
  slice (``decode_partial``) merge over ``"model"``.  MLA decompresses
  its own slice of the latents; cross caches split over the encoder's
  positions.  Where ``cache_pspecs`` falls back to a trailing dim (the
  time dim does not divide), that one layer's k/v is gathered for the
  attention and each rank writes its own part of the trailing dim.  A
  recurrent state whose split is not the one its block computes on
  (the mLSTM's ``C`` over ``dv`` and ``n`` over ``dk``, its heads on the
  ranks) is gathered over ``"model"`` for the block and each rank keeps
  its own part of the new state (:meth:`Sharding.state_get`,
  :meth:`Sharding.state_put`).

Sequence parallelism (Megatron's, the JAX package's ``apply(
act_sharding=)`` with the sequence dim on ``"model"``;
:meth:`Sharding.seq_parallel`): between the blocks the residual stream
holds this rank's slice of the sequence over ``"model"``, so that its
norms and sums run on a slice.  A block's input is all-gathered over the
sequence (``seq_in``), the block runs as without it on the whole
sequence, and its output lands on the slice (``to_residual``): a row-split
output's partial sums by one reduce-scatter instead of ``psum``'s
all-reduce, a replicated one by taking this rank's slice.  The
vocabulary-split ``embed`` reduce-scatters too, and the head gathers the
sequence back (a prefill's last window comes from the last model rank).

Where a weight's spec does not match the use (the model axis on another
dim, or a dim that does not divide) the weight is gathered whole for that
use.  The batch is split over the data axes (tokens, cache, frontend
embeddings) when it divides, and the logits come back whole on every
rank.

A stacked leaf of the JAX tree (a repeated group's ``(reps, ...)``) can
put an axis on its ``reps`` dim (qwen3-0.6b's ``(28, 1024)`` norms on a
``(2, 2)`` mesh get ``P("data", "model")``).  The port unrolls the layers,
so it replicates each layer's slice over the axes of that dim and keeps
the split of its other dims: ``stacked_replicated_bytes`` counts the bytes
this adds against the JAX spec.

Collectives go through ``repro_torch.core.comm`` on the mesh's
``DeviceGroup`` lines: all-reduce, all-gather and the gathers' stacks,
which gloo also runs on CUDA tensors (ranks that share one card), and
the backward's reduce-scatter, which gloo stages through the host there.

Gradients through the collectives.  Each collective of the forward is a
``torch.autograd.Function`` whose backward is the adjoint for what
consumes its output on that axis.  On ``"model"`` a tensor is replicated
(every model rank holds it whole and computes the same thing with it, so
its gradient is whole and the same on every model rank) or split (each
rank holds its part); over the data axes each rank's loss is its own
rows' (``train.make_train_step`` scales it so that the losses sum to the
global mean), so a gradient is summed over them.

=====================================  ==================  ===============
forward (site)                         consumer over axis  backward
=====================================  ==================  ===============
all-gather of a weight over the FSDP   differs by rank     reduce-scatter
axes (``Sharding.use``: every weight)                      (sum), this
                                                           rank's slice
all-gather over ``"model"`` of a       replicated          this rank's
weight or activation (``use``,                             slice, no sum
``gather_model``: heads gathered,
``proj_full``, ``logits``, the
recurrent blocks' gathered channels)
all-reduce of row-split partials       replicated          passed through
(``psum``: ``row``, ``embed``'s
masked lookup, the MoE's outputs)
a replicated tensor entering a         split               all-reduce over
split computation (``enter``: the                          ``"model"``
input of ``col`` and of ``logits``,
head-local ``q_norm``/``k_norm``,
MLA's latents, the MoE's top-k
weights)
this rank's part of a replicated       split               all-gather over
tensor (``chunk``: ``row``'s input,                        ``"model"``
the experts' dispatch, MLA's
``wuk``/``wuv`` columns, the mLSTM's
gates of this rank's heads)
the MoE layer's token gather over the  differs by rank     reduce-scatter
data axes (``gather_rows``; capacity                       over the data
unsharded) and the rows taken back                         axes
after (``take_rows``)
all-gather over ``"model"`` of the     split (partial)     reduce-scatter
residual's sequence slices (``seq_in``,                    over ``"model"``
sequence parallelism: a block's input)                     (sum)
reduce-scatter over ``"model"`` of a   split               all-gather over
block's partial sums onto the                              ``"model"``
sequence slices (``to_residual``)
a replicated consumer of ``seq_in``'s  replicated          the gradient on
output (``own``: a projection whose                        model rank 0,
columns are not split, the MoE's                           zeros elsewhere
dispatch)
=====================================  ==================  ===============

Under sequence parallelism ``seq_in``'s output enters the split
computations as it is (its consumers' gradients are partials, summed once
by its reduce-scatter), and a consumer that computes a replicated result
on it hands its whole gradient on from model rank 0 only, so that the sum
counts it once.

``decode_partial``/``merge_partials``, the cache writes and the state
updates run in serving only, under ``torch.no_grad``, and need no
backward.  Autograd runs the backward's collectives in its own order,
on its own thread on the card; every rank builds the same graph, so
every rank issues them in the same order, each on the group and the
transport its forward saw (the ``DeviceGroup`` is kept on the node).
:data:`CALLS` counts the backward's collectives too, as their own verbs
(``<verb>.bwd``).
"""

from __future__ import annotations

import collections
import copy
import math
from fractions import Fraction

import torch
from torch import nn

from ..core.comm import (all_gather_stack, all_reduce_tensor,
                         broadcast_tensor, reduce_scatter_tensor)
from ..core.runtime import DeviceGroup
from ..kernels.flash_attention import decode_partial, merge_partials
from . import transformer

# the collectives this process's sharded steps ran, by verb: calls, and
# the bytes of the tensors it put in (``<verb>_bytes``); the backward's
# are ``<verb>.bwd``, the train step's own reductions ``<verb>.step``; a
# report clears it before the steps it counts
CALLS: collections.Counter = collections.Counter()


def _count(verb, t) -> None:
    CALLS[verb] += 1
    CALLS[f"{verb}_bytes"] += t.numel() * t.element_size()


def _group(mesh) -> DeviceGroup:
    """A ``Communicator``'s group, or the ``DeviceGroup`` itself."""
    return getattr(mesh, "group", mesh)


def _axes(entry) -> tuple:
    """The axes of one spec entry: None, a name or a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _cat(t, sub, dim):
    stack = all_gather_stack(t.contiguous(), sub)
    return torch.cat(tuple(stack.unbind(0)), dim=dim)


def _mine(t, sub, dim):
    n = t.shape[dim] // sub.size
    return t.narrow(dim, sub.rank * n, n)


# -- the collectives with their adjoints (the table above) ----------------

class _SeqGather(torch.autograd.Function):
    """All-gather along the sequence dim (1) over the model axis ``sub``;
    backward: reduce-scatter (sum) of the block's partial gradients."""

    @staticmethod
    def forward(ctx, t, sub):
        ctx.sub = sub
        _count("all_gather", t)
        return _cat(t, sub, 1)

    @staticmethod
    def backward(ctx, g):
        x = g.movedim(1, 0).contiguous()
        _count("reduce_scatter.bwd", x)
        return reduce_scatter_tensor(x, ctx.sub).movedim(0, 1), None


class _SeqScatter(torch.autograd.Function):
    """Reduce-scatter along the sequence dim (1) over the model axis
    ``sub``: the partial sums onto this rank's slice; backward: the
    slices' gradients all-gathered."""

    @staticmethod
    def forward(ctx, t, sub):
        ctx.sub = sub
        x = t.movedim(1, 0).contiguous()
        _count("reduce_scatter", x)
        return reduce_scatter_tensor(x, sub).movedim(0, 1)

    @staticmethod
    def backward(ctx, g):
        _count("all_gather.bwd", g)
        return _cat(g, ctx.sub, 1), None


class _Own(torch.autograd.Function):
    """Identity; backward: the gradient on model rank 0, zeros on the
    others (a replicated consumer's whole gradient, counted once by the
    sum of ``_SeqGather``'s backward)."""

    @staticmethod
    def forward(ctx, t, keep):
        ctx.keep = keep
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over one axis's line ``sub``; backward:
    reduce-scatter (``summed``: the consumer differs by rank) or this
    rank's slice (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, t, sub, dim, summed):
        ctx.sub, ctx.dim, ctx.summed = sub, dim, summed
        _count("all_gather", t)
        return _cat(t, sub, dim)

    @staticmethod
    def backward(ctx, g):
        sub, dim = ctx.sub, ctx.dim
        if not ctx.summed:
            return _mine(g, sub, dim), None, None, None
        x = g.movedim(dim, 0).contiguous()
        _count("reduce_scatter.bwd", x)
        return (reduce_scatter_tensor(x, sub).movedim(0, dim), None, None,
                None)


class _Psum(torch.autograd.Function):
    """All-reduce of partial sums; backward: the gradient passed through
    (the sum is replicated)."""

    @staticmethod
    def forward(ctx, t, sub):
        _count("all_reduce", t)
        return all_reduce_tensor(t, sub)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Identity; backward: all-reduce over ``sub`` (a replicated tensor
    that enters a split computation, each rank's gradient a part)."""

    @staticmethod
    def forward(ctx, t, sub):
        ctx.sub = sub
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _count("all_reduce.bwd", g)
        return all_reduce_tensor(g.contiguous(), ctx.sub), None


class _Scatter(torch.autograd.Function):
    """This rank's part along ``dim`` of a replicated tensor; backward:
    the parts' gradients all-gathered."""

    @staticmethod
    def forward(ctx, t, sub, dim):
        ctx.sub, ctx.dim = sub, dim
        return _mine(t, sub, dim)

    @staticmethod
    def backward(ctx, g):
        _count("all_gather.bwd", g)
        return _cat(g, ctx.sub, ctx.dim), None, None


# -- specs per port parameter and per layer's cache ---------------------------

def _pad(spec, ndim) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _spec_map(cfg, model, mesh_shape, tp, fsdp) -> dict:
    """{parameter name: (its spec, the axes of its stacked dim)}: the JAX
    leaf's spec less the stacked dim of a repeated group, and the axes
    the JAX spec puts on that dim (``()`` for a leaf that is not
    stacked)."""
    from ..convert import port_leaves
    tree = transformer.param_pspecs(cfg, model, mesh_shape, tp=tp,
                                    fsdp=fsdp)
    pairs = port_leaves(cfg, tree,
                        lambda s, r: (tuple(s)[1:], _axes(s[0]) if s else ()),
                        whole=lambda s: (tuple(s), ()))
    return {name: (_pad(pairs[name][0], p.ndim), pairs[name][1])
            for name, p in model.named_parameters()}


def port_specs(cfg, model, mesh_shape, *, tp="model",
               fsdp=("data",)) -> dict:
    """The storage spec of each of ``model``'s parameters (port names, one
    entry per dim): the JAX leaf's spec, less the stacked dim of a repeated
    group (whose axes the layer's slice is replicated over)."""
    return {name: spec for name, (spec, _) in
            _spec_map(cfg, model, mesh_shape, tp, fsdp).items()}


def stacked_replicated_bytes(cfg, model, mesh_shape, *, tp="model",
                             fsdp=("data",)) -> int:
    """Bytes a rank holds beyond the JAX spec's slices: the layers of a
    stacked leaf whose ``reps`` dim the spec splits, replicated here."""
    extra = Fraction(0)
    specs = _spec_map(cfg, model, mesh_shape, tp, fsdp)
    for name, p in model.named_parameters():
        spec, reps_axes = specs[name]
        size = math.prod(mesh_shape[a] for a in reps_axes)
        extra += Fraction(local_numel(p.shape, spec, mesh_shape) *
                          p.element_size() * (size - 1), size)
    return int(extra)


def layer_cache_specs(cfg, cache, mesh_shape, *, tp="model",
                      batch=("data",)) -> list:
    """The spec of each leaf of the port's cache (one dict per layer), from
    ``cache_pspecs`` less the stacked dim of a repeated group."""
    tree = transformer.cache_pspecs(cfg, cache, mesh_shape, tp=tp,
                                    batch=batch)
    out = []
    for (unit, reps), gc in zip(transformer.layer_groups(cfg), tree):
        for _ in range(reps):
            for j in range(len(unit)):
                out.append(_drop_first(gc[f"l{j}"]) if reps > 1
                           else gc[f"l{j}"])
    return out


def _drop_first(tree):
    if isinstance(tree, dict):
        return {k: _drop_first(v) for k, v in tree.items()}
    return tuple(tree)[1:]


def local_numel(shape, spec, mesh_shape) -> int:
    return math.prod(n // math.prod(mesh_shape[a] for a in _axes(e))
                     for n, e in zip(shape, _pad(spec, len(shape))))


def local_slices(shape, spec, group: DeviceGroup) -> tuple:
    """This rank's slice of each dim: a dim split over a tuple of axes is
    cut row-major over them, as the JAX mesh cuts it."""
    sizes = group.mesh_shape
    coords = dict(zip(group.axes, group.coords))
    out = []
    for n, entry in zip(shape, _pad(spec, len(shape))):
        idx, size = 0, 1
        for a in _axes(entry):
            idx, size = idx * sizes[a] + coords[a], size * sizes[a]
        if n % size:
            raise ValueError(f"a dim of {n} does not split over {size}")
        out.append(slice(idx * (n // size), (idx + 1) * (n // size)))
    return tuple(out)


# -- this rank's shards ------------------------------------------------------

def assemble(cfg, mesh, make, *, tp="model", fsdp=("data",), expert_pad=1,
             names=None) -> transformer.Transformer:
    """This rank's :class:`~repro_torch.models.transformer.Transformer`:
    each parameter is ``make(name, take)``, where ``take(full)`` cuts this
    rank's slice from the whole leaf (a numpy array or a tensor), cast to
    the parameter's dtype on the mesh's device.  Leaves are made one at a
    time, so a rank never holds two whole leaves; ``names`` (when given)
    must be the model's parameter names."""
    group = _group(mesh)
    model = transformer.Transformer(cfg, device="meta",
                                    expert_pad=expert_pad)
    params = dict(model.named_parameters())
    if names is not None and set(names) != set(params):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(params) - set(names))}, only in the "
                         f"JAX tree {sorted(set(names) - set(params))}")
    specs = port_specs(cfg, model, group.mesh_shape, tp=tp, fsdp=fsdp)
    for name, p in params.items():
        cut = local_slices(p.shape, specs[name], group)
        local = make(name, lambda full: full[cut])
        want = tuple(s.stop - s.start for s in cut)
        if tuple(local.shape) != want:
            raise ValueError(f"{name}: shard shape {tuple(local.shape)} != "
                             f"{want}")
        local = local.to(device=group.device, dtype=p.dtype).clone(
            memory_format=torch.contiguous_format)
        mod_name, _, leaf = name.rpartition(".")
        param = nn.Parameter(local, requires_grad=False)
        param.pspec = specs[name]
        setattr(model.get_submodule(mod_name), leaf, param)
    model.sharded = {"tp": tp, "fsdp": tuple(fsdp), "group": group}
    return model


def shard_params(cfg, model, mesh, *, tp="model", fsdp=("data",)):
    """This rank's shards of a whole ``model`` (on any device), each
    parameter cut to the rank's slice of its spec and put on the mesh's
    device: the port of placing ``params`` with ``param_sh``."""
    full = dict(model.named_parameters())
    with torch.no_grad():
        return assemble(cfg, mesh,
                        lambda name, take: take(full[name].detach()),
                        tp=tp, fsdp=fsdp, expert_pad=model.expert_pad,
                        names=set(full))


def init_shards(cfg, mesh, generator=None, *, tp="model", fsdp=("data",),
                expert_pad=1):
    """This rank's shards of ``transformer.init_params(cfg, generator,
    expert_pad=)``, made leaf by leaf: each leaf is drawn whole on the
    mesh's device in the order the init draws it, cut to this rank's
    slice, and freed, so the shards are bitwise those of the whole model
    from a generator seeded alike (seed 0 when None).  Norms are ones,
    gates zeros, matrices ``dense_init``'s; the recurrent blocks' leaves
    are drawn by ``recurrent.init_leaf`` (the RG-LRU's ``lam`` before the
    block's matrices, as its init draws it).  On a dry mesh (the meta
    device) the shards have their shapes and no values."""
    from .layers import dense_init
    from .recurrent import init_leaf, rglru_lam
    group = _group(mesh)
    dev = group.device
    if dev.type == "meta":
        # a dry mesh (``DeviceGroup.dry``): the shards' shapes, no values
        skel = dict(transformer.Transformer(
            cfg, device="meta", expert_pad=expert_pad).named_parameters())
        with torch.no_grad():
            return assemble(cfg, mesh, lambda name, take: take(skel[name]),
                            tp=tp, fsdp=fsdp, expert_pad=expert_pad)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    skeleton = dict(transformer.Transformer(
        cfg, device="meta", expert_pad=expert_pad).named_parameters())
    kinds = [k for k, _ in transformer.unrolled_sigs(cfg)]
    lams = {}

    def make(name, take):
        p = skeleton[name]
        parts = name.split(".")
        if parts[0] == "layers" and parts[2] == "rnn":
            kind, leaf = kinds[int(parts[1])], parts[3]
            if kind == "rglru" and leaf == "wx":
                lams[parts[1]] = rglru_lam(cfg.rnn_width, generator, dev)
            full = lams.pop(parts[1]) if kind == "rglru" and leaf == "lam" \
                else init_leaf(cfg, kind, leaf, tuple(p.shape), p.dtype,
                               generator, dev)
        elif p.ndim == 0:
            full = torch.zeros((), dtype=p.dtype, device=dev)
        elif p.ndim == 1:
            full = torch.ones(p.shape, dtype=p.dtype, device=dev)
        else:
            full = dense_init(generator, tuple(p.shape), dtype=p.dtype,
                              device=dev)
        return take(full)

    with torch.no_grad():
        return assemble(cfg, mesh, make, tp=tp, fsdp=fsdp,
                        expert_pad=expert_pad)


def whole(t, spec, mesh):
    """The whole leaf of this rank's shard ``t`` (``spec`` its storage
    spec), gathered over every axis of the spec; every rank of the mesh
    calls it (a checkpoint writes the whole leaves)."""
    group = _group(mesh)
    for d, entry in enumerate(_pad(spec, t.ndim)):
        for a in reversed(_axes(entry)):
            sub = group.sub(a)
            if sub.size > 1:
                t = _cat(t, sub, d)
    return t


def cache_layout(cfg, shard: "Sharding", batch, max_len, dtype) -> list:
    """This rank's slice of the cache as ``(shape, dtype, spec)`` leaves
    (one dict per layer), from the whole cache's shapes on meta: worked
    out once, where the serving steps are built."""
    meta = transformer.init_cache(cfg, batch, max_len, dtype, device="meta")
    specs = layer_cache_specs(cfg, meta, shard.group.mesh_shape,
                              tp=shard.tp, batch=shard.batch_axes)

    def local(t, spec):
        if isinstance(t, dict):
            return {k: local(v, spec[k]) for k, v in t.items()}
        cut = local_slices(t.shape, spec, shard.group)
        return (tuple(s.stop - s.start for s in cut), t.dtype,
                _pad(spec, t.ndim))

    return [local(c, s) for c, s in zip(meta, specs)]


def init_cache(layout, device) -> list:
    """This rank's slice of the cache of ``layout`` (``cache_layout``) on
    ``device``, zeros, each leaf tagged with its spec (``pspec``)."""
    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, dtype, spec = leaf
        out = torch.zeros(shape, dtype=dtype, device=device)
        out.pspec = spec
        return out

    return [make(c) for c in layout]


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def spec_bytes(cfg, model, mesh_shape, *, tp="model",
               fsdp=("data",)) -> int:
    """The bytes of one rank's shards of ``model`` (whole, or on the meta
    device) by the port's specs: the JAX layout's slices plus
    ``stacked_replicated_bytes``."""
    specs = port_specs(cfg, model, mesh_shape, tp=tp, fsdp=fsdp)
    return sum(local_numel(p.shape, specs[name], mesh_shape) *
               p.element_size() for name, p in model.named_parameters())


# -- one rank's part of a sharded step -----------------------------------------

class Sharding:
    """One rank's view of a sharded step over ``mesh`` (a ``Communicator``
    or ``DeviceGroup`` of named axes): the tensor-parallel axis ``tp`` and
    the batch axes, the collectives over them, and the helpers the model's
    layers call on their shards."""

    def __init__(self, mesh, *, tp="model", batch_axes=("data",),
                 batch=1):
        self.group = _group(mesh)
        self.tp = tp
        self.device = self.group.device
        self.batch_axes = tuple(a for a in batch_axes
                                if a in self.group.axes)
        self._subs: dict[str, DeviceGroup] = {}
        self.model = self._sub(tp) if tp in self.group.axes else \
            DeviceGroup(0, 1, self.device, axes=(tp,))
        self.M, self.r = self.model.size, self.model.rank
        self.nbatch = self._size(self.batch_axes)
        # the global batch splits over the data axes when it divides, as
        # the cache spec splits it
        self.split_rows = self.nbatch > 1 and batch % self.nbatch == 0
        # sequence parallelism (``seq_parallel``): the residual stream
        # holds this rank's slice of the sequence over ``tp``
        self.seq = False

    def seq_parallel(self, act_sharding, seq: int, mode: str) -> "Sharding":
        """This Sharding with the residual stream split over the sequence
        as ``act_sharding`` says: ``(batch_axes, tp, None)``, the JAX
        package's ``P(batch, "model", None)`` in the port's tuple form, or
        None (no change).  A model axis of one rank changes nothing; a
        decode step (one token) and a sequence that does not divide the
        model axis are refused, as the JAX package's cells never ask for
        them."""
        if act_sharding is None or self.M == 1:
            return self
        act = tuple(act_sharding)
        if len(act) != 3 or act[1] != self.tp or act[2] is not None:
            raise ValueError(f"act_sharding takes (batch_axes, {self.tp!r}, "
                             f"None), not {act_sharding!r}")
        if mode == "decode" or seq % self.M:
            raise ValueError(f"sequence parallelism needs a {mode} sequence "
                             f"of {seq} to divide the model axis ({self.M})"
                             f" and no decode step")
        out = copy.copy(self)
        out.seq = True
        return out

    def _sub(self, axis) -> DeviceGroup:
        if axis not in self._subs:
            self._subs[axis] = self.group.sub(axis)
        return self._subs[axis]

    def _size(self, axes) -> int:
        return math.prod(self.group.mesh_shape[a] for a in axes)

    def check(self, params) -> None:
        """Raises unless ``params`` are shards of this mesh along ``tp``."""
        info = getattr(params, "sharded", None)
        if info is None or info["tp"] != self.tp or \
                info["group"].mesh_shape != self.group.mesh_shape:
            raise ValueError("the parameters are not this mesh's shards "
                             "(models.sharding.shard_params, init_shards or "
                             "convert.params_from_numpy(mesh=))")

    # -- collectives ---------------------------------------------------------
    def gather(self, t, axes, dim):
        """``t`` gathered along ``dim`` over ``axes`` (row-major: the minor
        axis first); its gradient is summed over every axis but ``tp``
        (the table of the module's docstring)."""
        for a in reversed(_axes(axes)):
            sub = self._sub(a)
            if sub.size > 1:
                t = _Gather.apply(t, sub, dim, a != self.tp)
        return t

    def gather_model(self, t, dim):
        return self.gather(t, self.tp, dim) if self.M > 1 else t

    def psum(self, t):
        """The sum of every model rank's partial ``t``."""
        if self.M == 1:
            return t
        return _Psum.apply(t, self.model)

    def enter(self, t):
        """``t`` (replicated over ``tp``) as the input of a split
        computation: itself, its gradient summed over ``tp`` (by
        ``seq_in``'s reduce-scatter where ``t`` is its output)."""
        if self.M == 1 or not (torch.is_grad_enabled() and t.requires_grad) \
                or getattr(t, "seq_in", False):
            return t
        return _Enter.apply(t, self.model)

    def own(self, t):
        """``t`` as the input of a replicated computation: itself; where
        ``t`` is ``seq_in``'s output its gradient counts on model rank 0
        only (the table of the module's docstring)."""
        if not (self.seq and getattr(t, "seq_in", False) and
                torch.is_grad_enabled() and t.requires_grad):
            return t
        return _Own.apply(t, self.r == 0)

    # -- sequence parallelism ------------------------------------------------
    def seq_in(self, x):
        """A block's input from the residual stream: under sequence
        parallelism this rank's slice gathered over the sequence (and
        marked as such); else ``x``."""
        if not self.seq:
            return x
        out = _SeqGather.apply(x, self.model)
        out.seq_in = True
        return out

    def seq_like(self, t, src):
        """``t``, a reshape or cast of ``seq_in``'s output ``src``, marked
        like it."""
        if getattr(src, "seq_in", False):
            t.seq_in = True
        return t

    def to_residual(self, y, partial):
        """A block's output onto the residual stream: ``partial`` sums
        (this rank's part of a row-split product) all-reduced, or under
        sequence parallelism reduce-scattered onto this rank's slice of
        the sequence; a replicated ``y`` as it is, or its slice."""
        if not self.seq:
            return self.psum(y) if partial else y
        if partial:
            return _SeqScatter.apply(y, self.model)
        return self.chunk(y, 1)

    def on_residual(self, w):
        """A replicated tensor (a norm's weight, a gate) that acts on the
        residual stream: under sequence parallelism it enters the split
        computation."""
        return self.enter(w) if self.seq else w

    def norm_weight(self, w):
        """A norm's weight whole, as it acts on the residual stream."""
        return self.on_residual(self.full(w))

    def seq_last(self, x, window):
        """The last ``window`` positions of the residual stream, whole on
        every rank: under sequence parallelism a prefill's window comes
        from the last model rank's slice (a broadcast, no gradient) where
        it holds them, else the sequence is gathered."""
        if not self.seq:
            return x[:, -window:]
        if window <= x.shape[1] and not torch.is_grad_enabled():
            tail = x[:, -window:].contiguous()
            _count("broadcast", tail)
            return broadcast_tensor(tail, self.model, src=self.M - 1)
        return self.seq_in(x)[:, -window:]

    def chunk(self, t, dim):
        """This model rank's part of ``t`` (replicated) along ``dim``."""
        if self.M == 1:
            return t
        return _Scatter.apply(t, self.model, dim)

    # -- the batch over the data axes ----------------------------------------
    def take_rows(self, t):
        """This rank's rows of the global batch (all of them when it does
        not divide over the data axes)."""
        if not self.split_rows:
            return t
        coords = dict(zip(self.group.axes, self.group.coords))
        idx = 0
        for a in self.batch_axes:
            idx = idx * self.group.mesh_shape[a] + coords[a]
        n = t.shape[0] // self.nbatch
        return t[idx * n:(idx + 1) * n]

    def gather_rows(self, t):
        """The global batch from every rank's rows (``take_rows``'s
        inverse)."""
        return self.gather(t, self.batch_axes, 0) if self.split_rows else t

    # -- weights -------------------------------------------------------------
    def use(self, w, keep=None):
        """``(weight, split)``: ``w`` gathered over every axis of its spec
        but ``tp`` on dim ``keep``; ``split`` when that dim stays split."""
        spec = getattr(w, "pspec", None)
        if spec is None:
            return w, False
        split = False
        keep = None if keep is None else keep % w.ndim
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes or self._size(axes) == 1:
                continue
            if d == keep and axes == (self.tp,):
                split = True
                continue
            w = self.gather(w, axes, d)
        return w, split

    def full(self, w):
        """The whole weight, for one use."""
        return self.use(w)[0]

    def part(self, w, dim, local):
        """A weight as a computation uses it: this rank's part along ``dim``
        (``local``) or whole."""
        t, split = self.use(w, keep=dim)
        if local and not split:
            return self.chunk(t, dim)
        if split and not local:
            return self.gather_model(t, dim)
        return t

    def col(self, x, w):
        """``(x @ w, split)``: this rank's columns when the spec splits
        them over ``tp``, else all of them."""
        t, split = self.use(w, keep=-1)
        x = self.enter(x) if split else self.own(x)
        return x @ t.to(x.dtype), split

    def col_as(self, x, w, local):
        """``x @ w`` on this rank's columns (``local``) or on all of them,
        whatever the spec splits."""
        y, split = self.col(x, w)
        if local and not split:
            return self.chunk(y, -1)
        if split and not local:
            return self.gather_model(y, -1)
        return y

    def proj_full(self, x, w):
        """``x @ w`` with every column on every rank."""
        return self.col_as(x, w, False)

    def row_partial(self, h, split, w):
        """``(h @ w, partial)``: with ``w``'s rows split over ``tp``, this
        rank's rows times its part of ``h`` (a partial sum over ``tp``);
        else the whole product.  ``split``: ``h`` holds this rank's part of
        its last dim."""
        t, rsplit = self.use(w, keep=-2)
        if rsplit and not split:
            h = self.chunk(h, -1)
        elif split and not rsplit:
            h = self.gather_model(h, -1)
        return h @ t.to(h.dtype), rsplit

    def row(self, h, split, w):
        y, partial = self.row_partial(h, split, w)
        return self.psum(y) if partial else y

    def row_out(self, h, split, w):
        """``row`` as a block's output onto the residual stream
        (``to_residual``)."""
        return self.to_residual(*self.row_partial(h, split, w))

    def embed(self, table, tokens):
        """Rows of ``table`` for ``tokens``: with the vocabulary split over
        ``tp``, each rank looks up its own rows (zeros elsewhere) and an
        all-reduce sums them."""
        t, split = self.use(table, keep=0)
        if not split:
            return self.to_residual(t[tokens], False)
        n = t.shape[0]
        idx = tokens - self.r * n
        hit = (idx >= 0) & (idx < n)
        rows = torch.where(hit[..., None], t[idx.clamp(0, n - 1)],
                           torch.zeros((), dtype=t.dtype, device=t.device))
        return self.to_residual(rows, True)

    def logits(self, x, head, tied):
        """float32 logits of ``x`` against the head (``embed`` when
        ``tied``), whole over the vocabulary."""
        if tied:
            t, split = self.use(head, keep=0)
            t = t.T
        else:
            t, split = self.use(head, keep=-1)
        x = self.enter(x) if split else self.own(x)
        y = (x @ t.to(x.dtype)).float()
        return self.gather_model(y, -1) if split else y

    # -- recurrent states ------------------------------------------------------
    def state_get(self, leaf, dim):
        """A state leaf as its block computes on it: this rank's part along
        ``dim`` (None: whole), gathered over ``tp`` where its storage is
        split on another dim."""
        md = self.model_dim(leaf)
        dim = None if dim is None else dim % leaf.ndim
        if md == dim:
            return leaf
        if md is not None:
            leaf = self.gather_model(leaf, md)
        return leaf if dim is None else self.chunk(leaf, dim)

    def state_put(self, leaf, value, dim) -> None:
        """Store ``value`` (this rank's part along ``dim``, or whole when
        None) into ``leaf`` in place: the part its storage holds."""
        md = self.model_dim(leaf)
        dim = None if dim is None else dim % leaf.ndim
        if md != dim:
            if dim is not None:
                value = self.gather_model(value, dim)
            if md is not None:
                value = self.chunk(value, md)
        leaf.copy_(value.to(leaf.dtype))

    # -- the cache ------------------------------------------------------------
    def model_dim(self, leaf):
        """The dim of a cache leaf that ``tp`` splits, or None."""
        if self.M == 1:
            return None
        for d, entry in enumerate(getattr(leaf, "pspec", ())):
            if self.tp in _axes(entry):
                return d
        return None

    def time_len(self, leaf, tdim) -> int:
        """The cache's whole length along its time dim ``tdim``."""
        return leaf.shape[tdim] * (self.M if self.model_dim(leaf) == tdim
                                   else 1)

    def time_view(self, leaf, tdim):
        """``(view, lo, partial)`` of a cache leaf for attention: this rank's
        slice of time, from position ``lo``, whose softmax partials merge
        over ``tp`` (``partial``); under the fallback layout the leaf
        gathered whole over ``tp`` for this one use."""
        md = self.model_dim(leaf)
        if md is None:
            return leaf, 0, False
        if md == tdim:
            return leaf, self.r * leaf.shape[tdim], True
        return self.gather_model(leaf, md), 0, False

    def write(self, leaf, tdim, idx, values) -> None:
        """``leaf[..., idx, ...] = values`` along the time dim ``tdim``, in
        place, for this rank's part: the positions of ``idx`` (a CPU index
        tensor of global time slots) in its slice of time, or its part of
        the dim the fallback layout splits."""
        md = self.model_dim(leaf)
        values = values.to(leaf.dtype)
        dev = leaf.device
        if md == tdim:
            n = leaf.shape[tdim]
            lo = self.r * n
            sel = ((idx >= lo) & (idx < lo + n)).nonzero().flatten()
            if sel.numel():
                leaf.index_copy_(tdim, (idx[sel] - lo).to(dev),
                                 values.index_select(tdim, sel.to(dev)))
            return
        if md is not None:
            values = self.chunk(values, md)
        leaf.index_copy_(tdim, idx.to(dev), values)

    def attend(self, q, k, v, partial, **kw):
        """``decode_attention`` of one query token over a cache view; with
        ``partial`` each model rank holds a slice of time and the softmax
        partials merge over ``tp``."""
        B, Hq = q.shape[:2]
        acc, l, m = decode_partial(q, k, v, **kw)
        if partial and self.M > 1:
            dv = acc.shape[-1]
            packed = torch.cat([acc, l, m], -1)
            _count("all_gather", packed)
            st = all_gather_stack(packed, self.model)
            out = merge_partials(st[..., :dv], st[..., dv:dv + 1],
                                 st[..., dv + 1:])
        else:
            out = acc / l.clamp(min=1e-30)
        return out.reshape(B, Hq, 1, v.shape[-1]).to(q.dtype)
