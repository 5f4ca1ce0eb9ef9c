"""The cost of one dry-run cell, the port of ``repro/launch/costing.py``:
one rank's step traced once, at full depth, on the meta device.

The JAX module compiles a cell and reads XLA's cost analysis, which counts
a scan's body once; it compiles a stem and a reduced depth and scales
between them (``reduced_depths``, ``_scale_costs``).  The port unrolls its
layers and runs every one of them in the trace, the sLSTM's loop over time
included, so there is nothing to correct and no depth correction is
ported.  The trace runs under four counters:

- ``torch.utils.flop_counter.FlopCounterMode``: the matmul family (mm,
  bmm, addmm, einsum's products, convolutions, attention), forward,
  backward and remat's recomputation alike; elementwise work (norms,
  activations, softmax, the optimizer) is not counted;
- ``kernels.registry.count()``: each hand kernel's flops and bytes by its
  spec's formulas (the kernels take the card's branch on meta inside
  ``registry.dry()``, so the trace holds and saves what the card does);
- ``core.comm.record()``: every collective, priced by ``launch.roofline``
  by the link its line runs on;
- :class:`MemoryTracker`: the live bytes of the storages the step makes;
  it also gives the pointwise operations their outputs' shapes without
  torch's Python meta functions, which would make the sLSTM's loop over
  a 32k prefill an hour's trace.

``memory`` has the JAX module's four keys, in torch's terms:
``argument_bytes`` the step's inputs (this rank's shards of the
parameters, the moments, the batch, a decode's cache), ``output_bytes``
what the step returns (the new storages and the inputs it updated in
place), ``alias_bytes`` the inputs it updated in place (the train state),
and ``temp_bytes`` the most it held beyond its inputs and its new
outputs, so that argument + temp + output - alias is the peak.

``hbm_model`` and ``bytes`` are the JAX module's itemized HBM traffic
model (``analytic_hbm_bytes``), and ``slstm_analytic_flops`` its estimate
of the sLSTM loop's work, recorded beside the traced count and not added
to it.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config
from ..core import comm
from ..kernels import registry
from ..models import sharding, transformer
from . import roofline
from .cells import build_cell, shape_of

__all__ = ["MemoryTracker", "analytic_hbm_bytes", "cell_cost",
           "record_key", "slstm_analytic", "storages", "trace_cell"]


class MemoryTracker(TorchDispatchMode):
    """The live bytes of the storages made inside the block, and their
    peak.  A storage counts once, however many views share it, from the
    operation that made it until its last reference goes (autograd's
    saved tensors and remat's recomputation included: a storage's Python
    object lives as long as the storage).  Only meta storages count (the
    traced step's device; an index on the host is not the card's), and
    not those of ``known`` (the step's arguments).

    The pointwise operations on meta tensors skip torch's Python meta
    functions, which cost 0.03-1.2 ms an operation (the
    sLSTM's loop over time runs ~17 of them a step): the output is a new
    contiguous meta tensor of the operands' broadcast shape and of the
    dtype the operation gives for the operands' dtypes, learned once from
    a probe on one-element operands; an in-place one returns its operand.
    ``log_sigmoid_forward`` (``F.logsigmoid``) gives its output and the
    card's empty buffer (its CPU kernel's, which the meta function
    copies, is the input's size and would be saved for the backward).
    Any other operation runs as it is."""

    def __init__(self, known=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._known = {t.untyped_storage()._cdata for t in known}
        self._dtypes: dict = {}

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or not t.is_meta:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes or key in self._known:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _pointwise(self, func, args, kwargs):
        """A pointwise operation's meta output without its meta function,
        or None for any other operation."""
        if func is torch.ops.aten.log_sigmoid_forward.default and \
                args[0].is_meta:
            x = args[0]
            return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                    torch.empty((0,), dtype=x.dtype, device="meta"))
        if (torch.Tag.pointwise not in func.tags or "out" in kwargs
                or len(func._schema.returns) != 1):
            return None
        flat = list(args) + list(kwargs.values())
        tensors = [a for a in flat if isinstance(a, torch.Tensor)]
        if not tensors or not all(t.is_meta for t in tensors) or \
                any(isinstance(a, (list, tuple)) for a in flat):
            return None
        if func._schema.is_mutable:
            return args[0]
        key = (func,) + tuple(
            (a.dtype, a.dim() == 0) if isinstance(a, torch.Tensor)
            else type(a) for a in args) + tuple(
            (k, v.dtype if isinstance(v, torch.Tensor) else type(v))
            for k, v in kwargs.items())
        dtype = self._dtypes.get(key)
        if dtype is None:
            def one(a):
                return torch.empty((1,) * a.dim(), dtype=a.dtype,
                                   device="meta") \
                    if isinstance(a, torch.Tensor) else a
            dtype = self._dtypes[key] = func(
                *(one(a) for a in args),
                **{k: one(v) for k, v in kwargs.items()}).dtype
        return torch.empty(_broadcast(t.shape for t in tensors),
                           dtype=dtype, device="meta")


def _broadcast(shapes) -> tuple:
    """The broadcast of ``shapes`` (``torch.broadcast_shapes`` without
    its symbolic-shape checks)."""
    out: list = []
    for shape in shapes:
        shape = tuple(shape)
        if len(shape) > len(out):
            out = [1] * (len(shape) - len(out)) + out
        for i, n in enumerate(shape, len(out) - len(shape)):
            if n != 1:
                if out[i] not in (1, n):
                    raise ValueError(f"shapes do not broadcast: {shape}")
                out[i] = n
    return tuple(out)


def storages(tensors) -> dict[int, int]:
    """The bytes of each storage under ``tensors``, once a storage."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def record_key(log) -> list[tuple]:
    """A record's entries as ``(kind, bytes, group, axes)``: what two
    ranks of one step must agree on."""
    return [(e["kind"], e["bytes"], e["group"], tuple(e["axes"]))
            for e in log]


def trace_cell(cell) -> dict:
    """One run of ``cell`` on the meta device under the counters: the
    matmul family's flops (``flops_counted``), the kernels' counts
    (``kernels``), the collective record (``record``), the ``memory``
    keys and the peak, and the seconds it took.  Inside
    ``registry.plain()`` every kernel's plain version runs instead (the
    CPU's path, for a comparison with a run on the CPU)."""
    args = cell.arguments
    arg_st = storages(args)
    t0 = time.perf_counter()
    with registry.dry(), registry.count() as kern, \
            comm.record() as log, FlopCounterMode(display=False) as fc, \
            MemoryTracker(args) as mem:
        out = cell.run()
    secs = time.perf_counter() - t0
    out_st = storages([t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)] +
                       _module_tensors(out))
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    arg_bytes, out_bytes = sum(arg_st.values()), sum(out_st.values())
    peak = arg_bytes + mem.peak
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(0, peak - arg_bytes - (out_bytes - alias)),
              "alias_bytes": alias}
    return {"flops_counted": int(fc.get_total_flops()), "kernels": kern,
            "record": log, "memory": memory, "peak_bytes": peak,
            "trace_s": secs}


def _module_tensors(out) -> list:
    """The parameters and moments of a train state in the step's output
    (a module is not a pytree leaf that ``tree_leaves`` opens)."""
    found = []
    for leaf in tree_leaves(out, is_leaf=lambda x: isinstance(
            x, torch.nn.Module)):
        if isinstance(leaf, torch.nn.Module):
            found.extend(leaf.parameters())
    return found


def analytic_hbm_bytes(cfg, kind, gbatch, seq, mesh, n_total,
                       cache_bytes=0) -> dict:
    """Per-chip HBM traffic model (bytes) for the memory roofline term."""
    chips = mesh.size
    d = cfg.d_model
    wt_bf16 = n_total * 2 / chips
    items = {}
    if kind == "train":
        items["weights_rw"] = 3 * wt_bf16
        items["grads_rw"] = n_total * 4 * 2 / chips
        items["optimizer_rw"] = n_total * 4 * 6 / chips
        items["act_stash_rw"] = (gbatch * seq * d * 2 / chips
                                 * cfg.n_layers * 3)
        items["logits_rw"] = gbatch * seq * cfg.vocab * 4 / chips * 2
    elif kind == "prefill":
        items["weights_r"] = wt_bf16
        items["activations_rw"] = gbatch * seq * d * 2 / chips \
            * cfg.n_layers * 2
        items["cache_w"] = cache_bytes / chips
    else:
        items["weights_r"] = wt_bf16
        items["cache_rw"] = cache_bytes / chips * 2
        items["activations_rw"] = gbatch * 1 * d * 2 / chips \
            * cfg.n_layers * 2
    items["total"] = float(sum(items.values()))
    return items


def slstm_analytic(cfg, kind, gbatch, seq) -> float:
    kinds = cfg.layer_kinds()
    n_sl = sum(1 for k in kinds if k == "slstm")
    if not n_sl:
        return 0.0
    d = cfg.d_model
    hd = d // max(cfg.rnn_heads, 1)
    per_tok = 2 * 4 * d * hd + 20 * d
    toks = gbatch * (seq if kind != "decode" else 1)
    mult = 3 if kind == "train" else 1
    return float(n_sl * per_tok * toks * mult)


def cell_cost(arch, shape, mesh_fn, *, act_sp=True, policy="fsdp_tp",
              remat=True, overrides=None) -> dict:
    """The cost of one cell a rank: ``mesh_fn(rank)`` gives the mesh as
    rank ``rank`` sees it.  The cell is traced on the first rank and on
    the last, whose records must agree entry for entry (kind, bytes,
    group, axes): the port's proof that the sharding is coherent, where
    the JAX module's is a compile.  Returns the first rank's counts
    (``trace_cell``) with ``flops`` (the matmul family's plus the
    kernels'), ``colls`` (the record priced by link), ``hbm_model``,
    ``bytes``, ``slstm_analytic_flops`` and the cell's ``meta``; None
    with the skip reason where the cell does not apply."""
    first = mesh_fn(0)
    size = first.size
    got = []
    for rank in sorted({0, size - 1}):
        mesh = first if rank == 0 else mesh_fn(rank)
        cell, meta = build_cell(arch, shape, mesh, remat=remat,
                                act_sp=act_sp, overrides=overrides,
                                policy=policy)
        if cell is None:
            return {"skipped": meta}
        got.append(trace_cell(cell))
        del cell
    if record_key(got[0]["record"]) != record_key(got[-1]["record"]):
        raise RuntimeError(f"{arch} x {meta['shape']}: the first and the "
                           f"last rank's collectives differ")
    total = got[0]
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    _, seq, gbatch, kind = shape_of(shape)
    kflops = registry.count_totals(total["kernels"])["flops"]
    total["kernel_flops"] = kflops
    total["flops"] = total["flops_counted"] + kflops
    total["colls"] = roofline.collectives(
        total["record"], sharding._group(first).mesh_shape)
    total["meta"] = meta
    total["ranks_traced"] = sorted({0, size - 1})
    data_shards = max(size // sharding._group(first).mesh_shape.get(
        "model", 1), 1)
    total["slstm_analytic_flops"] = \
        slstm_analytic(cfg, kind, gbatch, seq) / data_shards
    n_total = transformer.param_count(cfg)
    cache_bytes = 0
    if kind != "train":
        cache = transformer.init_cache(cfg, gbatch, seq, cfg.cdtype,
                                       device="meta")
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(cache))
    total["hbm_model"] = analytic_hbm_bytes(cfg, kind, gbatch, seq, first,
                                            n_total, cache_bytes)
    total["bytes"] = total["hbm_model"]["total"]
    return total
