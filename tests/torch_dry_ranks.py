"""Rank bodies of the dry-run and sequence-parallelism tests
(``test_torch_dryrun_records.py``, ``test_torch_seq_parallel.py``).  No
JAX import: the spawned ranks unpickle them by module name."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_ranks import SHARD_AXES, _cuts, _np, grads_on

ACT = (("data",), "model", None)


def f32_fields(cfg) -> dict:
    """Every field of ``cfg`` in float32: ``build_cell``'s overrides that
    make a SMOKE config of the full one."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def records_rank(env, meshes, cases):
    """Each ``(arch, (seq, gbatch, kind), act_sp)`` of ``cases`` on each
    mesh shape: the cell of ``launch.cells.build_cell`` on this rank's
    real (gloo, CPU) mesh, run once under ``core.comm.record()``,
    ``FlopCounterMode`` and ``registry.count()``; its record as
    ``costing.record_key`` gives it, the counted flops and the kernels'
    calls."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_smoke
    from repro_torch.core import comm as C
    from repro_torch.kernels import registry
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.costing import record_key
    out = {}
    for shape in meshes:
        comm = env.group(shape, SHARD_AXES)
        if comm is None:
            continue
        for arch, cell_shape, act_sp in cases:
            torch.manual_seed(0)
            cell, _ = build_cell(arch, cell_shape, comm, act_sp=act_sp,
                                 overrides=f32_fields(get_smoke(arch)))
            with registry.count() as kern, C.record() as log, \
                    FlopCounterMode(display=False) as fc:
                cell.run()
            out[shape, arch, cell_shape, act_sp] = {
                "record": record_key(log),
                "flops": int(fc.get_total_flops()),
                "kernels": registry.count_totals(kern)["calls"],
                "act": cell.act_sharding}
    return out


def seq_parallel_rank(env, meshes, cases, prompt_len):
    """Each case ``(arch, tree, tokens, labels, enc)`` on each mesh: the
    gradient shards and metrics of the step without and with sequence
    parallelism (``act_sharding``; with remat too), and the prefill's last
    logits of the first ``prompt_len`` tokens without and with it
    (``enc``: the frontend embeddings of a cross-attention arch, or
    None)."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models import sharding
    from repro_torch.serve import make_serve_steps
    out = {}
    for shape in meshes:
        comm = env.group(shape, SHARD_AXES)
        if comm is None:
            continue
        for arch, tree, tokens, labels, enc in cases:
            cfg = dataclasses.replace(get_smoke(arch),
                                      compute_dtype="float32")
            state = convert.train_state_from_numpy(cfg, {"params": tree},
                                                   mesh=comm)
            res = {"cuts": _cuts(state["params"], comm.group)}
            res["tp"] = grads_on(cfg, state, tokens, labels, enc,
                                 mesh=comm, remat=False)
            sharding.CALLS.clear()
            res["sp"] = grads_on(cfg, state, tokens, labels, enc,
                                 mesh=comm, remat=False, act_sharding=ACT)
            res["calls"] = dict(sharding.CALLS)
            res["sp_remat"] = grads_on(cfg, state, tokens, labels, enc,
                                       mesh=comm, remat=True,
                                       act_sharding=ACT)
            params = convert.params_from_numpy(cfg, tree, mesh=comm)
            tok = torch.from_numpy(np.ascontiguousarray(
                tokens[:, :prompt_len]))
            for key, act in (("prefill", None), ("prefill_sp", ACT)):
                prefill, _, init_cache = make_serve_steps(
                    cfg, comm, max_len=tokens.shape[1],
                    batch=tokens.shape[0], act_sharding=act)
                logits, _ = prefill(params, tok, init_cache(),
                                    None if enc is None
                                    else torch.from_numpy(enc))
                res[key] = _np(logits)
            out[shape, arch] = res
    return out
