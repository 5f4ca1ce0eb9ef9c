"""The port's dry-run tooling against the JAX package's, on the CPU.

- ``SHAPES``, ``cell_applicable`` and ``input_specs`` (every leaf's shape
  and dtype) as the JAX package's, for every arch x shape;
- ``model_flops``, ``analytic_hbm_bytes`` and ``slstm_analytic`` as
  ``repro.launch.cells``/``repro.launch.costing``'s on every arch x shape
  x production mesh (the JAX functions get a stand-in with ``.size`` and
  ``.shape``, never a 256-device mesh);
- ``param_pspecs`` at the production meshes' axis sizes as the JAX
  package's;
- the production mesh: a dry ``Communicator`` of 256 or 512 ranks whose
  lines price by where their ranks lie (NVLink inside a node of 8, the
  network across); the registry's meta branch only inside ``dry()``;
- one real production cell (qwen3-0.6b x decode_32k, single mesh)
  through ``dryrun.main`` into a temporary directory, the first and last
  rank's records equal, then ``report`` rendered from it.

No test imports ``repro.launch.dryrun``: it sets ``XLA_FLAGS`` to 512
host devices for the life of the process.
"""

import functools
import json
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.launch import cells as jcells
from repro.launch import costing as jcosting
from repro.models import transformer as jt
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_applicable,
                                 get_config, input_specs)
from repro_torch.core import HW
from repro_torch.core.comm import all_reduce_tensor, record
from repro_torch.kernels import registry
from repro_torch.launch import cells, costing, dryrun, mesh, report, roofline
from repro_torch.models import transformer

MESH_SHAPES = {"single": {"data": 32, "model": 8},
               "multi": {"pod": 2, "data": 32, "model": 8}}


def _stand_in(shape):
    """What the JAX functions read of a mesh: ``.size`` and ``.shape``."""
    return types.SimpleNamespace(size=int(np.prod(list(shape.values()))),
                                 shape=dict(shape))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def test_shapes_equal_jax():
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_applicable_and_input_specs_equal_jax(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert cell_applicable(cfg, shape) == jcell_applicable(jcfg, shape)
    want, got = jinput_specs(jcfg, shape), input_specs(cfg, shape)
    assert set(got) == set(want)
    for key in ("tokens", "labels", "pos", "enc"):
        if key in want:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert _dtype(got[key].dtype) == str(want[key].dtype), key
    if "cache" in want:
        jleaves = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): (tuple(leaf.shape), str(leaf.dtype))
                   for path, leaf in
                   jax.tree_util.tree_flatten_with_path(want["cache"])[0]}
        assert jleaves == _port_cache_leaves(cfg, got["cache"])


def _port_cache_leaves(cfg, cache) -> dict:
    """The port's per-layer cache as the JAX tree's leaves: a path of
    (group, ``l<j>``, keys...) to (shape, dtype), a repeated group's
    leaves stacked."""
    out, layer = {}, 0
    for g, (unit, reps) in enumerate(transformer.layer_groups(cfg)):
        for j in range(len(unit)):
            def walk(tree, path):
                if isinstance(tree, dict):
                    for k, v in tree.items():
                        walk(v, path + (k,))
                    return
                assert tree.device.type == "meta"
                lead = (reps,) if reps > 1 else ()
                out[(str(g), f"l{j}") + path] = (lead + tuple(tree.shape),
                                                 _dtype(tree.dtype))
            walk(cache[layer + j], ())
        layer += len(unit) * reps
    return out


@functools.lru_cache(maxsize=None)
def _sizes(arch) -> dict:
    """Each shape's ``model_flops`` and whole cache bytes, both packages',
    and the parameter counts."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    # the JAX package's counts are a trace of its init each: one call of
    # its model_flops, whose formula then gives the other shapes'
    first = jcells.model_flops(arch, "train_4k")
    out = {"n_total": (transformer.param_count(cfg), first["n_total"])}
    for sid, (seq, gbatch, kind) in SHAPES.items():
        tokens = gbatch * (seq if kind in ("train", "prefill") else 1)
        want = {**first, "tokens_per_step": tokens,
                "model_flops": (6 if kind == "train" else 2) *
                first["n_active"] * tokens}
        cache = jcache = 0
        if kind != "train":
            cache = sum(t.numel() * t.element_size() for t in
                        jax.tree.leaves(transformer.init_cache(
                            cfg, gbatch, seq, cfg.cdtype, device="meta")))
            jcache = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                         for l in jax.tree.leaves(jax.eval_shape(
                             lambda: jt.init_cache(jcfg, gbatch, seq,
                                                   jcfg.cdtype))))
        out[sid] = {"flops": (cells.model_flops(arch, sid), want),
                    "cache": (cache, jcache)}
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_cache_bytes_equal_jax(arch):
    sizes = _sizes(arch)
    for key, pair in sizes.items():
        if key == "n_total":
            assert pair[0] == pair[1]
        else:
            assert pair["flops"][0] == pair["flops"][1], key
            assert pair["cache"][0] == pair["cache"][1], key


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hbm_and_slstm_models_equal_jax(arch, mesh_name):
    jcfg, cfg = jget_config(arch), get_config(arch)
    stand = _stand_in(MESH_SHAPES[mesh_name])
    sizes = _sizes(arch)
    n_total = sizes["n_total"][0]
    for sid, (seq, gbatch, kind) in SHAPES.items():
        cache = sizes[sid]["cache"][0]
        assert costing.analytic_hbm_bytes(cfg, kind, gbatch, seq, stand,
                                          n_total, cache) == \
            jcosting.analytic_hbm_bytes(jcfg, kind, gbatch, seq, stand,
                                        n_total, cache)
        assert costing.slstm_analytic(cfg, kind, gbatch, seq) == \
            jcosting.slstm_analytic(jcfg, kind, gbatch, seq)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, pad):
    return jax.eval_shape(lambda: jt.init_params(
        jget_config(arch), jax.random.PRNGKey(0), expert_pad=pad))


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_at_the_production_mesh_equal_jax(arch, mesh_name):
    shape = MESH_SHAPES[mesh_name]
    fsdp = tuple(a for a in ("pod", "data") if a in shape)
    cfg = get_config(arch)
    pad = mesh.expert_pad_for(cfg, mesh.make_production_mesh(
        multi_pod=mesh_name == "multi"))
    want = jt.param_pspecs(jget_config(arch), _jax_shapes(arch, pad), shape,
                           fsdp=fsdp)
    got = transformer.param_pspecs(
        cfg, transformer.init_params(cfg, device="meta", expert_pad=pad),
        shape, fsdp=fsdp)
    assert jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple)) == \
        [tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, P))]


def test_production_mesh_is_a_dry_h100_cluster():
    """256 ranks (32 nodes of 8) and 512 across two pods, the model axis
    inside a node; a dry group's collective notes itself with its axes
    and returns the shape a real group gives, and each line prices by
    where its ranks lie."""
    single = mesh.make_production_mesh()
    last = mesh.make_production_mesh(multi_pod=True, rank=511)
    assert single.group.mesh_shape == MESH_SHAPES["single"]
    assert last.group.mesh_shape == MESH_SHAPES["multi"]
    assert single.backend == "dry" and single.device.type == "meta"
    assert last.group.coords == (1, 31, 7)
    assert last.group.sub("model").ranks == tuple(range(504, 512))
    assert last.group.sub("pod").ranks == (255, 511)
    t = torch.empty((4, 6), device="meta")
    with record() as log:
        assert all_reduce_tensor(t, single.group.sub("model")).shape == \
            (4, 6)
        all_reduce_tensor(t, single.group.sub("data"))
        all_reduce_tensor(t, last.group.sub("pod"))
    assert [(e["kind"], e["bytes"], e["group"], e["axes"]) for e in log] \
        == [("all_reduce", 96, 8, ("model",)),
            ("all_reduce", 96, 32, ("data",)),
            ("all_reduce", 96, 2, ("pod",))]
    colls = roofline.collectives(log[:2], MESH_SHAPES["single"])
    assert [c["link"] for c in colls] == ["nvlink", "net"]
    s = roofline.collective_summary(
        roofline.collectives(log[2:], MESH_SHAPES["multi"]))
    assert s["pod_wire_bytes"] == s["net_wire_bytes"] == 96.0
    terms = roofline.roofline_terms({}, colls)
    assert terms["t_collective_s"] == pytest.approx(
        2 * 96 * 7 / 8 / HW["nvlink_bw"] + 2 * 96 * 31 / 32 / HW["net_bw"])
    assert HW["cards_per_node"] == 8 and HW["net_bw"] == 50e9


def test_meta_takes_the_kernel_branch_only_inside_dry():
    """On meta a wrapper's kernel branch allocates its outputs and
    launches nothing, inside ``registry.dry()`` only; ``count()`` gets
    the spec's flops and bytes there as it would on the card."""
    from repro_torch.kernels.rg_lru.ops import RG_LRU, rg_lru_scan
    la, b, h0 = (torch.empty(s, device="meta") for s in
                 ((1, 64, 32), (1, 64, 32), (1, 32)))
    with pytest.raises(ValueError, match="no kernel"):
        rg_lru_scan(la, b, h0)
    before = registry.launches()["rg_lru"]
    with registry.dry(), registry.count() as c:
        hs, last = rg_lru_scan(la, b, h0)
    assert hs.shape == (1, 64, 32) and last.shape == (1, 32)
    assert registry.launches()["rg_lru"] == before
    assert c == {"rg_lru": {"calls": 1, "flops": RG_LRU.flops(la, b, h0),
                            "bytes": RG_LRU.nbytes(la, b, h0)}}


def test_production_cell_through_dryrun_main_and_report(tmp_path, capsys):
    out = tmp_path / "dry"
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    rec = json.loads((out / "qwen3-0.6b__decode_32k__h100x32x8.json")
                     .read_text())
    assert rec["mesh"] == MESH_SHAPES["single"]
    assert rec["ranks_traced"] == [0, 255]
    assert rec["flops"] > 0 and rec["n_collectives"] > 0
    assert rec["kind"] == "decode" and rec["batch_sharded"]
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes"}
    # a decode updates its cache in place: aliased, and the arguments hold
    # this rank's weights and its slice of the cache
    assert mem["alias_bytes"] > 0
    assert rec["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"] - mem["alias_bytes"]
    assert rec["fits"] and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    assert "cell_s=" in capsys.readouterr().out
    report.main(["--dir", str(out)])
    text = capsys.readouterr().out
    assert "| qwen3-0.6b | decode_32k |" in text
    assert "modelled" in text
    row = next(l for l in text.splitlines()
               if l.startswith("| qwen3-0.6b | decode_32k |"))
    assert row.endswith("| Y |")


@pytest.mark.parametrize("remat", (False, True))
def test_costing_sees_remat_recomputation(remat):
    """Four blocks of two ``exp`` (each saves its output, n bytes) on an
    argument of n bytes, with and without ``torch.utils.checkpoint``.
    Without it the forward holds both outputs of every block (8 n) and the
    backward's first gradient adds one n.  With it the forward holds only
    the blocks' outputs (4 n; 5 n at its peak, inside a block), the last
    of which nothing saves, and the backward's recomputation of one block
    (2 n) and its gradient (n) come on top of the three inputs that
    checkpoint saved."""
    from torch.utils.checkpoint import checkpoint
    n = 256 * 256 * 4
    x = torch.empty((256, 256), device="meta", requires_grad=True)

    def block(t):
        return torch.exp(torch.exp(t))

    with costing.MemoryTracker([x]) as mem:
        h = x
        for _ in range(4):
            h = checkpoint(block, h, use_reentrant=False) if remat \
                else block(h)
        z = h.sum()
        held, fwd_peak = mem.live, mem.peak
        del h
        saved = mem.live
        z.backward()
        del z
    if remat:
        assert (held, fwd_peak, saved) == (4 * n + 4, 5 * n, 3 * n + 4)
        assert mem.peak == 6 * n + 8
    else:
        assert (held, fwd_peak, saved) == (8 * n + 4, 8 * n + 4, 8 * n + 4)
        assert mem.peak == 9 * n + 8
    assert mem.live == n == x.grad.numel() * 4


def test_costing_sees_saved_and_freed_storages():
    """The memory tracker counts a storage once however many views share
    it, keeps what autograd saves until its last reference goes, and
    frees a temporary that nothing holds."""
    n = 256 * 256 * 4
    x = torch.empty((256, 256), device="meta", requires_grad=True)
    with costing.MemoryTracker([x]) as mem:
        y = torch.exp(x)            # saved for the backward
        v = y.view(-1)
        assert mem.live == n
        z = (y * 2).sum()           # y * 2 is freed at once
        assert (mem.live, mem.peak) == (n + 4, 2 * n + 4)
        del v
        z.backward()                # x.grad, y still held
        assert mem.live == 2 * n + 4
        del y, z
    assert mem.live == n == x.grad.numel() * 4
    assert mem.peak == 3 * n + 8
    # host tensors are not the step's memory
    with costing.MemoryTracker() as mem:
        host = torch.arange(1 << 16)
        kept = torch.zeros((4,), device="meta")
    assert (mem.live, mem.peak) == (16, 16)
    del host, kept
