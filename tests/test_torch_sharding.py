"""The port's partition specs and placement against the JAX package's:
``transformer.param_pspecs`` and ``cache_pspecs`` leaf for leaf for all
ten archs at their full config shapes (``jax.eval_shape`` on the JAX side,
the meta device on the port's; no weight is made) on the meshes
``{"data": 1, "model": 4}``, ``{"data": 2, "model": 2}``, ``{"data": 4}``
and ``{"pod": 2, "data": 2, "model": 2}`` (``fsdp=("pod", "data")``), the
expert padding from ``launch.mesh.expert_pad_for``, the cache at batch 8
and ``max_len`` 4096; ``mesh_axes`` and ``expert_pad_for`` as the JAX
package's.  A rank's bytes at full shapes: the JAX specs' slices plus the
stacked norms' layers the port replicates over data.  Placement on the
CPU, one coordinate of a mesh at a time: ``shard_params``,
``params_from_numpy(mesh=)`` and ``init_shards`` cut the same slices of
the same weights.  ``init_params(expert_pad=3)`` against the JAX
package's, and its padded experts take no token.  The recurrent archs'
``init_shards`` is bitwise their whole init, and their sharded steps run
on a 1-rank communicator (``test_torch_recurrent_sharded.py`` runs them
on meshes).  The softmax partials of a cache split over time merge into
``decode_attention``."""

import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import Communicator
from repro_torch.kernels.flash_attention import (decode_attention,
                                                 decode_partial,
                                                 merge_partials)
from repro_torch.launch.mesh import expert_pad_for, mesh_axes
from repro_torch.models import moe, sharding, transformer
from repro_torch.serve import make_serve_steps

MESHES = {"1x4": ({"data": 1, "model": 4}, ("data",)),
          "2x2": ({"data": 2, "model": 2}, ("data",)),
          "data4": ({"data": 4}, ("data",)),
          "pod2x2x2": ({"pod": 2, "data": 2, "model": 2}, ("pod", "data"))}
CACHE_BATCH, CACHE_LEN = 8, 4096
RECURRENT = ("recurrentgemma-2b", "xlstm-350m")


def _mesh(shape):
    """A stand-in for a mesh: its axes' sizes, as ``mesh_axes`` and
    ``expert_pad_for`` read them (both packages)."""
    return types.SimpleNamespace(mesh_shape=shape, shape=shape,
                                 axis_names=tuple(shape))


def _coords(shape, coords, device="cpu"):
    """One coordinate of a mesh, as the placement functions read it."""
    return types.SimpleNamespace(mesh_shape=dict(shape), axes=tuple(shape),
                                 coords=tuple(coords),
                                 device=torch.device(device))


def _jax_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, pad):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: jt.init_params(
        cfg, jax.random.PRNGKey(0), expert_pad=pad))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_jax(arch, mesh):
    shape, fsdp = MESHES[mesh]
    cfg = get_config(arch)
    pad = expert_pad_for(cfg, _mesh(shape))
    assert pad == jcells.expert_pad_for(jget_config(arch), _mesh(shape))
    want = jt.param_pspecs(jget_config(arch), _jax_shapes(arch, pad), shape,
                           fsdp=fsdp)
    got = transformer.param_pspecs(
        cfg, transformer.init_params(cfg, device="meta", expert_pad=pad),
        shape, fsdp=fsdp)
    assert jax.tree.structure(jax.tree.map(
        lambda _: 0, want, is_leaf=lambda x: isinstance(x, P))) == \
        jax.tree.structure(jax.tree.map(
            lambda _: 0, got, is_leaf=lambda x: isinstance(x, tuple)))
    assert _port_leaves(got) == _jax_leaves(want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_jax(arch, mesh):
    shape, fsdp = MESHES[mesh]
    jcfg, cfg = jget_config(arch), get_config(arch)
    want = jt.cache_pspecs(jcfg, jax.eval_shape(lambda: jt.init_cache(
        jcfg, CACHE_BATCH, CACHE_LEN, jcfg.cdtype)), shape, batch=fsdp)
    cache = transformer.init_cache(cfg, CACHE_BATCH, CACHE_LEN, cfg.cdtype,
                                   device="meta")
    got = transformer.cache_pspecs(cfg, cache, shape, batch=fsdp)
    assert _port_leaves(got) == _jax_leaves(want)
    # the same from a tree of shapes in the JAX layout
    again = transformer.cache_pspecs(
        cfg, convert.cache_shape_tree(cfg, cache), shape, batch=fsdp)
    assert again == got


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "pod2x2x2"])
def test_mesh_axes_match_jax(mesh):
    shape, fsdp = MESHES[mesh]
    assert mesh_axes(_mesh(shape)) == jmesh.mesh_axes(_mesh(shape)) == \
        (fsdp, "model")
    assert mesh_axes(_mesh({"data": 4})) == (("data",), None)


def _local_elems(shape, spec, mesh_shape):
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return math.prod(n // math.prod(mesh_shape[a]
                                    for a in sharding._axes(e))
                     for n, e in zip(shape, spec))


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "pod2x2x2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_bytes_at_full_shapes(arch, mesh):
    """One rank's float32 bytes by the port's specs: the JAX specs' slices
    of every leaf plus ``stacked_replicated_bytes``."""
    shape, fsdp = MESHES[mesh]
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    pad = expert_pad_for(cfg, _mesh(shape))
    jshapes = _jax_shapes(arch, pad)
    jspecs = jt.param_pspecs(jget_config(arch), jshapes, shape, fsdp=fsdp)
    jax_bytes = 4 * sum(_local_elems(leaf.shape, spec, shape) for leaf, spec
                        in zip(jax.tree.leaves(jshapes), _jax_leaves(jspecs)))
    model = transformer.init_params(cfg, device="meta", expert_pad=pad)
    extra = sharding.stacked_replicated_bytes(cfg, model, shape, fsdp=fsdp)
    assert sharding.spec_bytes(cfg, model, shape, fsdp=fsdp) == \
        jax_bytes + extra


def test_stacked_norms_replicate_over_data():
    """qwen3-0.6b's (28, 1024) and (28, 128) norm stacks get ("data",
    "model") on a (2, 2) mesh; a rank holds all 28 layers' model slices
    of the four, where the JAX spec gives it 14."""
    shape = MESHES["2x2"][0]
    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              compute_dtype="float32")
    model = transformer.init_params(cfg, device="meta")
    specs = sharding.port_specs(cfg, model, shape)
    assert specs["layers.0.norm1"] == ("model",)
    want = 14 * 4 * (2 * 1024 // 2 + 2 * 128 // 2)
    assert sharding.stacked_replicated_bytes(cfg, model, shape) == want


SMOKE_ARCHS = ("qwen3-0.6b", "gemma2-27b", "minicpm3-4b",
               "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
               "llama-3.2-vision-11b", "whisper-tiny")


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_placement_cuts_the_specs_slices(arch):
    """At every coordinate of a (2, 2) and a (1, 4) mesh: ``shard_params``
    of a whole model, ``params_from_numpy(mesh=)`` of its tree and
    ``init_shards`` from a generator seeded alike hold the same bits, the
    slices of the whole leaves by the specs."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device="cpu")
    tree = convert.params_to_numpy(cfg, whole)
    full = dict(whole.named_parameters())
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        specs = sharding.port_specs(cfg, whole, shape)
        for coords in np.ndindex(*shape.values()):
            group = _coords(shape, coords)
            a = sharding.shard_params(cfg, whole, group)
            b = convert.params_from_numpy(cfg, tree, mesh=group)
            c = sharding.init_shards(cfg, group,
                                     torch.Generator().manual_seed(3))
            for m in (b, c):
                for (name, p), q in zip(a.named_parameters(),
                                        m.parameters()):
                    assert torch.equal(p, q), (shape, coords, name)
            for name, p in a.named_parameters():
                cut = sharding.local_slices(full[name].shape, specs[name],
                                            group)
                assert torch.equal(p, full[name][cut]), name
                assert p.pspec == specs[name]


def test_placement_refuses_a_tree_of_another_model():
    cfg = dataclasses.replace(get_smoke("qwen3-0.6b"),
                              compute_dtype="float32")
    tree = convert.params_to_numpy(
        cfg, transformer.init_params(cfg, device="cpu"))
    tree["extra"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="only in the JAX tree"):
        convert.params_from_numpy(cfg, tree,
                                  mesh=_coords({"data": 1, "model": 2},
                                               (0, 0)))


def _jax_tree(cfg, pad, seed=5):
    return jax.tree.map(np.asarray, jt.init_params(
        cfg, jax.random.PRNGKey(seed), expert_pad=pad))


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"))
def test_expert_pad_matches_jax(arch):
    """``init_params(expert_pad=3)``: the shapes of JAX's (8 experts padded
    to 9), and JAX's padded weights through ``convert`` give JAX's logits,
    in both directions."""
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    tree = _jax_tree(jcfg, 3)
    model = convert.params_from_numpy(cfg, tree, device="cpu")
    mine = transformer.init_params(cfg, device="meta", expert_pad=3)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(p.shape) for n, p in mine.named_parameters()}
    back = convert.params_to_numpy(cfg, model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert any(x.shape[-1] == 9 for x in jax.tree.leaves(tree))
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
    lj, _, _ = jt.apply(jcfg, jax.tree.map(jnp.asarray, tree),
                        jnp.asarray(tok), mode="train")
    lt, _, _ = transformer.apply(cfg, model, torch.from_numpy(tok),
                                 mode="train")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)


def test_padded_experts_take_no_tokens():
    """The padded experts are masked in the router: the padded model gives
    the unpadded model's output bitwise (the same real experts, the
    capacity from the real count), whatever the padded experts hold."""
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"),
                              compute_dtype="float32")
    padded = moe.init(cfg, torch.Generator().manual_seed(0), pad_to=3,
                      device="cpu")
    plain = moe.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    E = cfg.n_experts
    assert padded.router.shape[1] == 9 and plain.router.shape[1] == E
    with torch.no_grad():
        plain.router.copy_(padded.router[:, :E])
        for name in ("gate", "up", "down"):
            getattr(plain.experts, name).copy_(
                getattr(padded.experts, name)[:E])
        padded.router[:, E:] = 10.0          # would win every token
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    y_pad, aux = moe.apply(cfg, padded, x)
    y, _ = moe.apply(cfg, plain, x)
    assert torch.equal(y_pad, y)
    assert float(aux["dropped"]) >= 0.0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_sharded_steps_on_one_rank(arch):
    """``init_shards`` of a recurrent arch is bitwise the whole init (its
    ``lam``, conv taps and gate biases drawn in the init's order), and
    ``make_serve_steps(mesh=)`` on a 1-rank communicator gives the
    unsharded steps' logits."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    mesh = Communicator.single("cpu")
    shards = sharding.init_shards(cfg, mesh)
    model = transformer.init_params(cfg, device="cpu")
    mine = dict(shards.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(mine[name], p), name
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)))
    out = []
    for params, m in ((model, None), (shards, mesh)):
        prefill, decode, init_cache = make_serve_steps(
            cfg, m, max_len=16, batch=2, device="cpu")
        lg, cache = prefill(params, tok[:, :10], init_cache())
        lg2, _ = decode(params, tok[:, 10:11], cache, 10)
        out.append((lg, lg2))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window", [None, 5])
def test_time_slices_softmax_partials_merge(window):
    """``decode_attention`` over a cache cut into 4 slices of time, one of
    them with no live key (past the query), from each slice's
    ``decode_partial`` merged by ``merge_partials``."""
    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, T, D = 2, 4, 2, 16, 8
    q = torch.randn(B, Hq, 1, D, generator=g)
    k = torch.randn(B, Hkv, T, D, generator=g)
    v = torch.randn(B, Hkv, T, D + 2, generator=g)
    kv_len = torch.tensor([11, 9])
    want = decode_attention(q, k, v, kv_len=kv_len, window=window,
                            softcap=30.0)
    parts = [decode_partial(q, k[:, :, s:s + 4], v[:, :, s:s + 4],
                            kv_len=kv_len, window=window, softcap=30.0,
                            k_positions=torch.arange(s, s + 4).expand(B, 4))
             for s in range(0, T, 4)]
    acc, l, m = (torch.stack(t) for t in zip(*parts))
    got = merge_partials(acc, l, m).reshape(B, Hq, 1, D + 2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
