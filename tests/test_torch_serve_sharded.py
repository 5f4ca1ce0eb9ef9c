"""Tensor-parallel serving on the CPU: the eight attention archs' sharded
prefill and decode steps (``make_serve_steps(mesh=)``) on 2 and 4 gloo
ranks, the weights and KV caches split over ``(data, model)`` meshes
(1, 2), (1, 4) and (2, 2) by the JAX package's specs.

At each arch's SMOKE config in float32 (the cross-attention gates opened
to 0.5, as ``test_torch_lm_configs.py`` does), the same numpy weights,
tokens and frontend embeddings go through a prefill of 20 tokens and 4
decode steps (each step fed the same next token on every path) on:

* the JAX package's unsharded ``make_serve_steps``: within 2e-3 for the
  prefill and 5e-3 for decode (the tolerances of
  ``test_torch_lm_configs.py``);
* the port's one-rank steps: within 1e-5 relative L2 at every step, with
  equal greedy tokens (each step's argmax).

``max_len`` 34 splits the caches over time on (1, 2) and (2, 2) and puts
them in ``cache_pspecs``' fallback layout on (1, 4) (34 does not divide
by 4; a trailing dim splits); gemma2's rolling window (16) wraps in the
prefill; the 2 kv heads of qwen3, llama3.2, gemma2, granite and the vlm
split mid-head at model 4 (the heads gathered).  Each rank's parameter
bytes equal its slices by the JAX package's specs.  One set of 4 rank
processes runs every mesh and arch (``torch_ranks.sharded_serve_rank``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from test_torch_lm_configs import open_gates
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro.serve.engine import make_serve_steps as jmake_serve_steps
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import run_ranks
from repro_torch.models import sharding, transformer

ARCHS = ("qwen3-0.6b", "llama3.2-3b", "gemma2-27b", "minicpm3-4b",
         "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
         "llama-3.2-vision-11b", "whisper-tiny")
MESHES = ((1, 2), (1, 4), (2, 2))
B, PREFILL, STEPS, MAX_LEN = 2, 20, 4, 34
PREFILL_TOL, DECODE_TOL = 2e-3, 5e-3     # against JAX
ONE_RANK_TOL = 1e-5                      # against the port's one rank


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _case(arch):
    """(arch, numpy tree, tokens, frontend embeddings, prefill, max_len)."""
    cfg = _f32(jget_smoke(arch))
    tree = open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(1))))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (B, PREFILL + STEPS))
    enc = None
    if cfg.encoder_seq:
        enc = (0.02 * np.random.default_rng(2).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return arch, tree, tokens, enc, PREFILL, MAX_LEN


@pytest.fixture(scope="module")
def cases():
    return {arch: _case(arch) for arch in ARCHS}


def _jax_steps(case):
    arch, tree, tokens, enc, prefill_len, max_len = case
    cfg = _f32(jget_smoke(arch))
    params = jax.tree.map(jnp.asarray, tree)
    prefill, decode, init_cache = jmake_serve_steps(cfg, max_len=max_len,
                                                    batch=B)
    lg, cache = prefill(params, jnp.asarray(tokens[:, :prefill_len]),
                        init_cache(),
                        None if enc is None else jnp.asarray(enc))
    out = [np.asarray(lg)]
    for pos in range(prefill_len, tokens.shape[1]):
        lg, cache = decode(params, jnp.asarray(tokens[:, pos:pos + 1]),
                           cache, pos)
        out.append(np.asarray(lg))
    return np.stack(out)


@pytest.fixture(scope="module")
def refs(cases):
    """Per arch: the JAX package's unsharded steps and the port's one-rank
    steps on the same inputs."""
    out = {}
    for arch, case in cases.items():
        cfg = _f32(get_smoke(arch))
        model = convert.params_from_numpy(cfg, case[1], device="cpu")
        out[arch] = (_jax_steps(case),
                     torch_ranks.serve_steps_on(cfg, model, *case[2:]))
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every mesh and arch on one set of 4 gloo ranks."""
    return run_ranks(torch_ranks.sharded_serve_rank, 4, device="cpu",
                     args=(MESHES, list(cases.values())), timeout=300,
                     store_dir=tmp_path_factory.mktemp("tp"))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _runs(ranks, mesh, arch):
    n = math.prod(mesh)
    return [ranks[r][mesh, arch] for r in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_steps_match_jax(ranks, refs, mesh, arch):
    jax_logits, _ = refs[arch]
    for run in _runs(ranks, mesh, arch):
        got = run["logits"]
        assert got.shape == jax_logits.shape
        np.testing.assert_allclose(got[0], jax_logits[0], atol=PREFILL_TOL,
                                   rtol=PREFILL_TOL)
        np.testing.assert_allclose(got[1:], jax_logits[1:], atol=DECODE_TOL,
                                   rtol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_steps_match_one_rank(ranks, refs, mesh, arch):
    """Every step within 1e-5 relative L2 of the port's one-rank step, the
    greedy tokens equal, and every rank's logits bitwise rank 0's."""
    _, one = refs[arch]
    runs = _runs(ranks, mesh, arch)
    for run in runs:
        np.testing.assert_array_equal(run["logits"], runs[0]["logits"])
    got = runs[0]["logits"]
    for step in range(len(one)):
        assert _rel(got[step], one[step]) <= ONE_RANK_TOL, step
    np.testing.assert_array_equal(got.argmax(-1), one.argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_rank_bytes_are_the_specs(ranks, cases, mesh, arch):
    """Each rank holds the JAX package's slices of every leaf (the JAX
    specs of the tree's own shapes), plus the layers of a stacked leaf
    whose ``reps`` dim the spec splits (replicated here)."""
    cfg = _f32(get_smoke(arch))
    tree = cases[arch][1]
    mesh_shape = dict(zip(torch_ranks.SHARD_AXES, mesh))
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          tree)
    specs = jt.param_pspecs(_f32(jget_smoke(arch)), shapes, mesh_shape)
    jax_bytes = sum(
        math.prod(n // math.prod(mesh_shape[a] for a in sharding._axes(e))
                  for n, e in zip(leaf.shape, tuple(spec) + (None,) * (
                      len(leaf.shape) - len(spec)))) * 4
        for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                PartitionSpec))))
    extra = sharding.stacked_replicated_bytes(
        cfg, transformer.Transformer(cfg, device="meta"), mesh_shape)
    for run in _runs(ranks, mesh, arch):
        assert run["bytes"] == jax_bytes + extra
