"""The recurrent archs' sharded steps on the CPU: recurrentgemma-2b
(RG-LRU and local attention) and xlstm-350m (mLSTM and sLSTM) at their
SMOKE configs in float32 on 2 and 4 gloo ranks, over ``(data, model)``
meshes (1, 2), (1, 4) and (2, 2).

* Serving (``make_serve_steps(mesh=)``): a prefill of 20 tokens and 4
  decode steps (each fed the same next token on every path), held to the
  port's one-rank steps within 1e-5 relative L2 with equal greedy tokens,
  and to the JAX package's unsharded ``make_serve_steps`` within 2e-3
  (prefill) and 5e-3 (decode), as ``test_torch_serve_sharded.py`` holds
  the attention archs.  The RG-LRU's width (64) splits over the model
  axis, and its state ``h`` with it; the mLSTM's 2 heads divide model 2
  (head-local cells) but not model 4 (every head on every rank, the
  inner width split), and its state ``C`` is split over ``dv`` and ``n``
  over ``dk``, so it is gathered for the cell and each rank keeps its
  part.
* Each rank's bytes of parameters and of the cache (states and the local
  layers' k/v): its slices by the specs.
* Training (``make_train_step(mesh=)``): each rank's gradient shard
  within 1e-5 relative L2 of the one-rank gradient's slice, and two
  steps by the rules of ``test_torch_train_sharded.py``; on (2, 2) the
  first step against the JAX package's sharded step
  (``build(state_shardings(...))`` on 4 host devices).

One set of 4 rank processes runs every case
(``torch_ranks.recurrent_sharded_rank``); one JAX subprocess runs the JAX
package's steps of the file.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import run_ranks
from repro_torch.models import sharding, transformer
from test_torch_train import STEP_TOL, _close
from test_torch_train_sharded import (GRAD_TOL, MESHES, check_moved,
                                      check_steps, cut, decay_of, jax_steps,
                                      make_case, mesh_id, one_rank, rel_l2,
                                      runs, whole_params)

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
B, PREFILL, STEPS, MAX_LEN = 2, 20, 4, 34
PREFILL_TOL, DECODE_TOL = 2e-3, 5e-3     # against JAX
ONE_RANK_TOL = 1e-5                      # against the port's one rank


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _serve_case(arch):
    """(arch, numpy tree, tokens, None, prefill, max_len)."""
    cfg = _f32(jget_smoke(arch))
    tree = jax.tree.map(np.asarray,
                        jt.init_params(cfg, jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (B, PREFILL + STEPS))
    return arch, tree, tokens, None, PREFILL, MAX_LEN


@pytest.fixture(scope="module")
def serve_cases():
    return {arch: _serve_case(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def train_cases():
    return {arch: make_case(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(serve_cases, train_cases, tmp_path_factory):
    return run_ranks(torch_ranks.recurrent_sharded_rank, 4, device="cpu",
                     args=(MESHES, list(serve_cases.values()),
                           list(train_cases.values())),
                     timeout=300, store_dir=tmp_path_factory.mktemp("rs"))


@pytest.fixture(scope="module")
def one(serve_cases, train_cases):
    """The port's one-rank serve steps and train steps."""
    out = {}
    for arch in ARCHS:
        case = serve_cases[arch]
        cfg = _f32(get_smoke(arch))
        model = convert.params_from_numpy(cfg, case[1], device="cpu")
        out[arch] = {"serve": torch_ranks.serve_steps_on(cfg, model,
                                                         *case[2:]),
                     "train": one_rank(train_cases[arch])}
    return out


@pytest.fixture(scope="module")
def jax_out(serve_cases, train_cases, tmp_path_factory):
    return jax_steps(tmp_path_factory.mktemp("jx"),
                     [train_cases[a] for a in ARCHS], serve=ARCHS,
                     serve_tokens={a: serve_cases[a][2] for a in ARCHS},
                     prefill=PREFILL, max_len=MAX_LEN)


def _serve_runs(ranks, mesh, arch):
    return [ranks[r]["serve"][mesh, arch] for r in range(math.prod(mesh))]


def _train(ranks):
    return [r["train"] for r in ranks]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_sharded_serving_matches_one_rank_and_jax(ranks, one, jax_out, mesh,
                                                   arch):
    want = one[arch]["serve"]
    jx = jax_out[arch + "/serve"]
    runs_ = _serve_runs(ranks, mesh, arch)
    for run in runs_:
        got = run["logits"]
        np.testing.assert_array_equal(got, runs_[0]["logits"])
        for step in range(len(want)):
            assert rel_l2(got[step], want[step]) <= ONE_RANK_TOL, step
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got[0], jx[0], atol=PREFILL_TOL,
                                   rtol=PREFILL_TOL)
        np.testing.assert_allclose(got[1:], jx[1:], atol=DECODE_TOL,
                                   rtol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_rank_bytes_are_the_slices(ranks, mesh, arch):
    """Parameters and cache (the recurrent states, the local layers' k/v):
    each rank's bytes are its slices by the specs."""
    cfg = _f32(get_smoke(arch))
    shape = dict(zip(torch_ranks.SHARD_AXES, mesh))
    whole = transformer.Transformer(cfg, device="meta")
    cache = transformer.init_cache(cfg, B, MAX_LEN, cfg.cdtype,
                                   device="meta")
    specs = sharding.layer_cache_specs(cfg, cache, shape)

    def leaves(c, s):
        if isinstance(c, dict):
            for k in c:
                yield from leaves(c[k], s[k])
        else:
            yield c, s

    cache_bytes = sum(sharding.local_numel(t.shape, s, shape) *
                      t.element_size() for c, s in zip(cache, specs)
                      for t, s in leaves(c, s))
    for run in _serve_runs(ranks, mesh, arch):
        assert run["bytes"] == sharding.spec_bytes(cfg, whole, shape)
        assert run["cache_bytes"] == cache_bytes
    assert cache_bytes < sum(t.numel() * t.element_size() for c in cache
                             for part in c.values() for t in part.values())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_sharded_train_matches_one_rank(ranks, one, mesh, arch):
    ref = one[arch]["train"]
    for run in runs(_train(ranks), mesh, arch):
        assert abs(run["grads"]["loss"] - ref["grads"]["loss"]) <= STEP_TOL
        for name, g in run["grads"]["grads"].items():
            want = ref["grads"]["grads"][name][cut(run, name)]
            assert rel_l2(g, want) <= GRAD_TOL, (name, rel_l2(g, want))
        check_steps(run, run["steps"], ref["steps"], ref["init"],
                    decay_of(arch))
        assert run["bytes"] == 3 * run["spec_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_matches_jax_sharded_step(ranks, one, jax_out, arch):
    cfg = _f32(get_smoke(arch))
    rs = runs(_train(ranks), (2, 2), arch)
    met = rs[0]["steps"]["metrics"][0]
    for k in ("loss", "gnorm", "lr", "nll", "aux"):
        assert _close(met[k], float(jax_out[f"{arch}/0/met/{k}"]),
                      STEP_TOL), k
    got = convert.named_to_numpy(cfg, {
        k: torch.from_numpy(v) for k, v in
        whole_params(rs, list(rs[0]["cuts"])).items()})
    old = jax.tree.leaves(convert.named_to_numpy(cfg, {
        k: torch.from_numpy(v) for k, v in one[arch]["train"]["init"].items()}))
    for j, (have, o) in enumerate(zip(jax.tree.leaves(got), old)):
        check_moved(have, jax_out[f"{arch}/0/params/{j}"], o, j)
