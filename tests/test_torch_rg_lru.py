"""The port's RG-LRU scan on the CPU against the JAX package: the plain
``rg_lru_scan`` (the associative form) against JAX's Pallas kernel
(interpret mode) and its sequential oracle at the JAX spec's three
samples, the port's own oracle, and the decode step.  Inputs are made
with numpy and handed to both packages.  Tolerances are the JAX spec's:
1e-4, 5e-2 for bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rg_lru import rg_lru_ref as jref
from repro.kernels.rg_lru import rg_lru_scan as jscan
from repro.kernels.rg_lru import rg_lru_step as jstep
from repro_torch.kernels import registry
from repro_torch.kernels.rg_lru import (FEATURE_CASES, rg_lru_ref,
                                        rg_lru_scan, rg_lru_step)

IDS = ["small", "batch2", "bf16"]


def _inputs(B, S, W, dtype, seed):
    rng = np.random.default_rng(seed)
    la = (-0.1 * np.abs(rng.standard_normal((B, S, W)))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(x, jdt) for x in (la, b, h0)],
            [torch.from_numpy(x).to(dtype) for x in (la, b, h0)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("jimpl", ["pallas", "ref"])
@pytest.mark.parametrize("case", FEATURE_CASES, ids=IDS)
def test_plain_scan_matches_jax(case, jimpl):
    B, S, W, dtype, tol = case
    jargs, targs = _inputs(B, S, W, dtype, seed=700 + S)
    want = jscan(*jargs, impl=jimpl) if jimpl == "pallas" else jref(*jargs)
    got = rg_lru_scan(*targs)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=10 * tol)


@pytest.mark.parametrize("case", FEATURE_CASES, ids=IDS)
def test_port_oracle_matches_plain_scan(case):
    B, S, W, dtype, tol = case
    _, targs = _inputs(B, S, W, dtype, seed=1)
    for g, w in zip(rg_lru_scan(*targs), rg_lru_ref(*targs)):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=10 * tol)


@pytest.mark.parametrize("S,W", [(1, 5), (37, 33), (0, 8)])
def test_ragged_and_empty_sequences(S, W):
    _, targs = _inputs(2, S, W, torch.float32, seed=S)
    hs, h_last = rg_lru_scan(*targs)
    want_hs, want_last = rg_lru_ref(*targs)
    assert hs.shape == (2, S, W) and h_last.shape == (2, W)
    np.testing.assert_allclose(hs.numpy(), want_hs.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(h_last.numpy(), want_last.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_step_matches_jax_and_continues_the_scan():
    jargs, targs = _inputs(2, 9, 16, torch.float32, seed=5)
    hs, _ = rg_lru_scan(*(t[:, :8] if t.ndim == 3 else t for t in targs))
    got = rg_lru_step(targs[0][:, 8], targs[1][:, 8], hs[:, -1])
    want = jstep(jargs[0][:, 8], jargs[1][:, 8],
                 jnp.asarray(hs[:, -1].numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    full, _ = rg_lru_scan(*targs)
    np.testing.assert_allclose(got.numpy(), full[:, 8].numpy(), atol=1e-4,
                               rtol=1e-3)


def test_wrapper_on_cpu_launches_nothing_and_checks_impl():
    _, targs = _inputs(1, 8, 4, torch.float32, seed=2)
    before = registry.launches()
    rg_lru_scan(*targs)
    rg_lru_scan(*targs, impl="plain")
    assert registry.launches() == before
    with pytest.raises(ValueError):
        rg_lru_scan(*targs, impl="pallas")
