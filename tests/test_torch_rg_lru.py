"""The port's RG-LRU scan on the CPU against the JAX package: the plain
``rg_lru_scan`` (the associative form) against JAX's Pallas kernel
(interpret mode) and its sequential oracle at the JAX spec's three
samples, the port's own oracle, the decode step, and the CUDA kernel's
arithmetic emulated in PyTorch (chunk aggregates from a zero state,
folded from h0 in chunk order, then each chunk re-walked) against JAX's
oracle.  Inputs are made with numpy and handed to both packages.
Tolerances are the JAX spec's: 1e-4, 5e-2 for bf16."""

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
from repro_torch.kernels.rg_lru.ops import CHUNK, parts

IDS = ["small", "batch2", "bf16"]


def _inputs(B, S, W, dtype, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    la = (-decay * np.abs(rng.standard_normal((B, S, W)))).astype(np.float32)
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


def _fold(aggs, h):
    """h through (decay, end) aggregates in order: h = exp(decay) h + end."""
    for decay, end in aggs:
        h = torch.exp(decay) * h + end
    return h


def _run(aggs):
    """Aggregates folded in order into one, from the identity (0, 0):
    decays summed, end = exp(decay) end + e."""
    decay, end = torch.zeros_like(aggs[0][0]), torch.zeros_like(aggs[0][0])
    for d, e in aggs:
        end = torch.exp(d) * end + e
        decay = decay + d
    return decay, end


def _one_pass(log_a, b, h0, chunk=CHUNK):
    """The CUDA kernel's arithmetic (``csrc/rg_lru.cu``) in float32.  A
    chunk is cut into ``parts(dtype)`` parts; each part walks its steps
    from a zero state to its aggregate (decay, the sum of its log_a; end,
    its state), and a chunk's aggregate is its parts' folded in order
    (decays summed in order).  Chunk c's predecessors 0 .. c - 1 are cut
    into ``parts`` runs of ceil(c / parts) chunks, each run folded in
    order into one aggregate, and the runs applied in order to h0; each
    part enters through the parts before it, then re-walks its own steps.
    Returns (hs, h_last) in b's dtype."""
    la, bb = log_a.float(), b.float()
    B, S, W = b.shape
    nc = max(1, -(-S // chunk))
    P = chunk // parts(b.dtype)

    def walk(t1, t2, h, out=None):
        decay = torch.zeros(B, W)
        for t in range(t1, t2):
            h = torch.exp(la[:, t]) * h + bb[:, t]
            decay = decay + la[:, t]
            if out is not None:
                out[:, t] = h
        return decay, h

    part_aggs = [[walk(p, min(p + P, S), torch.zeros(B, W))
                  for p in range(c * chunk, (c + 1) * chunk, P)]
                 for c in range(nc)]
    chunk_aggs = []
    for c in range(nc - 1):
        decay, end = part_aggs[c][0]
        for d, e in part_aggs[c][1:]:
            end = torch.exp(d) * end + e
            decay = decay + d
        chunk_aggs.append((decay, end))
    hs = torch.zeros(B, S, W)
    h = h0.float()
    n_parts = parts(b.dtype)
    for c in range(nc):
        q = -(-c // n_parts)
        runs = [_run(chunk_aggs[min(i * q, c):min(i * q + q, c)])
                if min(i * q + q, c) > min(i * q, c) else
                (torch.zeros(B, W), torch.zeros(B, W))
                for i in range(n_parts)]
        h_c = _fold(runs, h0.float())
        for i, p in enumerate(range(c * chunk, min(S, (c + 1) * chunk), P)):
            _, h = walk(p, min(p + P, S), _fold(part_aggs[c][:i], h_c), hs)
    return hs.to(b.dtype), h.to(b.dtype)


# (B, S, W, dtype, scale of |log_a|, tolerance): the JAX spec's samples,
# a ragged last chunk, S one past a chunk and S = 0, and S = 3072 (the
# served prompt, 24 chunks) at a narrow width with log_a = -1e-3 |N|, where
# the carried state grows furthest and an error in the fold shows most
EMULATED = [
    (1, 64, 128, torch.float32, 0.1, 1e-4),
    (2, 512, 256, torch.float32, 0.1, 1e-4),
    (2, 256, 128, torch.bfloat16, 0.1, 5e-2),
    (2, 300, 33, torch.float32, 0.1, 1e-4),
    (1, 129, 8, torch.float32, 0.1, 1e-4),
    (2, 0, 8, torch.float32, 0.1, 1e-4),
    (1, 3072, 8, torch.float32, 1e-3, 1e-4),
    (1, 3072, 8, torch.bfloat16, 1e-3, 5e-2),
    (2, 3072, 4, torch.float32, 0.1, 1e-4),
]


@pytest.mark.parametrize(
    "B,S,W,dtype,decay,tol", EMULATED,
    ids=[f"{B}x{S}x{W}-{str(dt)[6:]}-{d:g}" for B, S, W, dt, d, _ in
         EMULATED])
def test_kernel_arithmetic_matches_jax_oracle(B, S, W, dtype, decay, tol):
    jargs, targs = _inputs(B, S, W, dtype, seed=S + W, decay=decay)
    got = _one_pass(*targs)
    want = jref(*jargs)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=10 * tol)
    if decay < 0.01 and S:
        # the state carried furthest: past the fold's reach if it were off
        assert np.abs(_np(got[0])).max() > 10.0
