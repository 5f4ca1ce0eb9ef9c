"""The port's chunkwise mLSTM on the CPU against the JAX package: the
plain ``mlstm_chunkwise`` (what ``mlstm_scan`` runs on a CPU tensor)
against JAX's Pallas kernel in interpret mode at zero state and S
divisible by the chunk (the JAX spec's two samples), against JAX's
``mlstm_chunkwise`` at a nonzero state and a ragged S, and against JAX's
sequential oracle; h and the final state (C, n, m) alike.  Then the decode
step, S = 1, the port's own oracle and the wrapper's dispatch.  Inputs
are made with numpy and handed to both packages.  Tolerance: the JAX
spec's 2e-3 (atol, with rtol 10x as its harness)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm import mlstm_chunkwise as jchunkwise
from repro.kernels.mlstm import mlstm_pallas as jpallas
from repro.kernels.mlstm import mlstm_ref as jref
from repro.kernels.mlstm import mlstm_step as jstep
from repro_torch.kernels import registry
from repro_torch.kernels.mlstm import (FEATURE_CASES, chunk_flops,
                                       mlstm_chunkwise, mlstm_ref,
                                       mlstm_scan, mlstm_step)

TOL = registry.get("mlstm").tol           # the JAX spec's 2e-3
IDS = ["spec0", "spec1", "state", "ragged_state"]


def _inputs(B, H, S, dk, dv, nonzero_state, seed):
    """(JAX arrays, torch tensors) of q, k, v, log_i, log_f and the state
    (None for zero), drawn as the JAX spec draws them."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, S, d)).astype(np.float32)
            for d in (dk, dk, dv)]
    arrs.append((rng.standard_normal((B, H, S)) - 1.0).astype(np.float32))
    arrs.append((-0.1 * np.abs(rng.standard_normal((B, H, S))))
                .astype(np.float32))
    state = None
    if nonzero_state:
        state = [rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, dk, dv), (B, H, dk), (B, H))]
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    if state is not None:
        jx.append(tuple(jnp.asarray(s) for s in state))
        tx.append(tuple(torch.from_numpy(s) for s in state))
    return jx, tx


def _close(got, want, tol=TOL):
    h, (C, n, m) = got
    wh, (wC, wn, wm) = want
    assert h.shape == wh.shape and C.shape == wC.shape
    for g, w in zip((h, C, n, m), (wh, wC, wn, wm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=10 * tol)


@pytest.mark.parametrize("case", FEATURE_CASES[:2], ids=IDS[:2])
def test_plain_matches_jax_pallas_at_zero_state(case):
    B, H, S, dk, dv, chunk, nonzero = case
    jargs, targs = _inputs(B, H, S, dk, dv, nonzero, seed=600 + S)
    want = jpallas(*jargs, chunk=chunk, interpret=True)
    _close(mlstm_chunkwise(*targs, chunk=chunk), want)
    _close(mlstm_scan(*targs, chunk=chunk), want)


@pytest.mark.parametrize("case", FEATURE_CASES, ids=IDS)
def test_plain_matches_jax_chunkwise(case):
    """Every feature case, the nonzero-state and ragged ones included
    (96 + 37 steps at chunk 32), against the JAX package's plain form."""
    B, H, S, dk, dv, chunk, nonzero = case
    jargs, targs = _inputs(B, H, S, dk, dv, nonzero, seed=700 + S)
    _close(mlstm_chunkwise(*targs, chunk=chunk),
           jchunkwise(*jargs, chunk=chunk))


@pytest.mark.parametrize("case", FEATURE_CASES, ids=IDS)
def test_plain_matches_jax_oracle(case):
    B, H, S, dk, dv, chunk, nonzero = case
    jargs, targs = _inputs(B, H, S, dk, dv, nonzero, seed=800 + S)
    want = jref(*jargs)
    _close(mlstm_chunkwise(*targs, chunk=chunk), want)
    _close(mlstm_ref(*targs), want)


@pytest.mark.parametrize("S,chunk", [(1, 128), (1, 1), (5, 2), (37, 128)])
def test_short_and_ragged_sequences(S, chunk):
    jargs, targs = _inputs(2, 2, S, 16, 8, True, seed=S + chunk)
    _close(mlstm_chunkwise(*targs, chunk=chunk),
           jchunkwise(*jargs, chunk=chunk))


def test_step_matches_jax_and_continues_the_scan():
    """Prefill 20 steps, then decode the 21st: JAX's step on the same
    state, and the scan over all 21 steps."""
    jargs, targs = _inputs(2, 2, 21, 16, 24, True, seed=5)
    q, k, v, li, lf, st = targs
    _, state = mlstm_chunkwise(q[:, :, :20], k[:, :, :20], v[:, :, :20],
                               li[..., :20], lf[..., :20], st, chunk=8)
    got_h, got_state = mlstm_step(q[:, :, 20], k[:, :, 20], v[:, :, 20],
                                  li[..., 20], lf[..., 20], state)
    jq, jk, jv, jli, jlf, _ = jargs
    want = jstep(jq[:, :, 20], jk[:, :, 20], jv[:, :, 20], jli[..., 20],
                 jlf[..., 20], tuple(jnp.asarray(s.numpy()) for s in state))
    _close((got_h, got_state), want, 1e-5)
    full_h, full_state = mlstm_chunkwise(*targs, chunk=8)
    _close((got_h, got_state),
           (full_h[:, :, 20].numpy(), tuple(s.numpy() for s in full_state)))


def test_wrapper_on_cpu_launches_nothing_and_checks_impl():
    _, targs = _inputs(1, 2, 8, 4, 4, True, seed=2)
    before = registry.launches()
    mlstm_scan(*targs)
    with registry.plain():
        mlstm_scan(*targs)
    mlstm_scan(*targs, impl="plain")
    assert registry.launches() == before
    with pytest.raises(ValueError):
        mlstm_scan(*targs, impl="pallas")


def test_chunk_flops_count_the_ragged_chunk():
    # three chunks of 4 and one of 1 at dk = dv = 2: q k^T and scores v
    # (2 n^2 (dk + dv)), q C and k^T v (4 n dk dv); n_t = D k is never formed
    per = [2 * n * n * (2 + 2) + 4 * n * 2 * 2 for n in (4, 4, 4, 1)]
    assert chunk_flops(13, 2, 2, chunk=4) == sum(per)
    assert chunk_flops(3072, 512, 512) == 24 * (
        2 * 2 * 128 ** 2 * 512 + 2 * 2 * 128 * 512 ** 2)


def _split(x):
    """x as bf16 hi + lo: the kernel's bf16 pair for a float32 operand."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tensor_core_route(q, k, v, log_i, log_f, state, chunk, p_split):
    """The roundings of the kernel's bf16 route (``mlstm_bf16``) in plain
    PyTorch: bf16 q, k, v as stored, products summed in float32, dk^-1/2 on
    the q k^T, q C and q . n sums, the state's C and n (in q . n) and the
    scaled keys a . k of the hand-off as bf16 hi + lo pairs (n's update
    sums a . k in float32), P as a pair (``p_split``) or rounded to bf16
    alone, h rounded to bf16.  S divisible by ``chunk``."""
    B, H, S, dk = q.shape
    scale = dk ** -0.5
    C, n, m = state
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for j0 in range(0, S, chunk):
        qc, kc, vc = (x[:, :, j0:j0 + chunk] for x in (q, k, v))
        li, lf = log_i[..., j0:j0 + chunk], log_f[..., j0:j0 + chunk]
        c = torch.cumsum(lf, -1)
        w = torch.where(tri, c[..., :, None] - c[..., None, :]
                        + li[..., None, :], -1e30)
        m_t = torch.maximum(w.amax(-1), c + m[..., None])
        carry = torch.exp(c + m[..., None] - m_t)
        p = (qc @ kc.transpose(-1, -2)) * scale * torch.exp(
            w - m_t[..., None])
        p_hi, p_lo = _split(p)
        c_hi, c_lo = _split(C)
        num = (p_hi @ vc + (p_lo @ vc if p_split else 0.0)
               + carry[..., None] * scale * (qc @ c_hi + qc @ c_lo))
        n_hi, n_lo = _split(n)
        qn = ((qc * n_hi[..., None, :]).sum(-1)
              + (qc * n_lo[..., None, :]).sum(-1)) * scale
        den = torch.maximum((p.sum(-1) + carry * qn).abs(), torch.exp(-m_t))
        hs.append((num / den[..., None]).bfloat16())
        w_out = c[..., -1:] - c + li
        m_new = torch.maximum(c[..., -1] + m, w_out.amax(-1))
        decay = torch.exp(c[..., -1] + m - m_new)
        ak = kc * torch.exp(w_out - m_new[..., None])[..., None]
        ak_hi, ak_lo = _split(ak)
        C = decay[..., None, None] * C + (ak_hi.transpose(-1, -2) @ vc
                                          + ak_lo.transpose(-1, -2) @ vc)
        n = decay[..., None] * n + ak.sum(2)
        m = m_new
    return torch.cat(hs, 2), (C, n, m)


@pytest.mark.parametrize("p_split", [True, False], ids=["p_pair", "p_bf16"])
def test_tensor_core_roundings_hold_the_spec_tolerance(p_split):
    """The bf16 route's numerics at the served head dim (512) from a
    nonzero state, against JAX's chunkwise form on the same bf16-valued
    inputs: with P as a bf16 pair (the kernel's choice) h, C, n and m hold
    the spec's tolerance; with P rounded to bf16 alone, as flash attention
    rounds its P, h misses it while the state still holds."""
    B, H, S, dk, chunk = 1, 2, 256, 512, 128
    jargs, targs = _inputs(B, H, S, dk, dk, True, seed=17)
    q, k, v = (x.bfloat16().float() for x in targs[:3])
    jx = [jnp.asarray(x.numpy()) for x in (q, k, v)] + jargs[3:]
    want_h, want_state = jchunkwise(*jx, chunk=chunk)
    got_h, got_state = _tensor_core_route(q, k, v, *targs[3:], chunk,
                                          p_split)
    want_h = torch.tensor(np.asarray(want_h)).bfloat16().float()

    def close(g, w):
        return np.allclose(g.float().numpy(), np.asarray(w), atol=TOL,
                           rtol=10 * TOL)

    assert all(close(g, w) for g, w in zip(got_state, want_state))
    assert close(got_h, want_h) == p_split
