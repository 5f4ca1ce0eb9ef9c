"""The port's fused CG updates against the JAX package's, on the CPU.

The same numpy inputs, at the JAX specs' sample shapes, go through the
JAX Pallas kernel (interpret mode), the JAX jnp oracle and the port's
wrapper (plain PyTorch for CPU tensors), to the JAX spec's tolerance in
the registry harness's form (rtol = 10 tol, atol = tol).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cg_fused import ops as jops
from repro.kernels.cg_fused.kernel import xpby_dot_pallas
from repro_torch.kernels import registry
from repro_torch.kernels.cg_fused import (cg_update, row_sq_norm, sq_norm,
                                          xpby_dot)

TOL = registry.get("cg_update").tol


def _c(rng, shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=10 * tol, atol=tol)


def _operands(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [_c(rng, shape) for _ in range(n)]


@pytest.mark.parametrize("alpha_on_device", [False, True])
@pytest.mark.parametrize("shape", [(32, 32), (4, 16, 48), (96, 128)])
def test_cg_update_matches_jax(shape, alpha_on_device):
    p, ap, x, r = _operands(100, shape, 4)
    alpha = 0.37
    ta = torch.tensor(alpha, dtype=torch.float32) if alpha_on_device \
        else alpha
    got = cg_update(ta, *map(torch.from_numpy, (p, ap, x, r)))
    for impl in ("pallas", "jnp"):
        want = jops.cg_update(jnp.float32(alpha), *map(jnp.asarray,
                                                       (p, ap, x, r)),
                              impl=impl)
        for g, w in zip(got, want):
            _close(g, w)
    assert got[2].dtype == torch.float32 and got[2].ndim == 0


def test_cg_update_nan_operand():
    """A NaN in r poisons rs in both packages (CG's stop test then ends
    the loop, see test_torch_nlinv)."""
    p, ap, x, r = _operands(101, (32, 32), 4)
    r[3, 5] = np.nan
    _, r2, rs = cg_update(0.37, *map(torch.from_numpy, (p, ap, x, r)))
    _, jr2, jrs = jops.cg_update(jnp.float32(0.37),
                                 *map(jnp.asarray, (p, ap, x, r)),
                                 impl="pallas")
    assert np.isnan(float(rs)) and np.isnan(float(jrs))
    np.testing.assert_array_equal(np.isnan(r2.numpy()),
                                  np.isnan(np.asarray(jr2)))


@pytest.mark.parametrize("shape", [(32, 48), (2, 32, 64)])
def test_xpby_matches_jax(shape):
    x, y = _operands(200, shape, 2)
    w, none = xpby_dot(torch.from_numpy(x), torch.from_numpy(y), 0.61,
                       with_dot=False)
    assert none is None
    for impl in ("pallas", "jnp"):
        jw, _ = jops.xpby_dot(jnp.asarray(x), jnp.asarray(y),
                              jnp.float32(0.61), impl=impl, with_dot=False)
        _close(w, jw, registry.get("xpby").tol)


def test_xpby_dot_plain_form_matches_jax():
    """The epilogue form's plain version (the CPU path of its kernel)."""
    x, y = _operands(201, (32, 48), 2)
    w, d = xpby_dot(torch.from_numpy(x), torch.from_numpy(y), 0.61)
    jw, jd = jops.xpby_dot(jnp.asarray(x), jnp.asarray(y), jnp.float32(0.61),
                           impl="pallas")
    _close(w, jw)
    _close(d, jd)


@pytest.mark.parametrize("shape", [(32, 48), (2, 32, 64)])
def test_xpby_dot_epilogue_matches_pallas(shape):
    """The plain ``xpby_dot`` with its epilogue against JAX's
    ``xpby_dot_pallas`` in interpret mode (re/im row planes, the JAX
    spec's samples)."""
    x, y = _operands(202, shape, 2)
    w, d = xpby_dot(torch.from_numpy(x), torch.from_numpy(y), 0.61)
    flat = [jnp.asarray(p.reshape(-1, shape[-1]))
            for v in (x, y) for p in (v.real, v.imag)]
    wr, wi, jd = xpby_dot_pallas(jnp.asarray([0.61], jnp.float32), *flat,
                                 bm=16, interpret=True)
    jw = (np.asarray(wr) + 1j * np.asarray(wi)).reshape(shape)
    _close(w, jw)
    _close(d, jd[0])
    assert d.dtype == torch.float32 and d.ndim == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_xpby_nodot_consistency(seed):
    """The JAX spec's property ``_xpby_nodot_consistency`` in the port:
    the no-epilogue form returns the identical ``w``."""
    shape = [(32, 48), (2, 32, 64)][seed]
    x, y = map(torch.from_numpy, _operands(200 + seed, shape, 2))
    w_dot, d = xpby_dot(x, y, 0.61)
    w_only, none = xpby_dot(x, y, 0.61, with_dot=False)
    assert none is None and d is not None
    assert torch.equal(w_dot, w_only)


def test_cpu_wrappers_launch_nothing():
    p, ap, x, r = map(torch.from_numpy, _operands(5, (8, 8), 4))
    before = registry.launches()
    cg_update(0.5, p, ap, x, r)
    xpby_dot(r, p, 0.5, with_dot=False)
    xpby_dot(r, p, 0.5)
    assert registry.launches() == before


# -- the batched forms: a (B,) alpha / beta over (B, ...) operands -----------

BATCH = 3
ALPHAS = np.array([0.37, -1.25, 0.8], np.float32)


def _batched(seed, n, shape=(BATCH, 2, 16, 24)):
    return [torch.from_numpy(a) for a in _operands(seed, shape, n)]


def test_row_sq_norm_is_each_rows_norm():
    (v,) = _batched(300, 1)
    got = row_sq_norm(v)
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    for b in range(BATCH):
        assert torch.equal(got[b], sq_norm(v[b]))


def test_batched_cg_update_is_the_row_loop_bitwise():
    p, ap, x, r = _batched(301, 4)
    alpha = torch.from_numpy(ALPHAS)
    got = cg_update(alpha, p, ap, x, r)
    assert got[2].shape == (BATCH,)
    for b in range(BATCH):
        want = cg_update(alpha[b], p[b], ap[b], x[b], r[b])
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)


def test_batched_cg_update_keeps_an_inactive_row():
    """An inactive row's x and r are left as they were, whatever its
    alpha holds (NaN here), and rs is the norm of that r; the active rows
    are the row loop's bits."""
    p, ap, x, r = _batched(302, 4)
    alpha = torch.from_numpy(ALPHAS.copy())
    alpha[1] = float("nan")
    active = torch.tensor([True, False, True])
    x2, r2, rs = cg_update(alpha, p, ap, x, r, active=active)
    assert torch.equal(x2[1], x[1]) and torch.equal(r2[1], r[1])
    assert torch.equal(rs[1], sq_norm(r[1]))
    for b in (0, 2):
        want = cg_update(alpha[b], p[b], ap[b], x[b], r[b])
        for g, w in zip((x2, r2, rs), want):
            assert torch.equal(g[b], w)
    with pytest.raises(ValueError, match="active mask"):
        cg_update(0.5, p, ap, x, r, active=active)


def test_batched_cg_update_nan_row_leaves_the_other_rows():
    p, ap, x, r = _batched(303, 4)
    alpha = torch.from_numpy(ALPHAS)
    clean = cg_update(alpha, p, ap, x, r)
    r = r.clone()
    r[1, 0, 3, 5] = complex(float("nan"), 0.0)
    got = cg_update(alpha, p, ap, x, r)
    assert torch.isnan(got[2][1])
    for g, c in zip(got, clean):
        assert torch.equal(g[0], c[0]) and torch.equal(g[2], c[2])


def test_batched_xpby_is_the_row_loop_bitwise():
    x, y = _batched(304, 2)
    beta = torch.from_numpy(ALPHAS)
    w, none = xpby_dot(x, y, beta, with_dot=False)
    assert none is None
    for b in range(BATCH):
        assert torch.equal(w[b], xpby_dot(x[b], y[b], beta[b],
                                          with_dot=False)[0])
    # an inactive row keeps y, its frozen search direction, even at a NaN
    # beta; a NaN row leaves the others
    beta = beta.clone()
    beta[1] = float("nan")
    w2, _ = xpby_dot(x, y, beta, with_dot=False,
                     active=torch.tensor([True, False, True]))
    assert torch.equal(w2[1], y[1])
    assert torch.equal(w2[0], w[0]) and torch.equal(w2[2], w[2])
    w3, _ = xpby_dot(x, y, beta, with_dot=False)
    assert torch.isnan(w3[1]).all()
    assert torch.equal(w3[0], w[0]) and torch.equal(w3[2], w[2])
    with pytest.raises(ValueError, match="one scalar beta"):
        xpby_dot(x, y, beta)


def test_batched_cg_updates_match_vmapped_pallas():
    """Against ``jax.vmap`` of the JAX ops through their Pallas kernels
    (interpret mode), a (B,) alpha and beta."""
    import jax
    p, ap, x, r = _batched(305, 4)
    alpha = torch.from_numpy(ALPHAS)
    got = cg_update(alpha, p, ap, x, r)
    want = jax.vmap(lambda a, *v: jops.cg_update(a, *v, impl="pallas"))(
        jnp.asarray(ALPHAS), *[jnp.asarray(t.numpy()) for t in (p, ap, x, r)])
    for g, w in zip(got, want):
        _close(g, w)
    w, _ = xpby_dot(x, y := r, alpha, with_dot=False)
    jw, _ = jax.vmap(lambda a, u, v: jops.xpby_dot(u, v, a, impl="pallas",
                                                   with_dot=False))(
        jnp.asarray(ALPHAS), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    _close(w, jw, registry.get("xpby").tol)
