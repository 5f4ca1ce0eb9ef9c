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
from repro_torch.kernels import registry
from repro_torch.kernels.cg_fused import cg_update, xpby_dot

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
    """The epilogue form has its plain version only (its kernel waits)."""
    x, y = _operands(201, (32, 48), 2)
    w, d = xpby_dot(torch.from_numpy(x), torch.from_numpy(y), 0.61)
    jw, jd = jops.xpby_dot(jnp.asarray(x), jnp.asarray(y), jnp.float32(0.61),
                           impl="pallas")
    _close(w, jw)
    _close(d, jd)


def test_cpu_wrappers_launch_nothing():
    p, ap, x, r = map(torch.from_numpy, _operands(5, (8, 8), 4))
    before = registry.launches()
    cg_update(0.5, p, ap, x, r)
    xpby_dot(r, p, 0.5, with_dot=False)
    assert registry.launches() == before
