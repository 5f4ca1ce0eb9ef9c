"""The port's coil_mult ops against the JAX package's, on the CPU.

The same numpy inputs, at the JAX specs' sample shapes, go through the
JAX Pallas kernel (interpret mode), the JAX jnp oracle and the port's
wrapper (which takes its plain PyTorch version for CPU tensors), to the
JAX spec's tolerance in the registry harness's form (rtol = 10 tol,
atol = tol).  The CUDA kernels themselves are held against the same
plain versions on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coil_mult import ops as jops
from repro_torch.kernels import registry
from repro_torch.kernels.coil_mult import (coil_adjoint, coil_forward,
                                           coil_lincomb, plane_mult)


def _c(rng, shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _r(rng, shape):
    return rng.random(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=10 * tol, atol=tol)


def _both_jax(fn, *args, **kw):
    """The JAX Pallas kernel (interpret) and the jnp oracle."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    return (fn(*jargs, impl="pallas", **jkw), fn(*jargs, impl="jnp", **jkw))


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(4, 32, 32), (6, 64, 128)])
def test_coil_forward_matches_jax(shape):
    rng = np.random.default_rng(300)
    c, x = _c(rng, shape), _c(rng, shape[1:])
    got = coil_forward(*_t(c, x))
    for want in _both_jax(jops.coil_forward, c, x):
        _close(got, want, registry.get("coil_forward").tol)


@pytest.mark.parametrize("shape,masked", [((4, 32, 32), False),
                                          ((6, 64, 128), True)])
def test_coil_adjoint_matches_jax(shape, masked):
    rng = np.random.default_rng(310)
    c, z = _c(rng, shape), _c(rng, shape)
    m = (rng.random(shape[1:]) > 0.5).astype(np.float32) if masked else None
    got = coil_adjoint(*_t(c, z), mask=_t(m)[0])
    for want in _both_jax(jops.coil_adjoint, c, z, mask=m):
        _close(got, want, registry.get("coil_adjoint").tol)


def test_coil_scale_mult_matches_jax():
    """``coil_lincomb(a, x, scale=s)``: the coil_scale_mult kernel."""
    rng = np.random.default_rng(320)
    a, x, s = _c(rng, (32, 32)), _c(rng, (4, 32, 32)), _r(rng, (32, 32))
    got = coil_lincomb(*_t(a, x), scale=_t(s)[0])
    for want in _both_jax(jops.coil_lincomb, a, x, scale=s):
        _close(got, want, registry.get("coil_scale_mult").tol)


def test_coil_lincomb_matches_jax():
    rng = np.random.default_rng(321)
    a, x = _c(rng, (64, 64)), _c(rng, (6, 64, 64))
    b, y, s = _c(rng, (64, 64)), _c(rng, (6, 64, 64)), _r(rng, (64, 64))
    ta, tx, tb, ty, ts = _t(a, x, b, y, s)
    got = coil_lincomb(ta, tx, tb, ty, ts)
    for want in _both_jax(jops.coil_lincomb, a, x, b=b, y=y, scale=s):
        _close(got, want, registry.get("coil_lincomb").tol)


@pytest.mark.parametrize("shape", [(4, 32, 32), (8, 64, 64)])
def test_plane_mult_matches_jax(shape):
    rng = np.random.default_rng(330)
    z, m = _c(rng, shape), _r(rng, shape[1:])
    got = plane_mult(*_t(z, m))
    for want in _both_jax(jops.plane_mult, z, m):
        _close(got, want, registry.get("plane_mult").tol)


def test_cpu_wrappers_launch_nothing():
    """On the CPU every wrapper takes its plain version, so no launch
    counter moves; ``impl="plain"`` gives the same values."""
    rng = np.random.default_rng(1)
    c, z, x = _t(_c(rng, (3, 8, 8)), _c(rng, (3, 8, 8)), _c(rng, (8, 8)))
    s = torch.from_numpy(_r(rng, (8, 8)))
    before = registry.launches()
    for impl in ("auto", "plain"):
        coil_forward(c, x, impl=impl)
        coil_adjoint(c, z, impl=impl)
        coil_lincomb(x, c, x, z, s, impl=impl)
        coil_lincomb(x, c, scale=s, impl=impl)
        plane_mult(z, s, impl=impl)
    assert registry.launches() == before
    torch.testing.assert_close(plane_mult(z, s), plane_mult(z, s,
                                                            impl="plain"))


def test_unknown_impl_and_device_are_refused():
    z = torch.zeros((2, 4, 4), dtype=torch.complex64)
    m = torch.ones((4, 4))
    with pytest.raises(ValueError):
        plane_mult(z, m, impl="pallas")
    with pytest.raises(ValueError):        # neither CPU nor CUDA: no path
        plane_mult(z.to("meta"), m.to("meta"))
