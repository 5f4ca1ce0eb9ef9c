"""The port's NLINV solver against the JAX package's, on the CPU.

* operators: fused and unfused ``NlinvOps`` against JAX's, <= 1e-5
  relative (max abs error over max abs value);
* the identities of ``tests/test_nlinv.py``, in the port: DG adjointness,
  DG is the derivative of G, CG solves the normal system, NLINV beats
  gridding;
* the ``Reconstructor`` frame against JAX's: <= 1e-5 relative at the
  shallow point (n=16, J=4, newton 3, cg 10), <= 1e-2 relative L2 on the
  image at the deep one (n=24, J=4, newton 7, cg 30), where the late
  Newton steps' small alpha amplifies the two FFT libraries' rounding;
* a NaN acquisition returns the x0 solve in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nlinv import operators as jop
from repro.nlinv import phantom as jphantom
from repro.nlinv.recon import Reconstructor as JReconstructor
from repro_torch.nlinv import operators as top
from repro_torch.nlinv import phantom
from repro_torch.nlinv.cg import cg, cg_fused
from repro_torch.nlinv.gridding import gridding_recon
from repro_torch.nlinv.irgnm import irgnm, postprocess
from repro_torch.nlinv.recon import Reconstructor

CPU = "cpu"


def _c(rng, shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _rand_u(rng, J, g):
    return {"rho": _c(rng, (g, g)), "chat": _c(rng, (J, g, g))}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_max(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
        return
    assert _rel_max(got, want) <= tol, _rel_max(got, want)


@pytest.fixture(scope="module")
def small_data():
    return phantom.make_dataset(n=32, ncoils=4, nspokes=9, frames=1, seed=1)


def test_phantom_is_the_jax_packages(small_data):
    want = jphantom.make_dataset(n=32, ncoils=4, nspokes=9, frames=1, seed=1)
    for k in ("y", "masks", "coils", "rho", "fov"):
        np.testing.assert_array_equal(small_data[k], want[k])


def _both_ops(d):
    w = top.sobolev_weight(d["grid"])
    np.testing.assert_array_equal(w, jop.sobolev_weight(d["grid"]))
    return (top.make_ops(d["masks"][0], d["fov"], w, device=CPU),
            jop.make_ops(d["masks"][0], d["fov"], w))


@pytest.fixture(scope="module")
def op_case():
    d = phantom.make_dataset(n=16, ncoils=4, nspokes=5, frames=1, seed=3)
    rng = np.random.default_rng(11)
    g, J = d["grid"], 4
    return d, _rand_u(rng, J, g), _rand_u(rng, J, g), _c(rng, (J, g, g))


@pytest.mark.parametrize("method", ["G", "DG", "DGH", "normal"])
def test_unfused_ops_match_jax(op_case, method):
    d, u0, du, r = op_case
    tops, jops = _both_ops(d)
    args = {"G": (u0,), "DG": (u0, du), "DGH": (u0, r),
            "normal": (u0, du, 0.3)}[method]
    got = getattr(tops, method)(*[_t(a) if not isinstance(a, float) else a
                                  for a in args])
    want = getattr(jops, method)(*[_j(a) if not isinstance(a, float) else a
                                   for a in args])
    _assert_tree_close(got, want, 1e-5)


@pytest.mark.parametrize("method", ["G_fused", "DG_fused", "DGH_fused",
                                    "normal_pap"])
def test_fused_ops_match_jax(op_case, method):
    d, u0, du, r = op_case
    tops, jops = _both_ops(d)
    tpre, jpre = tops.precompute(_t(u0)), jops.precompute(_j(u0))
    _assert_tree_close(tpre, jpre, 1e-5)
    if method == "G_fused":
        got = tops.G_fused(_t(u0), c0=tpre["c0"])
        want = jops.G_fused(_j(u0), c0=jpre["c0"])
    elif method == "DG_fused":
        got, want = tops.DG_fused(tpre, _t(du)), jops.DG_fused(jpre, _j(du))
    elif method == "DGH_fused":
        # premasked=False: r is not mask-supported here
        got = tops.DGH_fused(tpre, _t(r), reducer=top.local_reducer,
                             premasked=False)[0]
        want = jops.DGH_fused(jpre, _j(r), reducer=jop.local_reducer,
                              premasked=False)[0]
    else:
        alpha = 0.3
        tap, tpap = tops.normal_pap(tpre, _t(du), torch.tensor(alpha),
                                    reducer=top.local_reducer)
        jap, jpap = jops.normal_pap(jpre, _j(du), jnp.float32(alpha),
                                    reducer=jop.local_reducer)
        assert abs(float(tpap) - float(jpap)) <= 1e-5 * abs(float(jpap))
        got, want = tap, jap
    _assert_tree_close(got, want, 1e-5)


# -- the identities of tests/test_nlinv.py, in the port ---------------------

def test_dg_adjointness(small_data):
    d = small_data
    ops = top.make_ops(d["masks"][0], d["fov"], top.sobolev_weight(d["grid"]),
                       device=CPU)
    rng = np.random.default_rng(0)
    g, J = d["grid"], d["ncoils"]
    u0, du = _t(_rand_u(rng, J, g)), _t(_rand_u(rng, J, g))
    r = torch.from_numpy(_c(rng, (J, g, g)))
    lhs = torch.vdot(r.reshape(-1), ops.DG(u0, du).reshape(-1))
    rhs = top.udot(ops.DGH(u0, r), du)
    np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-3,
                               atol=1e-3)


def test_dg_is_derivative_of_G(small_data):
    d = small_data
    ops = top.make_ops(d["masks"][0], d["fov"], top.sobolev_weight(d["grid"]),
                       device=CPU)
    rng = np.random.default_rng(4)
    g, J = d["grid"], d["ncoils"]
    u0, du = _t(_rand_u(rng, J, g)), _t(_rand_u(rng, J, g))
    eps = 1e-3
    fd = (ops.G(top.uaxpy(eps, du, u0)) - ops.G(top.uaxpy(-eps, du, u0))) \
        / (2 * eps)
    np.testing.assert_allclose(fd.numpy(), ops.DG(u0, du).numpy(),
                               atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("solver", ["cg", "cg_fused"])
def test_cg_solves_normal_system(small_data, solver):
    d = small_data
    ops = top.make_ops(d["masks"][0], d["fov"], top.sobolev_weight(d["grid"]),
                       device=CPU)
    g, J = d["grid"], d["ncoils"]
    u0 = top.uinit(J, g, device=CPU)
    rhs = _t(_rand_u(np.random.default_rng(6), J, g))
    alpha = torch.tensor(0.5)
    A = lambda du: ops.normal(u0, du, alpha)
    if solver == "cg":
        x = cg(A, rhs, top.uzeros(J, g, device=CPU), iters=100, tol=1e-8)
    else:
        pre = ops.precompute(u0)
        log = []
        x = cg_fused(lambda p: ops.normal_pap(pre, p, alpha,
                                              reducer=top.local_reducer),
                     rhs, iters=100, tol=1e-8, log=log)
        assert 0 < log[0] <= 100
    res = top.uaxpy(-1.0, A(x), rhs)
    rel = float(torch.sqrt(torch.real(top.udot(res, res))) /
                torch.sqrt(torch.real(top.udot(rhs, rhs))))
    assert rel < 1e-3, rel


def _nrmse_in_fov(img, truth, fov):
    m = np.asarray(fov) > 0
    a = np.abs(_np(img))[m]
    b = np.abs(np.asarray(truth))[m]
    a = a / a.max()
    b = b / max(b.max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_nlinv_beats_gridding(small_data):
    d = small_data
    ops = top.make_ops(d["masks"][0], d["fov"], top.sobolev_weight(d["grid"]),
                       device=CPU)
    y = torch.from_numpy(d["y"][0])
    u = irgnm(ops, y, top.uinit(d["ncoils"], d["grid"], device=CPU),
              newton=8, cg_iters=30)
    img = postprocess(ops, u)
    grid_img = gridding_recon(y, ops.mask, ops.fov)
    e_nlinv = _nrmse_in_fov(img, d["rho"][0], d["fov"])
    e_grid = _nrmse_in_fov(grid_img, d["rho"][0], d["fov"])
    assert e_nlinv < 0.6 * e_grid, (e_nlinv, e_grid)
    assert e_nlinv < 0.12, e_nlinv


# -- the frame against the JAX Reconstructor --------------------------------

def _frames(d, newton, cg_iters, y=None, fused=True):
    """One frame through both packages from the same numpy inputs."""
    g, J = d["grid"], d["ncoils"]
    y = d["y"][0] if y is None else y
    w = top.sobolev_weight(g)
    jr = JReconstructor(newton=newton, cg_iters=cg_iters, fused=fused)
    ju0 = jr.init_carry(J, g)
    ju, jimg = jr(jr.put_frame(y), jr.put_const(d["masks"][0]),
                  jr.put_const(d["fov"]), jr.put_const(w), ju0,
                  jax.tree.map(lambda a: a + 0, ju0))
    tr = Reconstructor(device=CPU, newton=newton, cg_iters=cg_iters,
                       fused=fused)
    tu0 = tr.init_carry(J, g)
    tu, timg = tr(tr.put_frame(y), tr.put_const(d["masks"][0]),
                  tr.put_const(d["fov"]), tr.put_const(w), tu0,
                  {k: v.clone() for k, v in tu0.items()})
    return (tu, timg, tr), (ju, jimg)


@pytest.mark.parametrize("fused", [True, False])
def test_frame_matches_jax_shallow(fused):
    d = phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=1, seed=0)
    (tu, timg, tr), (ju, jimg) = _frames(d, 3, 10, fused=fused)
    assert _rel_max(timg, jimg) <= 1e-5
    _assert_tree_close(tu, ju, 1e-5)
    if fused:
        assert len(tr.cg_log) == 3 and all(0 < i <= 10 for i in tr.cg_log)


def test_frame_matches_jax_deep():
    d = phantom.make_dataset(n=24, ncoils=4, nspokes=11, frames=1, seed=0)
    (_, timg, _), (_, jimg) = _frames(d, 7, 30)
    t, j = timg.numpy(), np.asarray(jimg)
    rel = float(np.linalg.norm(t - j) / np.linalg.norm(j))
    assert rel <= 1e-2, rel
    # and the port's image is as good as the reference's
    e_t = _nrmse_in_fov(t, d["rho"][0], d["fov"])
    e_j = _nrmse_in_fov(j, d["rho"][0], d["fov"])
    assert abs(e_t - e_j) <= 1e-3, (e_t, e_j)


def test_nan_acquisition_returns_x0_solve():
    """A NaN frame makes rs > thresh false at once: every CG solve returns
    x0 = 0, so u stays the initial carry, in both packages."""
    d = phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=1, seed=0)
    y = d["y"][0].copy()
    y[0, 5, 7] = np.nan
    (tu, timg, tr), (ju, jimg) = _frames(d, 3, 10, y=y)
    assert tr.cg_log == [0, 0, 0]
    np.testing.assert_array_equal(tu["rho"].numpy(),
                                  np.ones_like(tu["rho"].numpy()))
    np.testing.assert_array_equal(tu["chat"].numpy(), 0)
    for k in ("rho", "chat"):
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    np.testing.assert_array_equal(timg.numpy(), np.asarray(jimg))


def test_reconstructor_options():
    with pytest.raises(ValueError):
        Reconstructor(device=CPU, channel_sum="ring")
    with pytest.raises(ValueError):
        Reconstructor(device=CPU, impl="pallas")
    d = phantom.make_dataset(n=8, ncoils=2, nspokes=5, frames=1, seed=0)
    g = d["grid"]
    outs = []
    for cs in ("full", "crop"):
        rec = Reconstructor(device=CPU, newton=2, cg_iters=4, channel_sum=cs)
        u0 = rec.init_carry(2, g)
        outs.append(rec.fn(rec.put_frame(d["y"][0]),
                           rec.put_const(d["masks"][0]),
                           rec.put_const(d["fov"]),
                           rec.put_const(top.sobolev_weight(g)), u0,
                           {k: v.clone() for k, v in u0.items()})[1])
    assert torch.equal(outs[0], outs[1])
