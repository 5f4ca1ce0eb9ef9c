"""The port's radial gridding against the JAX package's, on the CPU.

* ``radial_trajectory``, ``ramlak_dcf_radial`` and ``interp_matrices``
  are equal exactly; the taps densified equal ``interp_matrices`` bit for
  bit, and the cell index holds exactly the operator's entries in
  (cell, sample) order over the touched cells alone (T = 19887 to 20007
  at full width);
* the kernel's order of summation in ``grid_adjoint``'s gather,
  emulated in plain PyTorch, against the plain version and JAX's;
* the plain ``degrid``/``grid_adjoint`` match JAX's ``impl="jnp"`` and
  ``impl="pallas"`` (interpret mode, as ``tests/test_kernel_registry.py``
  runs it) and the per-sample oracles at the JAX spec's sample sizes
  (J, grid, S) = (2, 16, 200) and (3, 32, 640).  The bound is 1e-5
  relative (max error over max value): both sides apply the same float32
  operator and differ only in the order of their sums, which moves the
  result by about 1e-7 relative, so 1e-5 leaves margin while staying far
  inside the spec's 1e-3;
* the adjoint dot test; ``RadialOps`` and ``gridding_recon_radial`` on
  the n = 32 phantom within 1e-5 of JAX's; the radial quality criterion
  of ``tests/test_gridding.py``;
* the plan: built once per (trajectory, device), keyed on the device,
  and under 10 MB of device tensors at full width (grid 768, 16896
  samples), with no dense matrix kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gridding import ops as jops
from repro.kernels.gridding import ref as jref
from repro.lib import gridding as jlg
from repro.nlinv import gridding as jng
from repro_torch.kernels import registry
from repro_torch.kernels.gridding import (Interp, cell_index, degrid,
                                          degrid_ref, grid_adjoint, grid_ref,
                                          interp_matrices, interp_taps)
from repro_torch.lib import gridding as tlg
from repro_torch.lib.plan import PlanCache
from repro_torch.nlinv import gridding as tng
from repro_torch.nlinv import phantom

CPU = "cpu"
TOL = 1e-5
SPEC_SIZES = [(2, 16, 200), (3, 32, 640)]


def _cplx(rng, shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _traj(seed, s, grid, lo=0.0, hi=None):
    rng = np.random.default_rng(seed)
    hi = float(grid) if hi is None else hi
    return rng.uniform(lo, hi, (s, 2)).astype(np.float32)


def _rel_max(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- geometry: exact equality ------------------------------------------------

@pytest.mark.parametrize("grid,nspokes,frame,nsamp",
                         [(32, 7, 0, None), (64, 13, 3, None),
                          (768, 11, 2, None), (16, 5, 1, 40)])
def test_trajectory_and_dcf_equal_jax(grid, nspokes, frame, nsamp):
    t = tlg.radial_trajectory(grid, nspokes, frame=frame, nsamp=nsamp)
    j = jlg.radial_trajectory(grid, nspokes, frame=frame, nsamp=nsamp)
    assert t.dtype == j.dtype and np.array_equal(t, j)
    assert np.array_equal(tlg.ramlak_dcf_radial(t, grid),
                          jlg.ramlak_dcf_radial(j, grid))


# (grid, S, lo, hi): in the grid, wrapping past both edges, the
# degenerate one-cell grid, and a radial trajectory
GEOMETRIES = [(16, 200, 0.0, 16.0), (32, 640, -5.0, 40.0), (1, 50, -2.0, 3.0),
              (5, 77, -3.0, 8.0)]


@pytest.mark.parametrize("grid,S,lo,hi", GEOMETRIES)
def test_interp_matrices_and_taps_equal_jax(grid, S, lo, hi):
    traj = _traj(grid + S, S, grid, lo, hi)
    jax_ax, jax_ay = jops.interp_matrices(traj, grid)
    ax, ay = interp_matrices(traj, grid)
    assert np.array_equal(ax, jax_ax) and np.array_equal(ay, jax_ay)
    op = Interp.build(traj, grid, device=CPU)
    dx, dy = op.dense()
    assert dx.dtype == torch.float32
    # bit for bit, padded rows included
    assert np.array_equal(dx.numpy().view(np.uint32), jax_ax.view(np.uint32))
    assert np.array_equal(dy.numpy().view(np.uint32), jax_ay.view(np.uint32))
    idx, w = interp_taps(traj, grid)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert (w[S:] == 0).all() and (idx[S:] == 0).all()


@pytest.mark.parametrize("grid,S,lo,hi", GEOMETRIES)
def test_cell_index_holds_the_operator(grid, S, lo, hi):
    traj = _traj(grid + S + 1, S, grid, lo, hi)
    ax, ay = jops.interp_matrices(traj, grid)
    op = Interp.build(traj, grid, device=CPU)
    cells = op.cells.numpy().astype(np.int64)
    ptr = op.cell_ptr.numpy().astype(np.int64)
    samp = op.cell_samp.numpy()
    wts = op.cell_w.numpy()
    assert ptr.size == cells.size + 1
    assert ptr[0] == 0 and ptr[-1] == samp.size
    # the touched cells only, ascending, none of them empty
    assert (np.diff(cells) > 0).all() and (np.diff(ptr) > 0).all()
    cell = np.repeat(cells, np.diff(ptr))
    u, v = cell // grid, cell % grid
    # every entry is (Ax[s, u], Ay[s, v]) of the dense matrices
    assert np.array_equal(wts[:, 0], ax[samp, u])
    assert np.array_equal(wts[:, 1], ay[samp, v])
    # (cell, sample) order, each pair once, no padded row
    order = np.lexsort((samp, cell))
    assert np.array_equal(order, np.arange(samp.size))
    assert len(set(zip(cell, samp))) == samp.size and samp.max() < S
    # and every nonzero of the operator is there
    nz = {(s, a * grid + b) for s in range(S)
          for a in np.flatnonzero(ax[s]) for b in np.flatnonzero(ay[s])}
    assert nz <= set(zip(samp, cell))
    assert op.touched == len(set(cell)) == cells.size
    # the bitmap marks the listed cells and no other
    bits = op.cell_bits.numpy()
    assert bits.size == -(-grid * grid // 32)
    marked = np.unpackbits(bits.view(np.uint8), bitorder="little")
    assert np.array_equal(np.flatnonzero(marked), cells)


@pytest.mark.parametrize("frame,touched", [(0, 19887), (1, 20007),
                                           (2, 19981), (3, 19983)])
def test_cell_index_at_full_width(frame, touched):
    """The main path's frames (grid 768, 11 spokes of 1536 samples): the
    touched cells, and the 48 entries of the cells where all 11 spokes
    cross."""
    traj = tlg.radial_trajectory(768, 11, frame=frame)
    idx, w = interp_taps(traj, 768)
    cells, ptr, samp, wts, _ = cell_index(idx, w, traj.shape[0], 768)
    counts = np.diff(ptr)
    assert cells.size == touched and samp.size == 4 * traj.shape[0]
    assert counts.max() == 48
    assert (np.diff(cells) > 0).all() and counts.min() >= 1


def _warp_gather(y, op: Interp):
    """``grid_adjoint``'s gather in plain PyTorch, in the kernel's order of
    summation: each touched cell's entries go to 4 slots at a stride of
    4, each slot sums wx * (y_j[s] * wy) in entry order, and the slots
    meet in the butterfly's order, (slot 0 + slot 1) + (slot 2 + slot 3);
    the other cells are the fill's zeros."""
    J, G = y.shape[0], op.grid
    cells, ptr = op.cells.long(), op.cell_ptr.long()
    samp, wx, wy = op.cell_samp.long(), op.cell_w[:, 0], op.cell_w[:, 1]
    rounds = -(-int(ptr.diff().max()) // 4)
    slots = []
    for k in range(4):
        acc = torch.zeros((J, cells.numel()), dtype=y.dtype)
        for r in range(rounds):
            e = ptr[:-1] + k + 4 * r
            live = e < ptr[1:]
            e = torch.where(live, e, 0)
            acc = torch.where(live, acc + wx[e] * (y[:, samp[e]] * wy[e]),
                              acc)
        slots.append(acc)
    out = torch.zeros((J, G * G), dtype=y.dtype)
    out[:, cells] = (slots[0] + slots[1]) + (slots[2] + slots[3])
    return out.reshape(J, G, G)


@pytest.mark.parametrize("J,grid,S", SPEC_SIZES + [(9, 32, None)])
def test_gather_order_matches_plain_and_jax(J, grid, S):
    """The kernel's order of summation, emulated on the CPU, against the
    plain version and JAX's ``jnp`` form, at the spec's sample sizes and
    on a radial trajectory (the DC cell's 52 entries take 13 rounds of
    the 4 slots; J = 9 takes a second block of coils)."""
    rng = np.random.default_rng(460 + grid)
    traj = (_traj(470 + grid, S, grid) if S is not None
            else tlg.radial_trajectory(grid, 13))
    S = traj.shape[0]
    ax, ay = jops.interp_matrices(traj, grid)
    y = np.zeros((J, ax.shape[0]), np.complex64)
    y[:, :S] = _cplx(rng, (J, S))
    op = Interp.build(traj, grid, device=CPU)
    got = _warp_gather(torch.from_numpy(y), op)
    assert _rel_max(got, grid_adjoint(torch.from_numpy(y), op).numpy()) \
        <= TOL
    assert _rel_max(got, jops.grid_adjoint(jnp.asarray(y), ax, ay,
                                           impl="jnp")) <= TOL


# -- the operators: plain versions against JAX and the oracles --------------

@pytest.mark.parametrize("jimpl", ["jnp", "pallas"])
@pytest.mark.parametrize("J,grid,S", SPEC_SIZES)
def test_degrid_plain_matches_jax(J, grid, S, jimpl):
    rng = np.random.default_rng(400 + grid)
    traj = _traj(410 + grid, S, grid)
    g = _cplx(rng, (J, grid, grid))
    ax, ay = jops.interp_matrices(traj, grid)
    op = Interp.build(traj, grid, device=CPU)
    got = degrid(torch.from_numpy(g), op)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (J, ax.shape[0])
    want = jops.degrid(jnp.asarray(g), ax, ay, impl=jimpl)
    assert _rel_max(got, want) <= TOL
    assert torch.equal(got, degrid(torch.from_numpy(g), op, impl="plain"))
    # padded rows read zero; the true rows match the per-sample oracles
    assert (got[:, S:] == 0).all()
    oracle = degrid_ref(torch.from_numpy(g), traj)
    assert _rel_max(got[:, :S], oracle) <= TOL
    assert _rel_max(oracle, jref.degrid_ref(jnp.asarray(g), traj)) <= TOL


@pytest.mark.parametrize("jimpl", ["jnp", "pallas"])
@pytest.mark.parametrize("J,grid,S", SPEC_SIZES)
def test_grid_adjoint_plain_matches_jax(J, grid, S, jimpl):
    rng = np.random.default_rng(420 + grid)
    traj = _traj(430 + grid, S, grid)
    ax, ay = jops.interp_matrices(traj, grid)
    y = np.zeros((J, ax.shape[0]), np.complex64)
    y[:, :S] = _cplx(rng, (J, S))
    op = Interp.build(traj, grid, device=CPU)
    got = grid_adjoint(torch.from_numpy(y), op)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (J, grid,
                                                                 grid)
    want = jops.grid_adjoint(jnp.asarray(y), ax, ay, impl=jimpl)
    assert _rel_max(got, want) <= TOL
    oracle = grid_ref(torch.from_numpy(y[:, :S]), traj, grid)
    assert _rel_max(got, oracle) <= TOL
    assert _rel_max(oracle, jref.grid_ref(jnp.asarray(y[:, :S]), traj,
                                          grid)) <= TOL


@pytest.mark.parametrize("grid,S,lo,hi", GEOMETRIES)
def test_adjoint_dot(grid, S, lo, hi):
    """<degrid(g), y> == <g, grid_adjoint(y)>: the two operators are
    transposes of each other (the JAX spec's ``_adjointness``)."""
    rng = np.random.default_rng(440 + S)
    traj = _traj(450 + S, S, grid, lo, hi)
    op = Interp.build(traj, grid, device=CPU)
    g = torch.from_numpy(_cplx(rng, (3, grid, grid)))
    y = torch.from_numpy(_cplx(rng, (3, op.nsamp_padded)))
    lhs = complex(torch.vdot(degrid(g, op).reshape(-1), y.reshape(-1)))
    rhs = complex(torch.vdot(g.reshape(-1), grid_adjoint(y, op).reshape(-1)))
    assert abs(lhs - rhs) / max(1.0, abs(lhs)) < 1e-4


def test_library_yardstick_computes_the_same_operator():
    """The sparse CSR matrices that the yardstick hands to the library
    product hold the same operator as the plain versions."""
    rng = np.random.default_rng(7)
    for grid, S, lo, hi in GEOMETRIES:
        op = Interp.build(_traj(S, S, grid, lo, hi), grid, device=CPU)
        g = torch.from_numpy(_cplx(rng, (2, grid, grid)))
        y = torch.from_numpy(_cplx(rng, (2, op.nsamp_padded)))
        y[:, op.nsamp:] = 0
        fwd = torch.sparse.mm(op.as_sparse(), g.reshape(2, -1).T).T
        adj = torch.sparse.mm(op.as_sparse(adjoint=True), y.T).T
        assert _rel_max(fwd, degrid(g, op).numpy()) <= TOL
        assert _rel_max(adj.reshape(2, grid, grid),
                        grid_adjoint(y, op).numpy()) <= TOL


def test_wrappers_on_cpu_launch_nothing_and_check_impl():
    op = Interp.build(_traj(1, 100, 8), 8, device=CPU)
    g = torch.zeros((2, 8, 8), dtype=torch.complex64)
    before = registry.launches()
    degrid(g, op)
    grid_adjoint(torch.zeros((2, op.nsamp_padded), dtype=torch.complex64),
                 op)
    assert registry.launches() == before
    with pytest.raises(ValueError):
        degrid(g, op, impl="pallas")


@pytest.mark.parametrize("threads", [2, 3, 4, 8])
def test_plain_gridding_bits_do_not_follow_the_thread_count(threads):
    """The plain versions give the same bits on any number of CPU threads
    (the BLAS would otherwise split the adjoint's sum over samples by its
    thread count), and leave the process's thread count as it was."""
    rng = np.random.default_rng(11)
    op = Interp.build(tlg.radial_trajectory(64, 13), 64, device=CPU)
    g = torch.from_numpy(_cplx(rng, (4, 64, 64)))
    y = torch.from_numpy(_cplx(rng, (4, op.nsamp_padded)))
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = degrid(g, op), grid_adjoint(y, op)
        torch.set_num_threads(threads)
        got = degrid(g, op), grid_adjoint(y, op)
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(before)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the radial operator pair and the baseline on the phantom ---------------

@pytest.fixture(scope="module")
def small():
    return phantom.make_dataset(n=32, ncoils=4, nspokes=13, frames=1, seed=5)


def test_radial_ops_match_jax(small):
    d = small
    g = d["grid"]
    coil_imgs = (d["rho"][0][None] * d["coils"]).astype(np.complex64)
    jops_ = jng.radial_ops(g, nspokes=13)
    tops_ = tng.radial_ops(g, nspokes=13, device=CPU)
    jy = jops_.forward(jnp.asarray(coil_imgs))
    ty = tops_.forward(torch.from_numpy(coil_imgs))
    assert _rel_max(ty, jy) <= TOL
    y = np.array(jy)
    assert _rel_max(tops_.adjoint(torch.from_numpy(y)),
                    jops_.adjoint(jnp.asarray(y))) <= TOL
    assert _rel_max(tops_.adjoint(torch.from_numpy(y), density_comp=True),
                    jops_.adjoint(jnp.asarray(y), density_comp=True)) <= TOL
    jimg = jng.gridding_recon_radial(jnp.asarray(y), g, 13,
                                     jnp.asarray(d["fov"]))
    timg = tng.gridding_recon_radial(torch.from_numpy(y), g, 13, d["fov"],
                                     device=CPU)
    assert timg.dtype == torch.float32 and _rel_max(timg, jimg) <= TOL
    assert torch.equal(timg, tops_.recon(torch.from_numpy(y), d["fov"]))


def test_radial_ops_pair_stays_adjoint():
    rng = np.random.default_rng(3)
    g = 32
    ops = tng.radial_ops(g, nspokes=7, device=CPU)
    imgs = torch.from_numpy(_cplx(rng, (2, g, g)))
    y = torch.from_numpy(_cplx(rng, (2, ops.plan.nsamp_padded)))
    lhs = complex(torch.vdot(y.reshape(-1), ops.forward(imgs).reshape(-1)))
    rhs = complex(torch.vdot(ops.adjoint(y).reshape(-1), imgs.reshape(-1)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-3)


def _nrmse_in_fov(img, truth, fov):
    m = np.asarray(fov) > 0
    a = np.abs(np.asarray(img))[m]
    b = np.abs(np.asarray(truth))[m]
    a = a / max(a.max(), 1e-9)
    b = b / max(b.max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_adjoint_recon_quality_radial(small):
    d = small
    ops = tng.radial_ops(d["grid"], nspokes=13, device=CPU)
    samples = ops.forward(torch.from_numpy(
        (d["rho"][0][None] * d["coils"]).astype(np.complex64)))
    img = ops.recon(samples, d["fov"]).numpy()
    assert np.isfinite(img).all()
    assert _nrmse_in_fov(img, d["rho"][0], d["fov"]) < 0.35


def test_radial_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tng.radial_ops(16, nspokes=3)
    with pytest.raises(RuntimeError):
        tlg.plan_gridding(tlg.radial_trajectory(16, 3), 16,
                          cache=PlanCache())
    assert tng.radial_ops(16, nspokes=3, device=CPU).plan.device.type == CPU


# -- the plan ----------------------------------------------------------------

def test_gridding_plan_built_once():
    cache = PlanCache()
    g = 32
    traj = tlg.radial_trajectory(g, nspokes=5)
    p1 = tlg.plan_gridding(traj, g, device=CPU, cache=cache)
    p2 = tlg.plan_gridding(traj, g, device=CPU, cache=cache)
    assert p1 is p2 and cache.misses == 1 and cache.hits == 1
    # a different frame geometry is a different plan
    tlg.plan_gridding(tlg.radial_trajectory(g, nspokes=5, frame=1), g,
                      device=CPU, cache=cache)
    assert cache.misses == 2
    # and so is the same geometry on another device
    p_meta = tlg.plan_gridding(traj, g, device="meta", cache=cache)
    assert p_meta is not p1 and p_meta.device.type == "meta"
    assert cache.misses == 3


def test_full_width_plan_keeps_no_dense_matrix():
    g, nspokes = 768, 11
    plan = tlg.plan_gridding(tlg.radial_trajectory(g, nspokes), g,
                             device=CPU, cache=PlanCache())
    assert plan.nsamp == plan.nsamp_padded == 16896
    assert plan.device_bytes() < 10e6, plan.device_bytes()
    for t in (*plan.interp.tensors(), plan.dcf):
        assert t.numel() < plan.nsamp_padded * g     # no (Sp, grid) matrix
    np.testing.assert_array_equal(
        plan.dcf.numpy(), jlg.ramlak_dcf_radial(plan.traj, g))
