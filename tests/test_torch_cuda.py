"""The port's CUDA kernels on the card: each against its plain PyTorch
version, at small and ragged shapes, plus launch counting, determinism and
the wrappers' refusals.  Every test here needs a CUDA device and skips
without one; the file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.cg_fused import cg_update, xpby_dot
from repro_torch.kernels.coil_mult import coil_adjoint, plane_mult
from repro_torch.kernels.gridding import Interp, degrid, grid_adjoint

pytestmark = pytest.mark.cuda

SPEC_NAMES = ["coil_forward", "coil_lincomb", "coil_scale_mult",
              "plane_mult", "coil_adjoint", "cg_update", "xpby"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("ncoils,grid", [(3, 37), (8, 64), (1, 1)])
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_kernel_matches_plain(card, name, ncoils, grid):
    """Kernel == plain version to the JAX spec's tolerance, at shapes that
    do and do not fill whole blocks (ragged edge masked by the loop)."""
    spec = registry.get(name)
    gen = torch.Generator(device=card).manual_seed(7)
    args = spec.sample(card, gen, ncoils=ncoils, grid=grid)
    before = spec.launches
    got = spec.kernel(*args)
    want = spec.plain(*args)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    for g, w in zip(_outputs(got), _outputs(want)):
        torch.testing.assert_close(g, w, rtol=10 * spec.tol, atol=spec.tol)


def test_plain_impl_on_card_does_not_launch(card):
    gen = torch.Generator(device=card).manual_seed(1)
    z, m = registry.get("plane_mult").sample(card, gen, ncoils=2, grid=16)
    before = registry.get("plane_mult").launches
    plane_mult(z, m, impl="plain")
    assert registry.get("plane_mult").launches == before


def test_cg_update_rs_is_deterministic(card):
    """Same inputs, same bits: the rs epilogue sums in a fixed order."""
    gen = torch.Generator(device=card).manual_seed(3)
    args = registry.get("cg_update").sample(card, gen, ncoils=8, grid=256)
    first = cg_update(*args)
    for _ in range(3):
        again = cg_update(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_cg_update_nan_operand_gives_nan_rs(card):
    gen = torch.Generator(device=card).manual_seed(4)
    a, p, ap, x, r = registry.get("cg_update").sample(card, gen, ncoils=2,
                                                      grid=32)
    r[0, 3, 5] = complex(float("nan"), 0.0)
    _, r2, rs = cg_update(a, p, ap, x, r)
    assert torch.isnan(rs)
    assert torch.isnan(r2[0, 3, 5].real)


def test_coil_adjoint_mask(card):
    gen = torch.Generator(device=card).manual_seed(5)
    c, z = registry.get("coil_adjoint").sample(card, gen, ncoils=4, grid=40)
    m = (torch.rand((40, 40), device=card, generator=gen) > 0.5).float()
    torch.testing.assert_close(coil_adjoint(c, z, m),
                               coil_adjoint(c, z, m, impl="plain"),
                               rtol=1e-3, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    z = torch.zeros((2, 8, 8), dtype=torch.complex128, device=card)
    m = torch.ones((8, 8), device=card)
    with pytest.raises(TypeError):
        plane_mult(z, m)
    zc = torch.zeros((2, 8, 8), dtype=torch.complex64, device=card)
    with pytest.raises(ValueError):
        plane_mult(zc.transpose(1, 2), m)
    with pytest.raises(ValueError):
        coil_adjoint(torch.conj(zc), zc)
    with pytest.raises(NotImplementedError):
        xpby_dot(zc, zc, 0.5)


def test_frame_kernel_path_matches_plain_path(card):
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    d = phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=1, seed=0)
    g = d["grid"]
    imgs = []
    for impl in ("auto", "plain"):
        rec = Reconstructor(device=card, newton=3, cg_iters=10, impl=impl)
        u0 = rec.init_carry(4, g)
        x_ref = {k: v.clone() for k, v in u0.items()}
        _, img = rec(rec.put_frame(d["y"][0]), rec.put_const(d["masks"][0]),
                     rec.put_const(d["fov"]),
                     rec.put_const(sobolev_weight(g)), u0, x_ref)
        imgs.append(img.cpu().numpy())
    rel = np.linalg.norm(imgs[0] - imgs[1]) / np.linalg.norm(imgs[1])
    assert rel <= 1e-4, rel


def test_double_buffer_side_stream(card):
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import DoubleBuffer, upload_frame
    rec = Reconstructor(device=card)
    rng = np.random.default_rng(0)
    ys = (rng.standard_normal((3, 2, 64, 64)) +
          1j * rng.standard_normal((3, 2, 64, 64))).astype(np.complex64)
    ms = rng.random((3, 64, 64)) > 0.5
    buf = DoubleBuffer(lambda f: upload_frame(rec, ys[f], ms[f]), card)
    buf.stage(0)
    for f in range(3):
        yd, md = buf.take()
        if f + 1 < 3:
            buf.stage(f + 1)
        np.testing.assert_array_equal(yd.cpu().numpy(), ys[f])
        np.testing.assert_array_equal(md.cpu().numpy(),
                                      ms[f].astype(np.float32))


# -- radial gridding ---------------------------------------------------------
# (J, grid, nspokes, nsamp): 200 samples padded to 256; J = 9 takes the
# adjoint kernel's second block of coils; 150 samples padded to 256 on a
# ragged grid; the one-cell grid, where both taps of an axis coincide.
GRIDDING_SHAPES = [(2, 16, 5, 40), (3, 32, 5, 128), (9, 24, 3, 50),
                   (1, 1, 2, 30)]


@pytest.mark.parametrize("ncoils,grid,nspokes,nsamp", GRIDDING_SHAPES)
@pytest.mark.parametrize("name", ["degrid", "grid_adjoint"])
def test_gridding_kernel_matches_plain(card, name, ncoils, grid, nspokes,
                                       nsamp):
    spec = registry.get(name)
    gen = torch.Generator(device=card).manual_seed(8)
    x, op, m = spec.sample(card, gen, ncoils=ncoils, grid=grid,
                           nspokes=nspokes, nsamp=nsamp)
    before = spec.launches
    got = spec.kernel(x, op, m)
    want = spec.plain(x, op, m)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    torch.testing.assert_close(got, want, rtol=10 * spec.tol, atol=spec.tol)
    if name == "degrid":
        assert bool((got[:, op.nsamp:] == 0).all())


def _radial_op(card, grid=32, nspokes=5, nsamp=40):
    from repro_torch.lib.gridding import radial_trajectory
    return Interp.build(radial_trajectory(grid, nspokes, nsamp=nsamp), grid,
                        device=card)


def test_grid_adjoint_is_bitwise_and_never_reads_padded_rows(card):
    op = _radial_op(card)
    gen = torch.Generator(device=card).manual_seed(9)
    y = torch.randn((8, op.nsamp_padded), dtype=torch.complex64,
                    device=card, generator=gen)
    y[:, op.nsamp:] = 0
    first = grid_adjoint(y, op)
    for _ in range(3):
        assert torch.equal(grid_adjoint(y, op), first)
    y_nan = y.clone()
    y_nan[:, op.nsamp:] = complex(float("nan"), float("nan"))
    assert torch.equal(grid_adjoint(y_nan, op), first)


def test_gridding_adjoint_dot_on_the_card(card):
    op = _radial_op(card, grid=64, nspokes=9, nsamp=None)
    gen = torch.Generator(device=card).manual_seed(10)
    g = torch.randn((4, 64, 64), dtype=torch.complex64, device=card,
                    generator=gen)
    y = torch.randn((4, op.nsamp_padded), dtype=torch.complex64,
                    device=card, generator=gen)
    lhs = complex(torch.vdot(degrid(g, op).reshape(-1), y.reshape(-1)))
    rhs = complex(torch.vdot(g.reshape(-1), grid_adjoint(y, op).reshape(-1)))
    assert abs(lhs - rhs) <= 1e-3 * abs(lhs)


def test_gridding_wrappers_refuse_what_the_kernels_do_not_take(card):
    op = _radial_op(card)
    with pytest.raises(ValueError):
        degrid(torch.zeros((2, 16, 16), dtype=torch.complex64, device=card),
               op)
    with pytest.raises(TypeError):
        degrid(torch.zeros((2, 32, 32), dtype=torch.complex128,
                           device=card), op)
    with pytest.raises(ValueError):
        grid_adjoint(torch.zeros((2, 7), dtype=torch.complex64, device=card),
                     op)


def test_radial_kernel_path_matches_plain_path(card):
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.gridding import radial_ops
    d = phantom.make_dataset(n=32, ncoils=4, nspokes=13, frames=1, seed=5)
    coil_imgs = torch.as_tensor(d["rho"][0][None] * d["coils"], device=card)
    imgs = []
    for impl in ("auto", "plain"):
        ops = radial_ops(d["grid"], 13, device=card, impl=impl)
        imgs.append(ops.recon(ops.forward(coil_imgs), d["fov"]))
    rel = float(torch.linalg.vector_norm(imgs[0] - imgs[1]) /
                torch.linalg.vector_norm(imgs[1]))
    assert rel <= 1e-4, rel
