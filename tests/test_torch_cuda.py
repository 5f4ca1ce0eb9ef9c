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
from repro_torch.kernels.coil_mult import (coil_adjoint, coil_forward,
                                           coil_forward_ref, coil_lincomb,
                                           plane_mult)
from repro_torch.kernels.flash_attention import (FEATURE_CASES, ROUTES,
                                                 chunked_attention,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gridding import Interp, degrid, grid_adjoint
from repro_torch.kernels.masked_allreduce import masked_sum, masked_sum_ref
from repro_torch.kernels.mlstm import FEATURE_CASES as MLSTM_CASES
from repro_torch.kernels.mlstm import (gated_inputs, mlstm_chunkwise,
                                       mlstm_ref, mlstm_scan)
from repro_torch.kernels.mlstm.ops import ROUTES as MLSTM_ROUTES
from repro_torch.kernels.rg_lru import (rg_lru_ref, rg_lru_scan,
                                        rg_lru_scan_plain)

pytestmark = pytest.mark.cuda

SPEC_NAMES = ["coil_forward", "coil_lincomb", "coil_scale_mult",
              "plane_mult", "coil_adjoint", "cg_update", "xpby", "xpby_dot"]


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


@pytest.mark.parametrize("ncoils,grid", [(1, 37), (3, 37), (1, 64),
                                         (8, 64), (2, 768)])
def test_coil_forward_is_the_plain_product_bitwise(card, ncoils, grid):
    """Both forms of the kernel (two pixels a thread for an even pixel
    count, one for an odd one, 37 x 37) compute each element as the one
    complex product ``coils * x`` does: the same bits."""
    gen = torch.Generator(device=card).manual_seed(ncoils * grid)
    c, x = registry.get("coil_forward").sample(card, gen, ncoils=ncoils,
                                               grid=grid)
    got = coil_forward(c, x)
    torch.cuda.synchronize()
    assert torch.equal(got, coil_forward_ref(c, x))


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
    with pytest.raises(TypeError):
        xpby_dot(z, z, 0.5)
    with pytest.raises(ValueError):
        xpby_dot(zc, zc[:1], 0.5)
    with pytest.raises(TypeError):
        masked_sum(z, m)
    with pytest.raises(ValueError):
        masked_sum(zc.transpose(1, 2), m)
    with pytest.raises(TypeError):
        masked_sum(zc, m.double())


def test_wrappers_refuse_operands_on_two_devices(card):
    """An operand on the card never runs the plain version because
    another lies on the CPU, whichever of them comes first: the call
    raises and launches nothing."""
    x = torch.zeros((2, 8, 8), dtype=torch.complex64, device=card)
    p = torch.zeros((2, 8, 8), dtype=torch.complex64)
    before = registry.launches()
    with pytest.raises(ValueError, match="more than one device"):
        coil_lincomb(torch.tensor(2 + 0j), x)
    with pytest.raises(ValueError, match="more than one device"):
        masked_sum(p, torch.ones((8, 8)),
                   out=torch.zeros((8, 8), dtype=torch.complex64,
                                   device=card))
    with pytest.raises(ValueError, match="more than one device"):
        coil_forward(x, torch.zeros((8, 8), dtype=torch.complex64))
    assert registry.launches() == before


def test_xpby_dot_epilogue_launches_its_kernel(card):
    """``xpby_dot(with_dot=True)`` runs its own kernel on the card (one
    launch), and its ``w`` is the no-epilogue kernel's, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(8)
    x, y, b = registry.get("xpby_dot").sample(card, gen, ncoils=2, grid=96)
    spec, nodot = registry.get("xpby_dot"), registry.get("xpby")
    before = (spec.launches, nodot.launches)
    w, d = xpby_dot(x, y, b)
    w_only, none = xpby_dot(x, y, b, with_dot=False)
    torch.cuda.synchronize()
    assert (spec.launches, nodot.launches) == (before[0] + 1, before[1] + 1)
    assert none is None and d.dtype == torch.float32 and d.ndim == 0
    assert torch.equal(w, w_only)
    for _ in range(3):
        w2, d2 = xpby_dot(x, y, b)
        assert torch.equal(w, w2) and torch.equal(d, d2)


@pytest.mark.parametrize("nparts,size", [(4, 384), (2, 37), (1, 1),
                                         (5, 130)])
def test_masked_sum_matches_plain(card, nparts, size):
    """Kernel == plain version within the spec's tolerance, at the
    frame's gathered window and ragged shapes; bitwise repeatable."""
    spec = registry.get("masked_sum")
    gen = torch.Generator(device=card).manual_seed(9)
    p, m = spec.sample(card, gen, nparts=nparts, size=size)
    before = spec.launches
    got = masked_sum(p, m)
    again = masked_sum(p, m)
    torch.cuda.synchronize()
    assert spec.launches == before + 2
    torch.testing.assert_close(got, masked_sum_ref(p, m),
                               rtol=10 * spec.tol, atol=spec.tol)
    assert torch.equal(got, again)


def test_masked_sum_reads_and_writes_windows_in_place(card):
    """The frame's form: the partials are a window of larger planes (or a
    gathered payload with extras after each plane) and the result lands
    in a window of a zero-filled image."""
    gen = torch.Generator(device=card).manual_seed(10)
    g, q = 64, 16
    full = torch.randn((3, g, g), dtype=torch.complex64, device=card,
                       generator=gen)
    win = (slice(q, 3 * q), slice(q, 3 * q))
    m = (torch.rand((2 * q, 2 * q), device=card, generator=gen)
         > 0.3).float()
    out = torch.zeros((g, g), dtype=torch.complex64, device=card)
    res = masked_sum(full[:, win[0], win[1]], m, out=out[win])
    torch.cuda.synchronize()
    want = torch.zeros_like(out)
    want[win] = masked_sum_ref(full[:, win[0], win[1]], m)
    assert res.data_ptr() == out[win].data_ptr()
    torch.testing.assert_close(out, want, rtol=1e-3, atol=1e-4)
    rows = torch.randn((3, 2 * q * 2 * q + 2), dtype=torch.complex64,
                       device=card, generator=gen)
    stack = torch.as_strided(rows, (3, 2 * q, 2 * q),
                             (rows.stride(0), 2 * q, 1))
    torch.testing.assert_close(masked_sum(stack, m),
                               masked_sum_ref(stack, m), rtol=1e-3,
                               atol=1e-4)


def test_batched_masked_sum_matches_plain_and_each_row(card):
    """The batched kernel at (4, 2, X, Y) against its plain form, read
    from a strided window of larger planes and written into the windows
    of a zero-filled image in one launch; each row bitwise the unbatched
    launch on that row."""
    spec = registry.get("masked_sum")
    gen = torch.Generator(device=card).manual_seed(24)
    g, q = 96, 24
    full = torch.randn((4, 2, g, g), dtype=torch.complex64, device=card,
                       generator=gen)
    win = (slice(q, 3 * q), slice(q, 3 * q))
    part = full[:, :, win[0], win[1]]
    m = (torch.rand((2 * q, 2 * q), device=card, generator=gen)
         > 0.4).float()
    out = torch.zeros((2, g, g), dtype=torch.complex64, device=card)
    before = spec.launches
    res = masked_sum(part, m, out=out[:, win[0], win[1]])
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    assert res.data_ptr() == out[:, win[0], win[1]].data_ptr()
    want = torch.zeros_like(out)
    want[:, win[0], win[1]] = masked_sum_ref(part, m)
    torch.testing.assert_close(out, want, rtol=10 * spec.tol,
                               atol=spec.tol)
    for b in range(2):
        assert torch.equal(res[b], masked_sum(part[:, b], m))
    p, mm = spec.sample(card, gen, nparts=4, size=37, width=2)
    torch.testing.assert_close(masked_sum(p, mm), masked_sum_ref(p, mm),
                               rtol=10 * spec.tol, atol=spec.tol)
    with pytest.raises(ValueError):
        masked_sum(p, mm, out=torch.zeros((37, 37), dtype=torch.complex64,
                                          device=card))


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


# -- the batched forms of the frame kernels (a leading client dim) ----------

BATCHED_NAMES = [s for s in SPEC_NAMES if s != "xpby_dot"]


def _with_planes(args, shared):
    """The batched sample with every real or complex plane (X, Y), shared
    by the rows (row stride 0), or (B, X, Y), one a row (stride X * Y);
    stacks (4-D) and the (B,) scalars stay as they are."""
    B = next(a.shape[0] for a in args if a.ndim == 4)
    out = []
    for a in args:
        if a.ndim == 3 and shared:
            a = a[0].contiguous()
        elif a.ndim == 2 and not shared:
            a = a.expand(B, *a.shape).contiguous()
        out.append(a)
    return out


def _row_args(args, b):
    """Row b of a batched call as the unbatched call takes it."""
    return [a if a.ndim == 2 else a[b] for a in args]


@pytest.mark.parametrize("shared", [False, True], ids=["row", "shared"])
@pytest.mark.parametrize("name", BATCHED_NAMES)
def test_batched_kernel_matches_plain(card, name, shared):
    """Each frame kernel at B = 3 (a ragged grid) against its plain form,
    to the spec's tolerance, in one counted launch."""
    spec = registry.get(name)
    gen = torch.Generator(device=card).manual_seed(21)
    args = _with_planes(spec.sample(card, gen, ncoils=3, grid=37, width=3),
                        shared)
    before = spec.launches
    got = spec.kernel(*args)
    want = spec.plain(*args)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=10 * spec.tol, atol=spec.tol)


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("name", BATCHED_NAMES)
def test_batched_kernel_rows_are_the_unbatched_kernel(card, name, width):
    """A row's bits depend neither on B nor on the other rows: each row of
    the batched launch equals the unbatched kernel on that row, bitwise
    (at B = 1 the batched call is the unbatched kernel)."""
    spec = registry.get(name)
    gen = torch.Generator(device=card).manual_seed(22)
    args = spec.sample(card, gen, ncoils=2, grid=64, width=width)
    got = _outputs(spec.kernel(*args))
    for b in range(width):
        want = _outputs(spec.kernel(*_row_args(args, b)))
        for g, w in zip(got, want):
            assert torch.equal(g[b], w), (name, b)


@pytest.mark.parametrize("name", BATCHED_NAMES)
def test_batched_kernel_nan_row_leaves_the_other_rows(card, name):
    spec = registry.get(name)
    gen = torch.Generator(device=card).manual_seed(23)
    args = list(spec.sample(card, gen, ncoils=2, grid=32, width=3))
    clean = _outputs(spec.kernel(*args))
    i = next(i for i, a in enumerate(args) if a.ndim == 4)
    args[i] = args[i].clone()
    args[i][1] = complex(float("nan"), float("nan"))
    got = _outputs(spec.kernel(*args))
    assert torch.isnan(got[0][1]).any()
    for g, c in zip(got, clean):
        assert torch.equal(g[0], c[0]) and torch.equal(g[2], c[2])


def test_batched_cg_kernels_freeze_inactive_rows(card):
    """A row that ``active`` marks False keeps its inputs whatever its
    scalar holds (NaN here): cg_update's x and r and the rs of that r,
    xpby's y; the other rows are the unmasked launch's bits."""
    gen = torch.Generator(device=card).manual_seed(24)
    a, p, ap, x, r = registry.get("cg_update").sample(card, gen, ncoils=2,
                                                      grid=48, width=3)
    a = a.clone()
    a[1] = float("nan")
    active = torch.tensor([True, False, True], device=card)
    x2, r2, rs = cg_update(a, p, ap, x, r, active=active)
    full = cg_update(a, p, ap, x, r)
    assert torch.equal(x2[1], x[1]) and torch.equal(r2[1], r[1])
    # rs of the kept r: the active update at alpha = 0 leaves r as it is
    assert torch.equal(rs[1], cg_update(torch.zeros_like(a[1:2]), p[1:2],
                                        ap[1:2], x[1:2], r[1:2])[2][0])
    for got, want in zip((x2, r2, rs), full):
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    w, _ = xpby_dot(x, p, a, with_dot=False, active=active)
    w_full, _ = xpby_dot(x, p, a, with_dot=False)
    assert torch.equal(w[1], p[1])
    assert torch.equal(w[0], w_full[0]) and torch.equal(w[2], w_full[2])


def test_batched_frame_kernel_path_matches_each_client(card):
    """The batched frame on the card, row k against the unbatched frame
    of client k within 1e-5, and the CG log row by row."""
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import stack_carries
    ds = [phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=1, seed=s)
          for s in range(3)]
    g = ds[0]["grid"]
    rec = Reconstructor(device=card, newton=3, cg_iters=10)
    fov, w = rec.put_const(ds[0]["fov"]), rec.put_const(sobolev_weight(g))
    imgs, logs = [], []
    for d in ds:
        u0 = rec.init_carry(4, g)
        start = len(rec.cg_log)
        _, img = rec(rec.put_frame(d["y"][0]), rec.put_const(d["masks"][0]),
                     fov, w, u0, {k: v.clone() for k, v in u0.items()})
        imgs.append(img)
        logs.append(rec.cg_log[start:])
    u0 = stack_carries([rec.init_carry(4, g) for _ in ds])
    rec.cg_log.clear()
    _, img = rec.fn_batched(3)(
        torch.stack([rec.put_frame(d["y"][0]) for d in ds]),
        torch.stack([rec.put_const(d["masks"][0]) for d in ds]), fov, w,
        u0, {k: v.clone() for k, v in u0.items()})
    for b in range(3):
        rel = float((img[b] - imgs[b]).abs().max() / imgs[b].abs().max())
        assert rel <= 1e-5, (b, rel)
        assert [c[b] for c in rec.cg_log] == logs[b]


def test_frame_pipeline_matches_frame_stream(card):
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FramePipeline, FrameStream
    d = phantom.make_dataset(n=16, ncoils=2, nspokes=7, frames=5, seed=11)
    args = (d["y"], d["masks"], d["fov"])
    rec = Reconstructor(device=card, newton=3, cg_iters=6)
    seq, _ = FrameStream(rec).run(*args)
    pipe, rep = FramePipeline(rec, inflight=3).run(*args)
    rel = float((pipe - seq).abs().max() / seq.abs().max())
    assert rel <= 1e-5 and len(rep.frame_ms) == 5


# -- radial gridding ---------------------------------------------------------
# (J, grid, nspokes, nsamp): 200 samples padded to 256; J = 9 takes the
# adjoint kernel's second block of coils; 150 samples padded to 256 on a
# ragged grid; an odd grid, whose planes the adjoint's fill takes a cell
# at a time; the one-cell grid, where both taps of an axis coincide.
GRIDDING_SHAPES = [(2, 16, 5, 40), (3, 32, 5, 128), (9, 24, 3, 50),
                   (3, 25, 4, 40), (1, 1, 2, 30)]


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


@pytest.mark.parametrize(
    "shape", GRIDDING_SHAPES + [None],
    ids=[f"J{s[0]}-grid{s[1]}" for s in GRIDDING_SHAPES] + ["frame0"])
def test_grid_adjoint_writes_every_cell(card, shape):
    """One counted wrapper call writes the whole grid: the fill's zeros
    where no sample falls and the gather's sums where one does, into the
    allocator's block of a grid of NaN freed just before the call (its
    address checked), against the plain version; at the GRIDDING_SHAPES
    and at frame 0 of the main path (J = 8, grid 768, 11 spokes of 1536
    samples)."""
    spec = registry.get("grid_adjoint")
    gen = torch.Generator(device=card).manual_seed(14)
    if shape is None:
        y, op, m = spec.sample(card, gen)
    else:
        ncoils, grid, nspokes, nsamp = shape
        y, op, m = spec.sample(card, gen, ncoils=ncoils, grid=grid,
                               nspokes=nspokes, nsamp=nsamp)
    want = spec.plain(y, op, m)
    poison = torch.full((y.shape[0], op.grid, op.grid),
                        complex(float("nan"), 0.0), dtype=torch.complex64,
                        device=card)
    block = poison.data_ptr()
    del poison
    before = spec.launches
    got = grid_adjoint(y, op)
    torch.cuda.synchronize()
    assert got.data_ptr() == block
    assert spec.launches == before + 1
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    torch.testing.assert_close(got, want, rtol=10 * spec.tol, atol=spec.tol)


def test_degrid_is_bitwise(card):
    op = _radial_op(card, grid=64, nspokes=9, nsamp=None)
    gen = torch.Generator(device=card).manual_seed(13)
    g = torch.randn((9, 64, 64), dtype=torch.complex64, device=card,
                    generator=gen)
    first = degrid(g, op)
    for _ in range(3):
        assert torch.equal(degrid(g, op), first)


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


# -- the LM path: flash attention and the RG-LRU scan ------------------------
# (B, Hq, Hkv, S, T, D, keywords): ragged S and T, a one-token prompt, head
# dims 32 to 256 (100: not a multiple of 64), MQA/GQA/MHA, and every mask
# feature: causal, window, softcap, kv_len, q_offset, non-causal.
ATTENTION_SHAPES = [
    (1, 10, 1, 1, 1, 256, {"causal": True, "window": 2048}),
    (1, 10, 1, 77, 77, 256, {"causal": True, "window": 16}),
    (2, 4, 2, 65, 130, 128, {"causal": True, "q_offset": 65}),
    (1, 2, 2, 33, 47, 64, {"causal": False, "kv_len": 40}),
    (1, 4, 1, 100, 100, 100, {"causal": True, "softcap": 30.0,
                              "window": 33}),
    (1, 3, 3, 5, 300, 32, {"causal": False}),
    (1, 2, 1, 70, 70, 256, {"causal": True, "kv_len": 0}),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES,
                         ids=lambda s: f"S{s[3]}_T{s[4]}_D{s[5]}")
def test_flash_attention_matches_plain(card, shape, dtype):
    B, Hq, Hkv, S, T, D, kw = shape
    gen = torch.Generator(device=card).manual_seed(S * 7 + D)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(dtype)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    spec = registry.get("flash_attention")
    before = spec.launches
    got = flash_attention(q, k, v, **kw)
    want = chunked_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert spec.launches == before + 1 and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=10 * tol,
                               atol=tol)


@pytest.mark.parametrize("case", FEATURE_CASES,
                         ids=["causal", "gqa_q_offset", "window_softcap",
                              "kv_len_noncausal", "bf16"])
def test_flash_attention_feature_samples(card, case):
    B, Hq, Hkv, S, T, D, dtype, kw, tol = case
    gen = torch.Generator(device=card).manual_seed(500)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(dtype)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                               chunked_attention(q, k, v, **kw).float(),
                               rtol=10 * tol, atol=tol)


@pytest.mark.parametrize("case", FEATURE_CASES,
                         ids=["causal", "gqa_q_offset", "window_softcap",
                              "kv_len_noncausal", "bf16"])
def test_flash_attention_feature_samples_on_tensor_cores(card, case):
    """Every JAX feature sample in bf16, through the tensor-core route,
    within the JAX spec's bf16 tolerance (2e-2)."""
    B, Hq, Hkv, S, T, D, _, kw, _ = case
    gen = torch.Generator(device=card).manual_seed(501)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(torch.bfloat16)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    spec = registry.get("flash_attention")
    before = spec.entry_launches.get(ROUTES[torch.bfloat16], 0)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert spec.entry_launches[ROUTES[torch.bfloat16]] == before + 1
    torch.testing.assert_close(got.float(),
                               chunked_attention(q, k, v, **kw).float(),
                               rtol=0.2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_takes_one_route_per_dtype(card, dtype):
    """bf16 launches the tensor-core entry, float32 the CUDA-core one:
    one launch a call, counted under its entry and under the spec."""
    gen = torch.Generator(device=card).manual_seed(502)
    q, k, v = (torch.randn((1, 2, 40, 64), device=card,
                           generator=gen).to(dtype) for _ in range(3))
    spec = registry.get("flash_attention")
    before = dict(spec.entry_launches), spec.launches
    flash_attention(q, k, v)
    torch.cuda.synchronize()
    moved = {e: n - before[0].get(e, 0)
             for e, n in spec.entry_launches.items()
             if n != before[0].get(e, 0)}
    assert moved == {ROUTES[dtype]: 1} and spec.launches == before[1] + 1


def test_flash_attention_bf16_is_bitwise_repeatable(card):
    """No atomics and a fixed reduction order: two calls of the
    tensor-core route at the LM sample give the same bits."""
    gen = torch.Generator(device=card).manual_seed(503)
    q, k, v, kw, _ = registry.get("flash_attention").sample(card, gen)
    first = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# v's head dim apart from k's: the two MLA archs' (D, Dv), a Dv above D,
# ragged dims that are not multiples of 8 (element-wise loads), and a Dv of
# 64 or less beside a D above 128 (the 192/128 and 256/128 instances)
DV_SHAPES = [(1, 16, 16, 77, 77, 192, 128, {"causal": True}),
             (1, 4, 4, 130, 130, 96, 64, {"causal": True, "q_offset": 3}),
             (2, 4, 2, 65, 200, 64, 128, {"causal": False, "kv_len": 150}),
             (1, 2, 1, 33, 33, 40, 20, {"causal": True, "window": 9}),
             (1, 2, 1, 50, 70, 160, 48, {"causal": False}),
             (1, 2, 2, 64, 64, 256, 64, {"causal": True})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DV_SHAPES,
                         ids=lambda s: f"D{s[5]}_Dv{s[6]}")
def test_flash_attention_takes_v_head_dim(card, shape, dtype):
    """Both routes with v of its own head dim against the plain version,
    the output of v's width, and a bitwise repeat."""
    B, Hq, Hkv, S, T, D, Dv, kw = shape
    gen = torch.Generator(device=card).manual_seed(S + D + Dv)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(dtype)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
    spec = registry.get("flash_attention")
    before = spec.entry_launches.get(ROUTES[dtype], 0)
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    want = chunked_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert spec.entry_launches[ROUTES[dtype]] == before + 2
    assert got.shape == (B, Hq, S, Dv) and torch.equal(got, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=10 * tol,
                               atol=tol)


# The bf16 kernel's tiles: BLOCK_Q query rows a block, block_k(D) keys a
# stage.  S one below, at and one above a block, T likewise around two
# stages (one at D = 256), at each of the six (D, Dv) instances; q_offset
# puts the prompt at the cache's end and kv_len cuts the last key, so every
# row sees the keys up to min(its position, T - 2).
TILE_DIMS = [(64, 64), (128, 64), (128, 128), (192, 128), (256, 128),
             (256, 256)]


@pytest.mark.parametrize("delta", [-1, 0, 1], ids=["below", "at", "above"])
@pytest.mark.parametrize("D,Dv", TILE_DIMS,
                         ids=[f"D{d}_Dv{dv}" for d, dv in TILE_DIMS])
def test_flash_attention_bf16_at_the_tile_edges(card, D, Dv, delta):
    S = flash_ops.BLOCK_Q + delta
    T = flash_ops.block_k(D) * (2 if D <= 192 else 1) + delta
    kw = {"causal": True, "q_offset": T - S, "kv_len": T - 1}
    gen = torch.Generator(device=card).manual_seed(D + Dv + delta)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(torch.bfloat16)
               for s in ((1, 4, S, D), (1, 2, T, D), (1, 2, T, Dv)))
    flash_ops.reset_loaders()
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    want = chunked_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.loader_launches == {"tma": 2, "threads": 0}
    assert got.shape == (1, 4, S, Dv) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.2,
                               atol=2e-2)


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 2, 8, 32), device=card)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 32), device=card),
                        torch.zeros((1, 3, 8, 32), device=card))
    with pytest.raises(ValueError):
        big = torch.zeros((1, 2, 8, 320), device=card)
        flash_attention(big, big, big)
    with pytest.raises(ValueError):
        flash_attention(q, q, torch.zeros((1, 2, 8, 320), device=card))
    with pytest.raises(ValueError):
        flash_attention(q, q, torch.zeros((1, 2, 9, 32), device=card))
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention(h, h, h)
    with pytest.raises(ValueError):
        t = torch.zeros((1, 2, 32, 8), device=card).transpose(2, 3)
        flash_attention(t, t, t)


# The kernel cuts time into chunks of RG_LRU_CHUNK (128) steps: S = 1,
# one step past a chunk, a ragged last chunk, S below one chunk, S equal to
# it, S = 0, batch 2 and widths that fill no warp (2567, 33), in both dtypes.
@pytest.mark.parametrize("B,S,W,dtype", [
    (1, 1, 33, torch.float32), (2, 17, 2567, torch.float32),
    (1, 100, 128, torch.float32), (2, 64, 96, torch.bfloat16),
    (2, 300, 2567, torch.float32), (1, 128, 64, torch.float32),
    (1, 129, 64, torch.float32), (1, 0, 32, torch.float32),
    (2, 1000, 96, torch.bfloat16)])
def test_rg_lru_matches_plain(card, B, S, W, dtype):
    gen = torch.Generator(device=card).manual_seed(W)
    la = (-0.1 * torch.randn((B, S, W), device=card, generator=gen).abs()
          ).to(dtype)
    b = torch.randn((B, S, W), device=card, generator=gen).to(dtype)
    h0 = torch.randn((B, W), device=card, generator=gen).to(dtype)
    spec = registry.get("rg_lru")
    before = spec.launches
    got = rg_lru_scan(la, b, h0)
    want = rg_lru_ref(la, b, h0)
    torch.cuda.synchronize()
    assert spec.launches == before + 1
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=10 * tol,
                                   atol=tol)
    for g, w in zip(got, rg_lru_scan_plain(la, b, h0)):
        torch.testing.assert_close(g.float(), w.float(), rtol=10 * tol,
                                   atol=tol)


def _rg_lru_served(card, seed):
    """The spec's inputs: recurrentgemma-2b's RG-LRU at the longest served
    prompt, (1, 3072, 2560) in float32."""
    return registry.get("rg_lru").sample(
        card, torch.Generator(device=card).manual_seed(seed))


def test_rg_lru_served_shape_matches_plain(card):
    la, b, h0 = _rg_lru_served(card, 11)
    assert tuple(b.shape) == (1, 3072, 2560) and b.dtype == torch.float32
    got = rg_lru_scan(la, b, h0)
    want = rg_lru_scan_plain(la, b, h0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_rg_lru_is_bitwise_repeatable(card):
    """Summaries folded in a fixed order, no atomics: two calls at the
    served shape give the same bits."""
    la, b, h0 = _rg_lru_served(card, 12)
    first = rg_lru_scan(la, b, h0)
    again = rg_lru_scan(la, b, h0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


# More tiles than fit resident at once (three blocks an SM): each block
# waits only on tiles of earlier tickets, whatever order the card runs them
@pytest.mark.parametrize("B,S,W", [(2, 3072, 2560), (4, 1024, 2560)])
def test_rg_lru_past_one_wave_matches_plain(card, B, S, W):
    gen = torch.Generator(device=card).manual_seed(B * S)
    la = -0.1 * torch.randn((B, S, W), device=card, generator=gen).abs()
    b = torch.randn((B, S, W), device=card, generator=gen)
    h0 = torch.randn((B, W), device=card, generator=gen)
    got = rg_lru_scan(la, b, h0)
    want = rg_lru_scan_plain(la, b, h0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_rg_lru_bf16_at_the_served_width(card):
    """bf16 at recurrentgemma-2b's width over 16 chunks, on TMA."""
    from repro_torch.kernels.rg_lru import ops as lru_ops
    gen = torch.Generator(device=card).manual_seed(16)
    la = (-0.1 * torch.randn((1, 2048, 2560), device=card,
                             generator=gen).abs()).bfloat16()
    b = torch.randn((1, 2048, 2560), device=card, generator=gen).bfloat16()
    h0 = torch.randn((1, 2560), device=card, generator=gen).bfloat16()
    lru_ops.reset_loaders()
    got = rg_lru_scan(la, b, h0)
    want = rg_lru_ref(la, b, h0)
    torch.cuda.synchronize()
    assert lru_ops.loader_launches == {"tma": 1, "threads": 0}
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=0.5, atol=5e-2)


def test_rg_lru_takes_its_loader(card):
    """TMA where a step's row is a multiple of 16 bytes at aligned bases;
    the block's threads for a width of 33 and for a base off 16 bytes."""
    from repro_torch.kernels.rg_lru import ops as lru_ops
    gen = torch.Generator(device=card).manual_seed(3)
    buf = torch.randn(2 * 300 * 64 + 1, device=card, generator=gen)
    la = -buf[1:].view(2, 300, 64).abs() * 0.1
    b = buf[1:].view(2, 300, 64)
    h0 = torch.zeros(2, 64, device=card)
    lru_ops.reset_loaders()
    aligned = rg_lru_scan(la, b.clone(), h0)
    rg_lru_scan(torch.zeros(1, 40, 33, device=card),
                torch.ones(1, 40, 33, device=card),
                torch.zeros(1, 33, device=card))
    got = rg_lru_scan(la, b, h0)
    torch.cuda.synchronize()
    assert b.data_ptr() % 16
    assert lru_ops.loader_launches == {"tma": 1, "threads": 2}
    for g, a, w in zip(got, aligned, rg_lru_ref(la, b, h0)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_rg_lru_repeats_across_calls_and_streams(card):
    """One kernel a call; three calls back to back give the first call's
    bits (the ticket counter reset by the last tile, the aggregate words
    of each call tagged with its own tag), and so does a call on a side
    stream (its own state) beside a call on the current one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    la, b, h0 = _rg_lru_served(card, 13)
    first = rg_lru_scan(la, b, h0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = [rg_lru_scan(la, b, h0) for _ in range(3)]
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    counts = [e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "rg_lru_kernel" in names[0], names
    assert counts == [3]
    side = torch.cuda.Stream(device=card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        beside = rg_lru_scan(la, b, h0)
    here = rg_lru_scan(la, b, h0)
    torch.cuda.synchronize()
    for out in again + [beside, here]:
        assert all(torch.equal(x, y) for x, y in zip(first, out))


def test_rg_lru_state_outlives_its_tags(card):
    """At the last tag the stream's state is made anew with zeros: the
    call before it, the call at it and the calls after give the same
    bits, and a longer sequence grows the state."""
    from repro_torch.kernels.rg_lru import ops as lru_ops
    gen = torch.Generator(device=card).manual_seed(21)
    la = -0.1 * torch.randn((2, 700, 320), device=card, generator=gen).abs()
    b = torch.randn((2, 700, 320), device=card, generator=gen)
    h0 = torch.randn((2, 320), device=card, generator=gen)
    first = rg_lru_scan(la, b, h0)
    key = (card.index or 0, torch.cuda.current_stream(card).cuda_stream)
    held = lru_ops._STATE[key]
    held[1] = lru_ops._LAST_TAG - 2
    outs = [rg_lru_scan(la, b, h0) for _ in range(3)]
    assert lru_ops._STATE[key] is not held and lru_ops._STATE[key][1] == 1
    longer = rg_lru_scan(la.repeat(1, 3, 1), b.repeat(1, 3, 1), h0)
    again = rg_lru_scan(la, b, h0)
    torch.cuda.synchronize()
    for out in outs + [again]:
        assert all(torch.equal(x, y) for x, y in zip(first, out))
    want = rg_lru_scan_plain(la.repeat(1, 3, 1), b.repeat(1, 3, 1), h0)
    for g, w in zip(longer, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_lm_kernel_path_matches_plain_path(card):
    """recurrentgemma-2b SMOKE in float32 on the card: the prefill through
    both kernels against the plain versions, past the window."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              compute_dtype="float32")
    model = transformer.init_params(cfg, device=card)
    tok = torch.randint(0, cfg.vocab, (2, 40), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    before = registry.launches()
    got, _, _ = transformer.apply(cfg, model, tok)
    after = registry.launches()
    with registry.plain():
        want, _, _ = transformer.apply(cfg, model, tok)
    assert after["flash_attention"] - before["flash_attention"] == 1
    assert after["rg_lru"] - before["rg_lru"] == 4
    assert registry.launches() == after
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# -- the xlstm-350m path: the chunkwise mLSTM --------------------------------
# (B, H, S, dk, dv, chunk, nonzero state, dtype): the feature cases, S = 1,
# head dims that fill no tile (100, 72, 48, 40), a ragged chunk of 16, and
# the served head dim 512 in bf16 with a ragged last chunk; then the
# tensor-core route (bf16) at the same cases: the served head dim from a
# nonzero state with a last chunk of 104 steps (both row halves of the
# output pass) and of 44 (the first half alone), the feature cases, S = 1,
# a head dim whose rows the wrapper pads to 16 bytes (100), partial tiles,
# and a head dim past the output pass's 512 (1056), which takes the
# CUDA-core passes in bf16 under the same entry.  Then the wgmma kernels'
# own edges: dv not a multiple of 64 over two column tiles (200), dv not
# a multiple of 8 (20: v's rows and the scratch's padded), a chunk below
# 64 (48), and a B * H past one wave of both kernels (192 walk blocks, 144
# output blocks on 132 SMs).
MLSTM_SHAPES = [c + (torch.float32,) for c in MLSTM_CASES] + [
    (1, 1, 1, 64, 64, 128, True, torch.float32),
    (1, 2, 200, 100, 72, 128, True, torch.float32),
    (2, 2, 77, 48, 40, 16, True, torch.float32),
    (1, 4, 300, 512, 512, 128, False, torch.bfloat16),
    (1, 4, 1000, 512, 512, 128, True, torch.bfloat16),
    (1, 2, 300, 512, 512, 128, True, torch.bfloat16),
] + [c + (torch.bfloat16,) for c in MLSTM_CASES] + [
    (1, 1, 1, 64, 64, 128, True, torch.bfloat16),
    (1, 2, 200, 100, 72, 128, True, torch.bfloat16),
    (2, 2, 77, 48, 40, 16, True, torch.bfloat16),
    (1, 1, 200, 1056, 96, 128, True, torch.bfloat16),
    (1, 2, 300, 64, 200, 128, True, torch.bfloat16),
    (1, 2, 150, 40, 20, 128, True, torch.bfloat16),
    (1, 2, 300, 128, 128, 48, True, torch.bfloat16),
    (2, 3, 3072, 512, 512, 128, True, torch.bfloat16),
]


@pytest.mark.parametrize("shape", MLSTM_SHAPES,
                         ids=lambda s: f"S{s[2]}_dk{s[3]}_dv{s[4]}_L{s[5]}"
                         f"{'_state' if s[6] else ''}_{str(s[7])[6:]}")
def test_mlstm_matches_plain(card, shape):
    B, H, S, dk, dv, chunk, nonzero, dtype = shape
    gen = torch.Generator(device=card).manual_seed(S + dk)
    args = gated_inputs(B, H, S, dk, dv, nonzero_state=nonzero, dtype=dtype,
                        device=card, generator=gen)
    spec = registry.get("mlstm")
    before = spec.launches
    h, state = mlstm_scan(*args, chunk=chunk)
    want_h, want_state = mlstm_chunkwise(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert spec.launches == before + 1 and h.dtype == dtype
    for g, w in zip((h, *state), (want_h, *want_state)):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_takes_one_route_per_dtype(card, dtype):
    """bf16 launches the tensor-core entry, float32 the CUDA-core one: one
    launch a call, counted under its entry and under the spec."""
    gen = torch.Generator(device=card).manual_seed(504)
    args = gated_inputs(1, 2, 150, 64, 64, nonzero_state=True, dtype=dtype,
                        device=card, generator=gen)
    spec = registry.get("mlstm")
    before = dict(spec.entry_launches), spec.launches
    mlstm_scan(*args)
    torch.cuda.synchronize()
    moved = {e: n - before[0].get(e, 0)
             for e, n in spec.entry_launches.items()
             if n != before[0].get(e, 0)}
    assert moved == {MLSTM_ROUTES[dtype]: 1}
    assert spec.launches == before[1] + 1


def test_mlstm_f32_is_bitwise_repeatable(card):
    gen = torch.Generator(device=card).manual_seed(5)
    args = gated_inputs(1, 2, 300, 128, 128, nonzero_state=True,
                        device=card, generator=gen)
    first = _flat(mlstm_scan(*args))
    again = _flat(mlstm_scan(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def _flat(out):
    h, (C, n, m) = out
    return h, C, n, m


def test_mlstm_matches_the_sequential_oracle(card):
    gen = torch.Generator(device=card).manual_seed(9)
    args = gated_inputs(1, 2, 70, 32, 32, nonzero_state=True, device=card,
                        generator=gen)
    h, state = mlstm_scan(*args, chunk=32)
    want_h, want_state = mlstm_ref(*args)
    for g, w in zip((h, *state), (want_h, *want_state)):
        torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-3)


def test_mlstm_is_bitwise_repeatable(card):
    gen = torch.Generator(device=card).manual_seed(2)
    args = gated_inputs(1, 2, 300, 128, 128, nonzero_state=True,
                        dtype=torch.bfloat16, device=card, generator=gen)
    h, (C, n, m) = mlstm_scan(*args)
    for _ in range(2):
        h2, (C2, n2, m2) = mlstm_scan(*args)
        assert torch.equal(h, h2) and torch.equal(C, C2)
        assert torch.equal(n, n2) and torch.equal(m, m2)


def test_mlstm_bf16_served_shape_is_bitwise_repeatable(card):
    """The wgmma kernels at xlstm-350m's prefill shape from a nonzero
    state: two calls give the same bits, each one launch of mlstm_bf16."""
    gen = torch.Generator(device=card).manual_seed(30)
    args = gated_inputs(1, 4, 3072, 512, 512, nonzero_state=True,
                        dtype=torch.bfloat16, device=card, generator=gen)
    spec = registry.get("mlstm")
    before = spec.entry_launches.get("mlstm_bf16", 0)
    first = _flat(mlstm_scan(*args))
    again = _flat(mlstm_scan(*args))
    torch.cuda.synchronize()
    assert spec.entry_launches["mlstm_bf16"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_mlstm_bf16_takes_unaligned_operands(card):
    """q, k, v and the gates on bases one element off a 16-byte boundary
    (contiguous views) give the bits of their aligned copies."""
    gen = torch.Generator(device=card).manual_seed(31)
    q, k, v, li, lf, st = gated_inputs(1, 2, 200, 64, 64,
                                       nonzero_state=True,
                                       dtype=torch.bfloat16, device=card,
                                       generator=gen)

    def off(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 and y.is_contiguous()
        return y
    want = _flat(mlstm_scan(q, k, v, li, lf, st))
    got = _flat(mlstm_scan(*map(off, (q, k, v, li, lf)), st))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_mlstm_refuses_what_the_kernel_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, li, lf, st = gated_inputs(1, 2, 16, 32, 32, device=card,
                                       generator=gen)
    with pytest.raises(ValueError):
        mlstm_scan(q, k, v, li, lf, st, chunk=256)
    with pytest.raises(ValueError):
        mlstm_scan(q[:, :, :0], k[:, :, :0], v[:, :, :0], li[..., :0],
                   lf[..., :0], st)
    with pytest.raises(TypeError):
        mlstm_scan(q.half(), k.half(), v.half(), li, lf, st)
    with pytest.raises(ValueError):
        mlstm_scan(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, li,
                   lf, st)
    with pytest.raises(ValueError):
        mlstm_scan(q, k, v, li, lf, (st[0][:, :1], st[1], st[2]))
    with pytest.raises(TypeError):
        mlstm_scan(q, k, v, li.double(), lf, st)


def test_xlstm_kernel_path_matches_plain_path(card):
    """xlstm-350m SMOKE in float32 on the card: the prefill through the
    mLSTM kernel against the plain versions, 7 mLSTM layers, a ragged
    chunk (S = 140 at the chunk of 128)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_smoke("xlstm-350m"),
                              compute_dtype="float32")
    model = transformer.init_params(cfg, device=card)
    tok = torch.randint(0, cfg.vocab, (2, 140), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    before = registry.launches()
    got, _, _ = transformer.apply(cfg, model, tok)
    after = registry.launches()
    with registry.plain():
        want, _, _ = transformer.apply(cfg, model, tok)
    assert after["mlstm"] - before["mlstm"] == 7
    assert registry.launches() == after
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# -- gradients through the LM kernels ---------------------------------------
# Each wrapper, on card tensors that require grad, launches its kernel in
# the forward and returns the plain version's gradient, recomputed, in the
# backward: the gradients are those of the plain path on the same inputs
# (bitwise, as the same operations; held here to 1e-6 relative L2).

GRAD_TOL = 1e-6


def _rel(a, b):
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp(min=1e-30))


def _grads_both_ways(card, fn, inputs, needs, seed=0):
    """(kernel-path grads, plain-path grads, launches of the kernel path's
    forward, whether its outputs carry a grad_fn)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    out = []
    for plain in (False, True):
        xs = [t.detach().clone().requires_grad_(n) for t, n in
              zip(inputs, needs)]
        before = registry.launches()
        with registry.plain() if plain else _nullcontext():
            ys = fn(*xs)
        ys = ys if isinstance(ys, tuple) else (ys,)
        launched = {k: v - before[k] for k, v in registry.launches().items()
                    if v != before[k]}
        gen.manual_seed(seed)           # the same weights both ways
        ws = [torch.randn(y.shape, device=card, generator=gen)
              for y in ys]
        loss = sum((y.float() * w).sum() for y, w in zip(ys, ws))
        gs = torch.autograd.grad(loss, [x for x, n in zip(xs, needs) if n])
        out.append((gs, launched, all(y.grad_fn is not None for y in ys)))
    return out


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()


def _check_grads(card, name, fn, inputs, needs):
    (gk, launched, has_fn), (gp, plain_launched, _) = _grads_both_ways(
        card, fn, inputs, needs)
    torch.cuda.synchronize()
    assert launched == {name: 1} and plain_launched == {}
    assert has_fn
    for a, b in zip(gk, gp):
        assert a.dtype == b.dtype and _rel(a, b) <= GRAD_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,Dv,kw", [
    (1, 4, 2, 200, 64, 64, {"causal": True, "window": 64}),
    (2, 2, 2, 128, 96, 64, {"causal": True, "softcap": 30.0}),
], ids=["gqa-window", "dv-softcap"])
def test_flash_attention_gradients_are_the_plain_ones(card, B, Hq, Hkv, S,
                                                      D, Dv, kw, dtype):
    gen = torch.Generator(device=card).manual_seed(S)
    q, k, v = (torch.randn(s, device=card, generator=gen).to(dtype)
               for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv)))
    _check_grads(card, "flash_attention",
                 lambda q, k, v: flash_attention(q, k, v, **kw),
                 (q, k, v), (True, True, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W", [(1, 300, 64), (2, 128, 256)])
def test_rg_lru_gradients_are_the_plain_ones(card, B, S, W, dtype):
    gen = torch.Generator(device=card).manual_seed(S)
    la = (-0.1 * torch.randn(B, S, W, device=card, generator=gen).abs())
    b = torch.randn(B, S, W, device=card, generator=gen)
    h0 = torch.randn(B, W, device=card, generator=gen)
    _check_grads(card, "rg_lru", rg_lru_scan,
                 tuple(t.to(dtype) for t in (la, b, h0)), (True,) * 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,S,dk,dv,nonzero", [
    (1, 2, 200, 64, 64, True), (2, 1, 128, 32, 64, False)])
def test_mlstm_gradients_are_the_plain_ones(card, B, H, S, dk, dv, nonzero,
                                            dtype):
    gen = torch.Generator(device=card).manual_seed(S)
    q, k, v, li, lf, st = gated_inputs(B, H, S, dk, dv,
                                       nonzero_state=nonzero, dtype=dtype,
                                       device=card, generator=gen)

    def fn(q, k, v, li, lf, C, n, m):
        h, (C1, n1, m1) = mlstm_scan(q, k, v, li, lf, (C, n, m))
        return h, C1, n1, m1
    _check_grads(card, "mlstm", fn, (q, k, v, li, lf, *st),
                 (True,) * 5 + (nonzero,) * 3)


def test_kernel_without_grad_adds_no_autograd_node(card):
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, 2, 64, 32, device=card, generator=gen,
                    requires_grad=True)
    k, v = (torch.randn(1, 2, 64, 32, device=card, generator=gen)
            for _ in range(2))
    before = registry.launches()["flash_attention"]
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q.detach(), k, v).grad_fn is None
    la = -torch.rand(1, 16, 8, device=card)
    hs, h_last = rg_lru_scan(la, torch.randn(1, 16, 8, device=card),
                             torch.zeros(1, 8, device=card))
    assert hs.grad_fn is None and h_last.grad_fn is None
    torch.cuda.synchronize()
    assert registry.launches()["flash_attention"] == before + 2


@pytest.mark.parametrize("remat", [False, True], ids=["stored", "remat"])
def test_train_step_kernel_path_matches_plain_path(card, remat):
    """One float32 train step of qwen3-0.6b's and recurrentgemma-2b's SMOKE
    configs with the kernels (flash attention, the RG-LRU scan) against
    the same step inside ``registry.plain()``: loss and global grad norm
    within 1e-4 relative.  With remat, the plain path's layers are
    recomputed in the autograd engine's thread, and must still take the
    plain path there."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.train import make_train_state, make_train_step
    for arch in ("qwen3-0.6b", "recurrentgemma-2b"):
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        tok = torch.randint(0, cfg.vocab, (2, 64), device=card,
                            generator=torch.Generator(device=card)
                            .manual_seed(1))
        lab = torch.roll(tok, -1, 1)
        mets = []
        for plain in (False, True):
            state = make_train_state(cfg, torch.Generator(device=card)
                                     .manual_seed(0), device=card)
            step = make_train_step(cfg, remat=remat)
            with registry.plain() if plain else _nullcontext():
                _, met = step(state, tok, lab)
            mets.append({k: float(v) for k, v in met.items()})
        for key in ("loss", "gnorm"):
            assert abs(mets[0][key] - mets[1][key]) <= \
                1e-4 * abs(mets[1][key]), (arch, key, mets)
