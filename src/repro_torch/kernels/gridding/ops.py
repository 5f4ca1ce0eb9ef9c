"""Radial gridding/degridding: the CUDA kernels of ``csrc/gridding.cu`` on
the card, their plain PyTorch versions on the CPU.

The counterpart of ``repro/kernels/gridding/ops.py``.  The JAX package
hands its kernels the dense separable interpolation matrices
(``interp_matrices``: ``Ax``/``Ay``, (Sp, grid) float32, two nonzeros per
row).  The port keeps the same operator in the compact form its kernels
read, an :class:`Interp`: per-sample taps for ``degrid`` and a
cell-major index over the touched cells for ``grid_adjoint``.  The plain
versions build the dense pair from the taps when they run
(``Interp.dense``, bit for bit ``interp_matrices``) and compute the
separable form the TPU kernels compute.  ``impl`` is ``"auto"`` (kernel
for CUDA tensors, plain for CPU tensors) or ``"plain"``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, pointers, radial_sampler

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_C64, _F32, _I32 = torch.complex64, torch.float32, torch.int32
_SOURCE = "src/repro_torch/kernels/csrc/gridding.cu"
_TPU = "src/repro/kernels/gridding/kernel.py"


def radial_trajectory(grid: int, nspokes: int, frame: int = 0,
                      nsamp: int | None = None) -> np.ndarray:
    """(S, 2) float32 radial trajectory in grid units (DC at grid//2).

    ``nsamp`` samples per spoke (default ``2*grid``: 2x readout
    oversampling), golden-angle rotation per frame: the acquisition of the
    paper's real-time protocol at true off-grid coordinates.  It lives
    with the operator it feeds, so the kernels' specs can build their
    inputs; ``repro_torch.lib.gridding`` re-exports it.
    """
    if nsamp is None:
        nsamp = 2 * grid
    ga = np.pi * (3 - np.sqrt(5.0))
    c = grid // 2
    r = (np.arange(nsamp) + 0.5) / nsamp * grid - c    # (-c, c)
    pts = []
    for s in range(nspokes):
        th = s * np.pi / nspokes + frame * ga
        pts.append(np.stack([c + r * np.cos(th), c + r * np.sin(th)], 1))
    return np.concatenate(pts).astype(np.float32)


def interp_matrices(traj, grid: int, pad_to: int = 128):
    """Dense separable bilinear interpolation matrices for a trajectory.

    traj: (S, 2) float (x, y) points in grid units.  Returns (Ax, Ay)
    float32 numpy arrays of shape (Sp, grid) with Sp = S padded up to a
    multiple of ``pad_to``: padded rows are all-zero, so they sample (and
    scatter) nothing.  Two nonzeros per row; periodic wrap matches the
    ``ref.py`` oracle.  The port's plans keep :func:`interp_taps`
    instead; this is the JAX package's form, for the tests.
    """
    t = np.asarray(traj, np.float64)
    S = t.shape[0]
    Sp = -(-S // pad_to) * pad_to
    i0 = np.floor(t).astype(np.int64)
    f = (t - i0).astype(np.float32)
    rows = np.arange(S)

    def one_axis(idx, frac):
        A = np.zeros((Sp, grid), np.float32)
        A[rows, idx % grid] = 1.0 - frac
        # += : the two corners coincide when grid == 1 (degenerate)
        np.add.at(A, (rows, (idx + 1) % grid), frac)
        return A

    return one_axis(i0[:, 0], f[:, 0]), one_axis(i0[:, 1], f[:, 1])


def interp_taps(traj, grid: int, pad_to: int = 128):
    """The nonzeros of ``interp_matrices``, row by row.

    Returns (idx, w): idx (Sp, 4) int32, the columns (ix0, ix1, iy0, iy1)
    of row s's two nonzeros in Ax and in Ay; w (Sp, 4) float32, their
    values (wx0, wx1, wy0, wy1), rounded exactly as ``interp_matrices``
    rounds them (the fraction in float64 cast to float32, ``1 - frac`` in
    float32).  Padded rows have index 0 and weight 0.  With grid == 1 both
    columns of an axis are 0, and the dense row holds their sum.
    """
    t = np.asarray(traj, np.float64)
    S = t.shape[0]
    Sp = -(-S // pad_to) * pad_to
    i0 = np.floor(t).astype(np.int64)
    f = (t - i0).astype(np.float32)
    idx = np.zeros((Sp, 4), np.int32)
    w = np.zeros((Sp, 4), np.float32)
    for a in (0, 1):
        idx[:S, 2 * a] = i0[:, a] % grid
        idx[:S, 2 * a + 1] = (i0[:, a] + 1) % grid
        w[:S, 2 * a] = 1.0 - f[:, a]
        w[:S, 2 * a + 1] = f[:, a]
    return idx, w


def cell_index(idx, w, nsamp: int, grid: int):
    """Cell-major (CSR) form of the adjoint of the taps' operator, over the
    touched cells only.

    ``cells`` lists, in ascending order, the T grid cells c = u * grid + v
    that any sample s < ``nsamp`` touches.  Cell ``cells[t]`` owns entries
    ``ptr[t]`` to ``ptr[t+1] - 1``: the samples s with Ax[s, u] Ay[s, v] in
    the operator, as (s, (Ax[s, u], Ay[s, v])), in the order of a stable
    sort on (cell, sample, corner).  ``bits`` marks the touched cells: bit
    c % 32 of word c // 32 is set when cell c is touched.  With grid == 1
    the two corners of an axis are one column, and its entry holds the
    summed weight, as the dense matrix does.  Returns (cells (T,) int32,
    ptr (T + 1,) int32, samp (nnz,) int32, wts (nnz, 2) float32, bits
    (ceil(grid² / 32),) int32).
    """
    S = nsamp
    if grid * grid > np.iinfo(np.int32).max or 4 * S > \
            np.iinfo(np.int32).max:
        raise ValueError(f"grid {grid} / {S} samples overflow the int32 "
                         f"cell index")
    ix, iy = idx[:S, 0:2], idx[:S, 2:4]
    wx, wy = w[:S, 0:2], w[:S, 2:4]
    if grid == 1:
        ix, iy = ix[:, :1], iy[:, :1]
        wx, wy = wx[:, :1] + wx[:, 1:], wy[:, :1] + wy[:, 1:]
    nx, ny = ix.shape[1], iy.shape[1]
    # sample-major, corner (a, b) -> a * ny + b: already (sample, corner)
    # order, so a stable sort on the cell gives (cell, sample, corner)
    cell = (ix[:, :, None].astype(np.int64) * grid
            + iy[:, None, :]).reshape(-1)
    samp = np.repeat(np.arange(S, dtype=np.int32), nx * ny)
    wts = np.stack([np.broadcast_to(wx[:, :, None], (S, nx, ny)).reshape(-1),
                    np.broadcast_to(wy[:, None, :], (S, nx, ny)).reshape(-1)],
                   axis=1)
    order = np.argsort(cell, kind="stable")
    cells, counts = np.unique(cell, return_counts=True)
    ptr = np.zeros(cells.size + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    mask = np.zeros(-(-grid * grid // 32) * 32, bool)
    mask[cells] = True
    bits = np.packbits(mask, bitorder="little").view("<i4").astype(np.int32)
    return (cells.astype(np.int32), ptr.astype(np.int32), samp[order],
            np.ascontiguousarray(wts[order]), bits)


@dataclasses.dataclass(frozen=True, eq=False)
class Interp:
    """Bilinear interpolation of one trajectory on a ``grid``², held on one
    device in the two forms the kernels read, and no dense matrix.

    ``idx``/``w`` are :func:`interp_taps`; ``cells``/``cell_ptr``/
    ``cell_samp``/``cell_w``/``cell_bits`` are
    :func:`cell_index`."""

    grid: int
    nsamp: int                  # true (pre-padding) sample count S
    idx: torch.Tensor           # (Sp, 4) int32
    w: torch.Tensor             # (Sp, 4) float32
    cells: torch.Tensor         # (T,) int32, the touched cells, ascending
    cell_ptr: torch.Tensor      # (T + 1,) int32
    cell_samp: torch.Tensor     # (nnz,) int32
    cell_w: torch.Tensor        # (nnz, 2) float32
    cell_bits: torch.Tensor     # (ceil(grid² / 32),) int32, touched cells

    @classmethod
    def build(cls, traj, grid: int, *, device):
        """Taps and cell index on the host, then moved to ``device``."""
        grid = int(grid)
        S = int(np.asarray(traj).shape[0])
        idx, w = interp_taps(traj, grid)
        cells, cptr, samp, wts, bits = cell_index(idx, w, S, grid)
        dev = torch.device(device)
        put = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
        return cls(grid=grid, nsamp=S, idx=put(idx), w=put(w),
                   cells=put(cells), cell_ptr=put(cptr), cell_samp=put(samp),
                   cell_w=put(wts), cell_bits=put(bits))

    @property
    def touched(self) -> int:
        """The grid cells that any sample touches (what ``degrid`` must
        gather and ``grid_adjoint`` sums into)."""
        return self.cells.shape[0]

    @property
    def nsamp_padded(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def tensors(self) -> tuple:
        return (self.idx, self.w, self.cells, self.cell_ptr, self.cell_samp,
                self.cell_w, self.cell_bits)

    def dense(self):
        """(Ax, Ay): the (Sp, grid) float32 matrices on this operator's
        device, equal bit for bit to ``interp_matrices``.  Built when a
        plain version asks and not kept."""
        S, G = self.nsamp, self.grid
        rows = torch.arange(S, device=self.device)
        out = []
        for a in (0, 2):
            A = torch.zeros((self.nsamp_padded, G), dtype=_F32,
                            device=self.device)
            A[rows, self.idx[:S, a].long()] = self.w[:S, a]
            A.index_put_((rows, self.idx[:S, a + 1].long()),
                         self.w[:S, a + 1], accumulate=True)
            out.append(A)
        return tuple(out)

    def as_sparse(self, adjoint: bool = False) -> torch.Tensor:
        """The operator as one complex64 torch sparse CSR matrix: (Sp,
        grid²) forward, (grid², Sp) adjoint (its row pointer rebuilt over
        every cell from the compact index).  Only the library yardstick
        (a cuSPARSE product) uses it; no path of the port does."""
        S, Sp, G = self.nsamp, self.nsamp_padded, self.grid
        if adjoint:
            vals = (self.cell_w[:, 0] * self.cell_w[:, 1]).to(_C64)
            counts = torch.zeros(G * G, dtype=torch.long, device=self.device)
            counts[self.cells.long()] = self.cell_ptr.diff().long()
            crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
            return torch.sparse_csr_tensor(
                crow, self.cell_samp.long(), vals, size=(G * G, Sp))
        k = 1 if G == 1 else 2
        ix, iy = self.idx[:S, 0:k].long(), self.idx[:S, 2:2 + k].long()
        wx, wy = self.w[:S, 0:2], self.w[:S, 2:4]
        if G == 1:
            wx, wy = wx.sum(1, keepdim=True), wy.sum(1, keepdim=True)
        cols = (ix[:, :, None] * G + iy[:, None, :]).reshape(-1)
        vals = (wx[:, :, None] * wy[:, None, :]).reshape(-1).to(_C64)
        crow = torch.cat([
            torch.arange(0, k * k * S + 1, k * k, device=self.device),
            torch.full((Sp - S,), k * k * S, device=self.device)])
        return torch.sparse_csr_tensor(crow, cols, vals, size=(Sp, G * G))


# -- plain versions: the separable dense form of the TPU kernels ------------

@contextlib.contextmanager
def _fixed_order(t: torch.Tensor):
    """On the CPU the BLAS splits a product's sum over the samples among
    its threads, so the bits of ``grid_adjoint_plain`` would follow the
    thread count, which a loaded machine's BLAS may change from call to
    call.  There the plain versions run on one thread: one order of
    summation, the same bits in every process and every call.  cuBLAS's
    order on the card does not depend on threads."""
    n = torch.get_num_threads()
    if t.device.type != "cpu" or n == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def degrid_plain(g, op: Interp):
    """out[j, s] = sum_v (Ax g_j)[s, v] * Ay[s, v], as ``_degrid_jnp``.
    The matrices are cast to complex64: ``torch.einsum`` does not mix
    float32 with complex64."""
    ax, ay = op.dense()
    with _fixed_order(g):
        return torch.einsum("su,juv,sv->js", ax.to(g.dtype), g,
                            ay.to(g.dtype))


def grid_adjoint_plain(y, op: Interp):
    """g_j = Ax^T (y_j[:, None] * Ay), as ``_grid_jnp``."""
    ax, ay = op.dense()
    with _fixed_order(y):
        return torch.einsum("su,js,sv->juv", ax.to(y.dtype), y,
                            ay.to(y.dtype))


# -- wrappers ----------------------------------------------------------------

def degrid(g, op: Interp, impl: str = "auto"):
    """g: (J, X, Y) complex64 grid -> (J, Sp) complex64 samples (padded
    rows read zero)."""
    if not kreg.use_kernel(impl, g, op.idx):
        return degrid_plain(g, op)
    if g.ndim != 3 or tuple(g.shape[1:]) != (op.grid, op.grid):
        raise ValueError(f"degrid: g must be (J, {op.grid}, {op.grid}), "
                         f"got {tuple(g.shape)}")
    J = g.shape[0]
    out = torch.empty((J, op.nsamp_padded), dtype=_C64, device=g.device)
    pg, pi, pw, s = pointers((g, _C64, "g"), (op.idx, _I32, "idx"),
                             (op.w, _F32, "w"))
    DEGRID.launch(pg, pi, pw, out.data_ptr(), J, op.grid, op.nsamp,
                  op.nsamp_padded, s, work=(g, op, None))
    return out


def grid_adjoint(y, op: Interp, impl: str = "auto"):
    """Adjoint: y (J, Sp) complex64 samples -> (J, X, Y) complex64 grid.
    One launch writes zeros to the untouched cells and sums each touched
    cell in an order fixed by its entry count; it never reads the padded
    rows."""
    if not kreg.use_kernel(impl, y, op.cell_ptr):
        return grid_adjoint_plain(y, op)
    if y.ndim != 2 or y.shape[1] != op.nsamp_padded:
        raise ValueError(f"grid_adjoint: y must be (J, {op.nsamp_padded}), "
                         f"got {tuple(y.shape)}")
    J, G = y.shape[0], op.grid
    out = torch.empty((J, G, G), dtype=_C64, device=y.device)
    *ptrs, s = pointers((y, _C64, "y"), (op.cells, _I32, "cells"),
                        (op.cell_ptr, _I32, "cell_ptr"),
                        (op.cell_samp, _I32, "cell_samp"),
                        (op.cell_w, _F32, "cell_w"),
                        (op.cell_bits, _I32, "cell_bits"))
    GRID_ADJOINT.launch(*ptrs, out.data_ptr(), J, G, op.nsamp_padded,
                        op.touched, s, work=(y, op, None))
    return out


def _frame0_op(grid, nspokes, nsamp, device) -> Interp:
    return Interp.build(radial_trajectory(grid, nspokes, nsamp=nsamp), grid,
                        device=device)


def _degrid_parts(g, op, m) -> dict:
    """One sample of one coil through ``degrid``: a launch of one block,
    the floor that any launch of the kernel pays."""
    traj = radial_trajectory(op.grid, 1, nsamp=1)
    one = Interp.build(traj, op.grid, device=g.device)
    return {"one sample, one coil": lambda: degrid(g[:1], one)}


def _grid_adjoint_parts(y, op, m) -> dict:
    """``grid_adjoint``'s two parts, each alone through the same launch:
    the fill of the whole grid (a plan with no touched cell) and the
    gather (a bitmap with every cell marked, so the fill blocks skip every
    cell; the untouched cells then hold what the block held); the fill's
    yardstick, ``torch.zeros`` of the grid (a ``cudaMemsetAsync``); and
    the form of two launches, that yardstick and then the gather."""
    J, G = y.shape[0], op.grid
    no_cell = dataclasses.replace(op, cells=op.cells[:0],
                                  cell_ptr=op.cell_ptr[:1],
                                  cell_bits=torch.zeros_like(op.cell_bits))
    every_cell = dataclasses.replace(
        op, cell_bits=torch.full_like(op.cell_bits, -1))

    def zeros():
        return torch.zeros((J, G, G), dtype=_C64, device=y.device)

    return {"fill alone": lambda: grid_adjoint(y, no_cell),
            "gather alone": lambda: grid_adjoint(y, every_cell),
            "torch.zeros of the grid": zeros,
            "torch.zeros, then the gather alone": lambda: (
                zeros(), grid_adjoint(y, every_cell))}


# -- specs: main-path inputs, bytes and flops, yardsticks -------------------
# Samples are (x, op, m): m is the operator as a sparse CSR matrix, read
# only by the library yardstick.  The bytes are what any kernel of the
# same work must move for this trajectory, whatever index it keeps:
# degrid reads each touched cell once per coil, the taps and writes the
# samples; grid_adjoint reads the S true samples and the taps and writes
# the whole grid.

DEGRID = kreg.register(KernelSpec(
    name="degrid", replaces=f"{_TPU}:40", tpu_function="degrid_pallas",
    source=_SOURCE, entry="degrid",
    argtypes=(_P, _P, _P, _P, _N, _N, _N, _N, _P),
    kernel=lambda g, op, m: degrid(g, op),
    plain=lambda g, op, m: degrid_plain(g, op), tol=1e-3,
    sample=radial_sampler("grid", _frame0_op),
    nbytes=lambda g, op, m: (op.touched * g.shape[0] * 8
                             + nbytes(op.idx, op.w)
                             + g.shape[0] * op.nsamp_padded * 8),
    flops=lambda g, op, m: 18 * g.shape[0] * op.nsamp,
    library=lambda g, op, m: torch.sparse.mm(
        m, g.reshape(g.shape[0], -1).T).T,
    parts=_degrid_parts,
))

GRID_ADJOINT = kreg.register(KernelSpec(
    name="grid_adjoint", replaces=f"{_TPU}:90", tpu_function="grid_pallas",
    source=_SOURCE, entry="grid_adjoint",
    argtypes=(_P, _P, _P, _P, _P, _P, _P, _N, _N, _N, _N, _P),
    kernel=lambda y, op, m: grid_adjoint(y, op),
    plain=lambda y, op, m: grid_adjoint_plain(y, op), tol=1e-3,
    sample=radial_sampler("samples", _frame0_op),
    nbytes=lambda y, op, m: (y.shape[0] * op.nsamp * 8
                             + nbytes(op.idx, op.w)
                             + y.shape[0] * op.grid * op.grid * 8),
    flops=lambda y, op, m: 6 * y.shape[0] * op.cell_samp.shape[0],
    library=lambda y, op, m: torch.sparse.mm(m, y.T).T.reshape(
        y.shape[0], op.grid, op.grid),
    parts=_grid_adjoint_parts,
))
