"""Radial gridding/degridding: the CUDA kernels of ``csrc/gridding.cu`` on
the card, their plain PyTorch versions on the CPU.

The counterpart of ``repro/kernels/gridding/ops.py``.  The JAX package
hands its kernels the dense separable interpolation matrices
(``interp_matrices``: ``Ax``/``Ay``, (Sp, grid) float32, two nonzeros per
row).  The port keeps the same operator in the compact form its kernels
read, an :class:`Interp`: per-sample taps for ``degrid`` and a
cell-major index for ``grid_adjoint``.  The plain versions build the
dense pair from the taps when they run (``Interp.dense``, bit for bit
``interp_matrices``) and compute the separable form the TPU kernels
compute.  ``impl`` is ``"auto"`` (kernel for CUDA tensors, plain for CPU
tensors) or ``"plain"``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, ptr, radial_sampler, stream

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
    """Cell-major (CSR) form of the adjoint of the taps' operator.

    For grid cell c = u * grid + v, entries ``ptr[c]`` to ``ptr[c+1] - 1``
    are the samples s < ``nsamp`` with Ax[s, u] Ay[s, v] in the operator,
    as (s, (Ax[s, u], Ay[s, v])), in the order of a stable sort on (cell,
    sample, corner).  With grid == 1 the two corners of an axis are one
    column, and its entry holds the summed weight, as the dense matrix
    does.  Returns (ptr (grid*grid + 1,) int32, samp (nnz,) int32,
    wts (nnz, 2) float32) and the number of cells with any entry.
    """
    S = nsamp
    if grid * grid + 1 > np.iinfo(np.int32).max or 4 * S > \
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
    counts = np.bincount(cell, minlength=grid * grid)
    ptr_ = np.zeros(grid * grid + 1, np.int64)
    np.cumsum(counts, out=ptr_[1:])
    return (ptr_.astype(np.int32), samp[order],
            np.ascontiguousarray(wts[order]), int((counts > 0).sum()))


@dataclasses.dataclass(frozen=True, eq=False)
class Interp:
    """Bilinear interpolation of one trajectory on a ``grid``², held on one
    device in the two forms the kernels read, and no dense matrix.

    ``idx``/``w`` are :func:`interp_taps`; ``cell_ptr``/``cell_samp``/
    ``cell_w`` are :func:`cell_index`; ``touched`` counts the grid cells
    that any sample touches (what ``degrid`` must gather)."""

    grid: int
    nsamp: int                  # true (pre-padding) sample count S
    idx: torch.Tensor           # (Sp, 4) int32
    w: torch.Tensor             # (Sp, 4) float32
    cell_ptr: torch.Tensor      # (grid*grid + 1,) int32
    cell_samp: torch.Tensor     # (nnz,) int32
    cell_w: torch.Tensor        # (nnz, 2) float32
    touched: int

    @classmethod
    def build(cls, traj, grid: int, *, device):
        """Taps and cell index on the host, then moved to ``device``."""
        grid = int(grid)
        S = int(np.asarray(traj).shape[0])
        idx, w = interp_taps(traj, grid)
        cptr, samp, wts, touched = cell_index(idx, w, S, grid)
        dev = torch.device(device)
        put = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
        return cls(grid=grid, nsamp=S, idx=put(idx), w=put(w),
                   cell_ptr=put(cptr), cell_samp=put(samp), cell_w=put(wts),
                   touched=touched)

    @property
    def nsamp_padded(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def tensors(self) -> tuple:
        return (self.idx, self.w, self.cell_ptr, self.cell_samp, self.cell_w)

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
        grid²) forward, (grid², Sp) adjoint.  Only the library yardstick
        (a cuSPARSE product) uses it; no path of the port does."""
        S, Sp, G = self.nsamp, self.nsamp_padded, self.grid
        if adjoint:
            vals = (self.cell_w[:, 0] * self.cell_w[:, 1]).to(_C64)
            return torch.sparse_csr_tensor(
                self.cell_ptr.long(), self.cell_samp.long(), vals,
                size=(G * G, Sp))
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

def degrid_plain(g, op: Interp):
    """out[j, s] = sum_v (Ax g_j)[s, v] * Ay[s, v], as ``_degrid_jnp``.
    The matrices are cast to complex64: ``torch.einsum`` does not mix
    float32 with complex64."""
    ax, ay = op.dense()
    return torch.einsum("su,juv,sv->js", ax.to(g.dtype), g, ay.to(g.dtype))


def grid_adjoint_plain(y, op: Interp):
    """g_j = Ax^T (y_j[:, None] * Ay), as ``_grid_jnp``."""
    ax, ay = op.dense()
    return torch.einsum("su,js,sv->juv", ax.to(y.dtype), y, ay.to(y.dtype))


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
    DEGRID.launch(ptr(g, _C64, "g"), ptr(op.idx, _I32, "idx"),
                  ptr(op.w, _F32, "w"), ptr(out, _C64, "out"), J, op.grid,
                  op.nsamp, op.nsamp_padded, stream(g))
    return out


def grid_adjoint(y, op: Interp, impl: str = "auto"):
    """Adjoint: y (J, Sp) complex64 samples -> (J, X, Y) complex64 grid.
    The kernel sums in the cell index's fixed order and never reads the
    padded rows."""
    if not kreg.use_kernel(impl, y, op.cell_ptr):
        return grid_adjoint_plain(y, op)
    if y.ndim != 2 or y.shape[1] != op.nsamp_padded:
        raise ValueError(f"grid_adjoint: y must be (J, {op.nsamp_padded}), "
                         f"got {tuple(y.shape)}")
    J, G = y.shape[0], op.grid
    out = torch.empty((J, G, G), dtype=_C64, device=y.device)
    GRID_ADJOINT.launch(ptr(y, _C64, "y"), ptr(op.cell_ptr, _I32, "cell_ptr"),
                        ptr(op.cell_samp, _I32, "cell_samp"),
                        ptr(op.cell_w, _F32, "cell_w"), ptr(out, _C64, "out"),
                        J, G, op.nsamp_padded, stream(y))
    return out


def _frame0_op(grid, nspokes, nsamp, device) -> Interp:
    return Interp.build(radial_trajectory(grid, nspokes, nsamp=nsamp), grid,
                        device=device)


# -- specs: main-path inputs, bytes and flops, yardsticks -------------------
# Samples are (x, op, m): m is the operator as a sparse CSR matrix, read
# only by the library yardstick.  The bytes are what the gather form must
# move for this trajectory: degrid reads each touched cell once per coil,
# the taps and writes the samples; grid_adjoint reads the S true samples
# and the cell index and writes the whole grid.

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
))

GRID_ADJOINT = kreg.register(KernelSpec(
    name="grid_adjoint", replaces=f"{_TPU}:90", tpu_function="grid_pallas",
    source=_SOURCE, entry="grid_adjoint",
    argtypes=(_P, _P, _P, _P, _P, _N, _N, _N, _P),
    kernel=lambda y, op, m: grid_adjoint(y, op),
    plain=lambda y, op, m: grid_adjoint_plain(y, op), tol=1e-3,
    sample=radial_sampler("samples", _frame0_op),
    nbytes=lambda y, op, m: (y.shape[0] * op.nsamp * 8
                             + nbytes(op.cell_ptr, op.cell_samp, op.cell_w)
                             + y.shape[0] * op.grid * op.grid * 8),
    flops=lambda y, op, m: 6 * y.shape[0] * op.cell_samp.shape[0],
    library=lambda y, op, m: torch.sparse.mm(m, y.T).T.reshape(
        y.shape[0], op.grid, op.grid),
))
