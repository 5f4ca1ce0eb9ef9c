"""The chunkwise mLSTM: the CUDA kernel of ``csrc/mlstm.cu`` on the card,
its plain PyTorch version on the CPU.

The counterpart of ``repro/kernels/mlstm/ops.py``:

- ``mlstm_chunkwise`` is the plain version: the linear-attention
  factorization over chunks of ``chunk`` steps, with the state (C, n, m)
  handed from chunk to chunk, as the JAX package's.  A ragged last chunk
  is padded with no-op steps (log_i = -1e30, log_f = 0).
- ``mlstm_scan`` is the prefill entry point.  ``impl`` is ``"auto"`` (the
  kernel for CUDA tensors, the plain version for CPU tensors) or
  ``"plain"``.  The kernel computes what the plain version computes: it
  takes an initial state and any S, where the JAX package's Pallas kernel
  takes a zero state and S divisible by the chunk only.  On the card it has
  two routes, one C entry each and one launch a call: bf16 q, k, v go to
  the tensor cores (``mlstm_bf16``; a head dim above 512, which no served
  model has, runs its CUDA-core passes in bf16), float32 ones to the CUDA
  cores (``mlstm_f32``), which hold the float32 path's tolerance.
- ``mlstm_step`` is the decode step, plain PyTorch as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import registry as kreg
from ..registry import (H100_BF16_FLOPS, XLSTM_HEAD_DIM, XLSTM_HEADS,
                        XLSTM_SEQ, KernelSpec, nbytes, pointers)
from .ref import init_state

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SOURCE = "src/repro_torch/kernels/csrc/mlstm.cu"
_TPU = "src/repro/kernels/mlstm/kernel.py"
# the C entry of each dtype of q, k, v: the tensor cores for bf16, the
# CUDA cores for float32
ROUTES = {torch.bfloat16: "mlstm_bf16", torch.float32: "mlstm_f32"}
MAX_CHUNK = 128          # the kernel's largest chunk
# the widest head the bf16 route's wgmma kernels take (the output pass
# keeps a chunk's q rows in shared memory); wider heads take the CUDA-core
# passes in bf16
MAX_WGMMA_DK = 512
NEG = -1e30

TOL = 2e-3               # the JAX spec's tolerance, at every case

# The JAX spec's samples (``mlstm/ops.py:105-109`` of the JAX package) at
# zero state, then a nonzero state, and a ragged S (96 + 37 steps at
# chunk 32) from a nonzero state: (B, H, S, dk, dv, chunk, nonzero state).
FEATURE_CASES = (
    (1, 2, 256, 64, 64, 128, False),
    (2, 1, 96, 32, 64, 128, False),
    (1, 2, 256, 64, 64, 128, True),
    (2, 1, 133, 32, 64, 32, True),
)


def gated_inputs(B, H, S, dk, dv, *, nonzero_state=False, dtype=torch.float32,
                 device=None, generator=None):
    """Inputs as the JAX spec draws them: q, k, v N(0, 1) in ``dtype``,
    log_i = N - 1 and log_f = -0.1 |N| in float32; the state zero, or
    C, n, m all N(0, 1)."""
    def rnd(*shape):
        return torch.randn(shape, device=device, generator=generator)
    q, k, v = (rnd(B, H, S, d).to(dtype) for d in (dk, dk, dv))
    li = rnd(B, H, S) - 1.0
    lf = -0.1 * rnd(B, H, S).abs()
    state = ((rnd(B, H, dk, dv), rnd(B, H, dk), rnd(B, H)) if nonzero_state
             else init_state(B, H, dk, dv, device=device))
    return q, k, v, li, lf, state


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk=128):
    """Chunkwise-parallel mLSTM.  q, k (B, H, S, dk); v (B, H, S, dv);
    log_i, log_f (B, H, S); state (C, n, m) or None for zeros.  Returns
    (h (B, H, S, dv) in v's dtype, (C, n, m) in float32)."""
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = init_state(B, H, dk, dv, device=q.device)
    C, n, m = (s.float() for s in state)
    L = min(chunk, S)
    pad = (-S) % L
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    li, lf = log_i.float(), log_f.float()
    if pad:       # padded steps: f = 1 (log 1 = 0), i = 0 -> no-ops
        qf, kf, vf = (torch.cat([x, x.new_zeros(B, H, pad, x.shape[-1])], 2)
                      for x in (qf, kf, vf))
        li = torch.cat([li, li.new_full((B, H, pad), NEG)], 2)
        lf = torch.cat([lf, lf.new_zeros(B, H, pad)], 2)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    hs = []
    for j0 in range(0, S + pad, L):
        qc, kc, vc = (x[:, :, j0:j0 + L] for x in (qf, kf, vf))
        lic, lfc = li[..., j0:j0 + L], lf[..., j0:j0 + L]
        c = torch.cumsum(lfc, -1)              # inclusive log f cumsum
        # intra-chunk log weights W[t, s] = c_t - c_s + li_s  (s <= t)
        w = torch.where(tri, c[..., :, None] - c[..., None, :]
                        + lic[..., None, :], NEG)
        m_inter = c + m[..., None]
        m_t = torch.maximum(w.amax(-1), m_inter)
        d = torch.exp(w - m_t[..., None])      # the decay matrix
        carry = torch.exp(m_inter - m_t)[..., None]
        scores = (qc @ kc.transpose(-1, -2)) * d
        h_num = scores @ vc + carry * (qc @ C)
        n_t = d @ kc + carry * n[..., None, :]
        den = torch.maximum((qc * n_t).sum(-1).abs(), torch.exp(-m_t))
        hs.append(h_num / den[..., None])
        # -- state hand-off
        c_last = c[..., -1]
        w_out = c_last[..., None] - c + lic
        m_new = torch.maximum(c_last + m, w_out.amax(-1))
        scale_old = torch.exp(c_last + m - m_new)
        wk = kc * torch.exp(w_out - m_new[..., None])[..., None]
        C = scale_old[..., None, None] * C + wk.transpose(-1, -2) @ vc
        n = scale_old[..., None] * n + wk.sum(2)
        m = m_new
    h = torch.cat(hs, 2)[:, :, :S]
    return h.to(v.dtype), (C, n, m)


def mlstm_scan(q, k, v, log_i, log_f, state=None, impl="auto", chunk=128):
    """The prefill's mLSTM over S steps from ``state`` (zeros when None).
    Returns (h (B, H, S, dv) in v's dtype, (C, n, m) in float32).  The
    kernel takes contiguous q, k, v of one dtype (float32 or bfloat16),
    float32 gates and state, S >= 1 and a chunk of at most 128 steps.

    On the card, with grad mode on and an operand that requires grad, the
    outputs carry a gradient: the kernel's forward, and the backward of
    ``mlstm_chunkwise`` recomputed (``registry.differentiable``)."""
    if not kreg.use_kernel(impl, q, k, v, log_i, log_f,
                           *(state if state is not None else ())):
        return mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk)
    if state is None:
        state = init_state(q.shape[0], q.shape[1], q.shape[-1],
                           v.shape[-1], device=q.device)

    def kernel(*args):
        return _flat(_launch(*args[:5], args[5:], chunk))

    def plain(*args):
        return _flat(mlstm_chunkwise(*args[:5], args[5:], chunk))

    h, C, n, m = kreg.differentiable(kernel, plain, q, k, v, log_i, log_f,
                                     *state)
    return h, (C, n, m)


def _launch(q, k, v, log_i, log_f, state, chunk):
    """One launch of the route of q's dtype, after the operand checks."""
    if q.ndim != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3] \
            or log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan: q, k (B, H, S, dk), v (B, H, S, dv) "
                         f"and gates (B, H, S), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}")
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if S < 1 or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_scan: the kernel takes S >= 1 and a chunk "
                         f"of 1 to {MAX_CHUNK}, got S {S}, chunk {chunk}")
    if q.dtype not in ROUTES:
        raise TypeError(f"mlstm_scan: kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    C0, n0, m0 = state
    if (tuple(C0.shape), tuple(n0.shape), tuple(m0.shape)) != \
            ((B, H, dk, dv), (B, H, dk), (B, H)):
        raise ValueError(f"mlstm_scan: state (C, n, m) of shapes "
                         f"{(B, H, dk, dv)}, {(B, H, dk)}, {(B, H)}")
    L = min(chunk, S)
    f32 = torch.float32
    dt = q.dtype
    h = torch.empty_like(v)
    C1 = torch.empty((B, H, dk, dv), dtype=f32, device=q.device)
    n1 = torch.empty((B, H, dk), dtype=f32, device=q.device)
    m1 = torch.empty((B, H), dtype=f32, device=q.device)
    cbuf, nbuf, sbuf = (torch.empty(shape, dtype=f32, device=q.device)
                        for shape in scratch_shapes(B, H, S, dk, dv, L, dt))
    qt, kt, vt, lit, lft = q, k, v, log_i, log_f
    if _wgmma_route(dt, dk):
        qt, kt, vt = (tma_rows(x) for x in (q, k, v))
        lit, lft = _aligned(log_i), _aligned(log_f)
    *ptrs, s = pointers(
        (qt, dt, "q"), (kt, dt, "k"), (vt, dt, "v"), (lit, f32, "log_i"),
        (lft, f32, "log_f"), (C0, f32, "C"), (n0, f32, "n"), (m0, f32, "m"))
    outs = (h, C1, n1, m1, cbuf, nbuf, sbuf)
    MLSTM.launch(*ptrs, *(t.data_ptr() for t in outs), B * H, S, dk, dv, L,
                 dk ** -0.5, s, entry=ROUTES[dt],
                 work=(q, k, v, log_i, log_f, state))
    return h, (C1, n1, m1)


def wgmma_smem_bytes(dk) -> tuple[int, int]:
    """Dynamic shared memory of the bf16 route's two wgmma kernels (the
    walk, the output pass) at head dim ``dk``, from the built library:
    (0, 0) above ``MAX_WGMMA_DK``.  Needs the card's compiler."""
    from .. import _build
    walk, out = ctypes.c_int(), ctypes.c_int()
    pint = ctypes.POINTER(ctypes.c_int)
    fn = _build.function("mlstm_bf16_smem", (_N, pint, pint))
    _build.check(fn(dk, ctypes.byref(walk), ctypes.byref(out)),
                 "mlstm_bf16_smem")
    return walk.value, out.value


def _wgmma_route(dtype, dk) -> bool:
    """Whether ``mlstm_bf16`` runs its wgmma kernels: bf16 heads of at
    most ``MAX_WGMMA_DK``."""
    return dtype == torch.bfloat16 and dk <= MAX_WGMMA_DK


def tma_rows(x):
    """x as the wgmma kernels' tensor maps read it: rows of a multiple of
    8 elements (16 bytes; zero columns appended, which the maps never read)
    on a 16-byte aligned base.  x itself where it already is so, as every
    served shape is, or where it is not contiguous (``pointers`` refuses
    it)."""
    if not x.is_contiguous():
        return x
    pad = -x.shape[-1] % 8
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    return _aligned(x)


def _aligned(x):
    """x on a 16-byte aligned base (a copy where it is not, and x is
    contiguous), as a tensor map needs."""
    return x.clone() if x.is_contiguous() and x.data_ptr() % 16 else x


def scratch_shapes(B, H, S, dk, dv, chunk=MAX_CHUNK, dtype=None) -> tuple:
    """The kernel's float32 scratch for nc = ceil(S / chunk) chunks: the
    state entering each chunk (on the bf16 route as two bf16 planes, hi
    and lo, in the same bytes; the wgmma kernels' planes have rows of dv
    rounded up to 8 elements, so ``dtype`` bf16 rounds the last dim), the
    entering n, and three scalars a chunk (the float32 route's log decay
    and local max, and the entering m)."""
    nc = -(-S // min(chunk, S))
    if _wgmma_route(dtype, dk):
        dv = -(-dv // 8) * 8
    return (B, H, nc, dk, dv), (B, H, nc, dk), (3, B, H, nc)


def scratch_bytes(B, H, S, dk, dv, chunk=MAX_CHUNK, dtype=None) -> int:
    """Bytes of device memory the kernel's scratch takes."""
    return sum(4 * math.prod(shape)
               for shape in scratch_shapes(B, H, S, dk, dv, chunk, dtype))


def mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step; q, k (B, H, dk), v (B, H, dv), gates (B, H)."""
    C, n, m = state
    dk = q.shape[-1]
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    m_new = torch.maximum(log_f + m, log_i)
    fs = torch.exp(log_f + m - m_new)
    is_ = torch.exp(log_i - m_new)
    C = fs[..., None, None] * C + is_[..., None, None] * \
        kf[..., :, None] * vf[..., None, :]
    n = fs[..., None] * n + is_[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(v.dtype)
    return h, (C, n, m_new)


def chunk_flops(S, dk, dv, chunk=128) -> int:
    """Flops of the chunkwise form per (batch, head): per chunk of Lc
    steps q k^T (2 Lc^2 dk), scores v (2 Lc^2 dv), q C and k^T v (2 Lc dk
    dv each).  No output needs n_t = D k itself: q . n_t is the row sum of
    the masked scores plus the carried q . n."""
    L = min(chunk, S)
    lens = [L] * (S // L) + ([S % L] if S % L else [])
    return sum(2 * n * n * (dk + dv) + 4 * n * dk * dv for n in lens)


def _flat(out):
    h, (C, n, m) = out
    return h, C, n, m


def _served_sample(device, gen):
    """The spec's inputs: xlstm-350m's prefill of the longest served prompt
    (q, k, v (1, 4, 3072, 512) in bf16) from the zero state that a fresh
    cache holds."""
    return gated_inputs(1, XLSTM_HEADS, XLSTM_SEQ, XLSTM_HEAD_DIM,
                        XLSTM_HEAD_DIM, dtype=torch.bfloat16, device=device,
                        generator=gen)


def _flops(q, k, v, li, lf, state):
    B, H, S, dk = q.shape
    return B * H * chunk_flops(S, dk, v.shape[-1])


# -- spec: the prefill's shape on the LM path (xlstm-350m's mLSTM layers at
# the longest prompt, zero state as a fresh cache holds); no PyTorch call
# computes this scan --------------------------------------------------------

MLSTM = kreg.register(KernelSpec(
    name="mlstm", replaces=f"{_TPU}:87", tpu_function="mlstm_pallas",
    source=_SOURCE, entry=ROUTES[torch.bfloat16],
    argtypes=(_P,) * 15 + (_N,) * 5 + (ctypes.c_float, _P),
    kernel=lambda *a: _flat(mlstm_scan(*a)),
    plain=lambda *a: _flat(mlstm_chunkwise(*a)),
    tol=TOL, sample=_served_sample,
    nbytes=lambda q, k, v, li, lf, state: nbytes(q, k, v, li, lf, *state, v,
                                                 *state),
    flops=_flops, peak_flops=H100_BF16_FLOPS,
    # the bf16 walk's rows of C a block (64, a wgmma's M), fixed by its
    # warpgroup and shared-memory plan: one candidate, compiled in
    block_args=("ct",), default_block=(64,),
))
