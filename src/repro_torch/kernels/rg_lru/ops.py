"""The RG-LRU scan: the CUDA kernel of ``csrc/rg_lru.cu`` on the card, its
plain PyTorch version on the CPU.

The counterpart of ``repro/kernels/rg_lru/ops.py``.  ``rg_lru_scan`` runs
the prefill's recurrence h_t = exp(log_a_t) h_{t-1} + b_t; ``impl`` is
``"auto"`` (the kernel for CUDA tensors, the plain version for CPU
tensors) or ``"plain"``; on the card a chunked two-level scan, one thread
per (lane, chunk of ``CHUNK`` steps), with the chunks' summaries in a
float32 scratch.  The plain version is the JAX package's
associative form (``_assoc``): a log-depth doubling scan, so it runs as a
dozen batched tensor operations rather than one per step.  ``rg_lru_step``
is the decode step, plain PyTorch as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from .. import registry as kreg
from ..registry import KernelSpec, nbytes, pointers, scan_sampler

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SOURCE = "src/repro_torch/kernels/csrc/rg_lru.cu"
_TPU = "src/repro/kernels/rg_lru/kernel.py"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# steps a thread of the kernel walks: time is cut into chunks of this many
# steps, one thread per (lane, chunk), so that lanes x chunks fill the card
CHUNK = 128

# The JAX spec's samples (``rg_lru/ops.py:36-43`` of the JAX package):
# (B, S, W, dtype, tolerance), with log_a = -0.1 |N|, b and h0 N(0, 1).
FEATURE_CASES = (
    (1, 64, 128, torch.float32, 1e-4),
    (2, 512, 256, torch.float32, 1e-4),
    (2, 256, 128, torch.bfloat16, 5e-2),
)


def rg_lru_scan_plain(log_a, b, h0):
    """The associative form: fold h0 into step 0, then combine (log a, b)
    pairs at offsets 1, 2, 4, ...; (la1, b1) then (la2, b2) is (la1 + la2,
    b1 exp(la2) + b2).  Float32 inside; returns (hs, h_last) in b's
    dtype."""
    S = b.shape[1]
    if S == 0:
        return b.clone(), h0.to(b.dtype)
    la = log_a.float()
    h = b.float().clone()
    h[:, 0] += torch.exp(la[:, 0]) * h0.float()
    off = 1
    while off < S:
        h = torch.cat([h[:, :off],
                       h[:, off:] + torch.exp(la[:, off:]) * h[:, :-off]], 1)
        la = torch.cat([la[:, :off], la[:, off:] + la[:, :-off]], 1)
        off *= 2
    return h.to(b.dtype), h[:, -1].to(b.dtype)


def rg_lru_scan(log_a, b, h0, impl="auto"):
    """h_t = exp(log_a_t) h_{t-1} + b_t.  log_a, b: (B, S, W); h0: (B, W).
    Returns (hs (B, S, W), h_last (B, W)) in b's dtype.  The kernel takes
    contiguous float32 or bfloat16 operands of one dtype.

    On the card, with grad mode on and an operand that requires grad, the
    outputs carry a gradient: the kernel's forward, and the backward of
    ``rg_lru_scan_plain`` recomputed (``registry.differentiable``)."""
    if not kreg.use_kernel(impl, log_a, b, h0):
        return rg_lru_scan_plain(log_a, b, h0)
    return kreg.differentiable(_launch, rg_lru_scan_plain, log_a, b, h0)


def _launch(log_a, b, h0):
    """One launch of the chunked scan, after the operand checks."""
    if b.ndim != 3 or log_a.shape != b.shape or \
            tuple(h0.shape) != (b.shape[0], b.shape[2]):
        raise ValueError(f"rg_lru_scan: log_a, b (B, S, W) and h0 (B, W), "
                         f"got {tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if b.dtype not in _DTYPES:
        raise TypeError(f"rg_lru_scan: kernel takes float32 or bfloat16, "
                        f"got {b.dtype}")
    B, S, W = b.shape
    hs = torch.empty_like(b)
    h_last = torch.empty((B, W), dtype=b.dtype, device=b.device)
    scratch = torch.empty(scratch_shape(B, S, W), dtype=torch.float32,
                          device=b.device)
    dt = b.dtype
    *ptrs, s = pointers((log_a, dt, "log_a"), (b, dt, "b"), (h0, dt, "h0"))
    RG_LRU.launch(*ptrs, hs.data_ptr(), h_last.data_ptr(),
                  scratch.data_ptr(), B, S, W, CHUNK, _DTYPES[dt], s,
                  work=(log_a, b, h0))
    return hs, h_last


def scratch_shape(B, S, W, chunk=CHUNK) -> tuple:
    """The kernel's float32 scratch: each chunk but the last's decay and
    end state, (2, nc - 1, B, W) for nc = ceil(S / chunk) chunks."""
    nc = max(1, -(-S // chunk))
    return (2, nc - 1, B, W)


def rg_lru_step(log_a, b, h):
    """One decode step over (B, W) operands, in b's dtype."""
    return (torch.exp(log_a.float()) * h.float() + b.float()).to(b.dtype)


# -- spec: the prefill's shape on the LM path (recurrentgemma-2b's rglru
# layers at the longest prompt); no PyTorch call computes this scan --------

RG_LRU = kreg.register(KernelSpec(
    name="rg_lru", replaces=f"{_TPU}:50", tpu_function="rg_lru_pallas",
    source=_SOURCE, entry="rg_lru",
    argtypes=(_P,) * 6 + (_N,) * 4 + (ctypes.c_int, _P),
    kernel=lambda log_a, b, h0: rg_lru_scan(log_a, b, h0),
    plain=rg_lru_scan_plain, tol=1e-4, sample=scan_sampler(),
    nbytes=lambda log_a, b, h0: nbytes(log_a, b, h0, b, h0),
    flops=lambda log_a, b, h0: 3 * b.numel(),
))
