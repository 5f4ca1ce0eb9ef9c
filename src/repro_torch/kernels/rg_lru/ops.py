"""The RG-LRU scan: the CUDA kernel of ``csrc/rg_lru.cu`` on the card, its
plain PyTorch version on the CPU.

The counterpart of ``repro/kernels/rg_lru/ops.py``.  ``rg_lru_scan`` runs
the prefill's recurrence h_t = exp(log_a_t) h_{t-1} + b_t; ``impl`` is
``"auto"`` (the kernel for CUDA tensors, the plain version for CPU
tensors) or ``"plain"``; on the card one launch that reads its inputs
once: a block a (chunk of ``CHUNK`` steps, 256 bytes of lanes) tile held
in shared memory and walked in ``parts`` by its threads; the chunks'
aggregates published as tagged words in a state kept for each stream and
folded in chunk order (``csrc/rg_lru.cu``'s header).  The tile comes by
TMA or, for rows a tensor map cannot describe, by the block's threads
(``loader``).  The plain version is the JAX package's
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
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# the steps of a tile: time is cut into chunks of this many steps (the
# kernel is compiled for 128: eight 16-step TMA stages)
CHUNK = 128
# bytes of a step's row a tile holds: 64 float32 or 128 bf16 lanes
ROW_BYTES = 256
# a block's threads (a tile a block, three blocks an SM): each lane walked
# in THREADS // lanes parts of the chunk, one thread each (4 in float32,
# 2 in bf16)
THREADS = 256
# the kernel's loaders, as its C entry takes them: TMA tensor maps, or the
# block's threads for rows a map cannot describe
LOADERS = {"tma": 1, "threads": 0}
# launches by loader since the last reset (``reset_loaders``)
loader_launches = {name: 0 for name in LOADERS}
# each (device, stream)'s kernel state (the ticket counter and the chunks'
# aggregate words) and the tag of its last call: calls on one stream run
# one after another and share it; a call's words hold its tag, so none
# needs a reset
_STATE: dict = {}
_LAST_TAG = 2 ** 32 - 1

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
    """One launch of the scan, after the operand checks."""
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
    dt = b.dtype
    *ptrs, s = pointers((log_a, dt, "log_a"), (b, dt, "b"), (h0, dt, "h0"))
    how = loader(S, W, dt, ptrs[0], ptrs[1], hs.data_ptr())
    state, tag = (0, 1) if s is None else _state(
        b.device, s, state_words(B, S, W, CHUNK))
    RG_LRU.launch(*ptrs, hs.data_ptr(), h_last.data_ptr(), state, tag, B, S,
                  W, CHUNK, _DTYPES[dt], LOADERS[how], s,
                  work=(log_a, b, h0))
    if s is not None:
        loader_launches[how] += 1
    return hs, h_last


def loader(S: int, W: int, dtype, *addresses: int) -> str:
    """The kernel's loader for a (B, S, W) scan of ``dtype`` whose log_a,
    b and hs lie at ``addresses``: ``"tma"`` (loads and stores) where a
    step's row is a multiple of 16 bytes and every base is 16-byte
    aligned, which a tensor map needs, and S >= 1; else ``"threads"``."""
    if S >= 1 and W * _ITEMSIZE[dtype] % 16 == 0 and \
            all(a % 16 == 0 for a in addresses):
        return "tma"
    return "threads"


def reset_loaders() -> None:
    for name in loader_launches:
        loader_launches[name] = 0


def lanes(dtype) -> int:
    """The lanes of a block's tile: 256 bytes of a step's row."""
    return ROW_BYTES // _ITEMSIZE[dtype]


def parts(dtype) -> int:
    """The parts a block cuts its chunk into, one thread a part and lane:
    each walks ``CHUNK // parts`` steps."""
    return THREADS // lanes(dtype)


def tile_bytes(chunk=CHUNK) -> int:
    """A tile's log_a and b, ``chunk`` steps of ``ROW_BYTES`` each (64 KB
    at 128)."""
    return 2 * chunk * ROW_BYTES


def state_words(B, S, W, chunk=CHUNK) -> int:
    """The kernel's int64 state: the ticket counter, then each chunk but
    the last's aggregate, a word for its decay and one for its end state
    per lane, 1 + 2 (nc - 1) B W words for nc = ceil(S / chunk)."""
    nc = max(1, -(-S // chunk))
    return 1 + 2 * (nc - 1) * B * W


def _state(device, stream: int, words: int) -> tuple[int, int]:
    """The address of this stream's kernel state, at least ``words`` int64
    words, and this call's tag.  Made with zeros at a stream's first call,
    and again, larger, when a call needs more words or the tags run out;
    the kernel leaves the counter at 0 and every word's tag below the next
    call's."""
    key = (device.index, stream)
    held = _STATE.get(key)
    if held is None or held[0].numel() < words or held[1] == _LAST_TAG:
        size = max(words, 2 * held[0].numel() if held else 0)
        held = _STATE[key] = [torch.zeros(size, dtype=torch.int64,
                                          device=device), 0]
    held[1] += 1
    return held[0].data_ptr(), held[1]


def rg_lru_step(log_a, b, h):
    """One decode step over (B, W) operands, in b's dtype."""
    return (torch.exp(log_a.float()) * h.float() + b.float()).to(b.dtype)


# -- spec: the prefill's shape on the LM path (recurrentgemma-2b's rglru
# layers at the longest prompt); no PyTorch call computes this scan --------

RG_LRU = kreg.register(KernelSpec(
    name="rg_lru", replaces=f"{_TPU}:50", tpu_function="rg_lru_pallas",
    source=_SOURCE, entry="rg_lru",
    argtypes=(_P,) * 6 + (_N,) * 5 + (ctypes.c_int,) * 2 + (_P,),
    kernel=lambda log_a, b, h0: rg_lru_scan(log_a, b, h0),
    plain=rg_lru_scan_plain, tol=1e-4, sample=scan_sampler(),
    nbytes=lambda log_a, b, h0: nbytes(log_a, b, h0, b, h0),
    flops=lambda log_a, b, h0: 3 * b.numel(),
    # the scan's chunk of steps (CHUNK): one candidate for now
    block_args=("chunk",), default_block=(CHUNK,),
))
