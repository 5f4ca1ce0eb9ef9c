"""repro_torch — the PyTorch/CUDA port of ``repro``.

Same module names as the JAX package, PyTorch idiom inside: plain
functions on tensors with an explicit ``device``, the ``{rho, chat}``
Newton state as a plain dict of tensors, and every Pallas kernel of the
ported path replaced by a CUDA kernel written by hand for Hopper
(``kernels/csrc/*.cu``, built with ``nvcc`` at first use).  Entry points
run on the card unless the caller passes ``device="cpu"``; on the CPU the
kernel wrappers take their plain PyTorch versions.

This package imports neither ``jax`` nor ``repro``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
