"""repro_torch — the PyTorch/CUDA port of ``repro``.

Same module names as the JAX package, PyTorch idiom inside: plain
functions on tensors with an explicit ``device``, the ``{rho, chat}``
Newton state as a plain dict of tensors, and every Pallas kernel of the
ported path replaced by a CUDA kernel written by hand for Hopper
(``kernels/csrc/*.cu``, built with ``nvcc`` at first use).  Entry points
run on the card unless the caller passes ``device="cpu"``; on the CPU the
kernel wrappers take their plain PyTorch versions.

This package imports neither ``jax`` nor ``repro``, and importing it
imports no torch (``resolve_device`` resolves on first use), so that the
benchmark artifact and compare tooling load on any host.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
