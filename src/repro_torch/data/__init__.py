"""Data: the port of ``repro.data``, the deterministic synthetic token
pipeline."""

from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
