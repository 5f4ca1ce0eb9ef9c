"""Scenario registry — every paper figure/table as a named, parameterized
benchmark scenario.

A *scenario* is one measured quantity from the paper (or from a layer
this repo added on top of it): a callable taking a
:class:`repro_torch.bench.harness.BenchContext` and returning a result dict
with at least ``wall_ms`` / ``compile_ms`` / ``steady_ms`` (usually just
``ctx.measure(...).as_dict()`` plus an ``extra`` dict of model-derived
columns).  Scenarios declare which problem sizes (``tiny`` for CI,
``paper`` for the paper's own settings) and rank counts they support;
the runner (``repro_torch.bench.run``) sweeps the cross product and
writes the schema-versioned artifact.  Keys, sizes and rank counts are
the JAX package's (``repro.bench.registry``).

Registration happens at import of :mod:`repro_torch.bench.suites` (named
so the package attribute cannot shadow this module's ``scenarios()``
accessor); the registry itself stays import-light so artifact/compare
tooling can load without pulling torch-heavy scenario modules.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module
from typing import Callable, Dict

# the sweep axes: problem size {tiny-CI, paper} x rank count {1, 2, 4}
SIZES = ("tiny", "paper")
DEVICE_COUNTS = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered benchmark scenario."""

    figure: str                      # paper anchor: fig4/fig5/.../stream
    name: str                        # scenario within the figure
    fn: Callable                     # BenchContext -> result dict
    sizes: tuple = SIZES             # problem sizes it supports
    devices: tuple = DEVICE_COUNTS   # rank counts it supports
    doc: str = ""

    @property
    def key(self) -> str:
        return f"{self.figure}.{self.name}"


_REGISTRY: Dict[str, Scenario] = {}


def scenario(figure: str, name: str, *, sizes=SIZES,
             devices=DEVICE_COUNTS) -> Callable:
    """Decorator: register ``fn`` as scenario ``figure.name``."""
    def deco(fn):
        doc = next(iter((fn.__doc__ or "").strip().splitlines()), "")
        sc = Scenario(figure, name, fn, tuple(sizes), tuple(devices),
                      doc=doc)
        if sc.key in _REGISTRY:
            raise ValueError(f"duplicate scenario key: {sc.key}")
        _REGISTRY[sc.key] = sc
        return fn
    return deco


def load() -> None:
    """Import the scenario modules (registration side effect)."""
    import_module("repro_torch.bench.suites")


def scenarios(figures=None) -> Dict[str, Scenario]:
    """The full registry, deterministically ordered (sorted by key).

    ``figures`` optionally restricts to a collection of figure names.
    """
    load()
    out = {k: _REGISTRY[k] for k in sorted(_REGISTRY)}
    if figures is not None:
        figures = set(figures)
        out = {k: s for k, s in out.items() if s.figure in figures}
    return out


def figure_names() -> tuple:
    """All registered figure names, sorted."""
    return tuple(sorted({s.figure for s in scenarios().values()}))
