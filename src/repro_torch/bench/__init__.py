"""repro_torch.bench — the benchmark subsystem of the port, the
counterpart of ``repro.bench``.

Every paper figure and table is a registered scenario that the port runs
on the card (or, when asked, on the CPU):

  ``harness``    warmup-disciplined timing fenced with
                 ``torch.cuda.synchronize``, with the first call (kernel
                 block sweeps, plan builds) measured apart from the steady
                 state, and the plan-cache counter deltas to prove it
  ``registry``   every paper figure/table as a registered scenario,
                 parameterized over problem size {tiny, paper} and rank
                 count {1, 2, 4}
  ``models``     the calibrated alpha-beta/roofline models behind every
                 derived column
  ``artifact``   the schema-versioned artifact writer/validator
  ``compare``    artifact diff + regression gate (non-zero exit)
  ``run``        the sweep runner (one set of rank processes per rank
                 count)

CLI:  ``python -m repro_torch.bench.run`` /
``python -m repro_torch.bench.compare``.
"""

from importlib import import_module

from . import registry
from .registry import Scenario, scenario, scenarios

__all__ = [
    "artifact", "compare", "harness", "models", "registry",
    "SCHEMA_VERSION", "ArtifactError", "load_artifact", "make_artifact",
    "run_key", "validate_artifact", "write_artifact",
    "Comparison", "compare_artifacts",
    "BenchContext", "Timing", "measure",
    "Scenario", "scenario", "scenarios",
]

# Everything except the registry resolves lazily (PEP 562):
#   * harness/models pull torch (and the NLINV latency machinery) — the
#     artifact/compare tooling must stay importable on any host;
#   * artifact/compare must not be imported at package level so
#     `python -m repro_torch.bench.compare` runs without the runpy
#     found-in-sys.modules RuntimeWarning.
_LAZY_MODULES = ("artifact", "compare", "harness", "models")
_LAZY_NAMES = {
    "SCHEMA_VERSION": "artifact", "ArtifactError": "artifact",
    "load_artifact": "artifact", "make_artifact": "artifact",
    "run_key": "artifact", "validate_artifact": "artifact",
    "write_artifact": "artifact",
    "Comparison": "compare", "compare_artifacts": "compare",
    "BenchContext": "harness", "Timing": "harness", "measure": "harness",
}


def __getattr__(name):
    if name in _LAZY_MODULES:
        mod = import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        obj = getattr(import_module(f".{_LAZY_NAMES[name]}", __name__), name)
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
