"""The port's public surface against the JAX package's: the counterparts
of ``tests/test_kernel_registry.py::test_registry_covers_every_family``
and of ``tests/test_api_surface.py``'s ``__all__`` snapshots (the
``Communicator``/``Environment`` verbs are held in
``test_torch_port_rules.py``).

* every subpackage of ``repro_torch/kernels/`` registers a spec, every
  spec replaces a TPU kernel of its own family, and the family set is the
  JAX package's;
* ``core``, ``lib``, ``serve``, ``task``, ``train`` and ``ckpt`` export
  the JAX package's names in its order, less what is left for later (the
  deprecated free functions of ``repro.core`` and ``compat``), and the
  names the port adds, each listed with its reason.
"""

import importlib
import os
import pkgutil
from pathlib import Path

import pytest

import repro_torch.kernels
from repro.kernels import registry as jregistry
from repro_torch.kernels import registry

# the deprecated free functions of ``repro/core/__init__.py:35-77`` the
# port does not export yet, and the JAX-version shim (ROADMAP Queue 1)
LATER = {"core": {"compat", "current_group", "segment", "gather",
                  "broadcast", "scatter", "reduce", "all_reduce",
                  "all_reduce_window", "vdot", "copy", "all_to_all",
                  "reduce_scatter", "make_spmd", "barrier",
                  "barrier_fence"}}

# what the port exports beyond the JAX package: the ring all-reduce and
# the rank launcher (one process a rank), the task layer's fault hook and
# executor module, the sharded step's gradient function
EXTRA = {"core": {"ring_allreduce", "run_ranks"},
         "task": {"TASK_HOOK", "executor"},
         "train": {"make_grad_fn"}}

EXPECTED = {
    "core": ["Environment", "Communicator", "DeviceGroup", "HW", "DCN_AXES",
             "Policy", "SegmentedArray", "overlap2d_map",
             "hierarchical_psum", "ring_allreduce", "invoke_kernel",
             "invoke_kernel_all", "PassThrough", "dev_rank", "fence",
             "ordered", "run_ranks"],
    "lib": ["blas", "fft", "gridding", "plan", "Plan", "PlanCache",
            "default_cache", "plan_stats"],
    "serve": ["Engine", "Request", "make_serve_steps", "AdmissionError",
              "Rejected", "ServeConfig", "Session", "StreamScheduler",
              "Workload", "LMDecodeWorkload", "NlinvStreamWorkload",
              "SlotPool", "stack_carries", "unstack_carry"],
    "task": ["Task", "TaskGraph", "TaskError", "CycleError",
             "CrossGroupError", "placement_token", "Executor", "Pipeline",
             "TaskRun", "TASK_HOOK", "executor"],
    "train": ["grad_compress", "optimizer", "trainer", "adamw_init",
              "adamw_update", "warmup_cosine", "lm_loss", "make_grad_fn",
              "make_train_state", "make_train_step", "state_shardings"],
    "ckpt": ["save", "restore", "restore_sharded", "list_steps",
             "latest_step"],
}


def _family(spec) -> str:
    """The kernels subpackage whose ``ops`` registered the spec."""
    return spec.kernel.__module__.split(".")[2]


def test_registry_covers_every_family():
    pkg_dir = os.path.dirname(repro_torch.kernels.__file__)
    subpkgs = {m.name for m in pkgutil.iter_modules([pkg_dir]) if m.ispkg}
    specs = registry.specs()
    assert {_family(s) for s in specs} == subpkgs
    for s in specs:
        assert Path(s.replaces.rsplit(":", 1)[0]).parent.name == \
            _family(s), s.name
    assert subpkgs == {s.family for s in jregistry.specs()}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_all_snapshot(name):
    mod = importlib.import_module(f"repro_torch.{name}")
    assert list(mod.__all__) == EXPECTED[name]
    for attr in EXPECTED[name]:
        assert hasattr(mod, attr), f"{name}.__all__ names missing {attr}"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_all_is_the_reference_less_what_waits(name):
    want = importlib.import_module(f"repro.{name}").__all__
    got = importlib.import_module(f"repro_torch.{name}").__all__
    later, extra = LATER.get(name, set()), EXTRA.get(name, set())
    assert [n for n in got if n not in extra] == \
        [n for n in want if n not in later]
    assert not extra & set(want)
