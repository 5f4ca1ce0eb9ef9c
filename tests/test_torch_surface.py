"""The port's public surface against the JAX package's: the counterparts
of ``tests/test_kernel_registry.py::test_registry_covers_every_family``
and of ``tests/test_api_surface.py``'s ``__all__`` snapshots (the
``Communicator``/``Environment`` verbs are held in
``test_torch_port_rules.py``).

* every subpackage of ``repro_torch/kernels/`` registers a spec, every
  spec replaces a TPU kernel of its own family, and the family set is the
  JAX package's;
* ``core``, ``lib``, ``serve``, ``task``, ``train``, ``ckpt`` and
  ``bench`` export
  the JAX package's names in its order, less what is left out (``compat``,
  the JAX-version shim), and the names the port adds, each listed with
  its reason;
* the kernel registry's autotuner has the JAX registry's names and
  signatures, and the same environment variables.
"""

import dataclasses
import importlib
import inspect
import os
import pkgutil
from pathlib import Path

import pytest

import repro_torch.kernels
from repro.kernels import registry as jregistry
from repro_torch.kernels import registry

# the JAX-version shim, which the port has no use for
LATER = {"core": {"compat"}}

# what the port exports beyond the JAX package: the ring all-reduce and
# the rank launcher (one process a rank), the task layer's fault hook and
# executor module, the sharded step's gradient function
EXTRA = {"core": {"ring_allreduce", "run_ranks"},
         "task": {"TASK_HOOK", "executor"},
         "train": {"make_grad_fn"}}

EXPECTED = {
    "core": ["Environment", "Communicator", "DeviceGroup", "current_group",
             "HW", "DCN_AXES", "Policy", "SegmentedArray", "segment",
             "gather", "overlap2d_map", "broadcast", "scatter", "reduce",
             "all_reduce", "all_reduce_window", "vdot", "copy",
             "all_to_all", "reduce_scatter", "hierarchical_psum",
             "ring_allreduce", "invoke_kernel", "invoke_kernel_all",
             "make_spmd", "PassThrough", "dev_rank", "fence", "barrier",
             "barrier_fence", "ordered", "run_ranks"],
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
    "bench": ["artifact", "compare", "harness", "models", "registry",
              "SCHEMA_VERSION", "ArtifactError", "load_artifact",
              "make_artifact", "run_key", "validate_artifact",
              "write_artifact", "Comparison", "compare_artifacts",
              "BenchContext", "Timing", "measure", "Scenario", "scenario",
              "scenarios"],
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


# -- the registry's autotuner against the JAX registry's --------------------

# the autotuner's module-level functions, and the spec fields it reads
TUNER_FUNCTIONS = ("register", "get", "specs", "get_impl", "autotune",
                   "pinned_block", "current_block", "choices",
                   "choices_token", "reset_choices", "tune_cache")
TUNER_FIELDS = ("family", "block_args", "default_block", "block_space",
                "supports")


def _params(fn) -> list:
    return [(p.name, p.kind, p.default) for p in
            inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", TUNER_FUNCTIONS)
def test_tuner_signature_is_the_reference(name):
    assert _params(getattr(registry, name)) == \
        _params(getattr(jregistry, name))


def test_tuner_environment_and_spec_surface():
    assert (registry.PIN_ENV, registry.TUNE_ENV) == \
        (jregistry.PIN_ENV, jregistry.TUNE_ENV) == \
        ("REPRO_KERNEL_BLOCKS", "REPRO_KERNEL_TUNE")
    fields = {f.name for f in dataclasses.fields(registry.KernelSpec)}
    assert set(TUNER_FIELDS) <= fields
    assert _params(registry.KernelSpec.pick_block) == \
        _params(jregistry.KernelSpec.pick_block)
    # the spec ids both packages hold are of one form, family.name
    shared = {s.id for s in registry.specs()} & \
        {s.id for s in jregistry.specs()}
    assert {"cg_fused.cg_update", "cg_fused.xpby_dot",
            "coil_mult.coil_forward", "gridding.degrid",
            "gridding.grid_adjoint", "masked_allreduce.masked_sum",
            "flash_attention.flash_attention"} <= shared
    for s in registry.specs():
        assert registry.get(s.id) is registry.get(s.name) is s
        assert s.default_block in s.block_space
        assert len(s.default_block) == len(s.block_args)
