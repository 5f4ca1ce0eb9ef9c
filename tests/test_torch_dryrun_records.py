"""The dry cell against the real step, on the CPU.

The SMOKE configs (float32) of qwen3-0.6b, granite-moe-3b-a800m and
recurrentgemma-2b, each as a train step, a prefill and a decode step of
4 x 16 tokens (``launch.cells.build_cell`` with a ``(seq, gbatch, kind)``
shape), with and without sequence parallelism, on ``(data, model)``
meshes (1, 4) and (2, 2):

- the dry cell (a ``DeviceGroup.dry`` mesh, traced on meta by
  ``launch.costing`` inside ``registry.plain()``, the kernels' plain
  versions as the CPU runs them)
  has rank 0's real record (every collective's kind, bytes, group and
  axes, in order) and its counted flops, from one set of 4 gloo CPU ranks
  (``torch_dry_ranks.records_rank``);
- the first rank's record equals the last rank's, dry and real.
"""

import pytest

import torch_dry_ranks
from repro_torch.configs import get_smoke
from repro_torch.core import Communicator, DeviceGroup, run_ranks
from repro_torch.kernels import registry
from repro_torch.launch import costing

ARCHS = ("qwen3-0.6b", "granite-moe-3b-a800m", "recurrentgemma-2b")
MESHES = ((1, 4), (2, 2))
SHAPES = ((16, 4, "train"), (16, 4, "prefill"), (16, 4, "decode"))
CASES = [(arch, shape, sp) for arch in ARCHS for shape in SHAPES
         for sp in (False, True)]


@pytest.fixture(scope="module")
def real():
    return run_ranks(torch_dry_ranks.records_rank, 4, device="cpu",
                     args=(MESHES, CASES), timeout=300)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch,shape,sp", CASES, ids=[
    f"{a}-{s[2]}-{'sp' if sp else 'tp'}" for a, s, sp in CASES])
def test_dry_cell_has_the_real_record_and_flops(real, arch, shape, sp,
                                                mesh):
    def dry_mesh(rank):
        return Communicator(DeviceGroup.dry(mesh, ("data", "model"), rank))

    with registry.plain():
        dry = costing.cell_cost(
            arch, shape, dry_mesh, act_sp=sp,
            overrides=torch_dry_ranks.f32_fields(get_smoke(arch)))
    first, last = real[0][mesh, arch, shape, sp], \
        real[3][mesh, arch, shape, sp]
    assert first["record"] == last["record"]
    assert dry["ranks_traced"] == [0, 3]
    assert costing.record_key(dry["record"]) == first["record"]
    assert dry["flops_counted"] == first["flops"] > 0
    assert dry["kernel_flops"] == 0 and first["kernels"] == 0
    if sp and shape[2] != "decode":
        assert first["act"] == (("data",), "model", None)
        assert any(e[0] == "reduce_scatter" for e in first["record"])
    else:
        assert first["act"] is None
