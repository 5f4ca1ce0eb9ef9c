"""The frozen yardsticks: the kernels' formulas against today's registry
specs, and the frame's counted work."""

import pytest
import torch

from cardbench.metrics import _kernels, _work
from cardbench.metrics._peaks import BYTES_PER_S, F32_FLOPS


def _spec(name):
    from repro_torch.kernels import registry
    return registry.get(name)


# xpby_dot, the segmented BLAS's kernel, takes no batch
CASES = [(n, w) for n in sorted(_kernels.FORMULAS) for w in (None, 3)
         if not (w and n == "xpby_dot")]


@pytest.mark.parametrize("name,width", CASES)
def test_frozen_formulas_equal_the_registry(name, width):
    spec = _spec(name)
    assert width is None or spec.batched
    gen = torch.Generator().manual_seed(0)
    kw = {"width": width} if width is not None else {}
    if name == "masked_sum":
        args = spec.sample("cpu", gen, nparts=2, size=8, **kw)
    else:
        args = spec.sample("cpu", gen, ncoils=2, grid=8, **kw)
    nbytes, flops = _kernels.FORMULAS[name]
    assert nbytes(*args) == spec.nbytes(*args)
    assert flops(*args) == spec.flops(*args)


def test_every_nlinv_spec_has_a_formula():
    from repro_torch.kernels import registry
    from repro_torch.nlinv import recon
    names = set(recon._FRAME_SPECS) | {"masked_sum", "xpby_dot"}
    assert names <= set(_kernels.FORMULAS)
    for name in _kernels.FORMULAS:
        assert registry.get(name).peak_flops == F32_FLOPS


def test_frozen_counts_restore_the_program_formulas():
    from repro_torch.kernels import registry
    spec = registry.get("plane_mult")
    before = (spec.nbytes, spec.flops)
    with _kernels.frozen_counts(registry) as got:
        assert spec.nbytes is not before[0]
    assert (spec.nbytes, spec.flops) == before
    assert got == {"known": {}, "unknown": {}}


@pytest.mark.parametrize("name,port", [
    ("(anonymous namespace)::cg_update_kernel(float const*, float2*)", True),
    ("void (anonymous namespace)::new_kernel<4>(float*)", True),
    ("void at::native::(anonymous namespace)::roll_cuda_kernel<float>()",
     False),
    ("void regular_fft<768u, EPT<6u, 8u, 16u>>(kernel_arguments_t)", False),
    ("void dot_kernel<float2, 128, 1, cublasDotParams<float2>>()", False),
    ("Memcpy HtoD (Pinned -> Device)", False),
])
def test_port_kernels_are_told_from_the_libraries(name, port):
    assert _kernels.is_port_kernel(name) is port


def test_unknown_port_kernels_are_listed():
    ops = [["(anonymous namespace)::cg_update_kernel(float*)", 0.0, 1.0],
           ["(anonymous namespace)::fused_roll_kernel(float*)", 1.0, 1.0],
           ["(anonymous namespace)::fused_roll_kernel(float*)", 2.0, 1.0]]
    assert _kernels.unknown_port_kernels(ops) == {
        "fused_roll_kernel": 2}


def test_frame_work_counts_ffts_and_passes():
    flops, nbytes = _work.frame_work(768, 8, [30] * 7)
    P = 768 * 768
    apps = 7 * (2 + 2 * 30)
    assert flops == pytest.approx(apps * 16 * 5 * P * 19.169925, rel=1e-6)
    # the FFT passes alone: each plane read once and written once
    assert nbytes > apps * 16 * 2 * 8 * P
    bound = _work.frames_bound_s(768, 8, [[30] * 7])
    assert bound == pytest.approx(nbytes / BYTES_PER_S)
    assert _work.frame_work(768, 8, [10] * 7)[1] < nbytes
