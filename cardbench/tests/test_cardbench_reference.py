"""The plain reference against the port's plain path at a tiny size: the
chain of frames from the initial carry, fused and unfused, and the
control's distance."""

import numpy as np
import pytest
import torch

from cardbench.data import phantom
from cardbench.reference import nlinv as ref

N, J, FRAMES, NEWTON, CG = 16, 4, 3, 3, 8


@pytest.fixture(scope="module")
def data():
    return phantom.make_cycle(N, J, 11, FRAMES, 1e-4, 2 ** 31 + 3, "cpu")


def _reference(data, rnd=ref.fp32):
    u0 = ref.initial_carry(J, data["grid"], "cpu")
    x0 = {k: v.clone() for k, v in u0.items()}
    return list(ref.frames(data["y"], data["masks"], data["fov"], u0, x0,
                           newton=NEWTON, cg_iters=CG, damping=0.9,
                           rnd=rnd))


@pytest.mark.parametrize("fused", [True, False])
def test_reference_follows_the_ports_stream(data, fused):
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    rec = Reconstructor(device="cpu", newton=NEWTON, cg_iters=CG,
                        channel_sum="crop", fused=fused)
    imgs, _ = FrameStream(rec, damping=0.9).run(data["y"], data["masks"],
                                                data["fov"])
    for got, want in zip(imgs, _reference(data)):
        assert ref.rel_err(got, want) < 1e-5


def test_the_control_is_farther_than_the_program(data):
    want = _reference(data)
    control = _reference(data, ref.bf16)
    errs = [ref.rel_err(c, w) for c, w in zip(control, want)]
    assert min(errs) > 1e-3


def test_bf16_rounds_both_parts():
    x = torch.tensor([1.0 + 1e-3 + 1j * (1.0 + 1e-3)], dtype=torch.complex64)
    y = ref.bf16(x)
    assert y.real.item() == 1.0 and y.imag.item() == 1.0


def test_the_generator_repeats_from_its_seed():
    a = phantom.make_cycle(8, 2, 5, 2, 1e-4, 2 ** 33 + 1, "cpu")
    b = phantom.make_cycle(8, 2, 5, 2, 1e-4, 2 ** 33 + 1, "cpu")
    c = phantom.make_cycle(8, 2, 5, 2, 1e-4, 2 ** 33 + 2, "cpu")
    assert np.array_equal(a["y"], b["y"]) and not np.array_equal(a["y"],
                                                                 c["y"])
    # every seed asks for the same work: the same shapes and spokes
    assert a["y"].shape == c["y"].shape
    assert a["masks"].sum(axis=(1, 2)).tolist() != [] and \
        abs(a["masks"].sum() - c["masks"].sum()) < 0.05 * a["masks"].sum()


def test_a_start_rotates_the_same_cycle():
    """Every ``--seed`` gets the same acquisitions, begun elsewhere."""
    start = 2 ** 31 + 5
    a = phantom.make_cycle(8, 2, 5, 4, 1e-4, 2 ** 33 + 1, "cpu")
    b = phantom.make_cycle(8, 2, 5, 4, 1e-4, 2 ** 33 + 1, "cpu", start=start)
    k = start % 4
    assert k != 0
    assert np.array_equal(np.roll(a["y"], -k, axis=0), b["y"])
    assert np.array_equal(np.roll(a["masks"], -k, axis=0), b["masks"])


def test_the_generator_matches_the_ports_phantom():
    """The frozen generator's phantom, coils and mask are the port's."""
    from repro_torch.nlinv import phantom as port
    n = 24
    got = phantom.shepp_logan(n, torch.tensor([0.3]), "cpu")[0].numpy()
    assert np.allclose(got, port.shepp_logan(n, 0.3), atol=0)
    coils = phantom.birdcage_coils(n, 4, "cpu").numpy()
    assert np.allclose(coils, port.birdcage_coils(n, 4), atol=2e-6)
    masks = phantom.radial_masks(2 * n, 11, np.arange(3))
    for f in range(3):
        assert np.array_equal(masks[f] > 0, port.radial_mask(2 * n, 11, f))
