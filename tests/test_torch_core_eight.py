"""The port's core on eight ranks, on the CPU: the counterparts of
``tests/test_core_multidevice.py`` (8 host devices) and of
``tests/test_nlinv_perf_collectives.py``.

One set of 8 gloo rank processes (spawned, ``FileStore``, 1 thread a
rank, every wait bounded; ``torch_ranks.eight_rank``) runs:

* the crop channel sum's wire bytes: the distributed NLINV frame at the
  reference's sizes (n = 32, 8 coils, 7 spokes, newton 3, cg 5), its
  collectives recorded (``core.comm.record()``) under ``channel_sum="full"``
  and ``"crop"`` and priced by ``launch.roofline``'s ring model.  The
  image-sized collectives (a payload of at least 4096 bytes: the channel
  sums and the RSS readout, not the CG scalars) under whatever verb the
  schedule uses, which for the fused channel sum is an all-gather of the
  ranks' windows: crop puts 3-6x fewer bytes on the wire, as the
  reference asserts of its compiled HLO's all-reduces;
* containers (NATURAL, padded, BLOCK, CLONE), reduce, all-reduce (sum,
  max), copy, all-to-all, reduce-scatter and the OVERLAP2D halo stencil,
  against numpy;
* ``invoke``/``invoke_all`` (a ``PassThrough`` too), ``lib.blas``
  (axpy, dot, the batched and the K-split GEMMs) and ``fft2_batched``
  against numpy, and a barrier fence;
* the hierarchical all-reduce on a ``(2, 4)`` ``("pod", "data")`` mesh
  against the flat one and against numpy.

Every rank must hold the same results.  The inputs are the reference's
shapes, drawn from a seeded generator.
"""

import numpy as np
import pytest

import torch_ranks
from repro_torch.core import run_ranks
from repro_torch.launch import roofline
from repro_torch.nlinv import phantom

NRANKS = 8
NEWTON, CG = 3, 5
IMAGE_BYTES = 4096


def _inputs():
    rng = np.random.default_rng(8)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def c(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    return {"x": f(24, 5), "x2": f(21, 3), "m": f(8, 6, 6),
            "xt": f(8, 16, 4), "xo": f(32, 8), "bx": f(16, 4),
            "by": f(16, 4), "xc": c(16, 4), "yc": c(16, 4),
            "a": f(8, 5, 6), "b": f(8, 6, 7), "A": f(12, 32), "B": f(32, 9),
            "xf": c(8, 16, 16), "hm": f(8, 4, 6)}


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = phantom.make_dataset(n=32, ncoils=8, nspokes=7, frames=1)
    return run_ranks(torch_ranks.eight_rank, NRANKS, device="cpu",
                     args=(d, NEWTON, CG, INPUTS), timeout=300,
                     store_dir=tmp_path_factory.mktemp("store"))


def _image_wire(records):
    return sum(c["wire_bytes"] for c in roofline.collectives(records)
               if c["bytes"] >= IMAGE_BYTES)


def test_cropped_channel_sum_moves_4x_fewer_bytes(ranks):
    for out in ranks:
        full = _image_wire(out["bytes"]["full"])
        crop = _image_wire(out["bytes"]["crop"])
        assert crop * 2 < full
        assert 3.0 < full / max(crop, 1) < 6.0, (full, crop)
    kinds = {c["kind"] for c in ranks[0]["bytes"]["crop"]
             if c["bytes"] >= IMAGE_BYTES}
    # the fused channel sum gathers the windows; the readout all-reduces
    assert kinds == {"all_gather", "all_reduce"}
    assert all(c["group"] == NRANKS for c in ranks[0]["bytes"]["crop"])


def test_segmented_containers_8_ranks(ranks):
    x, x2, m = INPUTS["x"], INPUTS["x2"], INPUTS["m"]
    for out in ranks:
        o = out["core"]
        np.testing.assert_array_equal(o["natural"], x)
        assert o["natural_len"] == 3
        np.testing.assert_array_equal(o["padded"], x2)
        np.testing.assert_array_equal(o["block"], x2)
        np.testing.assert_array_equal(o["clone"], x)
        np.testing.assert_allclose(o["reduce"], m.sum(0), atol=1e-5)
        np.testing.assert_allclose(o["all_reduce"], m.sum(0), atol=1e-5)
        np.testing.assert_array_equal(o["all_reduce_max"], m.max(0))
        np.testing.assert_array_equal(o["copy_clone"], x)
        got, dim = o["all_to_all"]
        np.testing.assert_array_equal(got, INPUTS["xt"])
        assert dim == 1
        np.testing.assert_allclose(o["reduce_scatter"], m.sum(0),
                                   atol=1e-5)
        xo = INPUTS["xo"]
        np.testing.assert_array_equal(o["overlap_identity"], xo)
        pad = np.pad(xo, ((1, 1), (0, 0)))
        np.testing.assert_allclose(o["overlap_stencil"],
                                   pad[:-2] + pad[1:-1] + pad[2:],
                                   atol=1e-5)


def test_invoke_blas_fft_8_ranks(ranks):
    i = INPUTS
    x, y = i["bx"], i["by"]
    want_fft = np.fft.fftshift(np.fft.fft2(
        np.fft.ifftshift(i["xf"], axes=(-2, -1)), axes=(-2, -1),
        norm="ortho"), axes=(-2, -1))
    rank3 = np.zeros_like(x)
    rank3[6:8] = x[6:8] + 1.0             # rank 3 owns rows 6:8
    for out in ranks:
        o = out["core"]
        np.testing.assert_allclose(o["axpy"], 2.0 * x + y, atol=1e-5)
        np.testing.assert_allclose(o["dot"], np.vdot(i["xc"], i["yc"]),
                                   atol=1e-4)
        np.testing.assert_allclose(o["gemm_batched"], i["a"] @ i["b"],
                                   atol=1e-4)
        np.testing.assert_allclose(o["gemm_ksplit"], i["A"] @ i["B"],
                                   atol=1e-4)
        np.testing.assert_allclose(o["fft2_batched"], want_fft, atol=1e-4)
        np.testing.assert_allclose(o["fft2_inverse"], i["xf"], atol=1e-4)
        np.testing.assert_allclose(o["invoke_all"], 2 * x + y, atol=1e-5)
        np.testing.assert_allclose(o["pass_through"], x + x.sum(),
                                   atol=1e-3)
        np.testing.assert_allclose(o["invoke_rank"], rank3, atol=1e-5)


def test_hierarchical_allreduce_2x4(ranks):
    m = INPUTS["hm"]
    for out in ranks:
        flat, hier = out["hier"]
        assert out["axes"] == (("data",), ("pod",))
        np.testing.assert_allclose(hier, flat, atol=1e-5)
        np.testing.assert_allclose(hier, m.sum(0), atol=1e-5)
