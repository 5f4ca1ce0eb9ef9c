"""The port's masked partial sum against the JAX package's, on the CPU.

* the plain ``masked_sum`` against JAX's ``masked_sum_pallas`` (interpret
  mode, re/im float32 planes, the way JAX's own tests run it on the CPU)
  and ``masked_sum_ref``, from the same numpy inputs at the JAX spec's
  samples (4, 32, 32) and (2, 96, 128), to the spec's tolerance 1e-4 in
  the registry harness's form (rtol = 10 tol, atol = tol);
* the frame's call form: partials that are a window of larger planes or
  a gathered payload with extras after each plane, the result written
  into a window of a zero-filled image;
* the batched form, a (G, B, X, Y) stack of B rows under one mask,
  against JAX's ``masked_sum_ref`` row by row, bitwise the unbatched
  call on each row, and in the frame's strided form;
* ``masked_psum_crop`` on 4 gloo ranks against JAX's under ``shard_map``
  on 4 host devices (one subprocess), and on a 1-rank communicator.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from helpers import run_with_devices
from repro.kernels.masked_allreduce import masked_sum_pallas, masked_sum_ref
from repro_torch.core import Communicator, run_ranks
from repro_torch.kernels import registry
from repro_torch.kernels.masked_allreduce import (masked_psum_crop,
                                                  masked_sum)

TOL = registry.get("masked_sum").tol


def _case(seed, g, x, y):
    rng = np.random.default_rng(seed)
    partials = (rng.standard_normal((g, x, y)) +
                1j * rng.standard_normal((g, x, y))).astype(np.complex64)
    mask = (rng.random((x, y)) > 0.4).astype(np.float32)
    return partials, mask


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=10 * TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(4, 32, 32), (2, 96, 128)])
def test_masked_sum_matches_jax(shape):
    partials, mask = _case(800 + shape[1], *shape)
    got = masked_sum(torch.from_numpy(partials), torch.from_numpy(mask))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape[1:]
    pr = jnp.asarray(partials.real)
    pi = jnp.asarray(partials.imag)
    outr, outi = masked_sum_pallas(pr, pi, jnp.asarray(mask), bx=32,
                                   interpret=True)
    _close(got.numpy(), np.asarray(outr) + 1j * np.asarray(outi))
    _close(got.numpy(), masked_sum_ref(jnp.asarray(partials),
                                       jnp.asarray(mask)))


def test_masked_sum_frame_form_on_the_cpu():
    """Strided partials and ``out=``: the same values as the contiguous
    call, written in place into the window."""
    partials, mask = _case(3, 3, 24, 24)
    big = torch.zeros((3, 48, 48), dtype=torch.complex64)
    big[:, 12:36, 12:36] = torch.from_numpy(partials)
    out = torch.zeros((48, 48), dtype=torch.complex64)
    res = masked_sum(big[:, 12:36, 12:36], torch.from_numpy(mask),
                     out=out[12:36, 12:36])
    want = masked_sum(torch.from_numpy(partials), torch.from_numpy(mask))
    assert res.data_ptr() == out[12:36, 12:36].data_ptr()
    np.testing.assert_array_equal(out[12:36, 12:36].numpy(), want.numpy())
    assert not out[:12].any() and not out[36:].any()
    before = registry.launches()
    masked_sum(torch.from_numpy(partials), torch.from_numpy(mask))
    assert registry.launches() == before    # CPU tensors launch nothing


@pytest.mark.parametrize("shape", [(4, 2, 32, 32), (3, 3, 24, 40)])
def test_batched_masked_sum_matches_jax_row_by_row(shape):
    G, B, X, Y = shape
    rng = np.random.default_rng(900 + B)
    partials = (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)
    mask = (rng.random((X, Y)) > 0.4).astype(np.float32)
    got = masked_sum(torch.from_numpy(partials), torch.from_numpy(mask))
    assert got.dtype == torch.complex64 and tuple(got.shape) == (B, X, Y)
    for b in range(B):
        _close(got[b].numpy(), masked_sum_ref(jnp.asarray(partials[:, b]),
                                              jnp.asarray(mask)))
        row = masked_sum(torch.from_numpy(partials[:, b]),
                         torch.from_numpy(mask))
        np.testing.assert_array_equal(got[b].numpy(), row.numpy())


def test_batched_masked_sum_frame_form_on_the_cpu():
    """The batched frame's call: a gathered payload of B windows with
    extras after each rank's plane, the result written into the windows
    of a zero-filled (B, X, Y) image."""
    G, B, w, g = 4, 2, 8, 16
    rng = np.random.default_rng(4)
    rows = torch.from_numpy((rng.standard_normal((G, B * w * w + B)) +
                             1j * rng.standard_normal((G, B * w * w + B)))
                            .astype(np.complex64))
    stack = rows[:, :B * w * w].view(G, B, w, w)
    mask = torch.from_numpy((rng.random((w, w)) > 0.3).astype(np.float32))
    full = torch.zeros((B, g, g), dtype=torch.complex64)
    target = full[:, 4:12, 4:12]
    res = masked_sum(stack, mask, out=target)
    assert res.data_ptr() == target.data_ptr()
    want = masked_sum(stack.contiguous(), mask)
    np.testing.assert_array_equal(full[:, 4:12, 4:12].numpy(), want.numpy())
    assert not full[:, :4].any() and not full[:, 12:].any()


JAX_CROP = """
import pickle
from repro.core import compat
from repro.kernels.masked_allreduce import masked_psum_crop
parts, mask = pickle.load(open(IN, "rb"))
mesh = compat.make_mesh((4,), ("data",))
f = compat.shard_map(lambda x, m: masked_psum_crop(x[0], m, "data")[None],
                     mesh=mesh, in_specs=(P("data"), P()),
                     out_specs=P("data"), check_vma=False)
pickle.dump(np.asarray(f(jnp.asarray(parts), jnp.asarray(mask))),
            open(OUT, "wb"))
"""


def test_masked_psum_crop_on_four_ranks_matches_jax(tmp_path):
    """Each rank's partial plane: only the centered FOV quarter crosses
    the wire, every rank sums the 4 quarters with ``masked_sum`` and
    gets the JAX package's psum result (and the same bits as the other
    ranks)."""
    parts, mask = _case(5, 4, 32, 32)
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps((parts, mask)))
    run_with_devices(f"IN, OUT = {str(src)!r}, {str(dst)!r}\n" + JAX_CROP,
                     ndev=4)
    want = pickle.loads(dst.read_bytes())
    got = run_ranks(torch_ranks.masked_psum_crop_rank, 4, device="cpu",
                    args=(parts, mask), timeout=120, store_dir=tmp_path)
    for r, out in enumerate(got):
        _close(out, want[r])
        np.testing.assert_array_equal(out, got[0])
    expect = np.zeros((32, 32), np.complex64)
    expect[8:24, 8:24] = (mask * parts.sum(0))[8:24, 8:24]
    _close(got[0], expect)


def test_masked_psum_crop_on_one_rank():
    parts, mask = _case(6, 1, 16, 16)
    out = masked_psum_crop(torch.from_numpy(parts[0]),
                           torch.from_numpy(mask),
                           Communicator.single("cpu")).numpy()
    want = np.zeros((16, 16), np.complex64)
    want[4:12, 4:12] = (mask * parts[0])[4:12, 4:12]
    np.testing.assert_array_equal(out, want)
