"""Property tests (hypothesis) for the port's segmented containers.

The counterparts of ``tests/test_core_properties.py``, with ``axpy`` and
``dot`` from the port's ``lib.blas``: segment then gather is the identity
for every policy, ``reduce`` and ``allreduce`` agree with numpy, and the
level-1 BLAS agrees with numpy.  They run in this process on a 1-rank
communicator; the layout of every rank of larger groups is checked
through the pure layout helpers, which ``segment`` and ``gather`` are
built from.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core import Communicator, Policy
from repro_torch.core.segmented import (local_segment, logical_array,
                                        physical_layout)
from repro_torch.lib import blas

COMM = Communicator.single("cpu")
POLICIES = [Policy.NATURAL, Policy.CLONE, Policy.BLOCK]


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 33), m=st.integers(1, 5),
       policy=st.sampled_from(POLICIES), block=st.integers(1, 4))
def test_roundtrip(n, m, policy, block):
    x = np.random.randn(n, m).astype(np.float32)
    s = COMM.container(x, policy=policy, block=block)
    np.testing.assert_array_equal(s.gather().numpy(), x)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 33), m=st.integers(1, 4), nseg=st.integers(1, 6),
       dim=st.integers(0, 1), policy=st.sampled_from(POLICIES),
       block=st.integers(1, 4))
def test_roundtrip_over_ranks(n, m, nseg, dim, policy, block):
    """Every rank's segment of the layout, concatenated in rank order and
    read back, is the array; every NATURAL/BLOCK segment has the same
    length, and the padding is zero."""
    x = np.random.randn(n, m).astype(np.float32)
    layout, orig = physical_layout(x, nseg, policy, dim, block)
    segs = [local_segment(layout, r, nseg, policy, dim) for r in range(nseg)]
    if policy is Policy.CLONE:
        assert all(s is layout for s in segs)
        back = layout
    else:
        assert len({s.shape for s in segs}) == 1
        back = np.concatenate(segs, axis=dim)
        assert np.abs(back).sum() == pytest.approx(np.abs(x).sum(),
                                                   rel=1e-6)
    np.testing.assert_array_equal(
        logical_array(back, nseg, policy, dim, orig, block), x)


@settings(max_examples=25, deadline=None)
@given(b=st.integers(1, 8), n=st.integers(1, 6))
def test_reduce_matches_numpy(b, n):
    x = np.random.randn(b, n, n).astype(np.float32)
    s = COMM.container(x)
    np.testing.assert_allclose(COMM.reduce(s).numpy(), x.sum(0), atol=1e-4)
    np.testing.assert_allclose(COMM.allreduce(s, "max").gather().numpy(),
                               x.max(0), atol=1e-6)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 40), a=st.floats(-3, 3, allow_nan=False))
def test_axpy_linearity(n, a):
    x = np.random.randn(n).astype(np.float32)
    y = np.random.randn(n).astype(np.float32)
    sx, sy = COMM.container(x), COMM.container(y)
    got = blas.axpy(a, sx, sy).gather().numpy()
    np.testing.assert_allclose(got, a * x + y, atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 20))
def test_dot_conjugate_symmetry(n):
    x = (np.random.randn(n) + 1j * np.random.randn(n)).astype(np.complex64)
    y = (np.random.randn(n) + 1j * np.random.randn(n)).astype(np.complex64)
    sx, sy = COMM.container(x), COMM.container(y)
    d1 = complex(blas.dot(sx, sy))
    d2 = complex(blas.dot(sy, sx))
    assert abs(d1 - np.conj(d2)) < 1e-3
    assert abs(d1 - np.vdot(x, y)) < 1e-3 * max(1.0, abs(np.vdot(x, y)))


def test_container_keeps_no_view_of_the_callers_array():
    """A container owns its segment: updating it in place (the frame's
    donated carry) never writes into the caller's array or tensor."""
    x = np.zeros((4, 3), np.float32)
    t = torch.zeros((4, 3))
    for src in (x, t):
        s = COMM.container(src)
        s.data.add_(1.0)
    assert not x.any() and not t.any()
