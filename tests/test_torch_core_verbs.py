"""The port's point-to-point ring, hierarchical sum, OVERLAP2D halo
exchange, kernel launchers, ``VERB_HOOK`` and ``survivor``, on the CPU.

One set of 4 gloo rank processes (``torch_ranks.verbs_rank``) runs them
all, the hierarchical sum on a ``(2, 2)`` ``("pod", "data")`` group made
on every rank.  Results are held against numpy (the JAX package's
``tests/test_core_comm_verbs.py`` holds its verbs to numpy the same
way): data movement exactly, sums within 1e-5.  The ring's bits must not
depend on ``chunks``, must be the same on every rank, and its masked form
must be bitwise the gathered schedule's (both sum one stack in rank
order).  The hook and the 1-rank doctests run in this process.
"""

import doctest

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.core import Communicator, Environment, Policy, run_ranks
from repro_torch.core import env as core_env
from repro_torch.core import invoke as core_invoke
from repro_torch.core import segmented as core_segmented

NRANKS = 4
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(5)

    def c(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"ring": f(NRANKS, 7, 3), "stack": f(8, 6, 6), "ovl": c(4, 6, 6),
            "e_re": f(4), "e_c": c(4),
            "mask": (rng.random((6, 6)) > 0.4).astype(np.float32),
            "hier_tiled": f(NRANKS, 4, 5), "hier_fallback": f(NRANKS, 3, 5),
            "halo_x": f(16, 5), "w": f(5)}


INPUTS = _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(torch_ranks.verbs_rank, NRANKS, device="cpu",
                     args=(INPUTS,), timeout=150,
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_ring_allreduce(ranks, op):
    """G - 1 = 3 rounds of shifts, ``compute`` once after the first; the
    same bits for ``chunks`` 1, 2 and 3 and on every rank, equal to numpy
    within 1e-5 (sum) or exactly (max)."""
    want = getattr(INPUTS["ring"], op)(0)
    first = ranks[0][f"ring_{op}_1"]
    for out in ranks:
        for chunks in (1, 2, 3):
            red, bits, c, events = out[f"ring_{op}_{chunks}"]
            assert bits == first[1], (op, chunks)
            assert c == 7
            assert events == ["round", "compute", "round", "round"]
            np.testing.assert_allclose(red, want, atol=TOL if op == "sum"
                                       else 0)
        red, scalar = out["ring_tuple"]
        np.testing.assert_allclose(red, INPUTS["ring"].sum(0), atol=TOL)
        assert scalar == sum(range(NRANKS))


def test_p2p_matches_psum(ranks):
    """``allreduce_window(p2p=True)`` against the default within 1e-5
    (``tests/test_core_comm_verbs.py``'s check), and the eager p2p sum
    and max against numpy."""
    stack = INPUTS["stack"]
    for out in ranks:
        psum, p2p = out["p2p_window"]
        np.testing.assert_allclose(p2p, psum, atol=TOL)
        want = np.zeros((6, 6), np.float32)
        want[1:5, 1:5] = stack.sum(0)[1:5, 1:5]
        np.testing.assert_allclose(p2p, want, atol=TOL)
        s, m = out["p2p_allreduce"]
        np.testing.assert_allclose(s, stack.sum(0), atol=TOL)
        np.testing.assert_array_equal(m, stack.max(0))


def test_fused_channel_sum_schedules(ranks):
    """``allreduce_overlap`` with a mask and two extras: the ring (2 and 3
    payloads a round) is bitwise the gathered schedule; the hierarchical
    sum on the 1-axis group is the gathered schedule (no DCN axis), on
    the (2, 2) group within 1e-5 of it; all against numpy; without a
    mask the ring sums within 1e-5 and runs ``compute``."""
    ovl, mask = INPUTS["ovl"], INPUTS["mask"]
    total = ovl.sum(0)
    want = np.zeros_like(total)
    want[1:5, 1:5] = mask[1:5, 1:5] * total[1:5, 1:5]
    e_re, e_c = INPUTS["e_re"].sum(), INPUTS["e_c"].sum()
    for out in ranks:
        base = out["ovl_gathered"]
        for name in ("p2p", "p2p3", "hier1"):
            for a, b in zip(out[f"ovl_{name}"], base):
                np.testing.assert_array_equal(a, b)
        for name in ("gathered", "hier22"):
            red, ex0, ex1 = out[f"ovl_{name}"]
            np.testing.assert_allclose(red, want, atol=TOL)
            assert ex0.dtype == np.float32 and ex1.dtype == np.complex64
            np.testing.assert_allclose([ex0, ex1], [e_re, e_c], atol=TOL)
        red, ex0, ex1, comp = out["ovl_p2p_nomask"]
        win = np.zeros_like(total)
        win[1:5, 1:5] = total[1:5, 1:5]
        np.testing.assert_allclose(red, win, atol=TOL)
        np.testing.assert_allclose([ex0, ex1], [e_re, e_c], atol=TOL)
        np.testing.assert_array_equal(comp, np.ones(2, np.float32))
        for k in ("ovl_hier22", "ovl_p2p_nomask"):
            assert all(np.array_equal(a, b)
                       for a, b in zip(out[k], ranks[0][k])), k


def test_hierarchical_psum_on_a_mesh(ranks):
    """The (2, 2) ("pod", "data") group: rank = pod * 2 + data, "pod" the
    DCN axis; a leading dim of 4 tiles over the ICI axis (reduce-scatter,
    all-reduce, all-gather), 3 does not (the flat sum); both equal
    numpy within 1e-5, and the local form too."""
    for r, out in enumerate(ranks):
        coords, ici, dcn, size, on_data, on_pod = out["mesh"]
        assert coords == (r // 2, r % 2) and size == NRANKS
        assert ici == ("data",) and dcn == ("pod",)
        assert (on_data, on_pod) == (r % 2, r // 2)
        for name, staged in (("hier_tiled", True), ("hier_fallback", False)):
            got, tiles = out[name]
            assert tiles is staged
            np.testing.assert_allclose(got, INPUTS[name].sum(0), atol=TOL)
        np.testing.assert_allclose(out["hier_local"],
                                   INPUTS["hier_tiled"].sum(0), atol=TOL)


def _stencil(x, h):
    xp = np.pad(x, ((h, h), (0, 0)))          # the edge ranks see zeros
    return sum(xp[k:k + len(x)] for k in range(2 * h + 1))


def test_overlap2d_halo_exchange(ranks):
    """OVERLAP2D round trips (container and scatter), its segments count
    the halo rows, ``overlap2d_map`` equals numpy's stencil for halo
    widths 0-2, and the extended container holds each rank's rows with
    its neighbours' (zeros past the edges)."""
    x = INPUTS["halo_x"]
    xp = np.pad(x, ((2, 2), (0, 0)))
    for r, out in enumerate(ranks):
        back, segs, scattered = out["halo_round_trip"]
        np.testing.assert_array_equal(back, x)
        np.testing.assert_array_equal(scattered, x)
        assert segs == [6, 8, 8, 6]
        for h in (0, 1, 2):
            np.testing.assert_allclose(out[f"halo_{h}"], _stencil(x, h),
                                       atol=TOL)
        policy, shape, local = out["halo_ext"]
        assert policy == "natural" and shape == (32, 5)
        np.testing.assert_array_equal(local, xp[4 * r:4 * r + 8])


def test_invoke_and_invoke_all(ranks):
    """``invoke`` runs on every rank and keeps rank 2's segment only;
    ``invoke_all`` passes segments, a ``PassThrough``'s whole array and a
    plain array; ``SegmentedArray.invoke`` keeps the layout."""
    x, w = INPUTS["halo_x"], INPUTS["w"]
    one = np.zeros_like(x)
    one[8:12] = 10 * x[8:12]
    for r, out in enumerate(ranks):
        got_one, got_all, rank, neg = out["invoke"]
        np.testing.assert_array_equal(got_one, one)
        np.testing.assert_allclose(got_all, x + x.sum() + w, atol=TOL)
        assert rank == r
        np.testing.assert_array_equal(neg, -x[4 * r:4 * r + 4])


def test_survivor_drops_a_lost_rank(ranks):
    """4 ranks minus rank 2: a 3-rank group made by its members alone
    all-reduces 1 + 2 + 4; rank 2 gets ``None``."""
    for r, out in enumerate(ranks):
        if r == 2:
            assert out["survivor"] is None
        else:
            assert out["survivor"] == (3, [0, 1, None, 2][r], 7.0)


def test_verb_hook_fires_at_the_six_sites(monkeypatch):
    """``VERB_HOOK(name, payload)`` runs at container, bcast, scatter,
    gather, the eager allreduce and copy, and what it returns is the
    payload the verb goes on with."""
    seen = []

    def hook(name, payload):
        seen.append(name)
        if name == "container":
            return np.asarray(payload) * 2
        return payload

    monkeypatch.setattr(core_env, "VERB_HOOK", hook)
    comm = Communicator.single("cpu")
    seg = comm.container([1.0, 2.0])
    np.testing.assert_array_equal(seg.data.numpy(), [2.0, 4.0])
    comm.bcast([1.0])
    comm.scatter([[1.0, 2.0]])
    comm.gather(seg)
    comm.allreduce(seg)
    comm.copy(seg, policy=Policy.CLONE)
    comm.allreduce(torch.ones(2))            # the local form does not fire
    assert seen == ["container", "bcast", "scatter", "gather", "allreduce",
                    "copy"]
    monkeypatch.setattr(core_env, "VERB_HOOK",
                        lambda name, p: (_ for _ in ()).throw(
                            RuntimeError(f"link to {name} lost")))
    with pytest.raises(RuntimeError, match="link to gather lost"):
        comm.gather(seg)


def test_schedule_rules_and_one_rank_forms():
    """p2p and hierarchical exclude each other; the p2p ring is one-axis;
    on one rank every schedule is the local math; ``survivor`` of nobody
    lost is the group itself; a mesh needs its ranks."""
    comm = Communicator.single("cpu")
    seg = comm.container(np.arange(6.0, dtype=np.float32).reshape(3, 2))
    with pytest.raises(ValueError, match="mutually exclusive"):
        comm.allreduce(seg, p2p=True, hierarchical=True)
    for kw in ({"p2p": True}, {"hierarchical": True}):
        np.testing.assert_array_equal(comm.allreduce(seg, **kw).data.numpy(),
                                      [6.0, 9.0])
    env = Environment(device="cpu")
    assert env.survivor(comm) is comm
    mesh = env.group((1, 1), ("pod", "data"))
    assert mesh.group.axes == ("pod", "data") and mesh.size == 1
    with pytest.raises(ValueError, match="single-axis"):
        mesh.allreduce(mesh.container([[1.0, 2.0]]), p2p=True)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        env.group((2, 2), ("pod", "data"))
    with pytest.raises(ValueError, match="1-D groups"):
        env.survivor(mesh)


@pytest.mark.parametrize("module", [core_segmented, core_invoke, core_env],
                         ids=["segmented", "invoke", "env"])
def test_one_rank_doctests(module):
    """The doctests (the 1-rank halo exchange zero-fills its halo rows;
    ``invoke``, ``reduce_scatter``, ``alltoall``, ``copy``)."""
    result = doctest.testmod(module)
    assert result.failed == 0 and result.attempted > 0


def test_fluent_arithmetic_keeps_the_layout():
    """Elementwise arithmetic and ``astype`` on a container keep its
    policy and metadata; ``to`` re-segments through ``copy``."""
    comm = Communicator.single("cpu")
    seg = comm.container(np.arange(6.0, dtype=np.float32).reshape(3, 2),
                         policy=Policy.OVERLAP2D, halo=1)
    out = ((seg + 1) * seg - seg / 2).astype(torch.float64)
    assert (out.policy, out.halo, out.global_shape, out.dtype) == \
        (Policy.OVERLAP2D, 1, (3, 2), torch.float64)
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_allclose(out.gather().numpy(), (x + 1) * x - x / 2)
    assert seg.to(Policy.CLONE).policy is Policy.CLONE
    assert seg.to(dim=1).dim == 1
