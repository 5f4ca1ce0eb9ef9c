"""The port's distributed NLINV frame against the JAX package's and
against its own single rank, on the CPU (paper §3.2: the coils split over
the ranks, ``rho`` CLONEd).

``test_nlinv_distributed.py``'s dataset (n = 24, J = 6 padded to 8 over 4
ranks, 7 spokes, seed 3): four gloo rank processes run the frame with
both channel sums at newton 5 / cg 20, held against JAX's
``make_dist_reconstruct`` on 4 host devices (one subprocess) within that
test's own 2e-3 * max|img|; at newton 3 / cg 10 (fused and unfused) the
four ranks are held against one rank of the port within 1e-5 (max abs
error over max abs value), and ``rho``, the CG log and the image must be
bitwise equal on every rank: the ranks steer their CG loops by the same
bits, or a collective would hang.  The padded zero channels stay exactly
zero.  A second set of ranks runs ``make_dist_reconstruct``'s global call
form and ``FrameStream``.

The channel sum's other schedules run in the same set of ranks: the p2p
ring (``overlap="p2p"``) on the 4 ranks and the hierarchical sum
(``hierarchical=True``) on a ``(2, 2)`` ``("pod", "data")`` group, held
against JAX's ``Reconstructor`` with the same option on 4 host devices
(the same subprocess) within ``JAX_TOL`` * max|img|, and against the
port's default 4-rank frame: the ring bitwise (both sum one stack of
the ranks' windows in rank order), the hierarchy within 1e-5, and the
hierarchy on the 1-axis group (no DCN axis: the default schedule)
bitwise, as JAX's is its psum's.
"""

import pickle

import numpy as np
import pytest

import torch_ranks
from helpers import run_with_devices
from repro_torch import convert
from repro_torch.core import Communicator, run_ranks
from repro_torch.nlinv import phantom
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.nlinv.stream import FrameStream

NRANKS = 4
DEEP = [(5, 20, "full", True), (5, 20, "crop", True)]
SHALLOW = [(3, 10, "crop", True), (3, 10, "crop", False)]
SHALLOW_TOL = 1e-5
# a FOV that is not 0/1: the ranks' masked channel sum masks by its support
HALF_FOV = (3, 10, "crop", True, 0.5)
# the p2p ring on the 4 ranks, the hierarchy on the (2, 2) group and on
# the 1-axis group (``torch_ranks.SCHEDULES``)
SCHED_DEEP = [(5, 20, "crop", True, 1.0, "p2p"),
              (5, 20, "crop", True, 1.0, "hier22")]
SCHED_SHALLOW = [(3, 10, "crop", True, 1.0, "p2p"),
                 (3, 10, "crop", True, 1.0, "hier22"),
                 (3, 10, "crop", True, 1.0, "hier")]
SCHED_HALF = [(3, 10, "crop", True, 0.5, "p2p"),
              (3, 10, "crop", True, 0.5, "hier22")]
# JAX's psum frame against the port's is held to 2e-3 * max|img| at this
# depth (``test_distributed_frame_matches_jax``); measured on the CPU, the
# psum frame is 4.17e-5 from JAX's, the ring 4.18e-5 and the hierarchy
# 3.74e-5 from JAX's with the same option (float32 sums in other orders
# through 5 Newton steps of 20 CG iterations), so these two are held to
# the tighter 1e-4
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    return phantom.make_dataset(n=24, ncoils=6, nspokes=7, frames=1, seed=3)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return run_ranks(torch_ranks.nlinv_rank, NRANKS, device="cpu",
                     args=(data, DEEP + SHALLOW + [HALF_FOV] + SCHED_DEEP +
                           SCHED_SHALLOW + SCHED_HALF), timeout=300,
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def one_rank(data):
    return torch_ranks.nlinv_on(Communicator.single("cpu"), data, SHALLOW)


JAX_DIST = """
import pickle
from repro.nlinv import phantom
from repro.nlinv.operators import sobolev_weight, uinit
from repro.nlinv.recon import make_dist_reconstruct, pad_channels
from repro.core import DeviceGroup
d = phantom.make_dataset(n=24, ncoils=6, nspokes=7, frames=1, seed=3)
g = DeviceGroup.all_devices((4,), ("data",))
w = sobolev_weight(d["grid"])
yp = pad_channels(d["y"][0], 4)
out = {}
for mode in ("full", "crop"):
    fn = make_dist_reconstruct(g, "data", newton=5, cg_iters=20,
                               channel_sum=mode)
    u0 = uinit(yp.shape[0], d["grid"])
    u, img = fn(jnp.asarray(yp), jnp.asarray(d["masks"][0]),
                jnp.asarray(d["fov"]), jnp.asarray(w), u0, u0)
    out[mode] = np.asarray(img)
from repro.core import Environment
from repro.nlinv.recon import Reconstructor
env = Environment()
for name, comm, kw in (("p2p", env.group((4,), ("data",)),
                        dict(overlap="p2p")),
                       ("hier22", env.group((2, 2), ("pod", "data")),
                        dict(hierarchical=True))):
    rec = Reconstructor(comm, newton=5, cg_iters=20, channel_sum="crop",
                        **kw)
    u0 = uinit(yp.shape[0], d["grid"])
    u, img = rec(jnp.asarray(yp), jnp.asarray(d["masks"][0]),
                 jnp.asarray(d["fov"]), jnp.asarray(w), u0, u0)
    out[name] = np.asarray(img)
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    dst = tmp_path_factory.mktemp("jax_dist") / "out.pkl"
    run_with_devices(f"OUT = {str(dst)!r}\n" + JAX_DIST, ndev=NRANKS)
    return pickle.loads(dst.read_bytes())


@pytest.mark.parametrize("case", DEEP, ids=[c[2] for c in DEEP])
def test_distributed_frame_matches_jax(ranks, jax_images, case):
    want = jax_images[case[2]]
    got = ranks[0][case]["img"]
    err = float(np.abs(got - want).max())
    assert err < 2e-3 * float(np.abs(want).max()), err


@pytest.mark.parametrize("case", SHALLOW, ids=["fused", "unfused"])
def test_four_ranks_match_one_rank(ranks, one_rank, case):
    got, want = ranks[0][case]["img"], one_rank[case]["img"]
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= SHALLOW_TOL, rel
    assert ranks[0][case]["log"] == one_rank[case]["log"]


def test_half_fov_matches_jax_on_one_device(ranks, data):
    """``fov = 0.5 * fov_mask`` on the 4 ranks against JAX's fused crop
    frame on one device (the 6 coils unpadded), within 1e-5."""
    import jax
    from repro.nlinv.recon import Reconstructor as JReconstructor
    from repro_torch.nlinv.operators import sobolev_weight
    newton, cg, mode, _, scale = HALF_FOV
    g = data["grid"]
    jr = JReconstructor(newton=newton, cg_iters=cg, channel_sum=mode)
    u0 = jr.init_carry(data["ncoils"], g)
    _, want = jr(jr.put_frame(data["y"][0]), jr.put_const(data["masks"][0]),
                 jr.put_const(scale * data["fov"]),
                 jr.put_const(sobolev_weight(g)), u0,
                 jax.tree.map(lambda a: a + 0, u0))
    want = np.asarray(want)
    for out in ranks:
        got = out[HALF_FOV]["img"]
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= SHALLOW_TOL, rel


@pytest.mark.parametrize("case", SCHED_DEEP, ids=["p2p", "hier22"])
def test_schedules_match_jax(ranks, jax_images, case):
    """The ring on 4 ranks and the hierarchy on the (2, 2) group against
    JAX's ``Reconstructor`` under the same option on 4 host devices."""
    want = jax_images[case[5]]
    for out in ranks:
        rel = float(np.abs(out[case]["img"] - want).max() /
                    np.abs(want).max())
        assert rel <= JAX_TOL, rel


@pytest.mark.parametrize("case", SCHED_SHALLOW,
                         ids=["p2p", "hier22", "hier_1axis"])
def test_schedules_match_the_default_frame(ranks, case):
    """Against the port's default 4-rank frame: the ring and the
    hierarchy on the 1-axis group bitwise (image, ``rho``, CG log), the
    hierarchy on the (2, 2) group within 1e-5."""
    want = ranks[0][SHALLOW[0]]
    got = ranks[0][case]
    if case[5] == "hier22":
        rel = float(np.abs(got["img"] - want["img"]).max() /
                    np.abs(want["img"]).max())
        assert rel <= SHALLOW_TOL, rel
        return
    np.testing.assert_array_equal(got["img"], want["img"])
    assert got["rho"] == want["rho"] and got["log"] == want["log"]


@pytest.mark.parametrize("case", SCHED_HALF, ids=["p2p", "hier22"])
def test_half_fov_under_each_schedule(ranks, case):
    """F2's half FOV under the ring (bitwise the default schedule's half
    FOV frame) and the hierarchy (within 1e-5 of it)."""
    want = ranks[0][HALF_FOV]["img"]
    for out in ranks:
        got = out[case]["img"]
        if case[5] == "p2p":
            np.testing.assert_array_equal(got, want)
        else:
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            assert rel <= SHALLOW_TOL, rel


@pytest.mark.parametrize("case", DEEP + SHALLOW + SCHED_DEEP + SCHED_SHALLOW
                         + SCHED_HALF,
                         ids=["full", "crop", "shallow", "unfused",
                              "p2p_deep", "hier22_deep", "p2p", "hier22",
                              "hier_1axis", "p2p_half", "hier22_half"])
def test_ranks_agree_bitwise(ranks, case):
    first = ranks[0][case]
    assert first["log"] == [] if not case[3] else len(first["log"]) == \
        case[0]
    for out in ranks[1:]:
        assert out[case]["rho"] == first["rho"]
        assert out[case]["log"] == first["log"]
        np.testing.assert_array_equal(out[case]["img"], first["img"])
        np.testing.assert_array_equal(out[case]["chat"], first["chat"])


def test_padded_channels_stay_zero(ranks, one_rank):
    """J = 6 over 4 ranks: rank 3 holds the two zero channels, and they
    stay exactly zero through the solve (exact no-ops in the channel
    sum, the residual partials and the RSS)."""
    case = SHALLOW[0]
    chat = ranks[0][case]["chat"]
    assert chat.shape[0] == 8
    np.testing.assert_array_equal(chat[6:], 0)
    np.testing.assert_array_equal(ranks[3][case]["chat_local"], 0)
    np.testing.assert_allclose(chat[:6], one_rank[case]["chat"], atol=1e-5)


@pytest.fixture(scope="module")
def movie():
    return phantom.make_dataset(n=16, ncoils=4, nspokes=11, frames=2, seed=2)


@pytest.fixture(scope="module")
def one_rank_stream(movie):
    """The 1-rank stream over the movie, and its global numpy carry after
    frame 0 (what a JAX run's ``last_carry`` would be, as numpy)."""
    rec = Reconstructor(device="cpu", newton=3, cg_iters=10)
    want, rep = FrameStream(rec).run(movie["y"], movie["masks"],
                                     movie["fov"])
    first = FrameStream(rec)
    first.run(movie["y"][:1], movie["masks"][:1], movie["fov"])
    return want.numpy(), rep, convert.carry_to_numpy(first.last_carry), rec


@pytest.fixture(scope="module")
def global_and_stream(data, movie, one_rank_stream, tmp_path_factory):
    return run_ranks(torch_ranks.nlinv_global_and_stream_rank, NRANKS,
                     device="cpu",
                     args=(data, 3, 10, movie, one_rank_stream[2]),
                     timeout=240, store_dir=tmp_path_factory.mktemp("store"))


def test_make_dist_reconstruct_global_form(global_and_stream, ranks):
    """Every rank passes the global inputs and gets containers back: the
    same frame as the Reconstructor's, ``rho`` and ``chat`` whole."""
    case = SHALLOW[0]
    for out in global_and_stream:
        np.testing.assert_array_equal(out["img"], ranks[0][case]["img"])
        np.testing.assert_array_equal(out["chat"], ranks[0][case]["chat"])
        assert out["rho"].shape == (48, 48)


def test_frame_stream_over_four_ranks(global_and_stream, one_rank_stream):
    """``FrameStream`` on every rank: each uploads its coil of every
    frame, keeps its (1, X, Y) segment of the carry, and the movie is the
    1-rank stream's within 1e-5."""
    want, rep, _, rec = one_rank_stream
    assert rep.summary()["devices"] == 1
    for out in global_and_stream:
        assert out["devices"] == NRANKS
        assert out["log"] == rec.cg_log[:len(out["log"])] and \
            len(out["log"]) == 2 * 3
        assert out["carry"] == {"rho": (32, 32), "chat": (1, 32, 32)}
        rel = float(np.abs(out["movie"] - want).max() / np.abs(want).max())
        assert rel <= SHALLOW_TOL, rel


def test_stream_resumes_from_a_global_numpy_carry(global_and_stream,
                                                  one_rank_stream):
    """``convert.segmented_from_numpy`` turns a global numpy carry (frame
    0's) into each rank's segmented carry; the 4 ranks' resumed frame 1
    is the 1-rank stream's, and ``segmented_to_numpy`` gives the carry
    back."""
    want, _, carry, _ = one_rank_stream
    for out in global_and_stream:
        rel = float(np.abs(out["resumed"][0] - want[1]).max() /
                    np.abs(want[1]).max())
        assert rel <= SHALLOW_TOL, rel
        for part in carry:
            for k in carry[part]:
                np.testing.assert_array_equal(out["carry_back"][part][k],
                                              carry[part][k])
