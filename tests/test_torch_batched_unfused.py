"""The port's unfused batched NLINV frame against the JAX package's, on the
CPU: ``Reconstructor(fused=False).fn_batched(width)`` against the JAX
``fn_batched``, which vmaps the unfused ``_frame`` (each row's CG under
the vmapped ``while_loop``: the loop runs until every row stops, a
stopped row keeps its state).

At ``tests/test_serve_scheduler.py``'s size (n = 16, 4 coils, 7 spokes,
seeds 0-2), newton 2, cg 6, widths 2 and 3:

* one rank (in this process, JAX on one host device): every row's image
  and state within 1e-5 of JAX's, and within 1e-5 of the port's own
  unbatched unfused frame of that client;
* a row fed NaN samples stops where the vmapped JAX row stops (its CG
  never starts, so it returns the carry it was given, as JAX's does)
  while the other rows are bitwise the clean batch's;
* four gloo ranks (one coil each; one set of rank processes,
  ``torch_ranks.unfused_batched_rank``), against JAX on 4 host devices (one
  subprocess): within 1e-5, every rank's image and ``rho`` bitwise alike,
  each row within 1e-5 of its client's own 4-rank unfused frame.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from helpers import run_with_devices
from repro.nlinv.recon import Reconstructor as JReconstructor
from repro_torch.core import Communicator, run_ranks
from repro_torch.nlinv import phantom
from repro_torch.nlinv.operators import sobolev_weight

K, NCOILS, NEWTON, CG = 3, 4, 2, 6
WIDTHS = (2, 3)
TOL = 1e-5            # the reference's stream and serve parity
NAN_ROW = 1
NRANKS = 4


@pytest.fixture(scope="module")
def datas():
    return [phantom.make_dataset(n=16, ncoils=NCOILS, nspokes=7, frames=1,
                                 seed=s) for s in range(K)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_batched(datas, width, nan_row=None):
    """JAX's unfused batched frame on one host device: (u, images)."""
    g = datas[0]["grid"]
    ys = np.stack([d["y"][0] for d in datas[:width]])
    if nan_row is not None:
        ys[nan_row] = np.nan
    jr = JReconstructor(None, newton=NEWTON, cg_iters=CG, fused=False)
    u0 = {"rho": jnp.ones((width, g, g), jnp.complex64),
          "chat": jnp.zeros((width, NCOILS, g, g), jnp.complex64)}
    u, img = jr.fn_batched(width)(
        jnp.asarray(ys), jnp.asarray(np.stack([d["masks"][0]
                                               for d in datas[:width]])),
        jnp.asarray(datas[0]["fov"]), jnp.asarray(sobolev_weight(g)), u0,
        jax.tree.map(lambda a: a + 0, u0))
    return jax.tree.map(np.asarray, u), np.asarray(img)


@pytest.fixture(scope="module")
def one_rank(datas):
    comm = Communicator.single("cpu")
    out = {w: torch_ranks.unfused_batched_on(comm, datas, w, NEWTON, CG)
           for w in WIDTHS}
    out["nan"] = torch_ranks.unfused_batched_on(comm, datas, K, NEWTON, CG,
                                                nan_row=NAN_ROW)
    return out


@pytest.mark.parametrize("width", WIDTHS)
def test_one_rank_matches_jax(datas, one_rank, width):
    ju, jimg = _jax_batched(datas, width)
    got = one_rank[width]
    assert got["img"].shape == (width, 32, 32)
    for b in range(width):
        assert _rel(got["img"][b], jimg[b]) <= TOL
        assert _rel(got["rho"][b], ju["rho"][b]) <= TOL
        assert _rel(got["chat"][b], ju["chat"][b]) <= TOL


@pytest.mark.parametrize("width", WIDTHS)
def test_one_rank_rows_match_the_unbatched_frame(one_rank, width):
    got = one_rank[width]
    for b, own in enumerate(got["own"]):
        assert _rel(got["img"][b], own["img"]) <= TOL
        assert _rel(got["rho"][b], own["rho"]) <= TOL


def test_nan_row_stops_as_the_vmapped_jax_row(datas, one_rank):
    ju, jimg = _jax_batched(datas, K, nan_row=NAN_ROW)
    got, clean = one_rank["nan"], one_rank[K]
    # the NaN row's CG never starts: the row keeps the carry it was given
    np.testing.assert_array_equal(ju["rho"][NAN_ROW], 1)
    np.testing.assert_array_equal(ju["chat"][NAN_ROW], 0)
    np.testing.assert_array_equal(got["rho"][NAN_ROW], ju["rho"][NAN_ROW])
    np.testing.assert_array_equal(got["chat"][NAN_ROW],
                                  ju["chat"][NAN_ROW])
    np.testing.assert_array_equal(got["img"][NAN_ROW], jimg[NAN_ROW])
    for b in range(K):
        if b == NAN_ROW:
            continue
        np.testing.assert_array_equal(got["img"][b], clean["img"][b])
        np.testing.assert_array_equal(got["rho"][b], clean["rho"][b])
        assert _rel(got["img"][b], jimg[b]) <= TOL


JAX_FOUR = """
import pickle
from repro.core import DeviceGroup
from repro.nlinv import phantom
from repro.nlinv.operators import sobolev_weight
from repro.nlinv.recon import Reconstructor
datas = [phantom.make_dataset(n=16, ncoils=NCOILS, nspokes=7, frames=1,
                              seed=s) for s in range(K)]
g = datas[0]["grid"]
rec = Reconstructor(DeviceGroup.all_devices((4,), ("data",)), newton=NEWTON,
                    cg_iters=CG, channel_sum="crop", fused=False)
out = {}
for width in WIDTHS:
    u0 = {"rho": jnp.ones((width, g, g), jnp.complex64),
          "chat": jnp.zeros((width, NCOILS, g, g), jnp.complex64)}
    u, img = rec.fn_batched(width)(
        jnp.asarray(np.stack([d["y"][0] for d in datas[:width]])),
        jnp.asarray(np.stack([d["masks"][0] for d in datas[:width]])),
        jnp.asarray(datas[0]["fov"]), jnp.asarray(sobolev_weight(g)), u0,
        jax.tree.map(lambda a: a + 0, u0))
    out[width] = (np.asarray(img), np.asarray(u["rho"]))
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def jax_four(tmp_path_factory):
    dst = tmp_path_factory.mktemp("jax_four") / "out.pkl"
    head = (f"OUT = {str(dst)!r}\nK, NCOILS, NEWTON, CG = {K}, {NCOILS}, "
            f"{NEWTON}, {CG}\nWIDTHS = {WIDTHS!r}\n")
    run_with_devices(head + JAX_FOUR, ndev=NRANKS)
    return pickle.loads(dst.read_bytes())


@pytest.fixture(scope="module")
def four_ranks(datas, tmp_path_factory):
    return run_ranks(torch_ranks.unfused_batched_rank, NRANKS, device="cpu",
                     args=(datas, [(w, NEWTON, CG) for w in WIDTHS]),
                     timeout=240, store_dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("width", WIDTHS)
def test_four_ranks_match_jax(four_ranks, jax_four, width):
    jimg, jrho = jax_four[width]
    for out in four_ranks:
        got = out[(width, NEWTON, CG)]
        for b in range(width):
            assert _rel(got["img"][b], jimg[b]) <= TOL
            assert _rel(got["rho"][b], jrho[b]) <= TOL


@pytest.mark.parametrize("width", WIDTHS)
def test_four_ranks_agree_bitwise(four_ranks, width):
    first = four_ranks[0][(width, NEWTON, CG)]
    assert first["chat"].shape == (width, 1, 32, 32)
    for out in four_ranks[1:]:
        assert out[(width, NEWTON, CG)]["bits"] == first["bits"]


@pytest.mark.parametrize("width", WIDTHS)
def test_four_ranks_rows_match_their_own_frame(four_ranks, width):
    got = four_ranks[0][(width, NEWTON, CG)]
    for b, own in enumerate(got["own"]):
        assert _rel(got["img"][b], own["img"]) <= TOL
        assert _rel(got["rho"][b], own["rho"]) <= TOL
