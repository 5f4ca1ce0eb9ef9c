"""The port's transfer schedules against numpy and the JAX package, on the
CPU: ``tests/test_transfer_schedules.py``'s parity body on 1, 2 and 4
ranks.

One set of 4 gloo rank processes runs it on the first 2 ranks and on all
4 (``torch_ranks.schedules_rank``), this process on a 1-rank
communicator; the JAX package runs the same body on 1, 2 and 4 of 4 host
devices in one subprocess.  Every schedule that the auto choice would
not take on the CPU (ranks sharing memory) is forced through
``comm.BCAST_SCHEDULE``/``comm.REDUCE_SCHEDULE``, so both sides of each
decision run.  Data movement (broadcast, every copy route, the FFT's
container metadata) must match numpy, the ``rebuild`` fallback (values,
metadata, and the local segment where the padding agrees) and the JAX
package exactly; sums within
1e-5 (float32 sums in another order; the 32 x 32 products of the k-split
GEMM within 1e-4 of float64 numpy, JAX's own test allows 1e-3).
"""

import pickle

import numpy as np
import pytest

import torch_ranks
from helpers import run_with_devices
from repro_torch.core import Communicator, run_ranks

SIZES = (1, 2, 4)
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)

    def c(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": c(64, 65), "xs": f(64, 5), "xp": f(13, 8), "xu": f(12, 3),
            "xo": f(16, 16), "xr": f(4, 32, 32), "A": f(32, 32),
            "B": f(32, 32), "Ga": f(8, 6, 5), "Gb": f(8, 5, 7),
            "xf": c(4, 16, 16), "xv": c(2, 16, 6)}


INPUTS = _inputs()

COPIES = {"replicate": ("xs", "NATURAL", dict(policy="CLONE")),
          "clone_split": ("xs", "CLONE", dict(policy="NATURAL")),
          "clone_split_block": ("xs", "CLONE", dict(policy="BLOCK", block=2)),
          "alltoall": ("xs", "NATURAL", dict(dim=1)),
          "block_pack": ("xs", "NATURAL", dict(policy="BLOCK", block=2)),
          "block_unpack": ("xs", "BLOCK", dict(policy="NATURAL")),
          "replicate_padded": ("xp", "NATURAL", dict(policy="CLONE")),
          "clone_split_padded": ("xp", "CLONE", dict(policy="NATURAL")),
          "alltoall_padded": ("xp", "NATURAL", dict(dim=1)),
          "unaligned": ("xu", "NATURAL", dict(policy="BLOCK", block=2))}

JAX_SCHEDULES = """
import pickle
import repro.core.comm as C
import repro.lib.blas as B
import repro.lib.fft as F
from repro.core.runtime import DeviceGroup
from repro.core.segmented import Policy, segment, gather
inp = pickle.load(open(IN, "rb"))
copies = pickle.load(open(COPIES, "rb"))
res = {}
for n in (1, 2, 4):
    g = DeviceGroup.subset(n)
    out = res[n] = {}
    for name, (key, pol, kw) in copies.items():
        src = segment(inp[key], g, policy=Policy.BLOCK, block=2) \\
            if pol == "BLOCK" else segment(inp[key], g)
        if pol == "CLONE":
            src = C.copy(src, policy=Policy.CLONE)
        kw = {k: Policy[v] if k == "policy" else v for k, v in kw.items()}
        got = C.copy(src, **kw)
        out["copy_" + name] = (C.copy_route(src, **kw),
                               np.asarray(gather(got)),
                               (got.policy.value, got.dim, got.block,
                                got.orig_len, tuple(got.global_shape)))
    sr = segment(inp["xr"], g)
    for sched in ("psum", "rs_ag"):
        C.REDUCE_SCHEDULE = sched
        out["reduce_" + sched] = (C.plan_reduce(sr).meta["schedule"],
                                  np.asarray(C.reduce(sr)))
        sa, sb = segment(inp["A"], g, dim=1), segment(inp["B"], g)
        out["gemm_" + sched] = (B.gemm_ksplit_schedule(sa, sb),
                                np.asarray(B.gemm_ksplit(sa, sb).data))
    C.REDUCE_SCHEDULE = None
    for op in ("sum", "max", "min"):
        out["reduce_scatter_" + op] = (
            np.asarray(gather(C.reduce_scatter(sr, op=op))),
            C.plan_reduce_scatter(sr, op).meta["schedule"])
    out["gemm_batched"] = np.asarray(gather(B.gemm_batched(
        segment(inp["Ga"], g), segment(inp["Gb"], g))))
    for name, seg in (("fft_dim0", segment(inp["xf"], g)),
                      ("fft_dim1", segment(inp["xf"], g, dim=1)),
                      ("fft_dim2", segment(inp["xf"], g, dim=2)),
                      ("fft_overlap2d", segment(inp["xf"], g, dim=1,
                                                policy=Policy.OVERLAP2D,
                                                halo=1)),
                      ("fft_fallback", segment(inp["xv"], g, dim=1))):
        plan = F.plan_fft2_batched(seg)
        out[name] = (plan.meta["schedule"], np.asarray(gather(plan(seg))))
pickle.dump(res, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each group size's results on every rank: {n: [rank 0's, ...]}."""
    ranks = run_ranks(torch_ranks.schedules_rank, 4, device="cpu",
                      args=(INPUTS,), timeout=180,
                      store_dir=tmp_path_factory.mktemp("store"))
    return {1: [torch_ranks.schedules_on(Communicator.single("cpu"),
                                         INPUTS)],
            2: [r[2] for r in ranks[:2]], 4: [r[4] for r in ranks]}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_schedules")
    src, copies, dst = d / "in.pkl", d / "copies.pkl", d / "out.pkl"
    src.write_bytes(pickle.dumps(INPUTS))
    copies.write_bytes(pickle.dumps(COPIES))
    run_with_devices(f"IN, COPIES, OUT = {str(src)!r}, {str(copies)!r}, "
                     f"{str(dst)!r}\n" + JAX_SCHEDULES, ndev=4)
    return pickle.loads(dst.read_bytes())


def _routes(n):
    """The route the JAX package's ``copy_route`` names for each case."""
    unaligned = 12 % (2 * n) != 0 or (12 // (2 * n)) % n != 0
    return {"replicate": "replicate", "clone_split": "clone_split",
            "clone_split_block": "clone_split", "alltoall": "alltoall",
            "block_pack": "block_pack", "block_unpack": "block_unpack",
            "replicate_padded": "replicate",
            "clone_split_padded": "clone_split",
            "alltoall_padded": "alltoall",
            "unaligned": "rebuild" if unaligned else "block_pack"}


@pytest.mark.parametrize("n", SIZES)
def test_broadcast_schedules(port, n):
    """Both schedules hand every rank rank 0's array bit for bit (the
    others passed zeros)."""
    for out in port[n]:
        for sched in ("device_put", "scatter_allgather"):
            policy, got = out[f"bcast_{sched}"]
            assert policy == "clone"
            np.testing.assert_array_equal(got, INPUTS["x"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(COPIES))
def test_copy_routes_match_rebuild_and_jax(port, jax_out, n, case):
    """Each route's container equals the ``rebuild`` fallback's (the
    logical array, the metadata, and this rank's segment wherever both
    have one padded length: a direct route keeps the source's padding,
    as the JAX package's do) and the JAX package's (route, logical
    array, metadata)."""
    key = COPIES[case][0]
    jroute, jgather, jmeta = jax_out[n][f"copy_{case}"]
    assert jroute == _routes(n)[case]
    for out in port[n]:
        got = out[f"copy_{case}"]
        assert got["route"] == jroute
        np.testing.assert_array_equal(got["gather"], INPUTS[key])
        np.testing.assert_array_equal(got["gather"], jgather)
        np.testing.assert_array_equal(got["gather"], got["ref_gather"])
        assert got["meta"][:5] == got["ref_meta"][:5], (got["meta"],
                                                        got["ref_meta"])
        if got["meta"][5] == got["ref_meta"][5]:
            np.testing.assert_array_equal(got["local"], got["ref_local"])
        else:
            assert case == "replicate_padded" and n > 1
        policy, dim, block, orig, gshape = jmeta
        assert got["meta"][:4] == (policy, dim, block, orig)
        assert got["meta"][5] == gshape


@pytest.mark.parametrize("n", SIZES)
def test_relabels_move_nothing(port, n):
    """A halo-only OVERLAP2D change and a same-layout copy are metadata
    only; a CLONE copy to itself aliases."""
    for out in port[n]:
        assert out["halo_only"] == ("meta", True, 3, "meta", True, "alias",
                                    True)


@pytest.mark.parametrize("n", SIZES)
def test_reduce_schedules(port, jax_out, n):
    """``psum`` and ``rs_ag`` (forced) against numpy, each other and the
    JAX package; ``rs_ag`` is taken wherever the rows tile over a group
    of more than one rank, as in JAX."""
    want = INPUTS["xr"].sum(0)
    for out in port[n]:
        for sched in ("psum", "rs_ag"):
            name, red, full = out[f"reduce_{sched}"]
            jname, jred = jax_out[n][f"reduce_{sched}"]
            assert name == jname == (sched if n > 1 else "psum")
            np.testing.assert_allclose(red, want, atol=TOL)
            np.testing.assert_allclose(full, want, atol=TOL)
            np.testing.assert_allclose(red, jred, atol=TOL)
        np.testing.assert_allclose(out["reduce_psum"][1],
                                   out["reduce_rs_ag"][1], atol=TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_reduce_scatter(port, jax_out, n, op):
    want = getattr(INPUTS["xr"], op)(0)
    jgot, jsched = jax_out[n][f"reduce_scatter_{op}"]
    for out in port[n]:
        policy, got, sched = out[f"reduce_scatter_{op}"]
        assert policy == "natural" and sched == jsched
        np.testing.assert_allclose(got, want, atol=TOL)
        np.testing.assert_allclose(got, jgot, atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_gemms(port, jax_out, n):
    """``gemm_ksplit`` under both reductions and ``gemm_batched`` against
    numpy in float64 and the JAX package."""
    want = INPUTS["A"].astype(np.float64) @ INPUTS["B"]
    for out in port[n]:
        for sched in ("psum", "rs_ag"):
            name, got = out[f"gemm_{sched}"]
            jname, jgot = jax_out[n][f"gemm_{sched}"]
            assert name == jname == (sched if n > 1 else "psum")
            np.testing.assert_allclose(got, want, atol=1e-4)
            np.testing.assert_allclose(got, jgot, atol=1e-4)
        batched = out["gemm_batched"]
        np.testing.assert_allclose(
            batched, np.matmul(INPUTS["Ga"], INPUTS["Gb"]), atol=TOL)
        np.testing.assert_allclose(batched, jax_out[n]["gemm_batched"],
                                   atol=TOL)


FFTS = {"fft_dim0": ("xf", "local"), "fft_dim1": ("xf", "fused_transpose"),
        "fft_dim2": ("xf", "fused_transpose"),
        "fft_overlap2d": ("xf", "fused_transpose"),
        "fft_fallback": ("xv", None)}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(FFTS))
def test_fft2_batched(port, jax_out, n, case):
    """The batched FFT of a container with the segmented dim outside the
    plane (local) and inside it (the fused transpose, or the verbs where
    the other axis of 6 does not tile), against numpy's and the JAX
    package's; the container's metadata comes back unchanged."""
    key, sched = FFTS[case]
    if sched is None:
        sched = "verbs" if 6 % n else "fused_transpose"
    want = np.fft.fft2(INPUTS[key], axes=(-2, -1), norm="ortho")
    jsched, jgot = jax_out[n][case]
    for out in port[n]:
        name, got, same_meta = out[case]
        assert name == jsched == sched
        assert same_meta
        np.testing.assert_allclose(got, want, atol=TOL)
        np.testing.assert_allclose(got, jgot, atol=TOL)
        assert out["fft_steady_builds"] == 0
