"""The port's segmented ``lib.blas`` against the JAX package's, on the CPU.

CG-state pytrees ``{rho: CLONE (8, 8), chat: NATURAL (6, 8, 8)}`` (J = 6
padded to 8 over 4 ranks), complex64 from one numpy seed.  Four gloo rank
processes run every level-1 form once (``torch_ranks.blas_rank``); the
JAX package's ``lib.blas`` runs the same forms on 4 host devices in one
subprocess (its single-container forms leaf by leaf, their scalars
summed).  Vectors and scalars agree within the ``cg_fused`` specs'
tolerance 1e-4 in the registry harness's form (rtol = 10 tol, atol =
tol), and every rank gets the same scalar bits.  A 1-rank communicator
runs the same program against numpy, and the plans are cached by layout.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_ranks
from helpers import run_with_devices
from repro_torch.core import Communicator, run_ranks
from repro_torch.kernels import registry
from repro_torch.lib import blas

NRANKS = 4
TOL = registry.get("xpby_dot").tol
KEYS = ("chat", "rho")


def _inputs():
    rng = np.random.default_rng(31)

    def c(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    inp = {"a": 0.37, "b": np.float32(0.61)}
    for name in "xyzw":
        inp[f"{name}_rho"] = c(8, 8)
        inp[f"{name}_chat"] = c(6, 8, 8)
    return inp


INPUTS = _inputs()

JAX_BLAS = """
import pickle
from repro.core import Environment, Policy
from repro.lib import blas
inp = pickle.load(open(IN, "rb"))
comm = Environment().subgroup(4)
def tree(p):
    return {"rho": comm.container(inp[p + "rho"], policy=Policy.CLONE),
            "chat": comm.container(inp[p + "chat"])}
x, y, z, w = tree("x_"), tree("y_"), tree("z_"), tree("w_")
a, b = jnp.float32(inp["a"]), jnp.float32(inp["b"])
K = ("chat", "rho")
def g(t):
    return {k: np.asarray(t[k].gather()) for k in K}
out = {"axpy": {k: np.asarray(blas.axpy(a, x[k], y[k]).gather()) for k in K},
       "dot": sum(complex(blas.dot(x[k], y[k])) for k in K),
       "norm2": sum(float(blas.norm2(x[k])) for k in K),
       "dot_allreduce": complex(blas.dot_allreduce(x["chat"], y["chat"])),
       "dot_allreduce_clone": complex(blas.dot_allreduce(x["rho"], y["rho"]))}
pairs = {k: blas.axpy_dot(a, x[k], y[k], z[k]) for k in K}
out["axpy_dot"] = ({k: np.asarray(pairs[k][0].gather()) for k in K},
                   sum(complex(pairs[k][1]) for k in K))
pairs = {k: blas.axpy_norm2(a, x[k], y[k]) for k in K}
out["axpy_norm2"] = ({k: np.asarray(pairs[k][0].gather()) for k in K},
                     sum(float(pairs[k][1]) for k in K))
wv, d = blas.xpby_dot(x, y, b)
out["xpby_dot"] = (g(wv), float(d))
x2, r2, rs = blas.cg_update(a, x, y, z, w)
out["cg_update"] = (g(x2), g(r2), float(rs))
out["single_leaf"] = float(blas.xpby_dot(x["chat"], y["chat"], b)[1])
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(torch_ranks.blas_rank, NRANKS, device="cpu",
                     args=(INPUTS,), timeout=120,
                     store_dir=tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_blas")
    src, dst = d / "in.pkl", d / "out.pkl"
    src.write_bytes(pickle.dumps(INPUTS))
    run_with_devices(f"IN, OUT = {str(src)!r}, {str(dst)!r}\n" + JAX_BLAS,
                     ndev=NRANKS)
    return pickle.loads(dst.read_bytes())


def _close(got, want):
    if isinstance(want, dict):
        for k in KEYS:
            _close(got[k], want[k])
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=10 * TOL, atol=TOL)


@pytest.mark.parametrize("op", ["axpy", "dot", "norm2", "axpy_dot",
                                "axpy_norm2", "xpby_dot", "cg_update",
                                "dot_allreduce", "dot_allreduce_clone",
                                "single_leaf"])
def test_segmented_blas_matches_jax(port, jax_out, op):
    for out in port:
        _close(out[op], jax_out[op])


def _scalars(x):
    if isinstance(x, tuple):
        return [v for p in x for v in _scalars(p)]
    if isinstance(x, dict):
        return []
    return [np.asarray(x).tobytes()]


def test_ranks_get_the_same_scalar_bits(port):
    """One collective a reduction hands every rank the same bits (a CG
    loop steered by them stays in step on every rank)."""
    for op in ("dot", "norm2", "axpy_dot", "xpby_dot", "cg_update",
               "dot_allreduce"):
        for out in port[1:]:
            assert _scalars(out[op]) == _scalars(port[0][op]), op
    assert all(out["xpby_dot_launches"] == 0 for out in port)  # the CPU


def test_one_rank_runs_the_same_program():
    out = torch_ranks.blas_on(Communicator.single("cpu"), INPUTS)
    x = {k: INPUTS[f"x_{k}"] for k in KEYS}
    y = {k: INPUTS[f"y_{k}"] for k in KEYS}
    a, b = INPUTS["a"], INPUTS["b"]
    _close(out["axpy"], {k: a * x[k] + y[k] for k in KEYS})
    _close(out["dot"], sum(np.vdot(x[k], y[k]) for k in KEYS))
    w = {k: x[k] + b * y[k] for k in KEYS}
    _close(out["xpby_dot"], (w, sum(np.vdot(v, v).real for v in w.values())))
    _close(out["dot_allreduce"], np.vdot(x["chat"], y["chat"]))


def test_operands_must_be_alike_containers():
    comm = Communicator.single("cpu")
    x = comm.container(INPUTS["x_chat"])
    y = comm.container(INPUTS["y_chat"])
    with pytest.raises(ValueError, match="SegmentedArrays"):
        blas.xpby_dot(torch.zeros(2), torch.zeros(2), 0.5)
    with pytest.raises(ValueError, match="structure"):
        blas.dot({"chat": x}, {"rho": y})
    with pytest.raises(ValueError, match="two SegmentedArrays"):
        blas.dot_allreduce(x, y.data)
