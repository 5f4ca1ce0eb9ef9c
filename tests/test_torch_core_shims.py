"""The deprecated free functions of ``repro_torch.core`` against the JAX
package's (``repro/core/__init__.py``'s shims).

* each of the 18 shims warns ``DeprecationWarning`` and names its
  replacement in ``__deprecated__``; ``hierarchical_psum`` is a plain
  primitive in both packages;
* on one rank each shim gives the JAX shim's result on the same numpy
  inputs; ``all_reduce``, ``gather``, ``vdot`` and ``copy`` also on 4
  gloo ranks against the JAX shims on 4 host devices;
* a frame of the port run with ``-W error::DeprecationWarning`` calls
  no shim.
"""

import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
import torch_ranks
from helpers import REPO, run_with_devices
from repro_torch.core import Communicator, Policy, run_ranks

SHIMS = ["current_group", "segment", "gather", "overlap2d_map",
         "broadcast", "scatter", "reduce", "all_reduce", "all_reduce_window",
         "vdot", "copy", "all_to_all", "reduce_scatter", "invoke_kernel",
         "invoke_kernel_all", "make_spmd", "barrier", "barrier_fence"]

rng = np.random.default_rng(28)
X = rng.standard_normal((8, 6)).astype(np.float32)
Y = rng.standard_normal((8, 6)).astype(np.float32)
C = (rng.standard_normal((4, 8)) + 1j * rng.standard_normal((4, 8))
     ).astype(np.complex64)
D = (rng.standard_normal((4, 8)) + 1j * rng.standard_normal((4, 8))
     ).astype(np.complex64)


def test_the_shims_are_the_references():
    assert sorted(SHIMS) == sorted(
        n for n in jcore.__all__
        if hasattr(getattr(jcore, n), "__deprecated__"))
    assert not hasattr(core.hierarchical_psum, "__deprecated__")
    assert not hasattr(jcore.hierarchical_psum, "__deprecated__")


@pytest.mark.parametrize("name", SHIMS)
def test_shim_warns_and_names_its_replacement(name):
    shim = getattr(core, name)
    assert shim.__deprecated__ == getattr(jcore, name).__deprecated__
    comm = Communicator.single("cpu")
    with pytest.warns(DeprecationWarning, match=f"core.{name} is "
                                                f"deprecated"):
        CALLS[name][0](comm)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "gather") and not isinstance(x, np.ndarray):
        return np.asarray(x.gather())
    return np.asarray(x)


# name -> (port call on a 1-rank communicator, JAX call on its default
# group of one host device); both return something numpy takes
CALLS = {
    "current_group": (lambda c: core.current_group(c).size,
                      lambda: jcore.current_group().ndev),
    "segment": (lambda c: core.segment(X, c),
                lambda: jcore.segment(X)),
    "gather": (lambda c: core.gather(c.container(X)),
               lambda: jcore.gather(jcore.segment(X))),
    "overlap2d_map": (
        lambda c: core.overlap2d_map(
            c.container(X, policy=Policy.OVERLAP2D, halo=1), None),
        lambda: jcore.overlap2d_map(
            jcore.segment(X, policy=jcore.Policy.OVERLAP2D, halo=1), None)),
    "broadcast": (lambda c: core.broadcast(X, c),
                  lambda: jcore.broadcast(X)),
    "scatter": (lambda c: core.scatter(X, c, dim=1),
                lambda: jcore.scatter(X, dim=1)),
    "reduce": (lambda c: core.reduce(c.container(X), "max"),
               lambda: jcore.reduce(jcore.segment(X), "max")),
    "all_reduce": (lambda c: core.all_reduce(c.container(X)),
                   lambda: jcore.all_reduce(jcore.segment(X))),
    "all_reduce_window": (
        lambda c: core.all_reduce_window(c.container(X), ((2, 6), (1, 5))),
        lambda: jcore.all_reduce_window(jcore.segment(X), ((2, 6), (1, 5)))),
    "vdot": (lambda c: core.vdot(c.container(C), c.container(D)),
             lambda: jcore.vdot(jcore.segment(C), jcore.segment(D))),
    "copy": (lambda c: core.copy(c.container(X), policy=Policy.CLONE),
             lambda: jcore.copy(jcore.segment(X),
                                policy=jcore.Policy.CLONE)),
    "all_to_all": (lambda c: core.all_to_all(c.container(X), 1),
                   lambda: jcore.all_to_all(jcore.segment(X), 1)),
    "reduce_scatter": (lambda c: core.reduce_scatter(c.container(X)),
                       lambda: jcore.reduce_scatter(jcore.segment(X))),
    "invoke_kernel": (
        lambda c: core.invoke_kernel(lambda a: a * 3, c.container(X),
                                     rank=0, group=c),
        lambda: jcore.invoke_kernel(lambda a: a * 3, jcore.segment(X),
                                    rank=0)),
    "invoke_kernel_all": (
        lambda c: core.invoke_kernel_all(lambda a, b: a + b,
                                         c.container(X), c.container(Y),
                                         group=c),
        lambda: jcore.invoke_kernel_all(lambda a, b: a + b,
                                        jcore.segment(X), jcore.segment(Y))),
    "make_spmd": (
        lambda c: core.make_spmd(lambda a: a * 2, c,
                                 in_policies=(Policy.NATURAL,),
                                 out_policies=Policy.NATURAL)(X),
        lambda: jcore.make_spmd(lambda a: a * 2,
                                in_policies=(jcore.Policy.NATURAL,),
                                out_policies=jcore.Policy.NATURAL)(X)),
    "barrier": (lambda c: core.barrier(c) is None,
                lambda: jcore.barrier() is None),
    "barrier_fence": (
        lambda c: core.barrier_fence(torch.from_numpy(X), group=c),
        lambda: jcore.barrier_fence(np.asarray(X))),
}


@pytest.mark.parametrize("name", SHIMS)
def test_shim_matches_the_jax_shim_on_one_rank(name):
    port, ref = CALLS[name]
    comm = Communicator.single("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got, want = _np(port(comm)), _np(ref())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


JAX_SHIMS = """
import pickle, warnings
import repro.core as jcore
inp = pickle.load(open(IN, "rb"))
warnings.simplefilter("ignore", DeprecationWarning)
seg, other = jcore.segment(inp["x"]), jcore.segment(inp["y"])
out = {"all_reduce": np.asarray(jcore.all_reduce(seg).gather()),
       "gather": np.asarray(jcore.gather(seg)),
       "vdot": complex(jcore.vdot(seg, other)),
       "copy": np.asarray(jcore.copy(seg, policy=jcore.Policy.CLONE)
                          .gather())}
pickle.dump(out, open(OUT, "wb"))
"""


def test_shims_on_four_ranks_match_the_jax_shims(tmp_path):
    inp = {"x": X, "y": Y}
    ranks = run_ranks(torch_ranks.shim_verbs, 4, device="cpu", args=(inp,),
                      timeout=120, store_dir=tmp_path)
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps(inp))
    run_with_devices(f"IN, OUT = {str(src)!r}, {str(dst)!r}\n" + JAX_SHIMS,
                     ndev=4)
    want = pickle.loads(dst.read_bytes())
    for r in ranks:
        np.testing.assert_allclose(r["gather"], want["gather"], rtol=1e-6)
        np.testing.assert_allclose(r["all_reduce"], want["all_reduce"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["copy"], want["copy"], rtol=1e-6)
        assert abs(r["vdot"] - want["vdot"]) <= 1e-5 * abs(want["vdot"])


FRAME = """
import numpy as np
from repro_torch.nlinv.phantom import make_dataset
from repro_torch.nlinv.recon import reconstruct_movie
from repro_torch.nlinv.gridding import radial_ops
data = make_dataset(n=8, ncoils=2, nspokes=5, frames=2, seed=0)
img = reconstruct_movie(data, newton=2, cg_iters=3, device="cpu")
assert np.isfinite(img.numpy()).all()
ops = radial_ops(16, 3, device="cpu")
print("frame ok")
"""


def test_a_frame_calls_no_shim():
    r = subprocess.run([sys.executable, "-W", "error::DeprecationWarning",
                        "-c", FRAME], capture_output=True, text=True,
                       timeout=300, cwd=str(REPO),
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and "frame ok" in r.stdout, r.stderr[-3000:]
