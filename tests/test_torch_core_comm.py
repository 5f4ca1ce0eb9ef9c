"""The port's multi-rank core against numpy and the JAX package, on the CPU.

Four gloo rank processes (``repro_torch.core.run_ranks``, spawned, one
``FileStore``) run every ported verb once (``torch_ranks.comm_verbs``);
the JAX package's ``Communicator`` runs the same verbs on 4 host devices
in one subprocess (``helpers.run_with_devices``).  Both start from the
same numpy inputs.  Containers and data movement must match exactly;
reductions within 1e-5 (float32 sums in another order).  A 1-rank
communicator without a process group runs the same program in this
process, with no-op collectives.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_ranks
from helpers import run_with_devices
from repro_torch.core import (Communicator, DeviceGroup, Environment,
                              Policy, run_ranks)
from repro_torch.core import env as core_env
from repro_torch.core.segmented import _block_cyclic_perm

NRANKS = 4
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(21)

    def c(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"nat": f(6, 5), "blk": f(10, 3), "cln": f(5, 4),
            "stack": f(4, 8, 8), "rho": c(3, 3), "rho2": c(3, 3),
            "chat": c(6, 3, 3), "chat2": c(6, 3, 3), "ovl": c(4, 8, 8),
            "e_re": f(4), "e_c": c(4),
            "mask": (rng.random((8, 8)) > 0.4).astype(np.float32)}


INPUTS = _inputs()

JAX_VERBS = """
import pickle
from repro.core import Environment, Policy
inp = pickle.load(open(IN, "rb"))
comm = Environment().subgroup(4)
out = {}
segs = {"nat": comm.container(inp["nat"]),
        "blk": comm.container(inp["blk"], policy=Policy.BLOCK, block=2),
        "cln": comm.container(inp["cln"], policy=Policy.CLONE)}
for k, s in segs.items():
    out[k + "_gather"] = np.asarray(comm.gather(s))
    out[k + "_segments"] = s.segments()
    out[k + "_seg_len"] = [s.seg_len(i) for i in range(4)]
    out[k + "_global_shape"] = tuple(s.global_shape)
nat = segs["nat"]
out["allreduce"] = np.asarray(comm.allreduce(nat).data)
out["reduce_max"] = np.asarray(comm.reduce(nat, "max"))
out["allgather"] = np.asarray(comm.allgather(segs["blk"]).data)
stack = comm.container(inp["stack"])
out["window"] = np.asarray(comm.allreduce_window(stack, ((2, 6), (2, 6))).data)
u = {"rho": comm.container(inp["rho"], policy=Policy.CLONE),
     "chat": comm.container(inp["chat"])}
v = {"rho": comm.container(inp["rho2"], policy=Policy.CLONE),
     "chat": comm.container(inp["chat2"])}
out["vdot_eager"] = complex(comm.vdot(u, v))
out["shift"] = np.asarray(comm.shift(nat, 1).data)
out["shift_open"] = np.asarray(comm.shift(nat, -1, wrap=False).data)
out["send_recv"] = np.asarray(comm.send_recv(
    nat, [(i, 3 - i) for i in range(4)]).data)
out["send_recv_partial"] = np.asarray(comm.send_recv(nat, [(0, 3)]).data)

def body(x, er, ec):
    red, ex, _ = comm.allreduce_overlap(
        x[0], ((2, 6), (2, 6)), axis=comm.axis, extras=(er[0], ec[0]),
        compute=lambda: jnp.ones(2))
    return red, ex[0], ex[1]
prog = comm.spmd(body, in_policies=(Policy.NATURAL,) * 3,
                 out_policies=(Policy.CLONE,) * 3, check_vma=False)
red, e0, e1 = prog(jnp.asarray(inp["ovl"]), jnp.asarray(inp["e_re"]),
                   jnp.asarray(inp["e_c"]))
out["ovl_psum"] = (np.asarray(red), np.asarray(e0), np.asarray(e1))
pickle.dump(out, open(OUT, "wb"))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results of the verbs, from one set of 4 ranks."""
    store = tmp_path_factory.mktemp("store")
    return run_ranks(torch_ranks.comm_verbs, NRANKS, device="cpu",
                     args=(INPUTS,), timeout=120, store_dir=store)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_verbs")
    src, dst = d / "in.pkl", d / "out.pkl"
    src.write_bytes(pickle.dumps(INPUTS))
    run_with_devices(f"IN, OUT = {str(src)!r}, {str(dst)!r}\n" + JAX_VERBS,
                     ndev=NRANKS)
    return pickle.loads(dst.read_bytes())


def _layout(name):
    """The numpy physical layout of an input (padding, block order)."""
    x = INPUTS[name]
    if name == "nat":
        return np.concatenate([x, np.zeros((2, 5), np.float32)])
    if name == "blk":
        x = np.concatenate([x, np.zeros((6, 3), np.float32)])
        return x[_block_cyclic_perm(16, NRANKS, 2)]
    return x


@pytest.mark.parametrize("name", ["nat", "blk", "cln"])
def test_containers_round_trip(port, jax_out, name):
    """NATURAL (J = 6 over 4, padded to 8), BLOCK (block-cyclic, block 2)
    and CLONE: each rank holds its numpy segment, gathers the input back,
    and reports the JAX package's segment metadata."""
    layout = _layout(name)
    for r, out in enumerate(port):
        np.testing.assert_array_equal(out[f"{name}_gather"], INPUTS[name])
        want = layout if name == "cln" else \
            layout[r * len(layout) // NRANKS:(r + 1) * len(layout) // NRANKS]
        np.testing.assert_array_equal(out[f"{name}_local"], want)
        for k, norm in (("segments", lambda v: [tuple(s) for s in v]),
                        ("seg_len", lambda v: [int(s) for s in v]),
                        ("global_shape", lambda v: tuple(map(int, v)))):
            assert norm(out[f"{name}_{k}"]) == \
                norm(jax_out[f"{name}_{k}"]), k


def test_reductions_match_numpy_and_jax(port, jax_out):
    nat, stack = INPUTS["nat"], INPUTS["stack"]
    window = np.zeros((8, 8), np.float32)
    window[2:6, 2:6] = stack.sum(0)[2:6, 2:6]
    for out in port:
        np.testing.assert_allclose(out["allreduce"], nat.sum(0), atol=TOL)
        np.testing.assert_allclose(out["allreduce"], jax_out["allreduce"],
                                   atol=TOL)
        np.testing.assert_array_equal(out["reduce_max"],
                                      jax_out["reduce_max"])
        np.testing.assert_allclose(out["window"], window, atol=TOL)
        np.testing.assert_allclose(out["window"], jax_out["window"],
                                   atol=TOL)
        np.testing.assert_array_equal(out["allgather"], INPUTS["blk"])
        np.testing.assert_array_equal(out["allgather"], jax_out["allgather"])
        np.testing.assert_array_equal(out["allgather_local"], _layout("nat"))
    assert all(np.array_equal(o["allreduce"], port[0]["allreduce"])
               for o in port), "ranks disagree on the all-reduce's bits"


def test_bcast_and_scatter_send_from_rank_0(port):
    """``bcast`` hands every rank rank 0's values (each rank passed its
    own); ``scatter`` builds rank 0's containers on every rank (the
    others passed ``None``)."""
    for out in port:
        np.testing.assert_array_equal(out["bcast"], INPUTS["cln"])
        local, shape, orig = out["scatter"]
        np.testing.assert_array_equal(local, out["nat_local"])
        assert tuple(shape) == (8, 5) and orig == 6


def test_vdot_mixed_policies(port, jax_out):
    """CLONE counted once, NATURAL summed across ranks: eager on
    containers and on local tensors with ``policies``."""
    want = complex(np.vdot(INPUTS["rho"], INPUTS["rho2"]) +
                   np.vdot(INPUTS["chat"], INPUTS["chat2"]))
    for out in port:
        for k in ("vdot_eager", "vdot_local"):
            assert abs(out[k] - want) <= TOL * abs(want), (k, out[k], want)
            assert abs(out[k] - jax_out["vdot_eager"]) <= TOL * abs(want)
        assert out["vdot_eager"] == port[0]["vdot_eager"]


def test_point_to_point_verbs(port, jax_out):
    """``shift`` (wrapped and open) and ``send_recv`` (a full and a
    partial permutation): each rank's segment equals numpy's and the JAX
    package's ``lax.ppermute`` result."""
    segs = np.split(_layout("nat"), NRANKS)
    zero = np.zeros_like(segs[0])
    for r, out in enumerate(port):
        np.testing.assert_array_equal(out["shift"], segs[(r - 1) % NRANKS])
        np.testing.assert_array_equal(
            out["shift_open"], segs[r + 1] if r + 1 < NRANKS else zero)
        np.testing.assert_array_equal(out["send_recv"],
                                      segs[NRANKS - 1 - r])
        np.testing.assert_array_equal(out["send_recv_partial"],
                                      segs[0] if r == NRANKS - 1 else zero)
        for k in ("shift", "shift_open", "send_recv", "send_recv_partial"):
            np.testing.assert_array_equal(out[k],
                                          np.split(jax_out[k], NRANKS)[r])
        assert out["ring_perm"] == [(0, 1), (1, 2), (2, 3), (3, 0)]


def test_allreduce_overlap_schedules(port, jax_out):
    """The fused channel sum's verb: the psum schedule (extras packed into
    the window's payload, each back in its own type) against the JAX
    package's in ``shard_map``, and the gathered ``masked_sum`` schedule
    against numpy; every rank gets the same bits."""
    ovl, mask = INPUTS["ovl"], INPUTS["mask"]
    total = ovl.sum(0)
    win = np.zeros_like(total)
    win[2:6, 2:6] = total[2:6, 2:6]
    e_re, e_c = INPUTS["e_re"].sum(), INPUTS["e_c"].sum()
    jred, je0, je1 = jax_out["ovl_psum"]
    for out in port:
        red, ex0, ex1, comp = out["ovl_psum"]
        np.testing.assert_allclose(red, win, atol=TOL)
        np.testing.assert_allclose(red, jred, atol=TOL)
        assert ex0.dtype == np.float32 and ex1.dtype == np.complex64
        np.testing.assert_allclose([ex0, ex1], [e_re, e_c], atol=TOL)
        np.testing.assert_allclose([ex0, ex1], [je0, je1], atol=TOL)
        np.testing.assert_array_equal(comp, np.ones(2, np.float32))
        red, ex0, ex1 = out["ovl_masked"]
        want = np.zeros_like(total)
        want[2:6, 2:6] = mask[2:6, 2:6] * total[2:6, 2:6]
        np.testing.assert_allclose(red, want, atol=TOL)
        np.testing.assert_allclose([ex0, ex1], [e_re, e_c], atol=TOL)
        np.testing.assert_allclose(out["ovl_masked_full"], mask * total,
                                   atol=TOL)
        for k in ("ovl_psum", "ovl_masked"):
            assert all(np.array_equal(a, b) for a, b in
                       zip(out[k], port[0][k])), k
        np.testing.assert_array_equal(out["fence"], np.ones(2, np.float32))


def test_one_rank_group_runs_the_same_program():
    """The same rank body on a 1-rank communicator without a process
    group: no-op collectives, the results of one rank holding it all."""
    comm = Communicator.single("cpu")
    assert comm.group.pg is None and comm.size == 1
    out = torch_ranks.comm_verbs_on(comm, INPUTS)
    for name in ("nat", "blk", "cln"):
        np.testing.assert_array_equal(out[f"{name}_gather"], INPUTS[name])
    np.testing.assert_array_equal(out["nat_local"], INPUTS["nat"])
    np.testing.assert_allclose(out["allreduce"], INPUTS["nat"].sum(0),
                               atol=TOL)
    np.testing.assert_array_equal(out["shift"], INPUTS["nat"])
    np.testing.assert_array_equal(out["shift_open"], 0)
    np.testing.assert_array_equal(out["send_recv"], INPUTS["nat"])
    red, ex0, ex1, _ = out["ovl_psum"]
    np.testing.assert_array_equal(red[2:6, 2:6], INPUTS["ovl"][0][2:6, 2:6])
    assert ex0 == INPUTS["e_re"][0] and ex1 == INPUTS["e_c"][0]
    red, _, _ = out["ovl_masked"]
    np.testing.assert_allclose(red[2:6, 2:6], (INPUTS["mask"] *
                                               INPUTS["ovl"][0])[2:6, 2:6],
                               atol=TOL)


def test_spmd_wraps_outputs_by_policy():
    comm = Communicator.single("cpu")
    prog = comm.spmd(lambda y, u: ({"rho": u["rho"] * 2, "chat": y + 1},
                                   y.sum(0)),
                     in_policies=(Policy.NATURAL, {"rho": Policy.CLONE,
                                                   "chat": Policy.NATURAL}),
                     out_policies=({"rho": Policy.CLONE,
                                    "chat": (Policy.NATURAL, 0)},
                                   Policy.CLONE))
    y = np.ones((3, 2, 2), np.float32)
    u = {"rho": np.ones((2, 2), np.float32), "chat": y}
    out, s = prog(y, u)
    assert out["chat"].policy is Policy.NATURAL and s.policy is Policy.CLONE
    np.testing.assert_array_equal(out["chat"].gather().numpy(), 2 * y)
    np.testing.assert_array_equal(out["rho"].data.numpy(), 2 * u["rho"])
    np.testing.assert_array_equal(s.data.numpy(), 3 * np.ones((2, 2)))


def test_environment_checks_the_backend_it_is_given(monkeypatch):
    """The backend is the caller's choice, checked, never swapped: N
    ranks need one, NCCL needs a card a rank, and without a card the
    entry points refuse unless asked for the CPU."""
    with pytest.raises(ValueError, match="backend"):
        Environment(0, 2, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        Environment(0, 2, backend="nccl", device="cpu", store=object())
    with pytest.raises(ValueError, match="store"):
        Environment(0, 2, backend="gloo", device="cpu")
    env = Environment(device="cpu")
    assert env.world.size == 1 and env.world.group.pg is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Environment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceGroup.single()


def test_run_ranks_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the call with its traceback, within the
    call's deadline, and leaves no process behind."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(torch_ranks.raise_on_rank_1, 2, device="cpu", timeout=60,
                  store_dir=tmp_path)


def test_env_doctests():
    import doctest
    result = doctest.testmod(core_env)
    assert result.failed == 0 and result.attempted > 10
