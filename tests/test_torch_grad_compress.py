"""The port's int8 gradient compression (``repro_torch.train.
grad_compress``) over a ``Communicator``: on one rank against the JAX
package's ``compressed_psum`` in a 1-device ``shard_map`` (after
``tests/test_substrates.py:183``; the same float32 arithmetic, within
1e-7 absolute), and on 2 gloo ranks against the numpy sum of the ranks'
gradients within the int8 bound (each block's shared absmax / 127 per
rank), with error feedback pushing two steps' sum toward exact."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import torch_ranks
from repro.core import compat
from repro.train.grad_compress import compressed_psum as jax_psum
from repro_torch.core import Communicator, run_ranks
from repro_torch.train.grad_compress import (compressed_psum,
                                             init_error_state,
                                             tree_compressed_psum)


def _grad(seed, n=10_000):
    rng = np.random.default_rng(seed)
    return (0.01 * rng.standard_normal(n)).astype(np.float32)


def test_one_rank_matches_jax_compressed_psum():
    import torch
    g = _grad(0)
    mesh = compat.make_mesh((1,), ("d",))
    f = compat.shard_map(lambda gg, e: jax_psum(gg, "d", e), mesh=mesh,
                         in_specs=(P(), P()), out_specs=(P(), P()))
    out_j, err_j = f(jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    out2_j, _ = f(jnp.asarray(g), err_j)
    comm = Communicator.single("cpu")
    gt = torch.from_numpy(g)
    out, err = compressed_psum(gt, comm, torch.zeros_like(gt))
    out2, _ = compressed_psum(gt, comm, err)
    for a, b in ((out, out_j), (err, err_j), (out2, out2_j)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-7
    q_err = float((out - gt).abs().max())
    assert q_err < 0.01 * 5 / 127          # block absmax / 127
    assert float((out + out2 - 2 * gt).abs().max()) < q_err * 1.01


def test_tree_form_and_error_state():
    import torch
    comm = Communicator.single("cpu")
    grads = {"a": torch.from_numpy(_grad(1, 300).reshape(10, 30)),
             "b": torch.from_numpy(_grad(2, 7))}
    err = init_error_state(grads)
    assert all(float(e.abs().max()) == 0 for e in err.values())
    out, new_err = tree_compressed_psum(grads, comm, err)
    for k, g in grads.items():
        assert out[k].shape == g.shape and new_err[k].shape == g.shape
        want, _ = compressed_psum(g, comm, err[k])
        assert torch.equal(out[k], want)


def test_two_ranks_sum_within_the_int8_bound(tmp_path):
    grads = [_grad(10 + r) for r in range(2)]
    outs = run_ranks(torch_ranks.grad_compress_rank, 2, device="cpu",
                     args=(grads,), timeout=120, store_dir=tmp_path)
    exact = grads[0] + grads[1]
    block = 4096
    n = exact.size
    pad = (-n) % block
    stacked = np.stack([np.pad(np.abs(g), (0, pad)) for g in grads])
    shared = stacked.reshape(2, -1, block).max(axis=(0, 2))  # pmax absmax
    bound = np.repeat(2 * shared / 127 / 2, block)[:n] + 1e-7
    for out in outs:
        assert np.array_equal(out["out"], outs[0]["out"])
        assert np.all(np.abs(out["out"] - exact) <= bound)
        # two steps of the same gradients with error feedback: the sum
        # of both reduced steps lands closer to 2x the exact sum
        two = out["out"] + out["out2"]
        assert np.abs(two - 2 * exact).max() <= \
            np.abs(out["out"] - exact).max() * 1.01
