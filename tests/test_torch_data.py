"""The port's ``TokenPipeline`` against the JAX package's: the same
``(seed, step, host_id)`` gives the same tokens bit for bit, over several
steps, hosts and seeds; its cursor's ``state``/``restore`` and the
Markov structure (each label the next token) as the JAX package's
``tests/test_substrates.py:101`` checks them."""

import numpy as np
import pytest

from repro.data import TokenPipeline as JaxPipeline
from repro_torch.data import TokenPipeline


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_batches_bitwise_equal_to_jax(seed, n_hosts, host_id):
    kw = dict(vocab=97, batch=3, seq=24, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    mine, ref = TokenPipeline(**kw), JaxPipeline(**kw)
    for step in (0, 1, 7, 123):
        (t, l), (tj, lj) = mine.batch_at(step), ref.batch_at(step)
        assert t.dtype == tj.dtype == np.int32
        assert np.array_equal(t, tj) and np.array_equal(l, lj)


def test_iteration_and_restore_match_jax():
    mine = TokenPipeline(vocab=64, batch=4, seq=16, seed=3)
    ref = JaxPipeline(vocab=64, batch=4, seq=16, seed=3)
    for _ in range(3):
        assert all(np.array_equal(a, b) for a, b in zip(next(mine),
                                                        next(ref)))
    assert mine.state() == ref.state() == {"step": 3}
    mine.restore({"step": 5})
    ref.restore({"step": 5})
    t, lab = next(mine)
    assert np.array_equal(t, next(ref)[0])
    assert np.array_equal(t, TokenPipeline(vocab=64, batch=4, seq=16,
                                           seed=3).batch_at(5)[0])
    assert np.array_equal(t[:, 1:], lab[:, :-1])
    assert mine.step == 6


def test_hosts_get_different_data():
    a = TokenPipeline(vocab=64, batch=4, seq=16, seed=3).batch_at(7)[0]
    b = TokenPipeline(vocab=64, batch=4, seq=16, seed=3, n_hosts=2,
                      host_id=1).batch_at(7)[0]
    assert not np.array_equal(a, b)
