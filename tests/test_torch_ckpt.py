"""The port's checkpoint layer (``repro_torch.ckpt``) and the checkpoint
half of its fault tolerance (``resume_or_init``, ``PreemptionGuard``), on
the CPU, after the JAX package's ``tests/test_substrates.py:127-160`` and
``tests/test_ckpt_elastic.py``.

* a roundtrip restores bitwise (float32, int32, bf16 and a train state
  with its module), keep-N, the async save (the host copy is taken before
  ``save`` returns, so an update in place after it does not leak in);
* the restart envelope resumes with no lost or duplicated step;
* ``resume_or_init``: a cold start, then the latest checkpoint;
* ``PreemptionGuard`` flushes on a SIGTERM sent to this process, and its
  ``close`` puts the old handler back;
* on 4 gloo ranks (``torch_ranks.ckpt_elastic_rank``): a tree written by
  one process restored segmented (each rank its rows), re-saved and
  restored whole; and the live ``FramePipeline`` carry checkpointed on 4
  ranks and resumed on 2, every frame within 1e-5 of the uninterrupted
  4-rank movie (``test_ckpt_elastic.py:92-94``'s bound).
"""

import os
import signal

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.ckpt import (latest_step, list_steps, restore,
                              restore_sharded, save)
from repro_torch.configs import get_smoke
from repro_torch.core import run_ranks
from repro_torch.ft import (PreemptionGuard, RestartPolicy, resume_or_init,
                            run_with_restarts)
from repro_torch.train import make_train_state

LIVE_TOL = 1e-5


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.int32),
                       "h": torch.linspace(0, 1, 5).to(torch.bfloat16)},
            "list": [torch.tensor(2.5), np.arange(3, dtype=np.int64)]}


def test_checkpoint_roundtrip_and_keep(tmp_path):
    tree = _tree()
    for s in (1, 5, 9, 13):
        save(tmp_path, s, tree, keep=2)
    assert list_steps(tmp_path) == [9, 13] and latest_step(tmp_path) == 13
    got, step = restore(tmp_path, tree)
    assert step == 13
    np.testing.assert_array_equal(got["a"], tree["a"].numpy())
    np.testing.assert_array_equal(got["nested"]["b"], np.ones(4, np.int32))
    assert isinstance(got["list"], list) and float(got["list"][0]) == 2.5
    placed, _ = restore_sharded(tmp_path, tree, "cpu")
    assert placed["nested"]["h"].dtype == torch.bfloat16
    assert torch.equal(placed["nested"]["h"], tree["nested"]["h"])
    assert torch.equal(placed["nested"]["b"], tree["nested"]["b"])
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "none", tree)


def test_checkpoint_async_copies_before_returning(tmp_path):
    tree = {"w": torch.full((8, 8), 3.0)}
    t = save(tmp_path, 2, tree, blocking=False)
    tree["w"].add_(1.0)                 # the train step's in-place update
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = restore(tmp_path, tree)
    np.testing.assert_array_equal(got["w"], np.full((8, 8), 3.0))


def test_train_state_roundtrip_is_bitwise(tmp_path):
    cfg = get_smoke("recurrentgemma-2b")
    state = make_train_state(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    state["opt"]["step"].fill_(7)
    for m in state["opt"]["m"].values():
        m.normal_()
    save(tmp_path, 7, state)
    fresh = make_train_state(cfg, torch.Generator().manual_seed(2),
                             device="cpu")
    got, step = restore_sharded(tmp_path, fresh, "cpu")
    assert step == 7 and int(got["opt"]["step"]) == 7
    assert set(got["params"]) == {n for n, _ in
                                  state["params"].named_parameters()}
    for name, p in state["params"].named_parameters():
        assert torch.equal(got["params"][name], p.detach()), name
        assert torch.equal(got["opt"]["m"][name], state["opt"]["m"][name])


def test_restart_policy_resumes(tmp_path):
    crashes = {"n": 0}

    def loop(start):
        step = latest_step(tmp_path) or 0
        state = restore(tmp_path, {"x": np.zeros(())})[0] \
            if step else {"x": np.zeros(())}
        while step < 10:
            step += 1
            state = {"x": state["x"] + 1}
            save(tmp_path, step, state, keep=1)
            if step == 4 and crashes["n"] == 0:
                crashes["n"] += 1
                raise RuntimeError("simulated node failure")
        return step

    final = run_with_restarts(loop, policy=RestartPolicy(max_restarts=2,
                                                         backoff_s=0.0))
    assert final == 10 and crashes["n"] == 1
    got, s = restore(tmp_path, {"x": np.zeros(())})
    assert s == 10 and float(got["x"]) == 10.0   # no lost/duplicated work


def test_resume_or_init(tmp_path):
    like = {"w": torch.zeros(3)}
    tree, step = resume_or_init(tmp_path, like, "cpu",
                                lambda: {"w": torch.ones(3)})
    assert step == 0 and torch.equal(tree["w"], torch.ones(3))
    save(tmp_path, 5, {"w": torch.full((3,), 2.0)})
    tree, step = resume_or_init(tmp_path, like, "cpu",
                                lambda: pytest.fail("cold start"))
    assert step == 5 and torch.equal(tree["w"], torch.full((3,), 2.0))


def test_preemption_guard_flushes_on_sigterm(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        assert not guard.maybe_flush(tmp_path, 1, {"w": torch.ones(2)})
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):        # the handler runs between bytecodes
            if guard.preempted:
                break
        assert guard.preempted
        assert guard.maybe_flush(tmp_path, 3, {"w": torch.ones(2)})
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) == before
    assert latest_step(tmp_path) == 3


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "opt": {"m": np.ones((16,), np.float32),
                    "c": np.arange(6, dtype=np.float32).reshape(3, 2)}}
    save(tmp / "ckpt", 3, tree)             # written from one process
    rng = np.random.default_rng(0)
    F, J, g = 4, 4, 16
    y = (rng.normal(size=(F, J, g, g)) +
         1j * rng.normal(size=(F, J, g, g))).astype(np.complex64)
    masks = (rng.random(size=(F, g, g)) < 0.4).astype(np.float32)
    fov = np.ones((g, g), np.float32)
    outs = run_ranks(torch_ranks.ckpt_elastic_rank, 4, device="cpu",
                     args=(str(tmp / "ckpt"), tree, (y, masks, fov)),
                     timeout=240, store_dir=tmp)
    return tree, outs


def test_elastic_restore_segmented_then_whole(elastic):
    tree, outs = elastic
    for r, out in enumerate(outs):
        assert out["step"] == 3 and out["step4"] == 4
        np.testing.assert_array_equal(out["w_local"],
                                      tree["w"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["m_local"],
                                      tree["opt"]["m"][4 * r:4 * r + 4])
        assert out["c_policy"] == "CLONE"
        np.testing.assert_array_equal(out["c_local"], tree["opt"]["c"])
        np.testing.assert_array_equal(out["w_whole"], tree["w"])
        np.testing.assert_array_equal(out["m_whole"], tree["opt"]["m"])


def test_live_carry_4_to_2_ranks_through_a_checkpoint(elastic):
    _, outs = elastic
    ref = outs[0]["ref"]
    assert all(out["second"] is None for out in outs[2:])
    for out in outs[:2]:
        assert out["step_live"] == 2
        movie = np.concatenate([out["first"], out["second"]])
        assert movie.shape == ref.shape and movie.shape[0] == 4
        for f in range(4):
            rel = np.abs(movie[f] - ref[f]).max() / max(
                np.abs(ref[f]).max(), 1e-30)
            assert rel <= LIVE_TOL, (f, rel)


def test_async_write_error_reaches_join(tmp_path, monkeypatch):
    """A write that fails on its thread (a full disk) raises in ``join``,
    where the launcher waits for it, and commits nothing."""
    from repro_torch.ckpt import checkpoint

    def full(*args, **kwargs):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(checkpoint.np, "savez", full)
    t = save(tmp_path, 1, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError, match="No space"):
        t.join(timeout=60)
    assert not t.is_alive() and list_steps(tmp_path) == []
