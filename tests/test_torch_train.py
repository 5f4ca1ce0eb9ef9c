"""The port's training layer (``repro_torch.train``) on the CPU against the
JAX package's ``repro.train``, from the same numpy inputs.

* AdamW, its warmup-cosine schedule and the global-norm clip on a random
  tree, several steps, within 1e-6 (both in float32; the port updates in
  place, JAX returns new trees);
* one ``make_train_step`` step of qwen3-0.6b's SMOKE config in float32:
  the metrics (1e-5) and every parameter after the update against JAX's
  jitted step from the same weights and batch: each leaf's update within
  1e-3 relative L2 of JAX's and each element within 5e-5 (lr 1e-3).  The
  first AdamW step moves an element by lr * g / (|g| + 1e-8), so where a
  gradient is near 1e-8 its float32 summation-order difference (about
  1e-6 relative L2 over the gradient) reaches the step at full size: the
  worst leaf's update is 1.3e-4 from JAX's, its worst element 1.6e-5;
* ``microbatches=4`` against ``microbatches=1`` (after
  ``tests/test_substrates.py:61``, within 1e-5);
* ``remat=True`` gradients against ``remat=False`` (bitwise: the same
  operations recomputed), xlstm-350m's sLSTM stack included;
* the loss falling over 60 steps on the Markov pipeline (after
  ``tests/test_substrates.py:38``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import compat
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.data import TokenPipeline
from repro_torch.train import (adamw_init, adamw_update, lm_loss,
                               make_train_state, make_train_step,
                               warmup_cosine)
from repro_torch.train.optimizer import clip_by_global_norm

OPT_TOL = 1e-6
STEP_TOL = 1e-5
UPDATE_TOL = 1e-3
ELEMENT_TOL = 5e-5


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "e": rng.standard_normal((4, 3, 5)).astype(np.float32)}


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("step", [0, 5, 10, 11, 50, 99, 100, 140])
def test_warmup_cosine_matches_jax(step):
    lr_t = warmup_cosine(3e-3, 10, 100)
    lr_j = jopt.warmup_cosine(3e-3, 10, 100)
    assert _close(float(lr_t(step)), float(lr_j(step)), OPT_TOL)
    assert _close(float(lr_t(torch.tensor(step, dtype=torch.int32))),
                  float(lr_j(step)), OPT_TOL)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(1)
    got, norm = clip_by_global_norm({k: torch.tensor(v) for k, v in
                                     g.items()}, max_norm)
    want, norm_j = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    assert _close(float(norm), float(norm_j), OPT_TOL)
    for k in g:
        assert _close(got[k].numpy(), want[k], OPT_TOL), k


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (1.0, 0.0)])
def test_adamw_matches_jax_over_steps(clip, wd):
    p0 = _tree(0)
    params_t = {k: torch.tensor(v) for k, v in p0.items()}
    state_t = adamw_init(params_t)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    state_j = jopt.adamw_init(params_j)
    lr_fn = jopt.warmup_cosine(1e-2, 2, 10)
    for i in range(6):
        g = _tree(10 + i)
        lr = lr_fn(i)
        _, _, gn_t = adamw_update(params_t, {k: torch.tensor(v) for k, v in
                                             g.items()}, state_t,
                                  float(lr), weight_decay=wd, clip=clip)
        params_j, state_j, gn_j = jopt.adamw_update(
            params_j, {k: jnp.asarray(v) for k, v in g.items()}, state_j,
            lr, weight_decay=wd, clip=clip)
        assert _close(float(gn_t), float(gn_j), OPT_TOL)
    assert int(state_t["step"]) == int(state_j["step"]) == 6
    assert state_t["step"].dtype == torch.int32
    for k in p0:
        assert _close(params_t[k].numpy(), params_j[k], OPT_TOL), k
        assert _close(state_t["m"][k].numpy(), state_j["m"][k], OPT_TOL), k
        assert _close(state_t["v"][k].numpy(), state_j["v"][k], OPT_TOL), k


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"].clone()}
        adamw_update(params, g, state, 0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2


def _batch(cfg, B=4, S=16, seed=1):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return tok.astype(np.int32), np.roll(tok, -1, 1).astype(np.int32)


def _both_states(arch, seed=0):
    cfg_j, cfg_t = _f32(jget_smoke(arch)), _f32(get_smoke(arch))
    params_j = jt.init_params(cfg_j, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params_j)
    model = convert.params_from_numpy(cfg_t, tree, device="cpu")
    model.requires_grad_(True)
    state_t = {"params": model,
               "opt": adamw_init(dict(model.named_parameters()))}
    state_j = {"params": params_j, "opt": jopt.adamw_init(params_j)}
    return cfg_j, cfg_t, state_j, state_t


def test_train_step_matches_jax():
    cfg_j, cfg_t, state_j, state_t = _both_states("qwen3-0.6b")
    p0 = jax.tree.map(np.asarray, state_j["params"])
    tok, lab = _batch(cfg_j)
    kw = dict(base_lr=1e-3, warmup=0, total=10, remat=False)
    mesh = compat.make_mesh((1,), ("data",))
    step_j, _ = jtrainer.make_train_step(cfg_j, mesh, donate=False, **kw)
    with mesh:
        new_j, met_j = jax.jit(step_j)(state_j, jnp.asarray(tok),
                                       jnp.asarray(lab), None)
    new_t, met_t = make_train_step(cfg_t, **kw)(
        state_t, torch.from_numpy(tok), torch.from_numpy(lab))
    for k in ("loss", "gnorm", "lr", "nll", "aux"):
        assert _close(float(met_t[k]), float(met_j[k]), STEP_TOL), k
    got = convert.params_to_numpy(cfg_t, new_t["params"])
    for (path, want), have, old in zip(
            jax.tree_util.tree_leaves_with_path(new_j["params"]),
            jax.tree.leaves(got), jax.tree.leaves(p0)):
        want = np.asarray(want)
        moved = np.linalg.norm(want - old)
        assert np.linalg.norm(have - want) <= UPDATE_TOL * moved, \
            jax.tree_util.keystr(path)
        assert np.abs(have - want).max() <= ELEMENT_TOL, \
            jax.tree_util.keystr(path)
    assert int(new_t["opt"]["step"]) == int(new_j["opt"]["step"]) == 1


def test_microbatch_accumulation_matches_full_batch():
    cfg = _f32(get_smoke("llama3.2-3b"))
    tok, lab = (torch.from_numpy(a) for a in _batch(cfg))
    g = torch.Generator().manual_seed(0)
    s1 = make_train_state(cfg, g, device="cpu")
    g = torch.Generator().manual_seed(0)
    s2 = make_train_state(cfg, g, device="cpu")
    _, m1 = make_train_step(cfg, microbatches=1, remat=False)(s1, tok, lab)
    _, m2 = make_train_step(cfg, microbatches=4, remat=False)(s2, tok, lab)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    p2 = dict(s2["params"].named_parameters())
    for k, p in s1["params"].named_parameters():
        assert float((p - p2[k]).abs().max()) < 1e-5, k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_remat_gradients_equal_no_remat(arch):
    cfg = _f32(get_smoke(arch))
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    model = state["params"]
    tok, lab = (torch.from_numpy(a) for a in _batch(cfg, B=2))
    grads = []
    for remat in (False, True):
        loss, _ = lm_loss(cfg, model, tok, lab, remat=remat)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_slstm_gradients_after_a_forward_without_autograd():
    """An xlstm-350m model that served a call without autograd (which
    caches its sLSTM recurrence stack) gives the same gradients as a
    fresh one, the recurrence matrices' included."""
    cfg = _f32(get_smoke("xlstm-350m"))
    tok, lab = (torch.from_numpy(a) for a in _batch(cfg, B=2))
    grads = []
    for served_first in (False, True):
        model = make_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")["params"]
        if served_first:
            with torch.no_grad():
                model(tok)
        loss, _ = lm_loss(cfg, model, tok, lab, remat=False)
        names = [n for n, _ in model.named_parameters()]
        grads.append(dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters())))))
    recurrent = [n for n in grads[0] if n.split(".")[-1] in
                 ("ri", "rf", "rz", "ro")]
    assert recurrent and all(float(grads[0][n].abs().max()) > 0
                             for n in recurrent)
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_train_loop_loss_decreases():
    """qwen3-smoke on the Markov pipeline: the loss must drop, from ln(256)
    = 5.55 toward the ln(8) = 2.08 entropy floor."""
    cfg = _f32(get_smoke("qwen3-0.6b"))
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, base_lr=1e-2, warmup=5, total=120,
                           remat=False)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq=32, seed=0)
    losses = []
    for i in range(60):
        tok, lab = pipe.batch_at(i)
        state, met = step(state, torch.from_numpy(tok),
                          torch.from_numpy(lab))
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[::10]
    assert losses[-1] < min(losses[:10]), losses[::10]


def test_train_state_turns_gradients_on_and_serving_keeps_them_off():
    cfg = _f32(get_smoke("qwen3-0.6b"))
    from repro_torch.models import transformer
    served = transformer.init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    state = make_train_state(cfg, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    assert set(state["opt"]["m"]) == {n for n, _ in
                                      state["params"].named_parameters()}
    assert all(m.dtype == torch.float32 for m in state["opt"]["m"].values())
