"""The port's LM loss and its gradient against the JAX package's, for
every arch of ``ARCH_IDS`` at its SMOKE config in float32 (after
``tests/test_arch_smoke.py:46``).

The JAX init is carried across with ``convert.params_from_numpy``, the
cross-attention gates opened to 0.5 in both packages (the init's 0 would
switch cross-attention, and the gradient of everything behind it, off),
and the same numpy tokens, labels and frontend embeddings go through
``jax.value_and_grad`` of ``repro.train.lm_loss`` and through the port's
``lm_loss`` and ``torch.autograd.grad``.  The port's gradients map back
onto the JAX tree with ``convert.named_to_numpy``, which only moves and
stacks leaves (the port unrolls the JAX package's stacked layer groups).
Tolerances: the loss within 1e-5, and every gradient leaf within 1e-5
relative L2 of JAX's (both sum in float32 in other orders; the worst
leaf over the ten archs is about 2e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.train import lm_loss
from test_torch_lm_configs import _frontend, open_gates

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_every_gradient_leaf_match_jax(arch):
    cfg_j, cfg_t = _f32(jget_smoke(arch)), _f32(get_smoke(arch))
    tree = open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg_j, jax.random.PRNGKey(1))))
    model = convert.params_from_numpy(cfg_t, tree, device="cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg_j.vocab, (2, 16)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    enc = _frontend(cfg_j, 2)

    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda p: jtrainer.lm_loss(
            cfg_j, p, jnp.asarray(tok), jnp.asarray(lab),
            None if enc is None else jnp.asarray(enc), remat=False),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))

    loss_t, met_t = lm_loss(
        cfg_t, model, torch.from_numpy(tok), torch.from_numpy(lab),
        None if enc is None else torch.from_numpy(enc), remat=False)
    params = dict(model.named_parameters())
    got = torch.autograd.grad(loss_t, list(params.values()),
                              allow_unused=True)
    grads_t = convert.named_to_numpy(cfg_t, {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(params.items(), got)})

    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_TOL
    assert abs(float(met_t["aux"].detach()) - float(met_j["aux"])) <= LOSS_TOL
    leaves_j = jax.tree_util.tree_leaves_with_path(grads_j)
    leaves_t = jax.tree.leaves(grads_t)
    assert jax.tree.structure(grads_t) == jax.tree.structure(
        jax.tree.map(np.asarray, grads_j))
    for (path, gj), gt in zip(leaves_j, leaves_t):
        gj = np.asarray(gj)
        assert gt.shape == gj.shape, jax.tree_util.keystr(path)
        rel = np.linalg.norm(gt - gj) / max(np.linalg.norm(gj), 1e-30)
        assert rel <= GRAD_TOL, (jax.tree_util.keystr(path), rel)
