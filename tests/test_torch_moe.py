"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU: the cases of
``tests/test_moe.py`` (the sort-based capacity dispatch against a dense
per-token reference at (E, k, pad) = (8, 2, 1), (8, 3, 1), (6, 2, 4);
padded experts never selected; drops reported at capacity factor 0.1; the
combine weights summing to one), and ``moe.apply`` against the JAX
package's on the same weights and numpy inputs: the output within 1e-5
atol / 1e-4 rtol, ``lb_loss`` and ``dropped`` equal.  The weights are the
JAX init's, carried across leaf by leaf; configs are granite's SMOKE in
float32, as the reference's test uses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.models import moe
from repro_torch.models.layers import ACTS, Params


def _cfgs(**kw):
    def one(get):
        return dataclasses.replace(get("granite-moe-3b-a800m"),
                                   compute_dtype="float32", **kw)
    return one(jget_smoke), one(get_smoke)


def _to_port(tree) -> Params:
    """A JAX MoE parameter dict (numpy leaves) as the port's modules."""
    return Params(**{k: _to_port(v) if isinstance(v, dict)
                     else torch.from_numpy(np.array(v))
                     for k, v in tree.items()})


def _both(E=None, k=None, pad=1, seed=0, **kw):
    if E is not None:
        kw.update(n_experts=E, top_k=k)
    cfg_j, cfg_t = _cfgs(**kw)
    pj = jmoe.init(cfg_j, jax.random.PRNGKey(seed), pad_to=pad)
    return cfg_j, pj, cfg_t, _to_port(jax.tree.map(np.asarray, pj))


def _x(cfg, shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape + (cfg.d_model,))
            ).astype(np.float32)


def _dense_reference(cfg, p, x):
    """Route every token through its top_k experts directly (no
    capacity)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    E = p.router.shape[1]
    logits = xf @ p.router
    logits = torch.where(torch.arange(E) < cfg.n_experts, logits, -1e30)
    topw, tope = torch.topk(torch.softmax(logits, -1), cfg.top_k)
    topw = topw / topw.sum(-1, keepdim=True)
    a = ACTS[cfg.act]
    out = torch.zeros_like(xf)
    for e in range(E):
        h = a(xf @ p.experts.gate[e]) * (xf @ p.experts.up[e])
        w = torch.where(tope == e, topw, 0.0).sum(-1)
        out = out + w[:, None] * (h @ p.experts.down[e])
    return out.reshape(B, S, d)


@pytest.mark.parametrize("E,k,pad", [(8, 2, 1), (8, 3, 1), (6, 2, 4)])
def test_dispatch_matches_dense(E, k, pad):
    _, _, cfg, p = _both(E, k, pad, capacity_factor=float(E) / k)
    x = torch.from_numpy(_x(cfg, (2, 10), seed=1, scale=0.5))
    got, aux = moe.apply(cfg, p, x)
    np.testing.assert_allclose(got.numpy(), _dense_reference(cfg, p, x),
                               atol=1e-5, rtol=1e-4)
    assert float(aux["dropped"]) == 0.0


def test_padded_experts_never_selected():
    cfg = _cfgs(n_experts=6, top_k=2)[1]
    p = moe.init(cfg, torch.Generator().manual_seed(0), pad_to=4, device="cpu")
    assert tuple(p.router.shape) == (cfg.d_model, 8)
    assert tuple(p.experts.gate.shape) == (8, cfg.d_model, cfg.moe_d_ff)
    xf = torch.from_numpy(_x(cfg, (64,), seed=1))
    logits = torch.where(torch.arange(8) < 6, xf @ p.router, -1e30)
    _, tope = torch.topk(torch.softmax(logits, -1), 2)
    assert int(tope.max()) < 6
    # and the dispatch gives the dummies no token: their rows of the
    # capacity buffer stay zero whatever their weights
    with torch.no_grad():
        p.experts.down[6:] = 1e3
    out, _ = moe.apply(cfg, p, xf[None])
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) < 1e2


def test_capacity_drops_are_reported():
    _, _, cfg, p = _both(8, 2, capacity_factor=0.1)
    x = torch.from_numpy(_x(cfg, (2, 32), seed=1))
    _, aux = moe.apply(cfg, p, x)
    assert float(aux["dropped"]) > 0.0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 100), S=st.integers(2, 17))
def test_combine_weights_sum_to_one(seed, S):
    _, _, cfg, p = _both()
    xf = torch.from_numpy(_x(cfg, (S,), seed=seed))
    E = p.router.shape[1]
    logits = torch.where(torch.arange(E) < cfg.n_experts, xf @ p.router,
                         -1e30)
    topw, _ = torch.topk(torch.softmax(logits, -1), cfg.top_k)
    topw = topw / topw.sum(-1, keepdim=True)
    np.testing.assert_allclose(topw.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("E,k,pad,cf", [(8, 2, 1, 1.25), (8, 3, 1, 0.5),
                                        (6, 2, 4, 1.25), (8, 2, 1, 0.1)],
                         ids=["granite_smoke", "k3_tight", "padded",
                              "drops"])
def test_apply_matches_jax(E, k, pad, cf):
    """The port's dispatch against the JAX package's on the same weights:
    the output, and ``lb_loss`` and ``dropped`` (drops at capacity
    factors below dropless)."""
    cfg_j, pj, cfg_t, pt = _both(E, k, pad, capacity_factor=cf)
    x = _x(cfg_t, (2, 24), seed=3)
    want, aux_j = jmoe.apply(cfg_j, pj, jnp.asarray(x))
    got, aux_t = moe.apply(cfg_t, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    assert float(aux_t["dropped"]) == float(aux_j["dropped"])
    np.testing.assert_allclose(float(aux_t["lb_loss"]),
                               float(aux_j["lb_loss"]), rtol=1e-6)


def test_shared_experts_are_added():
    """deepseek's SMOKE MoE (2 shared experts) against the JAX package."""
    cfg_j = dataclasses.replace(jget_smoke("deepseek-v2-lite-16b"),
                                compute_dtype="float32")
    cfg_t = dataclasses.replace(get_smoke("deepseek-v2-lite-16b"),
                                compute_dtype="float32")
    pj = jmoe.init(cfg_j, jax.random.PRNGKey(4))
    pt = _to_port(jax.tree.map(np.asarray, pj))
    assert {"shared0", "shared1"} <= dict(pt.named_children()).keys()
    x = _x(cfg_t, (1, 12), seed=5)
    want, aux_j = jmoe.apply(cfg_j, pj, jnp.asarray(x))
    got, aux_t = moe.apply(cfg_t, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    assert float(aux_t["dropped"]) == float(aux_j["dropped"])
