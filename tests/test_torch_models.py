"""The port's model stack on the CPU against the JAX package, on the SMOKE
configs of both ported archs (recurrentgemma-2b and xlstm-350m) switched
to float32 (as ``tests/test_arch_smoke.py`` does): the parameter map both
ways (xlstm-350m also in the full config's layout, one 8-layer unit
repeated),
``transformer.apply`` in train, prefill (logits and cache) and decode
mode, the port's own decode-matches-forward identity, the layer groups,
and the full config's parameter count from the config alone; every arch
of the registry builds, and stores each weight in the dtype of its use
(the other eight archs' parity is ``test_torch_lm_configs.py``).  Both
packages compute with the same weights (the JAX init, carried across
with ``convert.params_from_numpy``) and the same numpy tokens.
Tolerances: 2e-3 for train and prefill logits and caches, 5e-3 for
decode, as ``test_arch_smoke.py:71-101``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_smoke
from repro_torch.kernels import registry
from repro_torch.models import layers, recurrent, transformer
from repro_torch.models.config import ModelConfig

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
CPU = "cpu"
# weights stored in float32 because the JAX package computes with them in
# float32 (the rest in the compute dtype): the norms (the encoder's and
# the cross-attention block's among them), the MoE router, the gated
# cross-attention's scalar gate, and the recurrent blocks' gates
F32_WEIGHTS = {"norm1", "norm2", "final_norm", "norm1_post", "norm2_post",
               "xnorm", "q_norm", "k_norm", "kv_norm", "router"}
F32_RECURRENT = {
    "recurrentgemma-2b": {"wa", "ba", "wi", "bi", "lam"},
    "xlstm-350m": {"wif", "bif", "ri", "rf", "rz", "ro", "b"},
}
# parameter counts of the full configs (JAX ``CONFIG.total_params()``)
FULL_PARAMS = {"recurrentgemma-2b": 2_894_528_000, "xlstm-350m": 476_735_656}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(JAX config, JAX params, port config, port model) on SMOKE."""
    arch = request.param
    cfg_j, cfg_t = _f32(jget_smoke(arch)), _f32(get_smoke(arch))
    params = jt.init_params(cfg_j, jax.random.PRNGKey(1))
    model = convert.params_from_numpy(cfg_t, jax.tree.map(np.asarray, params),
                                      device=CPU)
    return cfg_j, params, cfg_t, model


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _unstack_cache(cfg_j, cache):
    """The JAX cache (stacked groups) as one dict per layer, in the port's
    layer order."""
    out = []
    for (unit, reps), gc in zip(jt.layer_groups(cfg_j), cache):
        for r in range(reps):
            for j in range(len(unit)):
                leaf = gc[f"l{j}"]
                out.append(jax.tree.map(
                    lambda x: np.asarray(x[r] if reps > 1 else x), leaf))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(type(jget_smoke(arch)))]
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.cdtype == torch.bfloat16 and cfg.hd == jcfg.hd
        assert cfg.layer_kinds() == jcfg.layer_kinds()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registered_arch_builds(arch):
    """Every arch of the registry is ported: its full config builds on the
    meta device, and its SMOKE config on the CPU gives finite logits."""
    assert PORTED == tuple(ARCH_IDS) and len(ARCH_IDS) == 10
    full = transformer.init_params(get_config(arch), device="meta")
    assert len(full.layers) == get_config(arch).n_layers
    cfg = _f32(get_smoke(arch))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device=CPU)
    enc = None
    if cfg.encoder_seq:
        enc = torch.randn((1, cfg.encoder_seq, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    logits, _, aux = transformer.apply(
        cfg, model, torch.from_numpy(_tokens(cfg, 1, 6)), enc=enc)
    assert logits.shape == (1, 6, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_layer_groups_equal_jax(which, arch):
    get, jget = ((get_smoke, jget_smoke) if which == "smoke"
                 else (get_config, jget_config))
    assert transformer.layer_groups(get(arch)) == jt.layer_groups(jget(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_config_equals_jax(arch):
    n = transformer.param_count(get_config(arch))
    assert n == jt.param_count(jget_config(arch)) == FULL_PARAMS[arch]
    assert get_config(arch).total_params() == n


def test_params_map_one_to_one_both_ways(both):
    cfg_j, params, cfg_t, model = both
    tree = jax.tree.map(np.asarray, params)
    back = convert.params_to_numpy(cfg_t, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(tree))
    bad = dict(tree, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError):
        convert.params_from_numpy(cfg_t, bad, device=CPU)


def test_params_map_a_repeated_unit_both_ways():
    """xlstm-350m's full layout, one group of an 8-layer unit repeated (3
    times at 24 layers), at SMOKE width and 16 layers: the stacked leaves
    map onto the unrolled layers and back, and the two models agree."""
    cfg_j = dataclasses.replace(_f32(jget_smoke("xlstm-350m")), n_layers=16)
    cfg_t = dataclasses.replace(_f32(get_smoke("xlstm-350m")), n_layers=16)
    groups = jt.layer_groups(cfg_j)
    assert len(groups) == 1 and groups[0][1] == 2 and len(groups[0][0]) == 8
    assert transformer.layer_groups(cfg_t) == groups
    params = jt.init_params(cfg_j, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    model = convert.params_from_numpy(cfg_t, tree, device=CPU)
    back = convert.params_to_numpy(cfg_t, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(
        model.layers[8].rnn.wq.numpy(),
        tree["groups"][0]["l0"]["rnn"]["wq"][1])
    tok = _tokens(cfg_t, 1, 12, seed=6)
    lj, _, _ = jt.apply(cfg_j, params, jnp.asarray(tok), mode="train")
    lt, _, _ = transformer.apply(cfg_t, model, torch.from_numpy(tok))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weights_stored_in_the_dtype_of_their_use(arch):
    cfg = get_smoke(arch)                          # bfloat16 compute
    model = transformer.init_params(cfg, device="meta")
    f32 = F32_WEIGHTS | F32_RECURRENT.get(arch, set())
    for name, p in model.named_parameters():
        *_, parent, leaf = ("",) + tuple(name.split("."))
        # "gate" is the cross-attention's scalar under an attention block,
        # a projection (bf16) under an MLP or the experts
        cross_gate = leaf == "gate" and parent in ("attn", "xattn")
        want = (torch.float32 if leaf in f32 or cross_gate
                else torch.bfloat16)
        assert p.dtype == want, name


def test_train_logits_match_jax(both):
    cfg_j, params, cfg_t, model = both
    tok = _tokens(cfg_t, 2, 40)
    lj, _, _ = jt.apply(cfg_j, params, jnp.asarray(tok), mode="train")
    lt, cache, aux = transformer.apply(cfg_t, model, torch.from_numpy(tok),
                                       mode="train")
    assert lt.shape == (2, 40, cfg_t.vocab) and cache is None
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)


def test_prefill_and_decode_match_jax(both):
    """Prefill past the window (24 > 16) fills the rolling cache; decode
    then runs 16 more positions against the JAX package's decode."""
    cfg_j, params, cfg_t, model = both
    B, S, pre = 2, 40, 24
    tok = _tokens(cfg_t, B, S, seed=2)
    cj = jt.init_cache(cfg_j, B, S, cfg_j.cdtype)
    ct = transformer.init_cache(cfg_t, B, S, cfg_t.cdtype, device=CPU)
    lj, cj, _ = jt.apply(cfg_j, params, jnp.asarray(tok[:, :pre]),
                         mode="prefill", pos=0, cache=cj)
    lt, ct, _ = transformer.apply(cfg_t, model, torch.from_numpy(tok[:, :pre]),
                                  mode="prefill", pos=0, cache=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)
    jcache = _unstack_cache(cfg_j, cj)
    assert len(jcache) == len(ct) == cfg_t.n_layers
    for want, got in zip(jcache, ct):
        assert want.keys() == got.keys()
        for part in want:
            for name in want[part]:
                np.testing.assert_allclose(got[part][name].numpy(),
                                           want[part][name], atol=2e-3,
                                           rtol=2e-3)
    for t in range(pre, S):
        dj, cj, _ = jt.apply(cfg_j, params, jnp.asarray(tok[:, t:t + 1]),
                             mode="decode", pos=t, cache=cj)
        dt, ct, _ = transformer.apply(cfg_t, model,
                                      torch.from_numpy(tok[:, t:t + 1]),
                                      mode="decode", pos=t, cache=ct)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=5e-3,
                                   rtol=5e-3, err_msg=f"decode@{t}")


def test_decode_matches_full_forward(both):
    """The port's own identity: prefill + decode reproduce the full
    forward's logits position by position (caches, the rolling window,
    the recurrent state)."""
    _, _, cfg_t, model = both
    B, S, pre = 1, 36, 6
    tok = torch.from_numpy(_tokens(cfg_t, B, S, seed=3))
    full, _, _ = transformer.apply(cfg_t, model, tok, mode="train")
    cache = transformer.init_cache(cfg_t, B, S, cfg_t.cdtype, device=CPU)
    pl, cache, _ = transformer.apply(cfg_t, model, tok[:, :pre],
                                     mode="prefill", pos=0, cache=cache)
    np.testing.assert_allclose(pl.numpy(), full[:, :pre].numpy(), atol=2e-3,
                               rtol=2e-3)
    for t in range(pre, S):
        dl, cache, _ = transformer.apply(cfg_t, model, tok[:, t:t + 1],
                                         mode="decode", pos=t, cache=cache)
        np.testing.assert_allclose(dl[:, 0].numpy(), full[:, t].numpy(),
                                   atol=5e-3, rtol=5e-3,
                                   err_msg=f"decode@{t}")


def test_logits_window_and_plain_impl(both):
    _, _, cfg_t, model = both
    tok = torch.from_numpy(_tokens(cfg_t, 1, 20, seed=4))
    full, _, _ = transformer.apply(cfg_t, model, tok)
    with registry.plain():
        last, _, _ = transformer.apply(cfg_t, model, tok, logits_window=1)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_slstm_stacks_its_recurrence_once_and_follows_writes():
    """The sLSTM block stacks its four recurrence matrices once, not on
    every call; an in-place write of one (as a weight load makes) stacks
    them again, so the block computes with the weights it holds: the same
    logits as a model built afresh from them."""
    cfg = _f32(get_smoke("xlstm-350m"))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device=CPU)
    rnn = next(m for m in model.layers if m.kind == "slstm").rnn
    tok = torch.from_numpy(_tokens(cfg, 1, 8, seed=7))
    first, _, _ = transformer.apply(cfg, model, tok)
    stacked = recurrent._stacked_r(rnn)
    transformer.apply(cfg, model, tok)
    assert recurrent._stacked_r(rnn) is stacked
    with torch.no_grad():
        rnn.rf.mul_(20.0)
    moved, _, _ = transformer.apply(cfg, model, tok)
    assert recurrent._stacked_r(rnn) is not stacked
    assert torch.equal(recurrent._stacked_r(rnn)[1], rnn.rf)
    fresh = convert.params_from_numpy(
        cfg, convert.params_to_numpy(cfg, model), device=CPU)
    again, _, _ = transformer.apply(cfg, fresh, tok)
    assert not torch.allclose(moved, first)
    torch.testing.assert_close(moved, again, rtol=0, atol=0)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_layers_match_jax(act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 6, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    pos = np.arange(3, 9)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        layers.ACTS[act](torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.ACTS[act](jnp.asarray(x))), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(x), 2.0).numpy(),
        np.asarray(jlayers.softcap(jnp.asarray(x), 2.0)), atol=1e-6,
        rtol=1e-5)
