"""The port's model stack on the CPU against the JAX package for the eight
archs of the other LM configs: dense attention (qwen3-0.6b, llama3.2-3b,
gemma2-27b), MLA (minicpm3-4b, deepseek-v2-lite-16b), MoE
(granite-moe-3b-a800m, deepseek) and cross-attention with the stubbed
frontends (llama-3.2-vision-11b, whisper-tiny with its encoder).

On the SMOKE configs switched to float32 (as ``tests/test_arch_smoke.py``
does), with the JAX init carried across by ``convert.params_from_numpy``
and the same numpy tokens and frontend embeddings: each config field for
field, the layer groups, the parameter map both ways, ``transformer.apply``
in train mode (logits and ``aux``, the MoE load-balancing loss), prefill
(logits and caches) and decode, and the port's own decode-matches-forward
identity.  The cross-attention gates are set to 0.5 in both packages (the
init's 0 would switch cross-attention off).  The full configs' total and
active parameter counts equal the JAX package's.  Tolerances: 2e-3 for
train and prefill logits and caches, 5e-3 for decode, as
``test_arch_smoke.py:71-101``; aux within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import transformer

ARCHS = ("qwen3-0.6b", "llama3.2-3b", "gemma2-27b", "minicpm3-4b",
         "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
         "llama-3.2-vision-11b", "whisper-tiny")
CPU = "cpu"
# (total, active) parameters of the full configs (JAX ``param_count``)
FULL_PARAMS = {
    "qwen3-0.6b": (596_049_920, 596_049_920),
    "llama3.2-3b": (3_212_749_824, 3_212_749_824),
    "gemma2-27b": (27_227_128_320, 27_227_128_320),
    "minicpm3-4b": (4_073_875_968, 4_073_875_968),
    "deepseek-v2-lite-16b": (15_496_769_024, 2_451_435_008),
    "granite-moe-3b-a800m": (3_298_793_472, 882_874_368),
    "llama-3.2-vision-11b": (9_249_820_680, 9_249_820_680),
    "whisper-tiny": (36_439_684, 36_439_684),
}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def open_gates(tree, value=0.5):
    """The parameter tree with every cross-attention ``gate`` (under an
    ``attn`` or ``xattn`` node) set to ``value``."""
    if isinstance(tree, list):
        return [open_gates(t, value) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("attn", "xattn") and isinstance(v, dict) and "gate" in v:
            v = dict(v, gate=np.full_like(v["gate"], value))
        out[k] = open_gates(v, value)
    return out


def _frontend(cfg, B, seed=2):
    if not cfg.encoder_seq:
        return None
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
            ).astype(np.float32)


def _both_enc(enc):
    if enc is None:
        return None, None
    return jnp.asarray(enc), torch.from_numpy(enc)


def _load(cfg_j, cfg_t, seed):
    tree = open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg_j, jax.random.PRNGKey(seed))))
    return (tree, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(cfg_t, tree, device=CPU))


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(JAX config, JAX params, port config, port model, numpy tree) on
    SMOKE."""
    arch = request.param
    cfg_j, cfg_t = _f32(jget_smoke(arch)), _f32(get_smoke(arch))
    tree, params, model = _load(cfg_j, cfg_t, seed=1)
    return cfg_j, params, cfg_t, model, tree


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _unstack_cache(cfg_j, cache):
    """The JAX cache (stacked groups) as one dict per layer, in the port's
    layer order."""
    out = []
    for (unit, reps), gc in zip(jt.layer_groups(cfg_j), cache):
        for r in range(reps):
            for j in range(len(unit)):
                out.append(jax.tree.map(
                    lambda x: np.asarray(x[r] if reps > 1 else x),
                    gc[f"l{j}"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.cdtype == torch.bfloat16 and cfg.hd == jcfg.hd
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert [cfg.ffn_kind(i) for i in range(cfg.n_layers)] == \
            [jcfg.ffn_kind(i) for i in range(jcfg.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_layer_groups_equal_jax(which, arch):
    get, jget = ((get_smoke, jget_smoke) if which == "smoke"
                 else (get_config, jget_config))
    assert transformer.layer_groups(get(arch)) == jt.layer_groups(jget(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_the_full_config_equal_jax(arch):
    """Total and active (MoE: top_k of n_experts of each routed expert
    stack) parameters, from the config alone."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = (transformer.param_count(cfg),
           transformer.param_count(cfg, active_only=True))
    assert got == (jt.param_count(jcfg),
                   jt.param_count(jcfg, active_only=True)) == \
        FULL_PARAMS[arch]
    assert (cfg.total_params(), cfg.active_params()) == got


def test_leading_dense_layer_takes_dense_d_ff():
    """deepseek's layer 0 is dense with d_ff 10944 (``dense_d_ff``), the
    layers after it MoE of 64 experts of 1408."""
    model = transformer.init_params(get_config("deepseek-v2-lite-16b"),
                                    device="meta")
    first, second = model.layers[0], model.layers[1]
    assert first.ffn == "mlp" and tuple(first.mlp.up.shape) == (2048, 10944)
    assert second.ffn == "moe" and not hasattr(second, "mlp")
    assert tuple(second.moe.experts.up.shape) == (64, 2048, 1408)


def test_params_map_one_to_one_both_ways(both):
    cfg_j, _, cfg_t, model, tree = both
    back = convert.params_to_numpy(cfg_t, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(tree))
    extra = dict(tree, final_norm_extra=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="only in the JAX tree"):
        convert.params_from_numpy(cfg_t, extra, device=CPU)
    short = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="only in the port"):
        convert.params_from_numpy(cfg_t, short, device=CPU)


def test_train_logits_and_aux_match_jax(both):
    """Logits within 2e-3; ``aux`` is the sum of the MoE layers' load
    balancing losses (0 without MoE), as the JAX package's."""
    cfg_j, params, cfg_t, model, _ = both
    tok = _tokens(cfg_t, 2, 40)
    ej, et = _both_enc(_frontend(cfg_t, 2))
    lj, _, aj = jt.apply(cfg_j, params, jnp.asarray(tok), enc=ej,
                         mode="train")
    lt, cache, at = transformer.apply(cfg_t, model, torch.from_numpy(tok),
                                      enc=et, mode="train")
    assert lt.shape == (2, 40, cfg_t.vocab) and cache is None
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)
    assert (float(at) > 0) == bool(cfg_t.n_experts)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-5, rtol=1e-5)


def test_prefill_and_decode_match_jax(both):
    """Prefill of 24 tokens (logits and every cache: attention, MLA's
    latents, the static cross cache), then 16 decode steps against the
    JAX package's decode, which reads the cross cache."""
    cfg_j, params, cfg_t, model, _ = both
    B, S, pre = 2, 40, 24
    tok = _tokens(cfg_t, B, S, seed=2)
    ej, et = _both_enc(_frontend(cfg_t, B))
    cj = jt.init_cache(cfg_j, B, S, cfg_j.cdtype)
    ct = transformer.init_cache(cfg_t, B, S, cfg_t.cdtype, device=CPU)
    lj, cj, _ = jt.apply(cfg_j, params, jnp.asarray(tok[:, :pre]), enc=ej,
                         mode="prefill", pos=0, cache=cj)
    lt, ct, _ = transformer.apply(cfg_t, model, torch.from_numpy(tok[:, :pre]),
                                  enc=et, mode="prefill", pos=0, cache=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3,
                               rtol=2e-3)
    jcache = _unstack_cache(cfg_j, cj)
    assert len(jcache) == len(ct) == cfg_t.n_layers
    for want, got in zip(jcache, ct):
        assert want.keys() == got.keys()
        for part in want:
            assert want[part].keys() == got[part].keys()
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
    forward's logits position by position (the caches, MLA's latents, the
    cross cache).  The MoE archs route to every expert here, as
    ``test_arch_smoke.py`` does: top-k on near ties is discontinuous."""
    cfg_j, _, cfg_t, model, tree = both
    if cfg_t.n_experts:
        cfg_t = dataclasses.replace(cfg_t, top_k=cfg_t.n_experts,
                                    capacity_factor=1.0)
        model = convert.params_from_numpy(cfg_t, tree, device=CPU)
    B, S, pre = 1, 24, 6
    tok = torch.from_numpy(_tokens(cfg_t, B, S, seed=3))
    _, enc = _both_enc(_frontend(cfg_t, B, seed=4))
    full, _, _ = transformer.apply(cfg_t, model, tok, enc=enc, mode="train")
    cache = transformer.init_cache(cfg_t, B, S, cfg_t.cdtype, device=CPU)
    pl, cache, _ = transformer.apply(cfg_t, model, tok[:, :pre], enc=enc,
                                     mode="prefill", pos=0, cache=cache)
    np.testing.assert_allclose(pl.numpy(), full[:, :pre].numpy(), atol=2e-3,
                               rtol=2e-3)
    for t in range(pre, S):
        dl, cache, _ = transformer.apply(cfg_t, model, tok[:, t:t + 1],
                                         mode="decode", pos=t, cache=cache)
        np.testing.assert_allclose(dl[:, 0].numpy(), full[:, t].numpy(),
                                   atol=5e-3, rtol=5e-3,
                                   err_msg=f"decode@{t}")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_attention_reads_the_frontend(arch):
    """With the gates open the frontend embeddings move the logits; with
    the init's closed gates (tanh(0) = 0) they do not."""
    cfg = _f32(get_smoke(arch))
    model = transformer.init_params(cfg, torch.Generator().manual_seed(8),
                                    device=CPU)
    tok = torch.from_numpy(_tokens(cfg, 1, 8, seed=5))
    enc = torch.from_numpy(_frontend(cfg, 1, seed=6))

    def logits(e):
        return transformer.apply(cfg, model, tok, enc=e)[0]

    if cfg.encoder_layers:        # whisper's encoder makes enc nonzero
        assert torch.equal(logits(enc), logits(2 * enc))
    gates = [p for n, p in model.named_parameters() if n.endswith("gate")
             and n.split(".")[-2] in ("attn", "xattn")]
    assert gates and all(float(g) == 0.0 for g in gates)
    with torch.no_grad():
        for g in gates:
            g.fill_(0.5)
    assert not torch.allclose(logits(enc), logits(2 * enc), atol=1e-4)
