"""The port's flash attention on the CPU against the JAX package: the plain
``flash_attention`` and ``chunked_attention`` against JAX's Pallas kernel
(interpret mode) and its chunked form, at the JAX spec's five feature
samples and at recurrentgemma's SMOKE shapes, with v's own head dim at
the MLA archs' (D, Dv) (``DV_CASES``: 96 / 64, 192 / 128), and
``decode_attention`` with and without a rolling cache's ``k_positions``
and with v's own head dim.  Inputs are made with numpy and handed to both
packages.  Tolerances are the JAX spec's: 2e-3, 2e-2 for bf16 (the
outputs are rounded to bf16 there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import (DV_CASES, FEATURE_CASES,
                                                 attention_ref,
                                                 chunked_attention,
                                                 decode_attention,
                                                 flash_attention, live_pairs)

# recurrentgemma-2b SMOKE's local layer: 2 query heads on one kv head of
# dim 32, window 16, a prompt longer than the window
SMOKE_CASE = (1, 2, 1, 40, 40, 32, torch.float32,
              {"causal": True, "window": 16}, 2e-3)
CASES = FEATURE_CASES + (SMOKE_CASE,)
IDS = ["causal", "gqa_q_offset", "window_softcap", "kv_len_noncausal",
       "bf16", "recurrentgemma_smoke"]


def _inputs(case, seed):
    B, Hq, Hkv, S, T, D, dtype, kw, tol = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    torch_args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return jax_args, torch_args, kw, tol


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("jimpl", ["pallas", "chunked"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_versions_match_jax(case, jimpl):
    jargs, targs, kw, tol = _inputs(case, seed=CASES.index(case))
    want = _np(jflash(*jargs, impl=jimpl, **kw))
    for fn in (flash_attention, chunked_attention):
        got = fn(*targs, **kw)
        assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=10 * tol)


@pytest.mark.parametrize("case", CASES[:4] + (SMOKE_CASE,),
                         ids=IDS[:4] + IDS[5:])
def test_oracle_matches_jax_oracle(case):
    jargs, targs, kw, tol = _inputs(case, seed=7)
    np.testing.assert_allclose(_np(attention_ref(*targs, **kw)),
                               _np(jattention_ref(*jargs, **kw)),
                               atol=tol, rtol=10 * tol)


def _dv_inputs(case, seed):
    B, Hq, Hkv, S, T, D, Dv, dtype, kw, tol = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
    return ([jnp.asarray(x) for x in (q, k, v)],
            [torch.from_numpy(x).to(dtype) for x in (q, k, v)], kw, tol)


@pytest.mark.parametrize("jimpl", ["pallas", "naive"])
@pytest.mark.parametrize("case", DV_CASES, ids=["D96_Dv64", "D192_Dv128"])
def test_v_head_dim_matches_jax(case, jimpl):
    """v of its own head dim (MLA's prefill): the plain versions and the
    oracle against JAX's Pallas kernel in interpret mode and its oracle,
    causal and at a q_offset."""
    jargs, targs, kw, tol = _dv_inputs(case, seed=21)
    want = _np(jflash(*jargs, impl=jimpl, **kw))
    assert want.shape[-1] == targs[2].shape[-1]
    for fn in (flash_attention, chunked_attention, attention_ref):
        got = fn(*targs, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=10 * tol)


def test_chunk_size_does_not_change_the_result():
    _, targs, kw, tol = _inputs(FEATURE_CASES[2], seed=3)
    a = chunked_attention(*targs, block_k=64, **kw)
    b = chunked_attention(*targs, block_k=100, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_rows_with_no_live_key_give_zero():
    _, (q, k, v), _, _ = _inputs(FEATURE_CASES[0], seed=4)
    out = chunked_attention(q, k, v, causal=True, q_offset=-200)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("rolling", [False, True], ids=["linear", "rolling"])
def test_decode_attention_matches_jax(rolling):
    rng = np.random.default_rng(11)
    B, Hq, Hkv, T, D = 2, 4, 1, 16, 32
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    if rolling:
        # a window-16 cache at position 37: slot t holds 37 - ((37 - t) % 16)
        pos = 37
        kp = np.broadcast_to(pos - ((pos - np.arange(T)) % T), (B, T))
        kw = {"kv_len": np.full((B,), pos + 1), "window": 16,
              "k_positions": kp}
    else:
        kw = {"kv_len": np.array([9, 16])}
    want = jdecode(*(jnp.asarray(x) for x in (q, k, v)),
                   **{n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
                      for n, a in kw.items()})
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           **{n: torch.from_numpy(np.array(a))
                              if isinstance(a, np.ndarray) else a
                              for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("D,Dv", [(96, 64), (192, 128)])
def test_decode_attention_takes_v_head_dim(D, Dv):
    """MLA's decode: q and the keys of D, the values of Dv, against
    JAX's ``decode_attention`` with MLA's scale."""
    rng = np.random.default_rng(12)
    B, H, T = 2, 4, 24
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H, T, Dv)).astype(np.float32)
    kv_len, scale = np.array([17, 24]), 1.0 / np.sqrt(D)
    want = jdecode(*(jnp.asarray(x) for x in (q, k, v)),
                   kv_len=jnp.asarray(kv_len), scale=scale)
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           kv_len=torch.from_numpy(kv_len), scale=scale)
    assert got.shape == (B, H, 1, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def test_live_pairs_counts_the_mask():
    for S, T, kw in ((40, 40, {"causal": True, "window": 16}),
                     (128, 256, {"causal": True, "q_offset": 128}),
                     (128, 256, {"causal": False, "kv_len": 200}),
                     (256, 256, {"causal": True, "window": 64})):
        q_pos = kw.get("q_offset", 0) + np.arange(S)[:, None]
        k_pos = np.arange(T)[None, :]
        mask = np.ones((S, T), bool) & (k_pos < kw.get("kv_len", T))
        if kw["causal"]:
            mask &= k_pos <= q_pos
        if "window" in kw:
            mask &= (q_pos - k_pos) < kw["window"]
        assert live_pairs(S, T, **kw) == int(mask.sum())
    # the LM path's prefill: 4.19e6 live pairs a head
    assert live_pairs(3072, 3072, causal=True, window=2048) == 4_195_328


def test_wrapper_on_cpu_launches_nothing_and_checks_impl():
    _, targs, kw, _ = _inputs(FEATURE_CASES[0], seed=5)
    before = registry.launches()
    flash_attention(*targs, **kw)
    flash_attention(*targs, impl="plain", **kw)
    assert registry.launches() == before
    with pytest.raises(ValueError):
        flash_attention(*targs, impl="pallas", **kw)
