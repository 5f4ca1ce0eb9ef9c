"""Sequence parallelism (``act_sharding``, Megatron's) in the port's
sharded steps, on 4 gloo CPU ranks.

The SMOKE configs of the ten archs in float32 (the cross-attention gates
opened to 0.5, as ``test_torch_lm_configs.open_gates`` does), on ``(data,
model)`` meshes (1, 4) and (2, 2), from the same numpy weights and batch
(4 rows of 16 tokens; whisper's and the vlm's frontend embeddings).  Each
arch's own adjoint sites are among them: MLA's latents (minicpm3-4b,
deepseek-v2-lite-16b), the experts over ``"model"`` (granite-moe-3b-a800m,
deepseek-v2-lite-16b), the cross-attention gate (llama-3.2-vision-11b,
whisper-tiny), gemma2's post-norms, the RG-LRU (recurrentgemma-2b) and
the mLSTM and sLSTM (xlstm-350m):

1. the loss and each rank's gradient shards with ``act_sharding=(("data",),
   "model", None)`` within 1e-5 of the step without it (relative L2 a
   leaf) and of the port's one-rank gradients' slices, with remat too;
2. the forward runs the collectives of the table in ``models/sharding.py``:
   the blocks' inputs all-gathered over the sequence and their outputs
   reduce-scattered onto it, each with its adjoint in the backward;
3. the prefill's last logits with it within 1e-5 of those without it and
   of the JAX package's unsharded prefill;
4. it is refused for a decode step and for a sequence that does not
   divide the model axis.

One set of 4 rank processes runs every mesh and arch
(``torch_dry_ranks.seq_parallel_rank``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dry_ranks
import torch_ranks
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro.serve.engine import make_serve_steps as jmake_serve_steps
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import DeviceGroup, run_ranks
from repro_torch.models import sharding
from test_torch_lm_configs import _frontend, open_gates

ARCHS = ("qwen3-0.6b", "llama3.2-3b", "gemma2-27b", "minicpm3-4b",
         "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
         "llama-3.2-vision-11b", "whisper-tiny", "recurrentgemma-2b",
         "xlstm-350m")
MESHES = ((1, 4), (2, 2))
B, S = 4, 16
TOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _case(arch, seed=1):
    cfg = _f32(jget_smoke(arch))
    tree = open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(seed))))
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return (arch, tree, tok.astype(np.int32),
            np.roll(tok, -1, 1).astype(np.int32), _frontend(cfg, B))


@pytest.fixture(scope="module")
def cases():
    return [_case(a) for a in ARCHS]


@pytest.fixture(scope="module")
def ranks(cases):
    return run_ranks(torch_dry_ranks.seq_parallel_rank, 4, device="cpu",
                     args=(MESHES, cases, S), timeout=300)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _one_rank(case):
    arch, tree, tok, lab, enc = case
    cfg = _f32(get_smoke(arch))
    state = convert.train_state_from_numpy(cfg, {"params": tree},
                                           device="cpu")
    return torch_ranks.grads_on(cfg, state, tok, lab, enc, remat=False)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_with_sequence_parallelism(ranks, cases, arch, mesh):
    case = next(c for c in cases if c[0] == arch)
    one = _one_rank(case)
    for res in ranks:
        got = res.get((mesh, arch))
        if got is None:
            continue
        for key in ("sp", "sp_remat"):
            assert abs(got[key]["loss"] - got["tp"]["loss"]) <= \
                TOL * abs(got["tp"]["loss"])
            assert abs(got[key]["loss"] - one["loss"]) <= \
                TOL * abs(one["loss"])
            for name, g in got[key]["grads"].items():
                cut = tuple(slice(a, b) for a, b in got["cuts"][name])
                assert _rel(g, got["tp"]["grads"][name]) <= TOL, \
                    (key, name)
                assert _rel(g, one["grads"][name][cut]) <= TOL, (key, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_collectives_run(ranks, arch):
    """On (1, 4) every block's partial output is reduce-scattered onto
    the sequence (the embedding's too; whisper's decoder cross-attention
    is a block of its own) and every block's input and the head's
    gathered over it; the backward runs their adjoints.  A block whose
    output is replicated is sliced with no collective: xlstm's sLSTM,
    whose feed-forward's int(4 d / 3) rows (85 at the SMOKE width) do not
    split over 4 model ranks."""
    cfg = get_smoke(arch)
    cross = cfg.cross_kind == "decoder"
    blocks = sum(1 + cross + (f != "none") for f in
                 (cfg.ffn_kind(i) for i in range(cfg.n_layers)))
    whole = sum(1 for k in cfg.layer_kinds()
                if k == "slstm" and int(cfg.d_model * 4 / 3) % 4)
    calls = next(r[(1, 4), arch]["calls"] for r in ranks
                 if ((1, 4), arch) in r)
    assert calls["reduce_scatter"] == blocks + 1 - whole
    assert calls["all_gather.bwd"] >= calls["reduce_scatter"]
    assert calls["reduce_scatter.bwd"] == blocks + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_with_sequence_parallelism(ranks, cases, arch):
    case = next(c for c in cases if c[0] == arch)
    _, tree, tok, _, enc = case
    cfg = _f32(jget_smoke(arch))
    prefill, _, init_cache = jmake_serve_steps(cfg, max_len=S, batch=B)
    want, _ = prefill(jax.tree.map(jnp.asarray, tree), jnp.asarray(tok),
                      init_cache(), None if enc is None else jnp.asarray(enc))
    want = np.asarray(want)
    for res in ranks:
        for (mesh, a), got in res.items():
            if a != arch:
                continue
            assert _rel(got["prefill_sp"], got["prefill"]) <= TOL, mesh
            assert _rel(got["prefill_sp"], want) <= TOL, mesh


def test_sequence_parallelism_refuses_a_decode_and_a_ragged_sequence():
    group = DeviceGroup.dry((1, 4), ("data", "model"))
    sh = sharding.Sharding(group, batch=4)
    act = (("data",), "model", None)
    assert sh.seq_parallel(None, 16, "train") is sh
    assert sh.seq_parallel(act, 16, "prefill").seq
    with pytest.raises(ValueError, match="divide"):
        sh.seq_parallel(act, 1, "decode")
    with pytest.raises(ValueError, match="divide"):
        sh.seq_parallel(act, 18, "train")
    with pytest.raises(ValueError, match="act_sharding"):
        sh.seq_parallel((("data",), "data", None), 16, "train")
    one = sharding.Sharding(DeviceGroup.dry((4, 1), ("data", "model")),
                            batch=4)
    assert one.seq_parallel(act, 18, "train") is one
