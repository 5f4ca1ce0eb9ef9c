"""The sharded train step on the CPU: the eight attention archs' SMOKE
configs in float32 (the cross-attention gates opened to 0.5, as
``test_torch_lm_configs.open_gates`` does) on 2 and 4 gloo ranks, the
train state split over ``(data, model)`` meshes (1, 2), (1, 4) and (2, 2)
by the JAX package's specs (``make_train_step(mesh=)``).

From the same numpy weights and batch (4 rows of 16 tokens; whisper's and
the vlm's frontend embeddings):

1. each rank's gradient shard against the slice of the port's one-rank
   gradient, within 1e-5 relative L2 per leaf: this pins the adjoint of
   every collective of the forward (``models/sharding.py``'s table);
2. two steps (lr 1e-3): the metrics of each within 1e-5 of the one-rank
   step's; after each step every shard of ``m`` and ``v`` against the
   one-rank tensor's slice by the rule of ``test_torch_train.py`` (the
   difference within ``UPDATE_TOL`` of the leaf's movement, each element
   within ``ELEMENT_TOL``); every parameter element within 1e-8 of the
   AdamW update of the shard's own moments (within 1e-6 of the element
   and of the step's size); and the
   parameters by the same rule where that update has been well
   conditioned at every step so far.  AdamW moves an element by
   lr * m^ / (sqrt(v^) + 1e-8); where the bias-corrected first moment m^
   is within ten times that 1e-8 (below ``COND_FLOOR``) the update turns
   the float32 summation-order difference of the gradient into a
   difference of the step's size: qwen3-0.6b's ``wq`` on (1, 4) has one
   such element (a first gradient of -3.6e-8 on one rank, -3.0e-8 on the
   shard, every other element within 4e-9), which alone puts the leaf's
   update 1.06e-3 of its movement apart, and gemma2-27b's ``wo`` one
   (-3.5e-8 against -2.1e-8): 2.9e-3, an element 1.3e-4 apart.  Whisper's
   encoder ``wq`` has 545 of its 1024 first gradients below 1e-7;
3. ``microbatches=2`` on (2, 2) against ``microbatches=1`` within 1e-5
   (after ``tests/test_substrates.py:61``) for the dense archs; an MoE
   layer's capacity and load-balancing loss are a microbatch's, so the
   MoE archs' are held against one rank's ``microbatches=2`` by test 2's
   rules;
4. ``remat=True`` on (1, 2) against the no-remat gradients, bitwise: the
   recomputed forward runs its collectives again in the backward;
5. the JAX package's own sharded step (``make_train_step(cfg, mesh)`` and
   ``build(state_shardings(...))`` on a (2, 2) mesh of 4 host devices, in
   one subprocess) against the port's (2, 2) step, for qwen3-0.6b,
   granite-moe-3b-a800m (experts over ``"model"``), minicpm3-4b (MLA)
   and whisper-tiny (encoder and cross-attention), at the tolerances of
   ``test_torch_train.py::test_train_step_matches_jax``;
6. each rank's bytes of params, ``m`` and ``v``: 3 x ``spec_bytes``; the
   global norm on (2, 2), whose norms are replicated over ``"data"``,
   within 1e-6 of one rank's (each element counted once);
7. a train state carried across (``convert.train_state_from_numpy(
   mesh=)``, AdamW's ``m``, ``v`` and step from the JAX tree layout):
   each rank's moments are the leaves' slices by ``state_shardings``.

One set of 4 rank processes runs every mesh and arch
(``torch_ranks.sharded_train_rank``).
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from helpers import run_with_devices
from repro.configs import get_smoke as jget_smoke
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import run_ranks
from repro_torch.models import transformer
from repro_torch.train import trainer
from test_torch_lm_configs import _frontend, open_gates
from test_torch_train import ELEMENT_TOL, STEP_TOL, UPDATE_TOL, _close

ARCHS = ("qwen3-0.6b", "llama3.2-3b", "gemma2-27b", "minicpm3-4b",
         "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
         "llama-3.2-vision-11b", "whisper-tiny")
JAX_ARCHS = ("qwen3-0.6b", "granite-moe-3b-a800m", "minicpm3-4b",
             "whisper-tiny")
MESHES = ((1, 2), (1, 4), (2, 2))
EXTRA = {(2, 2): ("microbatches",), (1, 2): ("remat",)}
B, S = 4, 16
GRAD_TOL = 1e-5
GNORM_TOL = 1e-6
MB_TOL = 1e-5
COND_FLOOR = 1e-7      # |m^| below which AdamW's update is ill conditioned
ADAM_TOL = 1e-6        # a parameter against the update of its own moments


def mesh_id(mesh) -> str:
    return "x".join(map(str, mesh))


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def make_case(arch, seed=1):
    """(arch, numpy tree, tokens, labels, frontend embeddings)."""
    cfg = _f32(jget_smoke(arch))
    tree = open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(seed))))
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (B, S))
    return (arch, tree, tok.astype(np.int32),
            np.roll(tok, -1, 1).astype(np.int32), _frontend(cfg, B))


def one_rank(case) -> dict:
    """The port's one-rank gradients and two steps on ``case``."""
    arch, tree, tok, lab, enc = case
    cfg = _f32(get_smoke(arch))

    def fresh():
        return convert.train_state_from_numpy(cfg, {"params": tree},
                                              device="cpu")

    state = fresh()
    return {"grads": torch_ranks.grads_on(cfg, state, tok, lab, enc,
                                          remat=False),
            "steps": torch_ranks.train_steps_on(cfg, state, tok, lab, enc,
                                                2),
            "mb2": torch_ranks.train_steps_on(cfg, fresh(), tok, lab, enc,
                                              1, microbatches=2),
            "init": {k: np.array(p.detach()) for k, p in
                     fresh()["params"].named_parameters()}}


JAX_STEPS = """
import dataclasses, json, sys
sys.path.insert(0, "tests")
from test_torch_lm_configs import _frontend, open_gates
from repro.configs import get_smoke
from repro.core import compat
from repro.models import transformer as jt
from repro.serve.engine import make_serve_steps
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
job = json.loads(JOB)
data = np.load(job["inp"])
mesh = compat.make_mesh(tuple(job["mesh"]), ("data", "model"))
out = {}
for arch in job["train"]:
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, open_gates(jax.tree.map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(job["seed"])))))
    state = {"params": params, "opt": jopt.adamw_init(params)}
    step, build = jtrainer.make_train_step(cfg, mesh, donate=False,
                                           remat=False, **job["kw"])
    sh = jtrainer.state_shardings(cfg, state, mesh)
    fn = build(sh)
    enc = data.get(arch + "/enc")
    with mesh:
        for i in range(job["steps"]):
            state, met = fn(jax.device_put(state, sh),
                            jnp.asarray(data[arch + "/tok"]),
                            jnp.asarray(data[arch + "/lab"]),
                            None if enc is None else jnp.asarray(enc))
            for k, v in met.items():
                out[f"{arch}/{i}/met/{k}"] = np.asarray(v)
            for j, leaf in enumerate(jax.tree.leaves(state["params"])):
                out[f"{arch}/{i}/params/{j}"] = np.asarray(leaf)
for arch in job["serve"]:
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, jax.tree.map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(job["seed"]))))
    tok = data[arch + "/serve_tok"]
    n = job["prefill"]
    prefill, decode, init_cache = make_serve_steps(
        cfg, max_len=job["max_len"], batch=tok.shape[0])
    lg, cache = prefill(params, jnp.asarray(tok[:, :n]), init_cache())
    steps = [np.asarray(lg)]
    for pos in range(n, tok.shape[1]):
        lg, cache = decode(params, jnp.asarray(tok[:, pos:pos + 1]), cache,
                           pos)
        steps.append(np.asarray(lg))
    out[arch + "/serve"] = np.stack(steps)
np.savez(job["out"], **out)
print("ok")
"""


def jax_steps(tmp, cases, *, steps=1, serve=(), serve_tokens=None,
              prefill=0, max_len=0, seed=1) -> dict:
    """One subprocess on 4 host devices: the JAX package's sharded train
    step (``build(state_shardings(...))`` on a (2, 2) mesh) ``steps``
    times on each case, and its unsharded serve steps (a prefill of
    ``prefill`` tokens, then a decode step a later column) on each arch of
    ``serve``.  Returns the npz's arrays."""
    inp, out = tmp / "jax_in.npz", tmp / "jax_out.npz"
    arrays = {}
    for arch, _, tok, lab, enc in cases:
        arrays[arch + "/tok"], arrays[arch + "/lab"] = tok, lab
        if enc is not None:
            arrays[arch + "/enc"] = enc
    for arch in serve:
        arrays[arch + "/serve_tok"] = serve_tokens[arch]
    np.savez(inp, **arrays)
    job = {"inp": str(inp), "out": str(out), "mesh": [2, 2],
           "train": [c[0] for c in cases], "steps": steps,
           "kw": torch_ranks.TRAIN_KW, "seed": seed, "serve": list(serve),
           "prefill": prefill, "max_len": max_len}
    run_with_devices(f"JOB = {json.dumps(job)!r}\n" + JAX_STEPS, 4,
                     timeout=400)
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def cases():
    return {arch: make_case(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def refs(cases):
    return {arch: one_rank(case) for arch, case in cases.items()}


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    return run_ranks(torch_ranks.sharded_train_rank, 4, device="cpu",
                     args=(MESHES, list(cases.values()), EXTRA),
                     timeout=300, store_dir=tmp_path_factory.mktemp("tr"))


@pytest.fixture(scope="module")
def jax_out(cases, tmp_path_factory):
    return jax_steps(tmp_path_factory.mktemp("jx"),
                     [cases[a] for a in JAX_ARCHS])


def runs(ranks, mesh, arch):
    return [ranks[r][mesh, arch] for r in range(math.prod(mesh))]


def cut(run, name):
    return tuple(slice(a, b) for a, b in run["cuts"][name])


def rel_l2(a, b) -> float:
    d = np.linalg.norm(a - b)
    return 0.0 if d == 0 else float(d / np.linalg.norm(b))


def check_moved(have, want, old, what):
    """The rule of ``test_torch_train.py``: the difference within
    ``UPDATE_TOL`` of the movement, each element within ``ELEMENT_TOL``."""
    assert np.linalg.norm(have - want) <= UPDATE_TOL * np.linalg.norm(
        want - old), what
    assert np.abs(have - want).max(initial=0.0) <= ELEMENT_TOL, what


def whole_params(rs, names) -> dict:
    """The whole leaves after the first step (numpy, by port name) from
    every rank's shards."""
    out = {}
    for name in names:
        shape = [max(r["cuts"][name][d][1] for r in rs)
                 for d in range(len(rs[0]["cuts"][name]))]
        full = np.zeros(shape, np.float32)
        for r in rs:
            full[cut(r, name)] = r["steps"]["first"]["params"][name]
        out[name] = full
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_gradient_shards_match_one_rank(ranks, refs, mesh, arch):
    ref = refs[arch]["grads"]
    for run in runs(ranks, mesh, arch):
        got = run["grads"]
        assert abs(got["loss"] - ref["loss"]) <= STEP_TOL
        for name, g in got["grads"].items():
            want = ref["grads"][name][cut(run, name)]
            assert g.shape == want.shape, name
            assert rel_l2(g, want) <= GRAD_TOL, (name, rel_l2(g, want))


def adamw(p, m, v, t, lr, decay):
    """AdamW's parameter update (``train.optimizer.adamw_update``) from the
    moments after step ``t``, in float32."""
    f = np.float32
    delta = (m / f(1 - 0.9 ** t)) / (np.sqrt(v / f(1 - 0.95 ** t)) + f(1e-8))
    if decay:
        delta = delta + f(0.1) * p
    return p - f(lr) * delta


def check_steps(run, got, ref, init, decay):
    """The steps ``got`` of one rank (``train_steps_on``'s) against the
    one-rank steps ``ref`` from the whole parameters ``init``: test 2's
    rules."""
    for g, w in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "gnorm", "lr", "nll", "aux"):
            assert _close(g[k], w[k], STEP_TOL), k
    before = {k: v[cut(run, k)] for k, v in init.items()}
    well = {}
    snaps = ("first", "last")[:len(got["metrics"])]
    for t, snap in enumerate(snaps, 1):
        have, want = got[snap], ref[snap]
        lr = got["metrics"][t - 1]["lr"]
        for name, p in have["params"].items():
            c = cut(run, name)
            for k in ("m", "v"):
                check_moved(have[k][name], want[k][name][c], 0.0,
                            (snap, k, name))
            np.testing.assert_allclose(
                p, adamw(before[name], have["m"][name], have["v"][name], t,
                         lr, decay[name]), rtol=ADAM_TOL,
                atol=ADAM_TOL * lr, err_msg=str((snap, name)))
            # an element ill conditioned at one step stays apart after
            well[name] = well.get(name, True) & (np.abs(
                want["m"][name][c] / (1 - 0.9 ** t)) >= COND_FLOOR)
            w = well[name]
            check_moved(p[w], want["params"][name][c][w], init[name][c][w],
                        (snap, name))
        before = have["params"]


def decay_of(arch) -> dict:
    cfg = _f32(get_smoke(arch))
    return trainer.decay_mask(cfg, transformer.Transformer(cfg,
                                                           device="meta"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_two_steps_match_one_rank(ranks, refs, mesh, arch):
    ref, decay = refs[arch], decay_of(arch)
    for run in runs(ranks, mesh, arch):
        check_steps(run, run["steps"], ref["steps"], ref["init"], decay)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_one_batch(ranks, refs, arch):
    for run in runs(ranks, (2, 2), arch):
        mb = run["mb2"]
        if get_smoke(arch).n_experts:
            check_steps(run, mb, refs[arch]["mb2"], refs[arch]["init"],
                        decay_of(arch))
            continue
        one = run["steps"]
        assert abs(mb["metrics"][0]["loss"] -
                   one["metrics"][0]["loss"]) < MB_TOL
        for name, p in mb["first"]["params"].items():
            assert np.abs(p - one["first"]["params"][name]).max() < MB_TOL, \
                name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_no_remat(ranks, arch):
    for run in runs(ranks, (1, 2), arch):
        assert run["remat"]["loss"] == run["grads"]["loss"]
        for name, g in run["remat"]["grads"].items():
            np.testing.assert_array_equal(g, run["grads"]["grads"][name],
                                          err_msg=name)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_step_matches_jax_sharded_step(ranks, refs, jax_out, arch):
    cfg = _f32(get_smoke(arch))
    rs = runs(ranks, (2, 2), arch)
    met = rs[0]["steps"]["metrics"][0]
    for k in ("loss", "gnorm", "lr", "nll", "aux"):
        assert _close(met[k], float(jax_out[f"{arch}/0/met/{k}"]),
                      STEP_TOL), k
    names = list(rs[0]["cuts"])
    got = convert.named_to_numpy(cfg, {
        k: torch.from_numpy(v) for k, v in whole_params(rs, names).items()})
    old = jax.tree.leaves(convert.named_to_numpy(cfg, {
        k: torch.from_numpy(v) for k, v in refs[arch]["init"].items()}))
    for j, (have, o) in enumerate(zip(jax.tree.leaves(got), old)):
        check_moved(have, jax_out[f"{arch}/0/params/{j}"], o, j)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_rank_bytes_and_global_norm(ranks, refs, mesh, arch):
    for run in runs(ranks, mesh, arch):
        assert run["bytes"] == 3 * run["spec_bytes"]
        if mesh == (2, 2):
            got = run["steps"]["metrics"][0]["gnorm"]
            want = refs[arch]["steps"]["metrics"][0]["gnorm"]
            assert abs(got - want) <= GNORM_TOL * max(abs(want), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_id)
def test_carried_state_moments_are_the_slices(ranks, cases, mesh, arch):
    cfg = _f32(get_smoke(arch))
    opt = torch_ranks.carried_opt(cases[arch][1])
    for run in runs(ranks, mesh, arch):
        got = run["carried"]
        assert got["step"] == 3
        for k in ("m", "v"):
            want = convert.port_leaves(cfg, opt[k])
            assert set(got[k]) == set(want)
            for name, t in got[k].items():
                np.testing.assert_array_equal(
                    t, np.asarray(want[name], np.float32)[cut(run, name)],
                    err_msg=f"{k} {name}")
