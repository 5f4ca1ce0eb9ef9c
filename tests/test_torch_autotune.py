"""The port's kernel-block autotuner on the CPU: the counterparts of
``tests/test_kernel_registry.py``'s autotune tests and
``tests/test_lib_plans.py``'s plan-key tests.

* off the card the choice is the pin or the default, one tune-cache miss
  then hits; pins (one spec's, ``default``), a pin of the wrong arity,
  and a changed pin as a new tune key; the port's ``pinned_block`` and
  ``choices`` against the JAX package's for the same pin string;
* ``REPRO_KERNEL_TUNE=1`` forces a sweep (of the plain versions: the
  mechanics, not a measurement): its table, its winner from the space as
  ``pick_block(None)`` and in ``choices_token``; a sweep's launches count
  in ``tune_launches`` alone; ``dry()`` never sweeps;
* the segmented BLAS and the gridding plan carry their blocks; the
  batched frame's plan key holds the choices: a changed pin builds a new
  plan, the steady state none, and no tune;
* on 2 gloo ranks whose own sweeps would disagree, both hold rank 0's
  block.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from repro.kernels import registry as jregistry
from repro_torch.core import Communicator, run_ranks
from repro_torch.core.plan import PlanCache
from repro_torch.kernels import registry
from repro_torch.lib import blas, gridding
from repro_torch.nlinv.recon import Reconstructor
from repro_torch.serve import stack_carries

ENVS = (registry.PIN_ENV, registry.TUNE_ENV)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """No pin, no forced sweep, no recorded choice, before and after."""
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)
    registry.reset_choices()
    jregistry.reset_choices()
    yield
    registry.reset_choices()
    jregistry.reset_choices()


def _sample(spec_id, seed=0):
    spec = registry.get(spec_id)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return spec.sample("cpu", gen, ncoils=2, grid=16)


def test_default_off_the_card():
    spec = registry.get("cg_fused.cg_update")
    args = _sample(spec.id)
    cache = PlanCache()
    got = [registry.autotune(spec.id, sample=lambda: (args, {}),
                             token=("t", 16), cache=cache) for _ in (0, 1)]
    assert got == [spec.default_block] * 2
    assert (cache.misses, cache.hits, cache.builds) == (1, 1, 1)
    assert registry.choices("cg_fused")[spec.id] == {"block": "256",
                                                     "source": "default"}
    (plan,) = cache._plans.values()
    assert plan.key == ("kernel_tune", spec.id, "cpu", ("t", 16), None)
    assert plan.meta["table"] == {}


# the non-default candidate each spec is pinned to
PINS = {s.id: next(b for b in s.block_space if b != s.default_block)
        for s in registry.specs() if len(s.block_space) > 1}


@pytest.mark.parametrize("spec_id", sorted(PINS))
def test_pin_of_one_spec(monkeypatch, spec_id):
    spec, pin = registry.get(spec_id), PINS[spec_id]
    label = "x".join(map(str, pin))
    monkeypatch.setenv(registry.PIN_ENV, f"{spec_id}={label}")
    assert registry.pinned_block(spec) == pin
    assert spec.pick_block(None) == pin
    assert registry.current_block(spec) == pin
    others = [s for s in registry.specs() if s is not spec]
    assert all(registry.pinned_block(s) is None for s in others)
    cache = PlanCache()
    assert registry.autotune(spec_id, token=("pin",), cache=cache) == pin
    assert registry.choices(spec.family)[spec_id] == {"block": label,
                                                      "source": "pinned"}
    assert (spec_id, pin) in registry.choices_token((spec.family,))
    # the pin is part of the tune key: another pin is another decision
    monkeypatch.setenv(registry.PIN_ENV, "default")
    assert registry.autotune(spec_id, token=("pin",), cache=cache) == \
        spec.default_block
    assert cache.misses == 2 and cache.hits == 0


def test_default_pin_and_bad_pins(monkeypatch):
    monkeypatch.setenv(registry.PIN_ENV, "default")
    for s in registry.specs():
        assert registry.pinned_block(s) == s.default_block
        assert registry.choices()[s.id]["source"] == "pinned"
    spec = registry.get("coil_mult.coil_forward")
    monkeypatch.setenv(registry.PIN_ENV, "coil_mult.coil_forward=256")
    with pytest.raises(ValueError, match="expected 2 dims"):
        registry.pinned_block(spec)
    with pytest.raises(ValueError, match="expected 2 dims"):
        spec.pick_block(None)
    # a block of the right arity outside the space: the kernels are
    # compiled for the space's shapes
    monkeypatch.setenv(registry.PIN_ENV, "cg_fused.cg_update=64")
    assert registry.pinned_block(registry.get("cg_update")) == (64,)
    with pytest.raises(ValueError, match="not in its space"):
        registry.get("cg_update").pick_block(None)
    with pytest.raises(ValueError, match="arity"):
        registry.get("cg_update").pick_block((128, 2))


# pin strings that both packages read: one spec each, of the arity both
# give it (the port's coil_forward has two dims, the JAX package's one)
SHARED_PINS = ["cg_fused.cg_update=128", "cg_fused.xpby_dot=128",
               "coil_mult.coil_adjoint=128", "coil_mult.plane_mult=128",
               "gridding.degrid=64", "gridding.grid_adjoint=16",
               "masked_allreduce.masked_sum=128",
               "flash_attention.flash_attention=64x64",
               "cg_fused.cg_update=512,gridding.degrid=32",
               "coil_mult.coil_forward=128x8", "coil_mult.coil_forward=64",
               "default"]


@pytest.mark.parametrize("pin", SHARED_PINS)
def test_pins_read_as_the_reference_reads_them(monkeypatch, pin):
    monkeypatch.setenv(registry.PIN_ENV, pin)
    shared = sorted({s.id for s in registry.specs()} &
                    {s.id for s in jregistry.specs()})
    for sid in shared:
        if len(registry.get(sid).block_args) != \
                len(jregistry.get(sid).block_args):
            continue        # coil_forward: each reads its own arity
        def read(reg):
            try:
                return reg.pinned_block(reg.get(sid))
            except ValueError as e:
                return "raises" if "dims" in str(e) else e
        port, ref = read(registry), read(jregistry)
        if pin == "default":
            # each package pins its own default
            assert port == registry.get(sid).default_block
            assert ref == jregistry.get(sid).default_block
            continue
        assert port == ref, (sid, port, ref)
        if port not in (None, "raises"):
            fam = sid.split(".")[0]
            assert registry.choices(fam)[sid] == \
                jregistry.choices(fam)[sid]


def test_forced_sweep_records_its_table(monkeypatch):
    monkeypatch.setenv(registry.TUNE_ENV, "1")
    spec = registry.get("masked_allreduce.masked_sum")
    gen = torch.Generator()
    gen.manual_seed(0)
    args = spec.sample("cpu", gen, nparts=2, size=8)
    cache = PlanCache()
    before = spec.launches
    b = registry.autotune(spec.id, sample=lambda: (args, {}),
                          token=("sweep",), cache=cache, iters=1)
    assert b in spec.block_space
    assert registry.choices()[spec.id]["source"] == "swept"
    (plan,) = cache._plans.values()
    table = plan.meta["table"]
    assert set(table) == {"128", "256", "512"}
    # one run a candidate on the CPU: no spread, the fastest wins
    assert plan.meta["spread"] == 0.0
    assert plan.meta["block"] == b == tuple(
        int(v) for v in min(table, key=table.get).split("x"))
    assert spec.pick_block(None) == b
    assert (spec.id, b) in registry.choices_token(("masked_allreduce",))
    assert spec.launches == before       # the plain versions ran
    # the steady state: a hit, no sweep
    assert registry.autotune(spec.id, sample=lambda: pytest.fail("swept"),
                             token=("sweep",), cache=cache) == b
    assert cache.hits == 1


def test_sweep_launches_count_apart(monkeypatch):
    """A sweep on the card (its launch and timer stubbed here): each
    candidate's launch adds to ``tune_launches``, never to ``launches``,
    ``entry_launches`` or an open ``count()``; a candidate that launches
    nothing raises."""
    monkeypatch.setenv(registry.TUNE_ENV, "1")
    spec = registry.get("cg_fused.xpby")
    monkeypatch.setitem(spec._bound, "xpby", lambda *a: 0)
    monkeypatch.setattr(registry, "_on_card", lambda args: True)
    times = {(128,): 2.0, (256,): 3.0, (512,): 1.0}
    monkeypatch.setattr(registry, "_time_candidate",
                        lambda run, iters, card: (run(), [times[last[0]]])[1])
    last = []

    def kernel(*args, block=None):
        last[:] = [block]
        spec.launch(*args, entry="xpby", work=None)

    monkeypatch.setattr(spec, "kernel", kernel)
    launches, entries = spec.launches, dict(spec.entry_launches)
    tuned = spec.tune_launches
    with registry.count() as counted:
        b = registry.autotune(spec.id, sample=lambda: ((0, 1), {}),
                              token=("stub",), cache=PlanCache())
    assert b == (512,)
    assert spec.tune_launches == tuned + 3
    assert (spec.launches, spec.entry_launches) == (launches, entries)
    assert counted == {}
    monkeypatch.setattr(spec, "kernel", lambda *a, block=None: None)
    with pytest.raises(RuntimeError, match="launched no kernel"):
        registry.autotune(spec.id, sample=lambda: ((0, 1), {}),
                          token=("none",), cache=PlanCache())


def test_dry_never_sweeps(monkeypatch):
    monkeypatch.setenv(registry.TUNE_ENV, "1")
    spec = registry.get("cg_fused.cg_update")
    with registry.dry():
        b = registry.autotune(spec.id, sample=lambda: pytest.fail("swept"),
                              token=("dry",), cache=PlanCache())
    assert b == spec.default_block


def test_get_impl_binds_the_route():
    x, y, beta = _sample("cg_fused.xpby")
    auto = registry.get_impl("cg_fused.xpby")
    plain = registry.get_impl("xpby", "plain")
    assert torch.equal(auto(x, y, beta), plain(x, y, beta))
    assert plain.__name__ == "xpby[plain]"
    with pytest.raises(ValueError):
        registry.get_impl("xpby", "pallas")
    with pytest.raises(KeyError):
        registry.get("coil_mult.cg_update")


def test_blas_and_gridding_carry_their_blocks(monkeypatch):
    comm = Communicator.single("cpu")
    gen = np.random.default_rng(0)
    mk = lambda: comm.container((gen.standard_normal((2, 8, 8)) + 1j *  # noqa: E731
                                 gen.standard_normal((2, 8, 8))
                                 ).astype(np.complex64))
    p, ap, x, r = mk(), mk(), mk(), mk()
    before = registry.tune_cache().snapshot()
    blas.cg_update(0.25, p, ap, x, r)
    blas.xpby_dot(x, r, 0.5)
    assert registry.tune_cache().delta(before)["builds"] <= 2
    steady = registry.tune_cache().snapshot()
    for beta in (0.5, 0.25):
        blas.xpby_dot(x, r, beta)
    d = registry.tune_cache().delta(steady)
    assert d["builds"] == 0 and d["hits"] == 2
    traj = gridding.radial_trajectory(16, 3)
    cache = PlanCache()
    plan = gridding.plan_gridding(traj, 16, device="cpu", cache=cache)
    assert plan.blocks == {"degrid": (32,), "grid_adjoint": (8,)}
    monkeypatch.setenv(registry.PIN_ENV, "gridding.grid_adjoint=16")
    pinned = gridding.plan_gridding(traj, 16, device="cpu", cache=cache)
    assert pinned.blocks["grid_adjoint"] == (16,) and pinned is not plan
    assert cache.builds == 2
    (key,) = [k for k in cache._plans if cache._plans[k].fn is pinned]
    assert ("grid_adjoint", (16,)) in key[-1]


def test_batched_frame_key_holds_the_choices(monkeypatch):
    g, width = 16, 2
    rec = Reconstructor(device="cpu", newton=1, cg_iters=2)
    rec.plan_cache = PlanCache()
    stack_carries([rec.init_carry(2, g) for _ in range(width)])
    first = rec._plan_batched(width, False)
    assert rec._plan_batched(width, False) is first
    tune = registry.tune_cache().snapshot()
    plans = rec.plan_cache.snapshot()
    for _ in range(3):
        rec.fn_batched(width)
    assert registry.tune_cache().delta(tune)["builds"] == 0
    assert rec.plan_cache.delta(plans)["builds"] == 0
    # a pin changed between frames builds a new plan, never reuses one
    monkeypatch.setenv(registry.PIN_ENV, "coil_mult.plane_mult=512")
    pinned = rec._plan_batched(width, False)
    assert pinned is not first
    assert ("coil_mult.plane_mult", (512,)) in pinned.key[-1]
    assert ("coil_mult.plane_mult", (256,)) in first.key[-1]
    assert rec._plan_batched(width, False) is pinned
    assert rec.plan_cache.builds == 2
    monkeypatch.setenv(registry.PIN_ENV, "default")
    assert rec._plan_batched(width, False).key[-1] == first.key[-1]


def test_frame_tunes_its_kernels_once():
    rec = Reconstructor(device="cpu", newton=1, cg_iters=2)
    g = 16
    rng = np.random.default_rng(1)
    y = rec.put_frame((rng.standard_normal((2, g, g)) + 1j *
                       rng.standard_normal((2, g, g))).astype(np.complex64))
    m = rec.put_const((rng.random((g, g)) > 0.5).astype(np.float32))
    fov = rec.put_const(np.ones((g, g), np.float32))
    u = rec.init_carry(2, g)
    snap = registry.tune_cache().snapshot()
    for _ in range(2):
        u, _ = rec(y, m, fov, fov, u, u)
    d = registry.tune_cache().delta(snap)
    assert d["builds"] == 0 and d["hits"] == 2 * 7


@pytest.mark.parametrize("best,want", [(0.9, (256,)), (0.5, (128,))])
def test_sweep_keeps_the_default_inside_its_spread(monkeypatch, best, want):
    """A candidate wins only where it beats the default by more than the
    sweep's spread (the widest gap between a candidate's own runs): 0.3
    here, the default's runs 1.0 to 1.3."""
    monkeypatch.setenv(registry.TUNE_ENV, "1")
    spec = registry.get("cg_fused.cg_update")
    runs = {(128,): [best, best + 0.05], (256,): [1.3, 1.0],
            (512,): [1.2, 1.25]}
    last = []
    monkeypatch.setattr(registry, "_time_candidate",
                        lambda run, iters, card: (run(), runs[last[0]])[1])

    def kernel(*args, block=None):
        last[:] = [block]

    monkeypatch.setattr(spec, "kernel", kernel)
    cache = PlanCache()
    assert registry.autotune(spec.id, sample=lambda: ((), {}),
                             token=("spread", best), cache=cache) == want
    (plan,) = cache._plans.values()
    assert plan.meta["spread"] == pytest.approx(0.3)
    assert plan.meta["table"]["256"] == 1.0


def _record_blocks(monkeypatch):
    """Every block the NLINV frame passes to its kernels' wrappers, by
    spec name, as the calls are made."""
    from repro_torch.nlinv import cg, irgnm, operators
    got = []
    names = {(operators, "plane_mult"): "plane_mult",
             (irgnm, "plane_mult"): "plane_mult",
             (operators, "coil_forward"): "coil_forward",
             (operators, "coil_adjoint"): "coil_adjoint",
             (operators, "coil_lincomb"): None,
             (cg, "cg_update"): "cg_update", (cg, "xpby_dot"): "xpby"}
    for (mod, attr), name in names.items():
        fn = getattr(mod, attr)

        def rec(*a, fn=fn, name=name, attr=attr, block=None, **kw):
            if name is None:      # coil_lincomb is two specs
                name = "coil_lincomb" if len(a) > 2 else "coil_scale_mult"
            got.append((name, block))
            return fn(*a, block=block, **kw)
        monkeypatch.setattr(mod, attr, rec)
    return got


def test_frame_plans_launch_the_blocks_they_were_made_with(monkeypatch):
    """The single frame and the batched plan pass each kernel the block
    they resolved when they were made: an explicit block at every launch
    (none left to the wrapper's lookup), and a batched plan made before a
    pin keeps launching its own blocks after it."""
    g, width, ncoils = 16, 2, 2
    rng = np.random.default_rng(3)
    rec = Reconstructor(device="cpu", newton=1, cg_iters=2)
    rec.plan_cache = PlanCache()
    ys = (rng.standard_normal((width, ncoils, g, g)) + 1j *
          rng.standard_normal((width, ncoils, g, g))).astype(np.complex64)
    y = torch.stack([rec.put_frame(v) for v in ys])
    m = torch.stack([rec.put_const((rng.random((g, g)) > 0.5).astype(
        np.float32)) for _ in range(width)])
    fov = rec.put_const(np.ones((g, g), np.float32))
    u = stack_carries([rec.init_carry(ncoils, g) for _ in range(width)])
    first = rec._plan_batched(width, False)
    assert first.meta["kernel_blocks"]["coil_mult.plane_mult"] == (256,)
    got = _record_blocks(monkeypatch)
    monkeypatch.setenv(registry.PIN_ENV, "coil_mult.plane_mult=512")
    first.fn(rec, y, m, fov, fov, u, u)
    assert got and all(b is not None for _, b in got)
    assert {b for n, b in got if n == "plane_mult"} == {(256,)}
    got.clear()
    rec.fn_batched(width)(y, m, fov, fov, u, u)
    assert {b for n, b in got if n == "plane_mult"} == {(512,)}
    got.clear()
    one = {k: v[0].clone() for k, v in u.items()}
    rec(y[0], m[0], fov, fov, one, one)
    assert got and all(b is not None for _, b in got)
    assert {b for n, b in got if n == "plane_mult"} == {(512,)}
    assert {n for n, _ in got} == {"plane_mult", "coil_forward",
                                   "coil_adjoint", "coil_lincomb",
                                   "coil_scale_mult", "cg_update", "xpby"}


def test_ranks_hold_rank_0s_block(tmp_path):
    ranks = run_ranks(torch_ranks.tune_agree, 2, device="cpu", timeout=90,
                      store_dir=tmp_path)
    space = registry.get("cg_fused.cg_update").block_space
    # alone, each rank's timer picks its own favourite
    assert [r["alone"] for r in ranks] == [space[0], space[1]]
    assert [r["held"] for r in ranks] == [space[0]] * 2
    assert [r["pick"] for r in ranks] == [space[0]] * 2
    assert [r["source"] for r in ranks] == ["swept", "rank 0"]
    assert [r["swept_in_group"] for r in ranks] == [len(space), 0]
