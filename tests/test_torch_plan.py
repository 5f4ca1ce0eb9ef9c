"""The port's plan substrate against the JAX package's, on the CPU.

* ``PlanCache`` mechanics, mirroring ``tests/test_lib_plans.py``: keying
  and hits, LRU eviction, hit/miss counters, ``delta``/``stats``;
* plan keys that describe tensors hold shape, dtype and device;
* ``fft2`` through ``plan_fft2`` gives the same bits as the direct
  ``torch.fft`` form it replaced, and matches numpy and the JAX package;
* the streaming engine's plan-cache report: frame 0 builds, the steady
  state builds nothing.
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lib import fft as jfft
from repro_torch.core import plan as core_plan
from repro_torch.lib import fft as lfft
from repro_torch.lib import plan as lib_plan
from repro_torch.lib.plan import (Plan, PlanCache, default_cache,
                                  device_token, group_token, plan_stats)


def _mk(seed=0, shape=(4, 16, 16)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


# -- PlanCache mechanics -----------------------------------------------------

def test_cache_keying_and_hits():
    cache = PlanCache(maxsize=8)
    built = []

    def maker(tag):
        def b():
            built.append(tag)
            return Plan(key=("k", tag), fn=lambda: tag)
        return b

    p1 = cache.get_or_build(("k", "a"), maker("a"))
    p2 = cache.get_or_build(("k", "a"), maker("a"))
    assert p1 is p2 and built == ["a"]
    assert (cache.hits, cache.misses) == (1, 1)
    cache.get_or_build(("k", "b"), maker("b"))
    assert built == ["a", "b"]
    assert cache.stats()["hit_rate"] == pytest.approx(1 / 3, abs=1e-3)


def test_cache_lru_eviction():
    cache = PlanCache(maxsize=2)
    mk = lambda k: (lambda: Plan(key=k, fn=lambda: k))   # noqa: E731
    cache.get_or_build(("a",), mk(("a",)))
    cache.get_or_build(("b",), mk(("b",)))
    cache.get_or_build(("a",), mk(("a",)))     # refresh a: b becomes LRU
    cache.get_or_build(("c",), mk(("c",)))     # evicts b
    assert cache.evictions == 1
    assert ("a",) in cache and ("c",) in cache and ("b",) not in cache
    # re-requesting the evicted key rebuilds it
    cache.get_or_build(("b",), mk(("b",)))
    assert cache.misses == 4 and len(cache) == 2


def test_cache_delta_stats_and_wrapping():
    cache = PlanCache(maxsize=4)
    assert cache.get_or_build(("f",), lambda: (lambda: 5))() == 5
    before = cache.snapshot()
    for _ in range(3):
        cache.get_or_build(("f",), lambda: (lambda: 6))
    d = cache.delta(before)
    assert d == {"hits": 3, "misses": 0, "builds": 0, "evictions": 0,
                 "hit_rate": 1.0}
    s = cache.stats()
    assert (s["capacity"], s["size"], s["builds"]) == (4, 1, 1)
    assert "hits=3" in repr(cache)
    cache.clear()
    assert len(cache) == 0 and cache.hits == 3
    with pytest.raises(ValueError):
        PlanCache(maxsize=0)


def test_plan_value_group_token_and_reexport():
    p = Plan.value(("blocks",), (8, 8), lib="demo", op="pick")
    assert p() == (8, 8) and "demo.pick" in repr(p)
    assert group_token(None) == ("nogroup",)
    with pytest.raises(TypeError):
        group_token(object())
    from repro_torch.core import Communicator
    comm = Communicator.single("cpu")
    assert group_token(comm) == group_token(comm.group) == \
        ("group", None, (0,), 0, "cpu")
    assert lib_plan.default_cache() is core_plan.default_cache()
    assert plan_stats() == default_cache().stats()
    assert device_token("cpu") == "cpu"


@pytest.mark.parametrize("module", [core_plan, lib_plan],
                         ids=["core.plan", "lib.plan"])
def test_plan_doctests(module):
    result = doctest.testmod(module)
    assert result.attempted > 0 and result.failed == 0


# -- fft through plan_fft2 ---------------------------------------------------

def _fft2_direct(x, inverse, centered):
    """The direct form ``fft2`` had before it went through plans."""
    axes = (-2, -1)
    if centered:
        x = torch.fft.ifftshift(x, dim=axes)
    x = (torch.fft.ifft2(x, dim=axes, norm="ortho") if inverse
         else torch.fft.fft2(x, dim=axes, norm="ortho"))
    if centered:
        x = torch.fft.fftshift(x, dim=axes)
    return x


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_fft2_through_plan_is_unchanged(inverse, centered):
    cache = PlanCache()
    x = torch.from_numpy(_mk(5, (3, 12, 20)))
    got = lfft.fft2(x, inverse=inverse, centered=centered, cache=cache)
    assert torch.equal(got, _fft2_direct(x, inverse, centered))
    want = jfft.fft2(jnp.asarray(x.numpy()), inverse=inverse,
                     centered=centered)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert cache.misses == 1


def test_fft2_plain_matches_numpy_and_caches():
    cache = PlanCache()
    x = _mk(1)
    got = lfft.fft2(torch.from_numpy(x), centered=True, cache=cache)
    want = np.fft.fftshift(
        np.fft.fft2(np.fft.ifftshift(x, axes=(-2, -1)), axes=(-2, -1),
                    norm="ortho"), axes=(-2, -1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    lfft.fft2(torch.from_numpy(x), centered=True, cache=cache)
    assert cache.misses == 1 and cache.hits == 1


def test_plan_fft2_key_holds_shape_dtype_device():
    cache = PlanCache()
    base = lfft.plan_fft2((2, 8, 8), torch.complex64, device="cpu",
                          centered=True, cache=cache)
    assert lfft.plan_fft2((2, 8, 8), torch.complex64, device="cpu",
                          centered=True, cache=cache) is base
    others = [
        lfft.plan_fft2((3, 8, 8), torch.complex64, device="cpu",
                       centered=True, cache=cache),
        lfft.plan_fft2((2, 8, 8), torch.complex128, device="cpu",
                       centered=True, cache=cache),
        lfft.plan_fft2((2, 8, 8), torch.complex64, device="meta",
                       centered=True, cache=cache),
        lfft.plan_fft2((2, 8, 8), torch.complex64, device="cpu",
                       inverse=True, centered=True, cache=cache),
    ]
    assert all(p is not base for p in others)
    assert len({id(p) for p in others}) == 4
    assert cache.misses == 5 and cache.hits == 1
    assert base.meta["device"] == "cpu" and base.lib == "fft"


def test_plan_fft2_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lfft.plan_fft2((2, 8, 8), torch.complex64, cache=PlanCache())


# -- the streaming engine's plan-cache report --------------------------------

def test_stream_reports_zero_steady_state_builds():
    from repro_torch.nlinv import phantom
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FrameStream
    d = phantom.make_dataset(n=16, ncoils=2, nspokes=5, frames=3, seed=3)
    # a cleared cache: frame 0 must build this geometry's FFT plans even
    # when an earlier test in the process built them already
    default_cache().clear()
    rec = Reconstructor(device="cpu", newton=2, cg_iters=4,
                        channel_sum="full")
    _, rep = FrameStream(rec).run(d["y"], d["masks"], d["fov"])
    pc = rep.summary()["plan_cache"]
    assert len(pc["frame_builds"]) == 3
    assert pc["frame_builds"][0] == 2, pc     # forward + inverse FFT plan
    assert pc["steady_builds"] == 0, pc
    assert all(b == 0 for b in pc["frame_builds"][1:]), pc
    assert pc["builds"] == 2 and pc["hit_rate"] > 0
    # a second run on the same geometry builds nothing at all
    _, rep2 = FrameStream(rec).run(d["y"], d["masks"], d["fov"])
    assert rep2.summary()["plan_cache"]["frame_builds"] == [0, 0, 0]
