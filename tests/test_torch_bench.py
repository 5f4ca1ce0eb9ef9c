"""The port's benchmark subsystem (``repro_torch.bench``) against the JAX
package's (``repro.bench``), on the CPU: the counterparts of
``tests/test_bench.py`` (less its two checks of the ``benchmarks/``
scripts), with parity.

* the registry: the same scenario keys, sizes and rank counts; duplicate
  keys rejected;
* the artifact and the compare gate: the same runs give the same artifact
  and the same bytes on disk in both packages, the malformed artifacts
  are rejected by both with the same message, and every compare case
  gives the same ``Comparison`` lists and the same exit codes;
* the models: ``speedup_model`` and ``paper_claims`` equal JAX's wherever
  they read the paper's testbed;
* the harness: ``measure``'s contract, and its fence after the first call
  and after every sample (a fake fence: no card here);
* the scenarios at the tiny size in process: the extras keys of every
  tiny scenario equal JAX's, less the one rename (``model_v5e_s4`` ->
  ``model_h100_s4``); the FFT counts of F, DF and DF^H equal JAX's jaxpr
  counts;
* the sweep CLI: 1 and 2 gloo ranks on the CPU, an unknown figure, and
  no card without ``--device cpu``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import types

import pytest
import torch

from repro.bench import artifact as jartifact
from repro.bench import compare as jcompare
from repro.bench import models as jmodels
from repro.bench import registry as jregistry
from repro_torch.bench import (ArtifactError, BenchContext, artifact,
                               compare, harness, load_artifact,
                               make_artifact, measure, models, run_key,
                               scenarios, validate_artifact,
                               write_artifact)
from repro_torch.bench.registry import DEVICE_COUNTS, SIZES
from repro_torch.core import Communicator
from repro_torch.lib.plan import PlanCache

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}

# the one extras key the port renames: the TPU column's H100 counterpart
RENAMED = {"model_v5e_s4": "model_h100_s4"}
# extras that depend on nothing timed or hardware-modelled: equal values
COUNTED = ("grid", "ncoils", "n", "batch", "nbytes", "payload_bytes",
           "threshold_bytes", "schedule", "frames", "clients", "inflight",
           "fft", "pointwise", "channel_sum", "allreduce", "ab",
           "scalar_products", "nspokes", "seed", "fired", "quarantined",
           "retried_tasks", "rejected_poisoned", "step_faults",
           "steady_builds", "cg", "newton", "frames_per_client", "ticks",
           "model_scaling", "advisory", "artifact", "model_paper_s2",
           "model_paper_s4", "model_paper_s8", "claim_s2", "claim_s4",
           "model_rel_J_per_frame_G1", "model_rel_J_per_frame_G2",
           "model_rel_J_per_frame_G4")


def _fake_run(scenario="figX.thing", figure="figX", devices=1, size="tiny",
              steady=1.0, **kw):
    run = {"scenario": scenario, "figure": figure, "devices": devices,
           "size": size, "wall_ms": 10.0, "compile_ms": 5.0,
           "steady_ms": steady}
    run.update(kw)
    return run


def _both(fn_name, *args, **kw):
    """``fn_name(*args, **kw)`` in the JAX package's artifact module and in
    the port's: (JAX's result, the port's)."""
    return (getattr(jartifact, fn_name)(*args, **kw),
            getattr(artifact, fn_name)(*args, **kw))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_is_the_reference():
    want, got = jregistry.scenarios(), scenarios()
    assert list(got) == list(want) == sorted(got)
    for key, sc in got.items():
        ref = want[key]
        assert (sc.figure, sc.name, sc.sizes, sc.devices) == \
            (ref.figure, ref.name, ref.sizes, ref.devices), key
        assert key == f"{sc.figure}.{sc.name}"
        assert set(sc.sizes) <= set(SIZES) and sc.sizes
        assert set(sc.devices) <= set(DEVICE_COUNTS) and sc.devices
    assert (SIZES, DEVICE_COUNTS) == (jregistry.SIZES,
                                      jregistry.DEVICE_COUNTS)


def test_registry_rejects_duplicates_and_tolerates_blank_docstrings():
    from repro_torch.bench.registry import _REGISTRY
    from repro_torch.bench.registry import scenario as register
    some = next(iter(scenarios().values()))
    with pytest.raises(ValueError, match="duplicate"):
        register(some.figure, some.name)(lambda ctx: {})

    def fn(ctx):
        """   """
    register("figtest", "blank_doc")(fn)
    try:
        assert _REGISTRY["figtest.blank_doc"].doc == ""
    finally:
        del _REGISTRY["figtest.blank_doc"]


# ---------------------------------------------------------------------------
# artifact
# ---------------------------------------------------------------------------

def test_artifact_round_trip_is_the_reference(tmp_path):
    runs = [_fake_run(devices=1, steady=4.0),
            _fake_run(devices=4, steady=2.0),
            _fake_run(scenario="figX.other", devices=1, steady=0.5,
                      extra={"model_eff2": 1.0}, plan_cache={"steady": {}})]
    host = {"platform": "cpu"}
    jart, art = _both("make_artifact", runs, sha="0" * 40, host=host,
                      calibration_ms=2.5)
    assert art == jart
    assert art["scenarios"]["figX.thing@d4@tiny"]["speedup_vs_1dev"] == 2.0
    assert "speedup_vs_1dev" not in art["scenarios"]["figX.thing@d1@tiny"]
    jpath = jartifact.write_artifact(tmp_path / "jax.json", jart)
    path = write_artifact(tmp_path / "port.json", art)
    assert path.read_bytes() == jpath.read_bytes()
    assert load_artifact(path) == art == jartifact.load_artifact(path)
    assert path.read_text() == json.dumps(art, indent=2, sort_keys=True) + \
        "\n"


def _malformed():
    good = jartifact.make_artifact([_fake_run()], sha="x", host={})
    swapped = json.loads(json.dumps(good))
    swapped["scenarios"]["wrong@d1@tiny"] = swapped["scenarios"].pop(
        "figX.thing@d1@tiny")
    no_steady = _fake_run()
    del no_steady["steady_ms"]
    return {
        "schema_version": ("validate", {**good, "schema_version": 99}),
        "schema": ("validate", {**good, "schema": "something-else"}),
        "git_sha": ("validate", {**good, "git_sha": ""}),
        "host": ("validate", {**good, "host": []}),
        "not_a_dict": ("validate", [good]),
        "scenarios": ("validate", {**good, "scenarios": []}),
        "identity": ("validate", swapped),
        "missing_field": ("make", [no_steady]),
        "field_type": ("make", [_fake_run(steady="fast")]),
        "bool_field": ("make", [_fake_run(devices=True)]),
        "optional_type": ("make", [_fake_run(iters=2.5)]),
        "devices": ("make", [_fake_run(devices=0)]),
        "negative": ("make", [_fake_run(steady=-1.0)]),
        "duplicate": ("make", [_fake_run(), _fake_run()]),
        "calibration_zero": ("make", [_fake_run()], 0.0),
        "calibration_negative": ("make", [_fake_run()], -1),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_artifact_rejects_what_the_reference_rejects(case):
    how, value, *cal = _malformed()[case]
    errors = []
    for mod in (jartifact, artifact):
        with pytest.raises(mod.ArtifactError) as e:
            if how == "validate":
                mod.validate_artifact(value)
            else:
                mod.make_artifact(value, sha="x", host={},
                                  calibration_ms=cal[0] if cal else None)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_artifact_load_rejects_non_json(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("not json {")
    with pytest.raises(ArtifactError, match="JSON"):
        load_artifact(p)


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def _p95(v):
    return {"extra": {"client_p95_ms": v}}


def _curve(*speeds):
    """A scenario's runs at 1, 2 and 4 ranks with these steady times."""
    return [_fake_run(devices=d, steady=s) for d, s in zip((1, 2, 4),
                                                             speeds)]


# name -> (base runs, base calibration, new runs, new calibration, kwargs)
COMPARE_CASES = {
    "pass": ([_fake_run(steady=4.0)], None, [_fake_run(steady=4.2)], None,
             {"threshold_pct": 25.0}),
    "regression": ([_fake_run(steady=4.0)], None, [_fake_run(steady=8.0)],
                   None, {"threshold_pct": 75.0}),
    "improvement": ([_fake_run(steady=4.0)], None, [_fake_run(steady=1.0)],
                    None, {}),
    "noise_floor": ([_fake_run(steady=0.0)], None, [_fake_run(steady=0.0)],
                    None, {}),
    "sub_floor_blowup": ([_fake_run(steady=0.1)], None,
                         [_fake_run(steady=500.0)], None,
                         {"threshold_pct": 75.0, "min_ms": 1.0}),
    "sub_floor_jitter": ([_fake_run(steady=0.1)], None,
                         [_fake_run(steady=0.9)], None,
                         {"threshold_pct": 75.0, "min_ms": 1.0}),
    "p95_regression": ([_fake_run(steady=4.0, **_p95(8.0))], None,
                       [_fake_run(steady=4.0, **_p95(20.0))], None,
                       {"threshold_pct": 25.0}),
    "p95_within": ([_fake_run(steady=4.0, **_p95(18.0))], None,
                   [_fake_run(steady=4.0, **_p95(20.0))], None,
                   {"threshold_pct": 25.0}),
    "p95_no_column": ([_fake_run(steady=4.0)], None,
                      [_fake_run(steady=4.0)], None, {}),
    "p95_calibrated": ([_fake_run(steady=4.0, **_p95(10.0))], 1.0,
                       [_fake_run(steady=12.0, **_p95(30.0))], 3.0, {}),
    "slow_host": ([_fake_run(steady=4.0)], 10.0, [_fake_run(steady=12.0)],
                  30.0, {"threshold_pct": 75.0}),
    "slow_code": ([_fake_run(steady=4.0)], 10.0, [_fake_run(steady=12.0)],
                  10.0, {"threshold_pct": 75.0}),
    "no_calibration": ([_fake_run(steady=4.0)], None,
                       [_fake_run(steady=4.0)], None, {}),
    "new_scenario": ([_fake_run()], None,
                     [_fake_run(), _fake_run(scenario="figX.added")], None,
                     {}),
    "missing_scenario": ([_fake_run(), _fake_run(scenario="figX.added")],
                         None, [_fake_run()], None, {}),
    "advisory": ([_fake_run(steady=4.0)], None,
                 [_fake_run(steady=40.0, extra={"advisory": True})], None,
                 {}),
    "non_monotone": (_curve(4.0, 2.0, 3.0), None, _curve(4.0, 2.0, 3.0),
                     None, {}),
}


def _artifacts(mod, case):
    base, bcal, new, ncal, _ = COMPARE_CASES[case]
    return (mod.make_artifact(base, sha="a", host={}, calibration_ms=bcal),
            mod.make_artifact(new, sha="b", host={}, calibration_ms=ncal))


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_is_the_reference(case):
    kw = COMPARE_CASES[case][-1]
    want = jcompare.compare_artifacts(*_artifacts(jartifact, case), **kw)
    got = compare.compare_artifacts(*_artifacts(artifact, case), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok == want.ok
    assert compare.format_report(got).replace("repro_torch.", "repro.") == \
        jcompare.format_report(want)
    assert compare.format_markdown(got).replace("repro_torch.", "repro.") \
        == jcompare.format_markdown(want)


def test_compare_cli_exit_codes_are_the_reference(tmp_path):
    """Non-zero exit on an injected 2x slowdown; a missing scenario fails
    only under ``--fail-on-missing``; the same codes as JAX's CLI."""
    paths = {}
    for case in ("regression", "missing_scenario"):
        base, new = _artifacts(artifact, case)
        paths[case] = (write_artifact(tmp_path / f"{case}_b.json", base),
                       write_artifact(tmp_path / f"{case}_n.json", new))
    reg, miss = paths["regression"], paths["missing_scenario"]
    argvs = [[str(reg[0]), str(reg[1]), "--threshold", "75"],
             [str(reg[0]), str(reg[0])],
             [str(miss[0]), str(miss[1])],
             [str(miss[0]), str(miss[1]), "--fail-on-missing"],
             [str(reg[0]), str(reg[1]), "--summary",
              str(tmp_path / "summary.md")]]
    got = [compare.main(a) for a in argvs]
    assert got == [jcompare.main(a) for a in argvs] == [1, 0, 0, 1, 1]


def test_compare_tooling_imports_no_torch():
    """``python -m repro_torch.bench.compare`` and the artifact tooling
    load on a host without torch: harness and models stay lazy."""
    code = (
        "import sys\n"
        "sys.modules['torch'] = None   # poison: any 'import torch' raises\n"
        "import repro_torch.bench.compare\n"
        "from repro_torch.bench import make_artifact, validate_artifact, "
        "compare_artifacts\n"
        "run = dict(scenario='f.x', figure='f', devices=1, size='tiny',\n"
        "           wall_ms=1.0, compile_ms=1.0, steady_ms=1.0)\n"
        "art = make_artifact([run], sha='s', host={})\n"
        "assert compare_artifacts(art, art).ok\n"
        "print('torch-free OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, env=ENV)
    assert r.returncode == 0 and "torch-free OK" in r.stdout, r.stderr


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_paper_models_are_the_reference():
    assert models.PAPER_HW == jmodels.PAPER_HW
    for grid, J in ((768, 8), (48, 4), (128, 8)):
        assert models.speedup_model(grid, J) == \
            jmodels.speedup_model(grid, J)
    sp = models.speedup_model(768, 8, hw="h100")
    assert sp[1] == pytest.approx(1.0) and sp[2] > 1.0
    with pytest.raises(ValueError, match="paper"):
        models.speedup_model(768, 8, hw="v5e")
    assert models.copy_time(1 << 20, 6e9) == jmodels.copy_time(1 << 20, 6e9)
    assert models.allreduce_time(1 << 20, 4, bw=6e9, latency=1e-5) == \
        jmodels.allreduce_time(1 << 20, 4, bw=6e9, latency=1e-5)


def test_paper_claims_are_the_reference():
    from repro.bench.suites import fig6 as jfig6
    from repro_torch.bench.suites import fig6
    assert fig6.paper_claims(None) == jfig6.paper_claims(None)


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------

def test_measure_separates_first_call_from_steady():
    cache = PlanCache()
    t = measure(lambda: torch.arange(8) * 2, warmup=1, iters=4,
                cache=cache, device="cpu")
    assert t.compile_ms >= 0 and t.steady_ms >= 0
    assert t.iters == 4 and t.warmup == 1
    # steady_ms is the best (minimum) sample; percentiles sit above it
    assert t.p95_ms >= t.p50_ms >= t.steady_ms
    assert t.wall_ms >= t.compile_ms
    assert t.as_dict()["plan_cache"]["steady"]["builds"] == 0
    with pytest.raises(ValueError):
        measure(lambda: None, iters=0)


def test_measure_fences_every_timed_call(monkeypatch):
    """The fence runs after the first call, after each warmup call and
    after each steady sample, inside the timed region: a fence that takes
    20 ms shows in every sample."""
    events = []
    card = torch.device("cuda", 1)      # never touched: the fence is fake

    def fence(device=None):
        events.append(("fence", device))
        time.sleep(0.02)

    monkeypatch.setattr(harness, "fence", fence)
    t = measure(lambda: events.append(("call", None)), warmup=2, iters=3,
                cache=PlanCache(), device=card)
    assert events == [("call", None), ("fence", card)] * (1 + 1 + 3)
    assert t.steady_ms >= 20.0 and t.compile_ms >= 20.0
    # BenchContext fences on its own device, the communicator's by default
    events.clear()
    ctx = BenchContext(size="tiny", devices=1,
                       comm=Communicator.single("cpu"),
                       out_dir=pathlib.Path("."), warmup=1, iters=2)
    assert ctx.device == torch.device("cpu")
    ctx.measure(lambda: None)
    assert [e for e in events if e[0] == "fence"] == \
        [("fence", torch.device("cpu"))] * 3


def test_fence_synchronizes_the_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    harness.fence(torch.device("cuda", 2))
    harness.fence("cpu")
    assert synced == [torch.device("cuda", 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    harness.fence(None)
    assert synced == [torch.device("cuda", 2)]


def test_measure_reports_plan_cache_regions():
    """Setup region pays the plan build; the steady region is all hits."""
    import numpy as np
    from repro_torch.lib import fft as lfft

    comm = Communicator.single("cpu")
    x = comm.container(np.ones((2, 8, 8), np.complex64))
    cache = PlanCache()
    t = measure(lambda: lfft.fft2_batched(x, cache=cache).data,
                warmup=1, iters=3, cache=cache, device="cpu")
    assert t.plan_cache["setup"]["builds"] >= 1
    assert t.plan_cache["steady"]["builds"] == 0
    assert t.plan_cache["steady"]["hit_rate"] == 1.0


# ---------------------------------------------------------------------------
# scenarios in process, tiny size
# ---------------------------------------------------------------------------

def _ctx(tmp_path, size="tiny"):
    return BenchContext(size=size, devices=1,
                        comm=Communicator.single("cpu"), out_dir=tmp_path,
                        warmup=1, iters=2)


def _jax_ctx(tmp_path, size="tiny"):
    from repro.bench.harness import BenchContext as JBenchContext
    from repro.core import Environment
    return JBenchContext(size=size, devices=1,
                         comm=Environment().subgroup(1), out_dir=tmp_path,
                         warmup=1, iters=2)


def test_scenario_runs_in_process(tmp_path):
    """One real scenario through BenchContext -> schema-valid artifact."""
    sc = scenarios()["gridding.plan_cold_vs_hit"]
    res = dict(sc.fn(_ctx(tmp_path)))
    assert res["compile_ms"] > res["steady_ms"]   # cold build >> LRU hit
    run = {"scenario": sc.key, "figure": sc.figure, "devices": 1,
           "size": "tiny", **res}
    art = make_artifact([run], sha="t", host={})
    assert run_key(run) in art["scenarios"]
    validate_artifact(art)


def test_table1_fft_counts_are_the_reference(tmp_path):
    """The FFTs the port's F, DF and DF^H dispatch equal the ``fft``
    primitives of JAX's traced operators and the paper's table; the
    scenario asserts them before it times F."""
    from repro.bench.suites import table1 as jtable1
    from repro_torch.bench.suites import table1
    size = types.SimpleNamespace(size="tiny")
    _, jops, ju0, jdu, jr = jtable1._setup(size)
    _, ops, u0, du, r = table1._setup(_ctx(tmp_path))
    want = {"F": jtable1._count_ffts(jops.G, ju0),
            "DF": jtable1._count_ffts(lambda a, b: jops.DG(a, b), ju0, jdu),
            "DFH": jtable1._count_ffts(lambda a, b: jops.DGH(a, b), ju0,
                                       jr)}
    got = {"F": table1.count_ffts(ops.G, u0),
           "DF": table1.count_ffts(ops.DG, u0, du),
           "DFH": table1.count_ffts(ops.DGH, u0, r)}
    assert got == want == {k: table1.EXPECTED[k]["fft"] for k in got}
    assert table1.EXPECTED == jtable1.EXPECTED
    res = scenarios()["table1.F"].fn(_ctx(tmp_path))
    assert res["steady_ms"] > 0 and res["extra"]["fft"] == 2


TINY = sorted(k for k, s in jregistry.scenarios().items()
              if "tiny" in s.sizes and 1 in s.devices)


@pytest.mark.parametrize("key", TINY)
def test_tiny_scenario_extras_are_the_reference(key, tmp_path):
    """Every tiny scenario runs on one rank in both packages: the result
    fields, the extras keys (less the one rename) and every extra that
    depends on nothing timed or modelled on hardware are JAX's."""
    want = dict(jregistry.scenarios()[key].fn(_jax_ctx(tmp_path / "jax")))
    got = dict(scenarios()[key].fn(_ctx(tmp_path / "port")))
    assert set(got) == set(want)
    wx, gx = want.get("extra") or {}, got.get("extra") or {}
    assert sorted(gx) == sorted(RENAMED.get(k, k) for k in wx)
    for k in COUNTED:
        if k in wx:
            assert gx[k] == wx[k], k
    if "plan_cache" in got:
        assert got["plan_cache"]["steady"]["builds"] == 0
    if "max_rel_err" in gx:
        assert gx["max_rel_err"] <= 1e-5
    run = {"scenario": key, "figure": key.split(".")[0], "devices": 1,
           "size": "tiny", **got}
    validate_artifact(make_artifact([run], sha="t", host={}))


# ---------------------------------------------------------------------------
# the sweep CLI
# ---------------------------------------------------------------------------

def _run_cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", *argv],
        capture_output=True, text=True, timeout=timeout, env=ENV,
        cwd=str(REPO))


def test_run_cli_sweeps_ranks_into_a_valid_artifact(tmp_path):
    """One rank and two gloo ranks on the CPU, one artifact with the
    speed-ups of the 2-rank runs; the side artifacts in --out-dir."""
    out = tmp_path / "bench.json"
    r = _run_cli("--device", "cpu", "--size", "tiny", "--devices", "1,2",
                 "--only", "fig5", "--out", str(out), "--out-dir",
                 str(tmp_path / "side"))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "fig5.reduce" in r.stdout and "speedup" in r.stdout
    art = load_artifact(out)
    assert jartifact.validate_artifact(art) == art
    keys = {f"fig5.{n}@d{d}@tiny" for n in ("broadcast", "reduce",
                                            "strong_copy", "weak_copy")
            for d in (1, 2)}
    assert set(art["scenarios"]) == keys
    for key, run in art["scenarios"].items():
        assert ("speedup_vs_1dev" in run) == (run["devices"] == 2), key
    host = art["host"]
    assert (host["platform"], host["device_count"], host["device_counts"],
            host["shared_card"]) == ("cpu", 1, [1, 2], False)
    assert "card" not in host and host["torch"] == torch.__version__
    for d in (1, 2):
        assert json.loads((tmp_path / "side" /
                           f"kernel_launches_d{d}.json").read_text()) \
            == {}       # the CPU runs the kernels' plain versions


def test_run_cli_rejects_unknown_figure_and_a_missing_card(tmp_path):
    out = tmp_path / "bench.json"
    r = _run_cli("--device", "cpu", "--size", "tiny", "--devices", "1",
                 "--only", "fig99", "--out", str(out), timeout=120)
    assert r.returncode != 0 and "unknown figure" in r.stderr
    assert not out.exists()     # a typo must never write an empty baseline
    if not torch.cuda.is_available():
        r = _run_cli("--size", "tiny", "--devices", "1", "--only", "fig5",
                     "--out", str(out), timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not out.exists()


def test_figure_main_fixes_the_figures(monkeypatch):
    from repro_torch.bench import run
    from repro_torch.bench.cli import figure_main
    seen = []
    monkeypatch.setattr(run, "main", lambda argv: seen.append(argv) or 0)
    assert figure_main("fig6,stream")(["--device", "cpu"]) == 0
    assert figure_main("fig6")(["--only", "fig5", "--out", "x.json"]) == 0
    assert seen == [["--device", "cpu", "--only", "fig6,stream", "--out",
                     "-"], ["--only", "fig5", "--out", "x.json"]]


def test_run_parses_sweeps_and_picks_backends():
    from repro_torch.bench import run
    args = run._parse_args(["--sweep", "tiny:fig5", "--sweep",
                            "paper:fig6,lm"])
    assert run._jobs(args) == [("tiny", "fig5"), ("paper", "fig6,lm")]
    with pytest.raises(SystemExit):
        run._jobs(run._parse_args(["--sweep", "huge:fig5"]))
    assert run._backend(1, torch.device("cuda"), False) is None
    assert run._backend(4, torch.device("cuda"), False) == "nccl"
    assert run._backend(4, torch.device("cuda"), True) == "gloo"
    assert run._backend(2, torch.device("cpu"), False) == "gloo"
