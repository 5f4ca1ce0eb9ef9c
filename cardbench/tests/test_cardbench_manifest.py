"""BENCHMARK.json against the rules of its format, and every file a cell
needs found by name."""

import importlib
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metric_keys_sources_and_bounds(manifest):
    e2e = manifest["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(manifest["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in e2e + manifest["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_finds_its_files(manifest):
    from cardbench import run
    configs = {c["name"]: c for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        c = configs[w["config"]]
        assert c["file"].startswith("cardbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        tf = json.loads((ROOT / "cardbench" / "workloads"
                         / f"{w['traffic']}.json").read_text())
        mod = importlib.import_module(f"cardbench.entries.{tf['entry']}")
        assert callable(mod.run)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for m in run.per_layer_of(manifest, w["name"]):
            assert callable(run.reader(m["name"]))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))


def test_metric_workloads_report_what_they_move(manifest):
    from cardbench import run
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"] + manifest["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in cells
    for m in manifest["per_layer"]:
        for cell in m.get("workloads", sorted(cells)):
            reported = {e["name"] for e in run.end_to_end_of(manifest, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e2e = {e["name"] for e in run.end_to_end_of(manifest, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.per_layer_of(manifest, cell)


def test_four_chip_cells_within_their_share(manifest):
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)


def test_a_full_check_fits_at_24_cells(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "cardbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("key", ["n", "grid", "ncoils", "spokes", "newton",
                                 "cg_iters", "damping", "channel_sum",
                                 "fused", "precision"])
def test_configurations_state_the_main_path(manifest, key):
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert key in cfg
        assert cfg["grid"] == 2 * cfg["n"]
