"""Schema-versioned benchmark artifacts.

One artifact is one sweep: a set of scenario runs, each at one
(rank count, problem size) point, carrying the harness timing fields
plus per-scenario extras.  The writer stamps the schema version and git
SHA so two artifacts from different commits are comparable
(``repro_torch.bench.compare``).  The schema is the JAX package's
``repro.bench`` schema, version 1: the same runs give the same artifact
and the same bytes on disk.

This module imports no torch: validation and diff tooling must load on
any host.
"""

from __future__ import annotations

import json
import pathlib
import subprocess

SCHEMA = "repro.bench"
SCHEMA_VERSION = 1

_REPO = pathlib.Path(__file__).resolve().parents[3]

# field -> allowed types, for every scenario run
REQUIRED_FIELDS = {
    "scenario": str,          # registry key, e.g. "fig6.nlinv_frame"
    "figure": str,            # registry figure, e.g. "fig6"
    "devices": int,           # rank count of the run
    "size": str,              # problem size: "tiny" | "paper"
    "wall_ms": (int, float),  # total measurement wall clock
    "compile_ms": (int, float),   # first-call (setup/compile/plan) cost
    "steady_ms": (int, float),    # steady-state best (minimum) sample
}
OPTIONAL_FIELDS = {
    "p50_ms": (int, float),
    "p95_ms": (int, float),
    "jitter_ms": (int, float),
    "iters": int,
    "warmup": int,
    "plan_cache": dict,            # PlanCache.delta regions
    "speedup_vs_1dev": (int, float),
    "extra": dict,                 # scenario-specific derived columns
}


class ArtifactError(ValueError):
    """A benchmark artifact violates the repro.bench schema."""


def run_key(run: dict) -> str:
    """Stable identity of one run inside an artifact."""
    return f"{run['scenario']}@d{run['devices']}@{run['size']}"


def git_sha(repo: pathlib.Path | None = None) -> str:
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"],
                           cwd=str(repo or _REPO), capture_output=True,
                           text=True, timeout=10)
        sha = r.stdout.strip()
        return sha if r.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def make_artifact(runs, *, sha: str | None = None, host: dict | None = None,
                  calibration_ms: float | None = None) -> dict:
    """Assemble + validate an artifact from scenario run dicts.

    Computes ``speedup_vs_1dev`` for every multi-device run whose
    (scenario, size) also ran at 1 device with a nonzero steady state.
    ``calibration_ms`` is the machine-speed reference
    (``harness.calibrate``) the compare tool normalizes by.
    """
    runs = [dict(r) for r in runs]
    base = {(r["scenario"], r["size"]): r for r in runs if r["devices"] == 1}
    for r in runs:
        b = base.get((r["scenario"], r["size"]))
        if (r["devices"] > 1 and b is not None
                and b["steady_ms"] > 0 and r["steady_ms"] > 0):
            r["speedup_vs_1dev"] = round(b["steady_ms"] / r["steady_ms"], 3)
    scen = {}
    for r in runs:
        key = run_key(r)
        if key in scen:
            raise ArtifactError(f"duplicate run for {key} (same scenario, "
                                f"device count and size measured twice)")
        scen[key] = r
    art = {
        "schema": SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "git_sha": git_sha() if sha is None else sha,
        "host": dict(host or {}),
        "scenarios": scen,
    }
    if calibration_ms is not None:
        art["calibration_ms"] = calibration_ms
    validate_artifact(art)
    return art


def validate_artifact(art) -> dict:
    """Raise :class:`ArtifactError` unless ``art`` is schema-valid."""
    if not isinstance(art, dict):
        raise ArtifactError(f"artifact must be a dict, got {type(art)}")
    if art.get("schema") != SCHEMA:
        raise ArtifactError(f"schema must be {SCHEMA!r}: {art.get('schema')!r}")
    if art.get("schema_version") != SCHEMA_VERSION:
        raise ArtifactError(
            f"schema_version must be {SCHEMA_VERSION}: "
            f"{art.get('schema_version')!r}")
    if not isinstance(art.get("git_sha"), str) or not art["git_sha"]:
        raise ArtifactError("git_sha must be a non-empty string")
    if not isinstance(art.get("host"), dict):
        raise ArtifactError("host must be a dict")
    cal = art.get("calibration_ms")
    if cal is not None and (not isinstance(cal, (int, float))
                            or isinstance(cal, bool) or cal <= 0):
        raise ArtifactError("calibration_ms must be a positive number")
    scen = art.get("scenarios")
    if not isinstance(scen, dict):
        raise ArtifactError("scenarios must be a dict")
    for key, run in scen.items():
        if not isinstance(run, dict):
            raise ArtifactError(f"{key}: run must be a dict")
        for field, types in REQUIRED_FIELDS.items():
            if field not in run:
                raise ArtifactError(f"{key}: missing field {field!r}")
            if not isinstance(run[field], types) or isinstance(run[field], bool):
                raise ArtifactError(
                    f"{key}: field {field!r} has type "
                    f"{type(run[field]).__name__}, want {types}")
        for field, types in OPTIONAL_FIELDS.items():
            if field in run and not isinstance(run[field], types):
                raise ArtifactError(
                    f"{key}: field {field!r} has type "
                    f"{type(run[field]).__name__}, want {types}")
        if run["devices"] < 1:
            raise ArtifactError(f"{key}: devices must be >= 1")
        if run["steady_ms"] < 0 or run["compile_ms"] < 0 or run["wall_ms"] < 0:
            raise ArtifactError(f"{key}: timing fields must be >= 0")
        if key != run_key(run):
            raise ArtifactError(
                f"artifact key {key!r} != run identity {run_key(run)!r}")
    return art


def write_artifact(path, art: dict) -> pathlib.Path:
    """Validate + write (deterministic field order, trailing newline)."""
    validate_artifact(art)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art, indent=2, sort_keys=True) + "\n")
    return path


def load_artifact(path) -> dict:
    """Load + validate an artifact from disk."""
    path = pathlib.Path(path)
    try:
        art = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise ArtifactError(f"{path}: not valid JSON: {e}") from e
    return validate_artifact(art)
