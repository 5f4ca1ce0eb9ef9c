"""Diff two benchmark artifacts and gate steady-state regressions.

  PYTHONPATH=src python -m repro_torch.bench.compare BASE.json NEW.json \\
      [--threshold 25] [--min-ms 0.01] [--fail-on-missing] \\
      [--summary $GITHUB_STEP_SUMMARY]

Exit status is non-zero iff a regression is found: a scenario present in
both artifacts whose steady-state per-call cost grew by more than
``--threshold`` percent over ``max(base, --min-ms)``.  When both
artifacts carry the ``calibration_ms`` machine-speed reference
(``harness.calibrate``, stamped by the sweep runner), the new steady
states are first scaled by ``base_cal / new_cal`` so a uniformly
slower/faster host (cgroup neighbors, different runner) cancels out and
only code-induced slowdowns remain.  Clamping the base
up to the floor means sub-floor rows (scheduler jitter territory;
model-only rows report 0.0) cannot flake the gate on noise — but they
still fail once the new cost clears threshold above the floor itself,
so a sub-floor baseline never exempts a real regression.  New scenarios
pass (the trajectory is supposed to grow); scenarios that disappeared
are reported and fail only under ``--fail-on-missing``.

Serve scenarios additionally gate the worst per-client p95
(``extra.client_p95_ms``) with the same threshold/floor/scale rules: a
scheduler change that keeps the mean tick fast while starving one
client is a regression too.
"""

from __future__ import annotations

import argparse
import dataclasses

from .artifact import load_artifact

DEFAULT_THRESHOLD_PCT = 25.0
DEFAULT_MIN_MS = 0.01


@dataclasses.dataclass
class Comparison:
    """Outcome of diffing two artifacts (lists of per-scenario entries)."""

    regressions: list
    improvements: list
    unchanged: list
    below_floor: list    # skipped: steady state under the noise floor
    new: list            # keys only in the new artifact
    missing: list        # keys only in the base artifact
    threshold_pct: float
    min_ms: float
    scale: float = 1.0   # machine-speed normalization applied to `new`
    # (scenario, size) groups in the NEW artifact whose speedup_vs_1dev
    # drops anywhere as the device count grows (advisory: reported, not
    # gated — the fig. 5 scaling-shape check)
    non_monotone: list = dataclasses.field(default_factory=list)
    # serving SLO gate: scenarios whose per-client p95
    # (``extra.client_p95_ms``, worst client) regressed past the same
    # threshold — a scheduler change that keeps the mean tick fast but
    # starves one client fails here, not silently
    p95_regressions: list = dataclasses.field(default_factory=list)
    # scenarios flagged ``extra.advisory`` in either artifact: evidence
    # columns only (e.g. the chaos drill's recovery latency), excluded
    # from both the steady-state and the p95 gates by construction
    advisory: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.regressions or self.p95_regressions)


def compare_artifacts(base: dict, new: dict, *,
                      threshold_pct: float = DEFAULT_THRESHOLD_PCT,
                      min_ms: float = DEFAULT_MIN_MS) -> Comparison:
    """Diff two (already validated) artifacts; see module docstring."""
    b, n = base["scenarios"], new["scenarios"]
    # normalize by relative machine speed when both artifacts carry the
    # calibration reference: neighbor contention on a shared host slows
    # the reference and every scenario together (the ratio cancels it),
    # while a genuine code regression moves only the scenario.
    bc, nc = base.get("calibration_ms"), new.get("calibration_ms")
    scale = bc / nc if bc and nc else 1.0
    cmp = Comparison([], [], [], [], [], [],
                     threshold_pct=threshold_pct, min_ms=min_ms,
                     scale=round(scale, 4))
    for key in sorted(set(b) | set(n)):
        if key not in n:
            cmp.missing.append(key)
            continue
        if key not in b:
            cmp.new.append(key)
            continue
        if (b[key].get("extra") or {}).get("advisory") \
                or (n[key].get("extra") or {}).get("advisory"):
            # a fault-injection drill's timings measure the injected
            # faults, not the code: report, never gate
            cmp.advisory.append(key)
            continue
        bs = b[key]["steady_ms"]
        ns = round(n[key]["steady_ms"] * scale, 6)
        entry = {"key": key, "base_ms": bs, "new_ms": ns,
                 "raw_new_ms": n[key]["steady_ms"],
                 "ratio": round(ns / bs, 3) if bs > 0 else None}
        # a sub-floor BASE must not exempt an unbounded regression: the
        # base is clamped up to the floor, so a noise-floor row fails
        # only once its new cost clears threshold above the floor itself
        if bs < min_ms and ns < min_ms:
            cmp.below_floor.append(entry)
        elif ns > max(bs, min_ms) * (1.0 + threshold_pct / 100.0):
            cmp.regressions.append(entry)
        elif bs >= min_ms and ns < bs * (1.0 - threshold_pct / 100.0):
            cmp.improvements.append(entry)
        else:
            cmp.unchanged.append(entry)
        # per-client SLO column (serve scenarios): same threshold/floor
        # discipline, on the worst client's p95 instead of the mean tick
        bp = (b[key].get("extra") or {}).get("client_p95_ms")
        np_ = (n[key].get("extra") or {}).get("client_p95_ms")
        if bp is not None and np_ is not None:
            np_ = round(np_ * scale, 6)
            if not (bp < min_ms and np_ < min_ms) and \
                    np_ > max(bp, min_ms) * (1.0 + threshold_pct / 100.0):
                cmp.p95_regressions.append(
                    {"key": key, "base_ms": bp, "new_ms": np_,
                     "ratio": round(np_ / bp, 3) if bp > 0 else None})
    cmp.non_monotone = _non_monotone_speedups(new)
    return cmp


def _non_monotone_speedups(art: dict) -> list:
    """(scenario, size) groups whose ``speedup_vs_1dev`` DROPS anywhere
    as the device count grows (1 device counts as speedup 1.0).  The
    paper's fig. 5 point is that transfers should scale; a schedule that
    gets slower with more devices shows up here even when it clears the
    regression threshold."""
    groups: dict = {}
    for run in art["scenarios"].values():
        sp = 1.0 if run["devices"] == 1 else run.get("speedup_vs_1dev")
        if sp is None:
            continue
        groups.setdefault((run["scenario"], run["size"]), {})[
            run["devices"]] = sp
    out = []
    for (scenario, size), by_dev in sorted(groups.items()):
        devs = sorted(by_dev)
        if len(devs) < 2:
            continue
        speeds = [by_dev[d] for d in devs]
        if any(b < a for a, b in zip(speeds, speeds[1:])):
            out.append({"key": f"{scenario}@{size}",
                        "speedups": {f"d{d}": by_dev[d] for d in devs}})
    return out


def format_report(cmp: Comparison) -> str:
    lines = [f"repro_torch.bench.compare: threshold +{cmp.threshold_pct:g}% "
             f"steady-state, noise floor {cmp.min_ms:g} ms, "
             f"machine-speed scale {cmp.scale:g}x"]
    for entry in cmp.regressions:
        lines.append(f"  REGRESSION {entry['key']}: "
                     f"{entry['base_ms']:g} -> {entry['new_ms']:g} ms "
                     f"({entry['ratio']}x)")
    for entry in cmp.p95_regressions:
        lines.append(f"  P95 REGRESSION {entry['key']}: worst-client p95 "
                     f"{entry['base_ms']:g} -> {entry['new_ms']:g} ms "
                     f"({entry['ratio']}x)")
    for entry in cmp.improvements:
        lines.append(f"  improved   {entry['key']}: "
                     f"{entry['base_ms']:g} -> {entry['new_ms']:g} ms "
                     f"({entry['ratio']}x)")
    for key in cmp.new:
        lines.append(f"  new        {key}")
    for key in cmp.missing:
        lines.append(f"  MISSING    {key} (in base, not in new)")
    for key in cmp.advisory:
        lines.append(f"  advisory   {key} (not gated)")
    for entry in cmp.non_monotone:
        curve = " -> ".join(f"{v:g} ({d})"
                            for d, v in entry["speedups"].items())
        lines.append(f"  NON-MONOTONE scaling {entry['key']}: {curve}")
    lines.append(
        f"  {len(cmp.unchanged)} unchanged, "
        f"{len(cmp.below_floor)} under the noise floor, "
        f"{len(cmp.improvements)} improved, {len(cmp.new)} new, "
        f"{len(cmp.missing)} missing, {len(cmp.advisory)} advisory, "
        f"{len(cmp.non_monotone)} non-monotone scaling, "
        f"{len(cmp.regressions)} regressions, "
        f"{len(cmp.p95_regressions)} per-client p95 regressions")
    return "\n".join(lines)


def format_markdown(cmp: Comparison) -> str:
    """GitHub-flavored markdown table of every per-scenario steady-state
    delta — what ``--summary`` emits into the Actions job summary so the
    trajectory is visible on every PR without downloading artifacts."""
    lines = [
        "### repro_torch.bench steady-state vs baseline",
        "",
        f"threshold +{cmp.threshold_pct:g}% · noise floor "
        f"{cmp.min_ms:g} ms · machine-speed scale {cmp.scale:g}x",
        "",
        "| scenario | base ms | new ms | ratio | status |",
        "|---|---:|---:|---:|---|",
    ]
    rows = ([(e, "🔴 regression") for e in cmp.regressions] +
            [(e, "🟢 improved") for e in cmp.improvements] +
            [(e, "unchanged") for e in cmp.unchanged] +
            [(e, "below floor") for e in cmp.below_floor])
    for entry, status in sorted(rows, key=lambda r: r[0]["key"]):
        ratio = entry["ratio"]
        lines.append(
            f"| `{entry['key']}` | {entry['base_ms']:g} | "
            f"{entry['new_ms']:g} | "
            f"{ratio if ratio is not None else '—'} | {status} |")
    for key in cmp.new:
        lines.append(f"| `{key}` | — | — | — | 🆕 new |")
    for key in cmp.missing:
        lines.append(f"| `{key}` | — | — | — | ⚠️ missing |")
    for key in cmp.advisory:
        lines.append(f"| `{key}` | — | — | — | advisory (not gated) |")
    if cmp.p95_regressions:
        lines += ["", "**Per-client p95 regressions** (serve scenarios, "
                      "worst client):", ""]
        for entry in cmp.p95_regressions:
            lines.append(f"- `{entry['key']}`: {entry['base_ms']:g} → "
                         f"{entry['new_ms']:g} ms ({entry['ratio']}x)")
    if cmp.non_monotone:
        lines += ["", "**Non-monotone `speedup_vs_1dev`** (scaling drops "
                      "somewhere as devices grow):", ""]
        for entry in cmp.non_monotone:
            curve = " → ".join(f"{v:g} ({d})"
                               for d, v in entry["speedups"].items())
            lines.append(f"- `{entry['key']}`: {curve}")
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.bench.compare",
        description="diff two BENCH artifacts; non-zero exit on regression")
    ap.add_argument("base", help="baseline artifact")
    ap.add_argument("new", help="freshly generated artifact")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD_PCT,
                    metavar="PCT",
                    help="steady-state growth tolerated before failing "
                         "(percent, default %(default)s)")
    ap.add_argument("--min-ms", type=float, default=DEFAULT_MIN_MS,
                    help="noise floor: the base steady state is clamped up "
                         "to this before the threshold test (ms, default "
                         "%(default)s)")
    ap.add_argument("--fail-on-missing", action="store_true",
                    help="also fail when a baseline scenario disappeared")
    ap.add_argument("--summary", default=None, metavar="PATH",
                    help="append a markdown table of per-scenario deltas "
                         "to PATH (CI passes $GITHUB_STEP_SUMMARY); '-' "
                         "prints it to stdout")
    args = ap.parse_args(argv)

    cmp = compare_artifacts(load_artifact(args.base), load_artifact(args.new),
                            threshold_pct=args.threshold, min_ms=args.min_ms)
    print(format_report(cmp))
    if args.summary:
        md = format_markdown(cmp)
        if args.summary == "-":
            print(md)
        else:
            with open(args.summary, "a") as f:
                f.write(md + "\n")
    if not cmp.ok:
        return 1
    if args.fail_on_missing and cmp.missing:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
