"""The comparison that decides ``correct``.

The program's delivered images are held against the plain reference
(``cardbench/reference/nlinv.py``) worked out from the same acquisitions:
the first frames of the scanner's chain from the initial carry, and
frames drawn from the seed from the program's carry before them.  The
number compared is the widest relative L2 gap of a compared image,
``||program - reference|| / ||reference||``.

Each limit lies between two readings on the card at the cells' own
sizes (PERF.md gives them): the largest that sound runs of the program
gave over a dozen seeds and more, and the smallest that the control (the
reference stored in bfloat16, in the program's place) gave.
"""

from __future__ import annotations

# name: limit
LIMITS = {
    "frame_rel_err": 1e-3,
}


def readings(pairs) -> dict:
    """``pairs``: [(label, relative error), ...] -> the numbers compared."""
    if not pairs:
        return {"frame_rel_err": float("inf"), "frames_compared": 0}
    worst = max(pairs, key=lambda p: p[1] if p[1] == p[1] else float("inf"))
    err = worst[1] if worst[1] == worst[1] else float("inf")
    return {"frame_rel_err": err, "frames_compared": len(pairs),
            "worst_frame": worst[0]}


def verdict(got: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a missing or non-finite number fails."""
    checks, ok = {}, True
    for name, limit in LIMITS.items():
        value = got.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    if got.get("frames_compared", 0) <= 0:
        ok = False
    checks["frames_compared"] = {"value": got.get("frames_compared", 0),
                                 "limit": 1}
    return ok, checks
