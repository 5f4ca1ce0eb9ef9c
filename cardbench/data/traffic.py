"""The one traffic generator: a traffic file's parameters and a
configuration's sizes -> the scanner's cycle of acquisitions.

A traffic file (``cardbench/workloads/<traffic>.json``) holds:

  entry      the module of ``cardbench/entries`` that drives the program
  cycle      distinct acquisitions the scanner makes at set-up; its
             movie replays them in order, from the acquisition that
             ``--seed`` picks (``--seed`` modulo ``cycle``)
  acquisition_seed
             the seed of the acquisitions themselves (noise, motion
             phase, first spoke angle): the same for every run, so that
             every ``--seed`` asks for the same frames, in another order
  warmup     frames run at set-up, from the initial carry
  noise      k-space noise standard deviation
  start      frames at the start of the scanner's chain that the
             reference works out from the initial carry and compares
  samples    later frames drawn from the seed whose images the
             reference works out from the program's carry before them
  traced_frames
             the traced stretch of ``--trace 1``, after the window
"""

from __future__ import annotations

import json
from pathlib import Path

from . import phantom

WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


def load(traffic: str) -> dict:
    """The traffic file named ``traffic``."""
    path = WORKLOADS / f"{traffic}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def cycle(config: dict, traffic: dict, seed: int, device) -> dict:
    """The scanner's cycle of acquisitions (``phantom.make_cycle``),
    begun at the acquisition that ``seed`` picks."""
    return phantom.make_cycle(config["n"], config["ncoils"],
                              config["spokes"], traffic["cycle"],
                              traffic["noise"], traffic["acquisition_seed"],
                              device, start=int(seed) % traffic["cycle"])
