"""The comparison that decides ``correct``.

During the window a reservoir drawn from the seed keeps ``check_steps`` of
the completed steps, each with every request in it: the payloads the
program shipped and the answers it returned, with what the step was served
at (for a split, the cut and the codec).  After the window, with the
program's state freed, the cell's family (``families/<family>.py``, named
by the configuration's file) has its plain reference compute the same
requests from the same inputs, drawn again from the seed, and reads the
numbers compared.  Under a controller the cut and the codec are the
tick's decisions: the reference takes them as inputs of the step, as the
executor does.

Each number is the worst over the sampled steps, and is compared with its
limit in ``limits/<cell>.json``, which gives the readings the limit was
set from.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import torch

from .seeds import derive


@dataclass
class Kept:
    step: int
    decision: Dict                      # what the step was served at
    payload: Dict[str, torch.Tensor]    # as shipped, on the device
    answer: torch.Tensor                # as returned, on the host


class Sample:
    """Algorithm R over the window's steps, with its own generator."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.seen = 0
        self.kept: List[Kept] = []
        self._rng = random.Random(derive(seed, "check"))

    def offer(self, make) -> None:
        """``make()`` builds the record; it is called only if it is kept."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(make())
            return
        j = self._rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = make()


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def _read(family, c, params, inputs, kept, want, out, requests) -> None:
    rows = family.per_request(c, params, inputs, kept, want)
    out.append(family.numbers(c, kept, want, rows))
    if requests is not None:
        requests.append({k: v.tolist() for k, v in rows.items()})


def judge(family: ModuleType, c: Dict, params: Dict, inputs,
          sample: Sample, requests: Optional[list] = None
          ) -> Dict[str, float]:
    """The program's worst readings over the sampled steps; each request's
    own readings are appended to ``requests`` where one is given."""
    out = []
    for kept in sample.kept:
        want = family.reference(c, params, inputs, kept)
        _read(family, c, params, inputs, kept, want, out, requests)
    return worst(out)


def control(family: ModuleType, c: Dict, params: Dict, inputs,
            sample: Sample, lowp: str = "fp8",
            requests: Optional[list] = None) -> Dict[str, float]:
    """The control's readings: the reference in ``lowp`` put in the
    program's place on the same steps."""
    out = []
    for kept in sample.kept:
        want = family.reference(c, params, inputs, kept)
        low = family.as_control(c, kept, family.reference(
            c, params, inputs, kept, lowp))
        _read(family, c, params, inputs, low, want, out, requests)
    return worst(out)


def verdict(readings: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each number beside its limit; a number the cell does not limit is
    refused, so that no reading goes unjudged."""
    return {k: {"value": v, "limit": limits[k]["limit"]}
            for k, v in readings.items()}


def passed(table: Dict[str, Dict]) -> bool:
    return all(e["value"] <= e["limit"] for e in table.values())
