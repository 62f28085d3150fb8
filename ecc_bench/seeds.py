"""Named draws of one run's seed.

Every input and weight of a run is drawn from a generator seeded by the
run's seed and the name of the draw (and, for a step's inputs, the step's
index), so that any draw can be made again after the window for the
comparison, and every seed does the same amount of work.
"""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one named draw of the run ``seed``."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8)
                          .digest(), "little") >> 1


def generator(seed: int, device, *parts) -> torch.Generator:
    """A generator on ``device`` for the draw ``parts`` of the run ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *parts))
    return g
