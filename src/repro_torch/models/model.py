"""Uniform model API of the port.

Counterpart of ``src/repro/models/model.py`` for the families ported so
far: ``build(cfg)`` returns a :class:`Model` exposing ``param_specs`` (the
ParamSpec tree), ``init(generator, device)`` (random parameters) and
``forward(params, batch, ...)`` — the action for a VLA, the logits of the
whole sequence for a dense LM.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from . import transformer as T
from . import vla as V
from .sharding import init_params

Tree = Any


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    param_specs: Tree
    forward: Callable

    def init(self, generator: torch.Generator, device="cuda") -> Tree:
        """Random parameters on ``device`` (the card unless the caller asks
        for the CPU); raises when the device is not there."""
        return init_params(self.param_specs, generator, device)


def build(cfg: ModelConfig) -> Model:
    fam = cfg.family

    if fam == "dense":
        def forward(params, batch):
            h, _ = T.lm_hidden(cfg, params, batch["tokens"])
            return T.lm_logits(cfg, params, h)

        return Model(cfg, T.lm_specs(cfg), forward)

    if fam == "vla":
        def forward(params, batch, noise=None, generator=None):
            return V.vla_forward(cfg, params, batch["patches"],
                                 batch["tokens"], noise, generator)

        return Model(cfg, V.vla_specs(cfg), forward)

    if fam in ("moe", "ssm", "hybrid", "audio", "vlm"):
        raise NotImplementedError(f"family {fam!r} is not ported yet")
    raise ValueError(f"unknown family {fam!r}")
