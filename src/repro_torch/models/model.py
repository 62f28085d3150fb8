"""Uniform model API of the port.

Counterpart of ``src/repro/models/model.py`` for the families ported so
far: ``build(cfg)`` returns a :class:`Model` exposing ``param_specs`` (the
ParamSpec tree), ``init(generator, device)`` (random parameters),
``forward(params, batch, ...)`` — the action for a VLA, the logits of the
whole sequence for a dense, MoE, SSM or hybrid LM — and the serving triple
``prefill(params, batch)``, ``decode(params, cache, tokens, pos)`` and
``cache_specs(batch, max_len)``.  A VLA re-prefills every request: its ``prefill`` and
``decode`` raise and its cache is empty, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from . import hybrid as Hy
from . import ssm as S
from . import transformer as T
from . import vla as V
from .sharding import init_params

Tree = Any


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    param_specs: Tree
    forward: Callable
    prefill: Callable
    decode: Callable
    cache_specs: Callable

    def init(self, generator: torch.Generator, device="cuda") -> Tree:
        """Random parameters on ``device`` (the card unless the caller asks
        for the CPU); raises when the device is not there."""
        return init_params(self.param_specs, generator, device)


def build(cfg: ModelConfig) -> Model:
    fam = cfg.family

    if fam in ("dense", "moe"):
        def forward(params, batch):
            h, _ = T.lm_hidden(cfg, params, batch["tokens"])
            return T.lm_logits(cfg, params, h)

        def prefill(params, batch):
            return T.lm_prefill(cfg, params, batch["tokens"])

        def decode(params, cache, tokens, pos):
            return T.lm_decode(cfg, params, cache, tokens, pos)

        def cache_specs(batch, max_len, **_):
            return T.lm_cache_specs(cfg, batch, max_len)

        return Model(cfg, T.lm_specs(cfg), forward, prefill, decode,
                     cache_specs)

    if fam == "vla":
        def forward(params, batch, noise=None, generator=None):
            return V.vla_forward(cfg, params, batch["patches"],
                                 batch["tokens"], noise, generator)

        def prefill(params, batch):
            raise NotImplementedError("VLA serves whole requests; use forward")

        def decode(params, cache, tokens, pos):
            raise NotImplementedError("VLA serves whole requests; use forward")

        def cache_specs(batch, max_len, **_):
            return {}

        return Model(cfg, V.vla_specs(cfg), forward, prefill, decode,
                     cache_specs)

    if fam == "ssm":
        def forward(params, batch):
            return S.ssm_logits(cfg, params,
                                S.ssm_lm_hidden(cfg, params, batch["tokens"]))

        def prefill(params, batch):
            return S.ssm_lm_prefill(cfg, params, batch["tokens"])

        def decode(params, cache, tokens, pos):
            return S.ssm_lm_decode(cfg, params, cache, tokens, pos)

        def cache_specs(batch, max_len=0, **_):
            return S.ssm_lm_cache_specs(cfg, batch)      # no sequence axis

        return Model(cfg, S.ssm_lm_specs(cfg), forward, prefill, decode,
                     cache_specs)

    if fam == "hybrid":
        def forward(params, batch):
            return S.ssm_logits(cfg, params,
                                Hy.hybrid_hidden(cfg, params, batch["tokens"]))

        def prefill(params, batch):
            return Hy.hybrid_prefill(cfg, params, batch["tokens"])

        def decode(params, cache, tokens, pos):
            return Hy.hybrid_decode(cfg, params, cache, tokens, pos)

        def cache_specs(batch, max_len, **_):
            return Hy.hybrid_cache_specs(cfg, batch, max_len)

        return Model(cfg, Hy.hybrid_specs(cfg), forward, prefill, decode,
                     cache_specs)

    if fam in ("audio", "vlm"):
        raise NotImplementedError(f"family {fam!r} is not ported yet")
    raise ValueError(f"unknown family {fam!r}")
