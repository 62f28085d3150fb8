"""Uniform model API of the port.

Counterpart of ``src/repro/models/model.py``, all six families:
``build(cfg)`` returns a :class:`Model` exposing ``param_specs``
(the ParamSpec tree), ``init(generator, device)`` (random parameters),
``loss_fn(params, batch, generator=None, **inject)`` (the training loss, a
scalar; ``inject`` passes a VLA's ``t`` / ``noise`` draws),
``input_specs(shape)`` (the batch of a ``ShapeConfig`` as ParamSpecs),
``forward(params, batch, ...)`` — the action for a VLA, the logits of the
whole sequence for a dense, MoE, SSM, hybrid or VLM LM, the teacher-forced
decoder logits for the encoder-decoder — and the serving triple
``prefill(params, batch)``, ``decode(params, cache, tokens, pos)`` and
``cache_specs(batch, max_len, src_len=...)``.  The batch is
``{"tokens"}``, with ``"vision"`` (``(B, n_vision_tokens, d_model)``) for
a VLM and ``"frames"`` (``(B, S_src, d_model)``) for the encoder-decoder,
whose ``cache_specs`` takes ``src_len``.  A VLA re-prefills every request:
its ``prefill`` and ``decode`` raise and its cache is empty, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec as E
from . import hybrid as Hy
from . import ssm as S
from . import transformer as T
from . import vla as V
from . import vlm as VL
from .sharding import init_params, spec

Tree = Any


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    param_specs: Tree
    forward: Callable
    prefill: Callable
    decode: Callable
    cache_specs: Callable
    loss_fn: Callable
    input_specs: Callable

    def init(self, generator: torch.Generator, device="cuda") -> Tree:
        """Random parameters on ``device`` (the card unless the caller asks
        for the CPU); raises when the device is not there."""
        return init_params(self.param_specs, generator, device)


def _tok_specs(shape: ShapeConfig, with_labels: bool) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": spec((B, S), ("batch", "seq"), dtype=torch.int32,
                          init="zeros")}
    if with_labels:
        out["labels"] = spec((B, S), ("batch", "seq"), dtype=torch.int32,
                             init="zeros")
    return out


def _one_token(B: int) -> Dict:
    return {"tokens": spec((B, 1), ("batch", "seq"), dtype=torch.int32,
                           init="zeros")}


def _lm_input_specs(shape: ShapeConfig) -> Dict:
    """Dense, MoE, SSM and hybrid: tokens (and labels to train on); one
    token a decode step."""
    if shape.kind == "train":
        return _tok_specs(shape, True)
    if shape.kind == "prefill":
        return _tok_specs(shape, False)
    return _one_token(shape.global_batch)


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

        def loss_fn(params, batch, generator=None):
            return T.lm_loss(cfg, params, batch["tokens"], batch["labels"])

        return Model(cfg, T.lm_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, _lm_input_specs)

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

        def loss_fn(params, batch, generator=None, **inject):
            return V.vla_loss(cfg, params, batch["patches"], batch["tokens"],
                              batch["actions"], generator, **inject)

        def input_specs(shape: ShapeConfig):
            B = shape.global_batch
            out = {"patches": spec((B, cfg.n_patches, cfg.vit_dim),
                                   ("batch", None, None), init="zeros"),
                   "tokens": spec((B, 64), ("batch", "seq"),
                                  dtype=torch.int32, init="zeros")}
            if shape.kind == "train":
                out["actions"] = spec((B, cfg.action_horizon, cfg.action_dim),
                                      ("batch", None, None),
                                      dtype=torch.float32, init="zeros")
            return out

        return Model(cfg, V.vla_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, input_specs)

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

        def loss_fn(params, batch, generator=None):
            return S.ssm_lm_loss(cfg, params, batch["tokens"],
                                 batch["labels"])

        return Model(cfg, S.ssm_lm_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, _lm_input_specs)

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

        def loss_fn(params, batch, generator=None):
            return Hy.hybrid_loss(cfg, params, batch["tokens"],
                                  batch["labels"])

        return Model(cfg, Hy.hybrid_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, _lm_input_specs)

    if fam == "audio":
        def forward(params, batch):
            return E.encdec_logits(cfg, params, batch["frames"],
                                   batch["tokens"])

        def prefill(params, batch):
            return E.encdec_prefill(cfg, params, batch["frames"],
                                    batch["tokens"])

        def decode(params, cache, tokens, pos):
            return E.encdec_decode(cfg, params, cache, tokens, pos)

        def cache_specs(batch, max_len, src_len=None, **_):
            return E.encdec_cache_specs(cfg, batch, max_len,
                                        src_len or max_len)

        def loss_fn(params, batch, generator=None):
            return E.encdec_loss(cfg, params, batch["frames"],
                                 batch["tokens"], batch["labels"])

        def input_specs(shape: ShapeConfig):
            B = shape.global_batch
            frames = spec((B, shape.seq_len, cfg.d_model),
                          ("batch", "seq", None), init="zeros")
            if shape.kind == "train":
                return {"frames": frames, **_tok_specs(shape, True)}
            if shape.kind == "prefill":
                # encode the source frames + the BOS teacher-forcing token
                return {"frames": frames, **_one_token(B)}
            return _one_token(B)

        return Model(cfg, E.encdec_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, input_specs)

    if fam == "vlm":
        def forward(params, batch):
            return VL.vlm_logits(cfg, params, batch["tokens"],
                                 batch["vision"])

        def prefill(params, batch):
            return VL.vlm_prefill(cfg, params, batch["tokens"],
                                  batch["vision"])

        def decode(params, cache, tokens, pos):
            return VL.vlm_decode(cfg, params, cache, tokens, pos)

        def cache_specs(batch, max_len, **_):
            return VL.vlm_cache_specs(cfg, batch, max_len)

        def loss_fn(params, batch, generator=None):
            return VL.vlm_loss(cfg, params, batch["tokens"], batch["vision"],
                               batch["labels"])

        def input_specs(shape: ShapeConfig):
            B = shape.global_batch
            vis = spec((B, cfg.n_vision_tokens, cfg.d_model),
                       ("batch", None, None), init="zeros")
            if shape.kind == "train":
                return {"vision": vis, **_tok_specs(shape, True)}
            if shape.kind == "prefill":
                return {"vision": vis, **_tok_specs(shape, False)}
            return _one_token(B)

        return Model(cfg, VL.vlm_specs(cfg), forward, prefill, decode,
                     cache_specs, loss_fn, input_specs)

    raise ValueError(f"unknown family {fam!r}")
