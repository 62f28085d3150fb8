"""Network fluctuation predictor — lightweight LSTM (paper §IV-B-1).

The port of ``src/repro/core/predictor.py``, the one piece of the control
plane the JAX package wrote in JAX: the same LSTM (gate order ``i, f, o,
u`` along the ``4 * hidden`` axis, forget-gate bias ``+1.0``), the same
log-normalised windows, the same hand-rolled Adam and the same batch draws
from ``np.random.default_rng(seed)``; gradients come from autograd.
Parameters are float32 tensors on an explicit device, the card by default.
The initial weights come from a ``torch.Generator`` and so differ from the
JAX package's draw; ``repro_torch.convert.lstm_params_from_numpy`` carries
the JAX package's parameters across when both must compute the same thing.

Constraint Eq. 3: the input granularity ``t_input`` must be finer than
``min(t_cloud, t_edge)`` — :func:`check_granularity`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import require_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class PredictorConfig:
    window: int = 32
    hidden: int = 64
    lr: float = 1e-2
    epochs: int = 200
    batch: int = 64


def init_lstm(generator: torch.Generator, hidden: int, device="cuda"
              ) -> Params:
    """Gaussian weights scaled by ``hidden ** -0.5``, zero gate bias.  The
    draws are made on the generator's device and moved to ``device``."""
    dev = require_device(device)
    s = hidden ** -0.5

    def normal(shape):
        return (torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
                * s).to(dev)
    return {
        "wx": normal((1, 4 * hidden)),
        "wh": normal((hidden, 4 * hidden)),
        "b": torch.zeros((4 * hidden,), dtype=torch.float32, device=dev),
        "head": normal((hidden, 1)),
    }


def lstm_forward(params: Params, window: torch.Tensor) -> torch.Tensor:
    """window: (B, T) log-normalised -> (B,) next-value prediction."""
    B, T = window.shape
    H = params["wh"].shape[0]
    h = window.new_zeros((B, H))
    c = window.new_zeros((B, H))
    for t in range(T):
        g = window[:, t:t + 1] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, o, u = g.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(u)
        h = torch.sigmoid(o) * torch.tanh(c)
    return (h @ params["head"])[:, 0]


def _normalise(bw: np.ndarray, ref: float) -> np.ndarray:
    return np.log(np.maximum(bw, 1.0) / ref)


@dataclasses.dataclass
class Predictor:
    params: Params
    cfg: PredictorConfig
    ref_bps: float

    @property
    def device(self) -> torch.device:
        return self.params["wh"].device

    @torch.no_grad()
    def predict(self, window_bps: np.ndarray) -> float:
        """One forecast: a host-to-device copy of the window, the LSTM, and
        a synchronising read of the result."""
        x = torch.as_tensor(_normalise(window_bps, self.ref_bps),
                            dtype=torch.float32).to(self.device)[None, :]
        y = lstm_forward(self.params, x)[0]
        return float(torch.exp(y) * self.ref_bps)

    def n_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.params.values())


def train_predictor(trace_bps: np.ndarray,
                    cfg: PredictorConfig = PredictorConfig(), seed: int = 0,
                    device="cuda") -> Tuple[Predictor, list]:
    """Train on (window -> next tick) pairs from a historical trace."""
    dev = require_device(device)
    ref = float(np.mean(trace_bps))
    x = _normalise(trace_bps, ref)
    W = cfg.window
    wins = torch.as_tensor(np.stack([x[i:i + W] for i in range(len(x) - W)]),
                           dtype=torch.float32).to(dev)
    tgts = torch.as_tensor(x[W:], dtype=torch.float32).to(dev)
    params = init_lstm(torch.Generator(device=dev).manual_seed(seed),
                       cfg.hidden, dev)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    rng = np.random.default_rng(seed)
    losses = []
    for e in range(1, cfg.epochs + 1):
        idx = torch.as_tensor(rng.integers(0, len(wins), cfg.batch)).to(dev)
        p = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        loss = torch.mean((lstm_forward(p, wins[idx]) - tgts[idx]) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for k, g in zip(p, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** e)
                vh = v[k] / (1 - b2 ** e)
                params[k] = params[k] - cfg.lr * mh / (torch.sqrt(vh) + eps)
        losses.append(float(loss.detach()))
    return Predictor(params, cfg, ref), losses


def check_granularity(t_input_s: float, t_cloud_s: float, t_edge_s: float
                      ) -> bool:
    """Paper Eq. 3: t_input < min(t_cloud, t_edge)."""
    return t_input_s < min(t_cloud_s, t_edge_s)
