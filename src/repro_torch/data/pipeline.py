"""Synthetic data pipeline: deterministic, restartable.

Counterpart of ``src/repro/data/pipeline.py``, carried as the numpy code
it is, so that the port's batches are the JAX package's (``==``): LM token
streams (a Zipf unigram whose second half repeats the first, so that the
~100M-parameter training example shows a falling loss), VLA trajectories,
and the stub frames / vision embeddings of the encoder-decoder and the
VLM.  The step index is the stream's state, which checkpoints carry.
:func:`to_device` puts a batch on one device and :func:`shard_batch` on a
bound mesh, as ``DTensor`` s sharded over the rules' ``batch`` axes (and
``seq`` for tokens and labels), as the JAX package's ``shard_batch`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"          # which batch keys to emit
    d_model: int = 0               # frames/vision stub width
    n_vision_tokens: int = 0
    n_patches: int = 0
    vit_dim: int = 0
    action_dim: int = 7
    action_horizon: int = 16


class SyntheticStream:
    """Deterministic, seekable batch stream (step index = state)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0

    # ------------------------------------------------------------ checkpoint
    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])

    # ------------------------------------------------------------- batches
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, step))

    def _synth_tokens(self, rng, B, S, V) -> np.ndarray:
        # Zipf unigram + copy structure: second half repeats the first.
        base = rng.zipf(1.3, size=(B, S)) % V
        half = S // 2
        base[:, half:half * 2] = base[:, :half]
        return base.astype(np.int32)

    def next(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng(self.step)
        self.step += 1
        toks = self._synth_tokens(rng, c.global_batch, c.seq_len + 1,
                                  c.vocab_size)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.family == "audio":
            batch["frames"] = rng.standard_normal(
                (c.global_batch, c.seq_len, c.d_model)).astype(np.float32)
        if c.family == "vlm":
            batch["vision"] = rng.standard_normal(
                (c.global_batch, c.n_vision_tokens, c.d_model)
            ).astype(np.float32)
        if c.family == "vla":
            batch = {
                "patches": rng.standard_normal(
                    (c.global_batch, c.n_patches, c.vit_dim)
                ).astype(np.float32),
                "tokens": batch["tokens"][:, :64],
                "actions": rng.uniform(
                    -1, 1, (c.global_batch, c.action_horizon, c.action_dim)
                ).astype(np.float32),
            }
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device`` (the same dtypes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh, rules
                ) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> ``DTensor`` s on the bound ``mesh``, on its
    device type.  Every rank holds the same host batch and keeps its own
    shard of it."""
    from torch.distributed.tensor import distribute_tensor
    from ..models.sharding import placements, resolve
    dm = mesh.device_mesh
    dev = torch.device(dm.device_type)
    out = {}
    for k, v in batch.items():
        axes = ("batch",) + (None,) * (v.ndim - 1)
        if k in ("tokens", "labels"):
            axes = ("batch", "seq")
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        out[k] = distribute_tensor(t, dm, placements(resolve(axes, rules),
                                                     mesh), src_data_rank=None)
    return out
