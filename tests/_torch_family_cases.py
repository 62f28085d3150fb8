"""The cases of ``tests/test_torch_spmd_families*.py``: the five families
(SSM, hybrid, VLM, encoder-decoder, VLA with its detok and DiT heads) at
their reduced configs in float32, with parameters from the JAX package's
``init`` (the VLM's cross gates drawn nonzero, the DiT's zero leaves
filled: at zero they hide the layers behind them), a batch of 4 drawn with
numpy, the DiT's timesteps and noise taken from the JAX key, and the port's
one-rank loss, gradients and greedy decode on the CPU."""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from _torch_port_util import both_params_f32, np_batch, vla_draws
from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.sharding import tree_map
from repro_torch.runtime.serving import greedy_generate
from repro_torch.train.train_loop import loss_and_grads

SSM, HYBRID = "mamba2-1.3b", "zamba2-1.2b"
VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
OPENVLA, COGACT = "openvla-7b", "cogact-7b"
# six query heads over two K/V heads: model 4 divides neither, so the
# heads are padded to 8 and each rank handed the K/V heads its own read
UNEVEN = "llama3.2-3b"
# MLA: its causal prefill through B5 on each rank's heads
MLA = "deepseek-v2-lite-16b"
# the other MoE LM and the dense LMs at their reduced configs
GRANITE, PHI3 = "granite-moe-3b-a800m", "phi3-mini-3.8b"
COMMAND_R, GLM4 = "command-r-35b", "glm4-9b"
# the reduced VLAs' ViT has one head of 32; at width 256 it has 4 of 64,
# which every mesh below divides
KW = {OPENVLA: {"vit_dim": 256}, COGACT: {"vit_dim": 256},
      UNEVEN: {"n_heads": 6, "n_kv_heads": 2},
      MLA: {"moe_capacity_factor": 8.0},     # no choice dropped
      GRANITE: {"moe_capacity_factor": 8.0}}
MESHES = ((2, 2), (1, 4), (4, 1))
BATCH, DECODE_PROMPT, DECODE_STEPS = 4, 8, 8
GRAD_REL, LOGIT_REL = 1e-5, 1e-4


def cfg_kw(name: str) -> dict:
    return dict(KW.get(name, {}), dtype="float32")


@functools.lru_cache(maxsize=None)
def case(name: str) -> dict:
    kw = cfg_kw(name)
    cj = j_get_config(name).reduced().replace(**kw)
    mt = build(get_config(name).reduced().replace(**kw))
    pj, pt = both_params_f32(j_build(cj), mt, 0, gates=cj.family == "vlm",
                             fill_zeros=cj.vla_action_head == "dit")
    batch = np_batch(cj, 1, B=BATCH)
    key = jax.random.PRNGKey(2)
    inject = vla_draws(cj, key, batch) if cj.family == "vla" else {}
    return {"kw": kw, "model": mt, "params": pt, "jax_params": pj,
            "params_np": tree_map(lambda t: t.numpy(), pt), "batch": batch,
            "key": key, "inject": inject,
            "inject_np": {k: v.numpy() for k, v in inject.items()}}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _one_thread:
    """One CPU thread for the block, as each gloo rank runs
    (``launch/ranks.py``): the one-rank sums then do not depend on how
    many threads the test's process has."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)
        return False


@functools.lru_cache(maxsize=None)
def one_rank_grads(name: str):
    c = case(name)
    p = tree_map(lambda t: t.clone(), c["params"])
    with _one_thread():
        loss, grads = loss_and_grads(c["model"], p, _t(c["batch"]),
                                     **c["inject"])
    return float(loss), grads


def decode_batch(name: str) -> dict:
    b = case(name)["batch"]
    return {k: v[:, :DECODE_PROMPT] if k == "tokens" else v
            for k, v in b.items() if k not in ("labels",)}


@functools.lru_cache(maxsize=None)
def one_rank_decode(name: str):
    """The greedy tokens and the last position's logits of the prefill and
    of every step, on one rank."""
    c = case(name)
    model, p = c["model"], c["params"]
    b = decode_batch(name)
    kw = {"src_len": b["frames"].shape[1]} if "frames" in b else {}
    logits = []
    step = model.decode

    def recording(params, cache, tokens, pos):
        out = step(params, cache, tokens, pos)
        logits.append(out[0][:, -1])
        return out

    model.decode = recording
    prefill = model.prefill

    def recording_prefill(params, batch):
        out = prefill(params, batch)
        logits.append(out[0][:, -1])
        return out

    model.prefill = recording_prefill
    try:
        with _one_thread():
            toks = greedy_generate(model, p, _t(b), DECODE_STEPS, **kw)
    finally:
        model.decode, model.prefill = step, prefill
    return toks, torch.stack(logits, 1)


def assert_grads_match(loss, grads, name):
    """The loss and every gradient leaf against one rank's, within
    GRAD_REL of the leaf's largest value (the loss relative)."""
    from repro_torch.models.sharding import tree_leaves
    want_loss, want = one_rank_grads(name)
    assert abs(loss - want_loss) <= GRAD_REL * abs(want_loss), \
        (loss, want_loss)
    got, ref = tree_leaves(grads), tree_leaves(want)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_REL * scale, \
            (name, tuple(b.shape), float((a - b).abs().max()), scale)


def assert_decode_matches(toks, logits, name):
    want_toks, want_logits = one_rank_decode(name)
    assert torch.equal(toks, want_toks), (toks, want_toks)
    scale = float(want_logits.abs().max())
    assert float((logits - want_logits).abs().max()) <= LOGIT_REL * scale
