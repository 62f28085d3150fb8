"""The VLA family: what a robot's request carries, and how the plain
reference (``reference/vla.py``) judges what the program returned.

A request carries the robot's instruction (``prompt_tokens`` token ids,
drawn once a run) and a fresh image (``n_patches`` patch rows of
``vit_dim``) every step; for a head that samples, also its initial noise.
Every draw is made on the device from a generator seeded by the run's seed,
the draw's name and the step's index (``seeds.py``).

The numbers compared, each the worst over the sampled requests:

- ``payload_err``: the relative error (the sum of absolute differences
  over the request's rows, over the sum of the reference's absolute
  values) of the activation the program shipped, decoded, against the
  reference's cut activation through the same codec.  It covers the ViT,
  the embedding, the edge's LLM blocks and the quantizer.  The sum of
  absolute values, not of squares: where a coarse codec's codes differ by
  one step, the squares would grow with the square root of the error
  behind them and hide most of it.
- ``logit_gap`` (``detok``): how far below the reference's best logit the
  best token of the action bin the program served lies, in standard
  deviations of the reference's logits at that position.  A bin is a token
  id modulo 256, so the program's answer names a class of tokens, and the
  gap is that of the class's best; it covers the whole request.
- ``action_err`` (``dit``): the relative error of a step's action chunks
  against the reference's, from the same inputs and initial noise, over
  all the step's requests (the norm of the differences of every chunk
  over the norm of every reference chunk), the worst step.  It covers the
  whole request, edge and cloud; per step, because a request's own error
  here swings with where a coarse codec's codes flip.
- ``chunk_err`` (``dit``): each request's action chunk against the
  reference's cloud part (the blocks after the cut, the final norm and the
  DiT's DDIM loop, in float32) run from the activation the program itself
  shipped, decoded, and the same noise; the relative error of the chunk,
  the worst request.  The codec's code flips are then common to both
  sides, so one request's answer altered where it is produced stands out
  of the rounding of the others.  ``payload_err`` checks that start.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ecc_bench.check import Kept
from ecc_bench.reference import codec as wire
from ecc_bench.reference import vla as ref
from ecc_bench.seeds import generator

BINS = 256


class Inputs:
    """A fleet of ``robots``: each step one request from every robot."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.c = config["config"]
        self.robots = int(traffic["robots"])
        self.prompt_tokens = int(traffic["prompt_tokens"])
        self.seed = seed
        self.device = torch.device(device)
        self.tokens = torch.randint(
            0, self.c["vocab_size"], (self.robots, self.prompt_tokens),
            generator=generator(seed, self.device, "prompts"),
            device=self.device)

    def images(self, step: int) -> torch.Tensor:
        """(robots, n_patches, vit_dim) float32 patch rows of one step."""
        return torch.randn((self.robots, self.c["n_patches"],
                            self.c["vit_dim"]),
                           generator=generator(self.seed, self.device,
                                               "images", step),
                           device=self.device)

    def noise(self, step: int) -> Optional[torch.Tensor]:
        """The DiT's initial noise of each request, or ``None``."""
        if self.c["vla_action_head"] != "dit":
            return None
        return torch.randn((self.robots, self.c["action_horizon"],
                            self.c["action_dim"]),
                           generator=generator(self.seed, self.device,
                                               "noise", step),
                           device=self.device)

    @property
    def seq(self) -> int:
        """Positions of one request in the LLM: image rows and prompt."""
        return self.c["n_patches"] + self.prompt_tokens


def _rel_rows(got: torch.Tensor, want: torch.Tensor, p: int = 2
              ) -> torch.Tensor:
    """Per-request relative error in the ``p``-norm over all but the batch
    axis; ``inf`` where the program's answer is not finite."""
    got = got.to(want.device).float()
    d = (got - want.float()).flatten(1).norm(p=p, dim=1)
    rel = d / want.float().flatten(1).norm(p=p, dim=1).clamp_min(1e-30)
    return torch.where(torch.isfinite(got.flatten(1)).all(1), rel,
                       torch.full_like(rel, float("inf")))


def served_bins(action: torch.Tensor) -> Optional[torch.Tensor]:
    """The bins of ``detok`` actions ``(bin / 127.5) - 1``, or ``None``
    where a value is no bin."""
    a = action.float().reshape(action.shape[0], -1)
    bins = torch.round((a + 1.0) * 127.5)
    if not torch.isfinite(a).all() or (bins < 0).any() \
            or (bins >= BINS).any() \
            or ((bins / 127.5 - 1.0) - a).abs().max() > 1e-5:
        return None
    return bins.long()


def class_gap(logits: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """(B, positions): the reference's best logit less the best logit of
    the tokens in each served bin, over the logits' standard deviation."""
    V = logits.shape[-1]
    cls = torch.arange(V, device=logits.device) % BINS
    member = cls[None, None, :] == bins[..., None].to(logits.device)
    best = logits.max(dim=-1).values
    in_class = logits.masked_fill(~member, float("-inf")).max(dim=-1).values
    return (best - in_class) / logits.std(dim=-1)


def reference(c: Dict, params: Dict, inputs: Inputs, kept: Kept,
              lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The reference's answer to a kept step, from its inputs drawn again,
    at the step's cut and codec."""
    return ref.request(c, params, inputs.images(kept.step), inputs.tokens,
                       kept.decision["edge_blocks"], kept.decision["codec"],
                       inputs.noise(kept.step), lowp=lowp)


def per_request(c: Dict, params: Dict, inputs: Inputs, kept: Kept,
                want: Dict) -> Dict[str, torch.Tensor]:
    """Each request's own reading of each number; for ``action_err``, each
    request's chunk against the reference's, whose step norm is compared."""
    out = {"payload_err": _rel_rows(wire.decode_payload(kept.payload),
                                    want["wire"], p=1)}
    if c["vla_action_head"] == "detok":
        bins = served_bins(kept.answer)
        out["logit_gap"] = torch.full((kept.answer.shape[0],), float("inf")) \
            if bins is None else class_gap(want["logits"], bins).amax(1)
        return out
    out["action_err"] = _rel_rows(kept.answer, want["action"])
    cloud = ref.cloud(c, params, wire.decode_payload(kept.payload),
                      kept.decision["edge_blocks"], inputs.noise(kept.step))
    out["chunk_err"] = _rel_rows(kept.answer, cloud["action"])
    return out


def numbers(c: Dict, kept: Kept, want: Dict, rows: Dict
            ) -> Dict[str, float]:
    """The step's reading of each number compared, from its requests'
    ``rows``."""
    out = {k: float(v.max()) for k, v in rows.items()}
    if "action_err" in rows:
        out["action_err"] = float(_rel_rows(kept.answer.reshape(1, -1),
                                            want["action"].reshape(1, -1)))
    return out


def as_control(c: Dict, kept: Kept, low: Dict) -> Kept:
    """The control in the program's place on a kept step: its cut
    activation as the payload, and its action, or the bins of the tokens
    it puts first at each position."""
    if c["vla_action_head"] == "detok":
        toks = low["logits"].argmax(dim=-1)
        answer = ((toks % BINS).float() / 127.5 - 1.0).cpu()
    else:
        answer = low["action"].cpu()
    return Kept(kept.step, kept.decision, {"x": low["wire"]}, answer)
