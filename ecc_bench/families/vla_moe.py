"""The VLA family over a sparse-expert trunk with latent attention: the
requests and the numbers of the ``vla`` family (``families/vla.py``:
``payload_err``, ``action_err``, ``chunk_err``), judged against the plain
reference of this trunk (``reference/vla_moe.py``).

The reference follows the program's own choice of experts where that
choice is a top-k of the reference's scores up to the rounding of a
near-tie (the reference's docstring): the payload the program returns
keeps, beside what it ships, the experts each MoE block chose
(``choices``).  The control, the reference in float8 in the program's
place, is held to the same choices, under its own scores.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ecc_bench.catalog import plugin
from ecc_bench.check import Kept
from ecc_bench.reference import codec as wire
from ecc_bench.reference import vla_moe as ref

_vla = plugin("families", "vla")
Inputs = _vla.Inputs
numbers = _vla.numbers


class _Payload(dict):
    """A payload as the control ships it, with the program's choices."""

    def __init__(self, payload: Dict, choices):
        super().__init__(payload)
        self.choices = choices


def _choices(kept: Kept):
    """The experts the program's MoE blocks chose in the kept step, or
    ``None`` where its payload keeps none."""
    return getattr(kept.payload, "choices", None)


def reference(c: Dict, params: Dict, inputs, kept: Kept,
              lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The reference's answer to a kept step, from its inputs drawn again,
    at the step's cut and codec, following the program's choices."""
    return ref.request(c, params, inputs.images(kept.step), inputs.tokens,
                       kept.decision["edge_blocks"], kept.decision["codec"],
                       inputs.noise(kept.step), lowp=lowp,
                       choices=_choices(kept))


def per_request(c: Dict, params: Dict, inputs, kept: Kept, want: Dict
                ) -> Dict[str, torch.Tensor]:
    """Each request's own reading of each number, as the ``vla`` family
    reads a DiT head's (its ``per_request``)."""
    sent = wire.decode_payload(kept.payload)
    cloud = ref.cloud(c, params, sent, kept.decision["edge_blocks"],
                      inputs.noise(kept.step), choices=_choices(kept))
    return {"payload_err": _vla._rel_rows(sent, want["wire"], p=1),
            "action_err": _vla._rel_rows(kept.answer, want["action"]),
            "chunk_err": _vla._rel_rows(kept.answer, cloud["action"])}


def as_control(c: Dict, kept: Kept, low: Dict) -> Kept:
    """The ``vla`` family's control (its ``as_control``), which keeps the
    program's choices for the reference that judges it."""
    k = _vla.as_control(c, kept, low)
    return Kept(k.step, k.decision, _Payload(k.payload, _choices(kept)),
                k.answer)
