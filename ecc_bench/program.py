"""The system under test: with the servers (``servers/<server>.py``), the
only modules of the benchmark that import ``repro_torch``.

Here: the port's configuration and parameter tree, its flight recorder,
and what every server of split VLA requests shares.  A server, named by
the traffic's ``server``, is a module with ``make(cfg, traffic, device)``
that returns an object with

- ``decide()``: the :class:`Decision` of the next step (under a
  controller, after its tick);
- ``serve(params, inputs, step, decision, recorder)``: the step's answers
  (on the device) and the payloads it shipped;
- ``warm_decisions()``: a decision for every executor the traffic can
  reach, to warm it up;
- ``trace_more(steps)``: whether the traced steps so far miss a path the
  cell exercises;
- ``close()``: drops the program's state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.telemetry import FlightRecorder
from repro_torch.models import build


def model_config(config: Dict) -> ModelConfig:
    return ModelConfig(**config["config"])


def param_specs(cfg: ModelConfig) -> Dict:
    return build(cfg).param_specs


def recorder() -> FlightRecorder:
    """Keeps every span the executor records."""
    return FlightRecorder(mode="full")


def spans_ms(rec: FlightRecorder) -> Dict[str, List[float]]:
    """Every span the recorder kept, in ms, by the span's name."""
    out: Dict[str, List[float]] = {}
    for group in rec.spans.items:
        for s in group:
            out.setdefault(s.name, []).append(s.dur_s * 1e3)
    return out


@dataclass
class Decision:
    executor: object            # the port's VLASplitExecutor
    split: int                  # the executor's split: ViT layers + edge
    edge_blocks: int            # LLM blocks on the edge, as clamped
    codec: str                  # the wire codec, "" for raw
    overhead_s: Optional[float] = None  # the controller's own tick cost

    def record(self) -> Dict:
        """What the comparison needs to serve the step again."""
        return {"edge_blocks": self.edge_blocks, "codec": self.codec}


class VLAServer:
    """A step of VLA requests through the port's split executor."""

    cfg: ModelConfig

    def decision(self, ex, split: int,
                 overhead_s: Optional[float] = None) -> Decision:
        return Decision(ex, split, ex.plan.clamp(split) - self.cfg.vit_layers,
                        ex.plan.wire_codec, overhead_s)

    def serve(self, params, inputs, step: int, d: Decision, recorder=None):
        return d.executor.run(params, inputs.images(step), inputs.tokens,
                              d.split, noise=inputs.noise(step),
                              recorder=recorder)

    def trace_more(self, steps: List) -> bool:
        return False
