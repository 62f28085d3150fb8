"""The planner's layer graph (paper Eq. 1) as the port builds it.

:func:`build_graph` is ``structure.build_graph``, the JAX package's code
carried unchanged, for every configuration the JAX package has.  A VLA
whose LLM trunk has experts (Kimi-VL's, in the benchmark) is the port's
own: ``structure.build_graph`` would cost its trunk as dense blocks of
width ``d_ff``, some seven times short of the weights the cloud's quota
must hold.  Its ViT nodes, ``vit.proj`` and action-head nodes stay as
``structure`` gives them, and each trunk node ``llm.<i>`` takes the cost
the ``moe`` branch gives that layer: every expert's weights resident, the
operations of the router, the ``moe_top_k`` chosen experts and the shared
expert, attention costed as MLA where the config says so.  The nodes keep
their names and order, so a split maps to the executor as before.
"""
from __future__ import annotations

from typing import List

from ..configs.base import ModelConfig
from .structure import LayerCost, Workload
from .structure import build_graph as _structure_graph


def build_graph(cfg: ModelConfig, w: Workload = Workload()
                ) -> List[LayerCost]:
    """Flattened per-request layer graph in execution order."""
    g = _structure_graph(cfg, w)
    if cfg.family != "vla" or not cfg.n_experts:
        return g
    trunk = {c.name: c for c in _structure_graph(cfg.replace(family="moe"),
                                                 w)
             if c.name.startswith("llm.")}
    return [trunk.get(c.name, c) for c in g]
