"""Architecture registry of the port: ``get_config("<arch-id>")``.

The same twelve configurations as ``src/repro/configs/__init__.py``: the
ten assigned architectures plus the paper's two VLA models.  The planner
(``repro_torch.core``) runs over all twelve; the model code of the port
serves the ``vla`` and ``dense`` families so far.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, SHAPES, get_shape, shape_applicable
from . import (
    llama3_2_3b,
    command_r_35b,
    glm4_9b,
    phi3_mini_3_8b,
    deepseek_v2_lite_16b,
    granite_moe_3b_a800m,
    mamba2_1_3b,
    seamless_m4t_large_v2,
    llama_3_2_vision_11b,
    zamba2_1_2b,
    openvla_7b,
    cogact_7b,
)

ARCHS = {
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "phi3-mini-3.8b": phi3_mini_3_8b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    # paper's own evaluation models
    "openvla-7b": openvla_7b.CONFIG,
    "cogact-7b": cogact_7b.CONFIG,
}

ASSIGNED = tuple(k for k in ARCHS if k not in ("openvla-7b", "cogact-7b"))


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "ASSIGNED",
    "get_config", "get_shape", "shape_applicable",
]
