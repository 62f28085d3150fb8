"""Architecture registry of the port: ``get_config("<arch-id>")``.

Holds the configurations this slice of the port serves: the paper's two
VLA models and the dense LM the runtime tests use.  The other
architectures of ``src/repro/configs/__init__.py`` follow with the model
families that need them.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig, SHAPES, get_shape, shape_applicable
from . import cogact_7b, llama3_2_3b, openvla_7b

ARCHS = {
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "openvla-7b": openvla_7b.CONFIG,
    "cogact-7b": cogact_7b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") from None


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "get_shape", "shape_applicable"]
