"""Model substrate of the port: layers, attention, assemblies per family."""
from .model import Model, build
from .sharding import ParamSpec, init_params, is_spec, spec

__all__ = ["Model", "build", "ParamSpec", "init_params", "is_spec", "spec"]
