"""Helpers shared by the port's parity tests: carry data between the JAX
package and ``repro_torch`` as numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import from_numpy_tree


def to_np(x) -> np.ndarray:
    """jax array -> numpy (bf16 travels as float32, which is exact)."""
    if x.dtype == jnp.bfloat16:
        return np.asarray(x.astype(jnp.float32))
    return np.asarray(x)


def t2np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def jax_tree_to_np(tree):
    return jax.tree_util.tree_map(to_np, tree)


def fill_zero_leaves(np_tree, seed: int = 0, scale: float = 0.05):
    """Zero-initialised weights (the DiT's adaLN-zero leaves) would make a
    parity test blind to the layers behind them: give them seeded values
    that bf16 holds exactly."""
    rng = np.random.default_rng(seed)

    def fill(a):
        if a.dtype.kind == "f" and a.size and not a.any():
            v = rng.standard_normal(a.shape).astype(np.float32) * scale
            return np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                              .astype(jnp.float32))
        return a
    return jax.tree_util.tree_map(fill, np_tree)


def both_params(model_jax, model_torch, seed: int = 0, fill_zeros=False):
    """Initialise on the JAX side; return (jax params, torch params) holding
    identical values."""
    params = model_jax.init(jax.random.PRNGKey(seed))
    np_tree = jax_tree_to_np(params)
    if fill_zeros:
        np_tree = fill_zero_leaves(np_tree, seed)
        params = jax.tree_util.tree_map(
            lambda a, p: jnp.asarray(a).astype(p.dtype), np_tree, params)
    tparams = from_numpy_tree(np_tree, "cpu", specs=model_torch.param_specs)
    return params, tparams


def to_port(value):
    """A value of the JAX package's carried numpy modules (a dataclass of
    ``repro.*`` such as ``FleetConfig``, ``TraceConfig``, ``DeviceSpec``,
    ``DeltaCodec``, or a sequence of them) rebuilt as the port's class of
    the same name in the same module, field by field."""
    import dataclasses
    import importlib
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = type(value)
        mod = importlib.import_module(
            cls.__module__.replace("repro.", "repro_torch.", 1))
        return getattr(mod, cls.__name__)(**{
            f.name: to_port(getattr(value, f.name))
            for f in dataclasses.fields(value) if f.init})
    if isinstance(value, (list, tuple)):
        return type(value)(to_port(v) for v in value)
    return value


def plain(value):
    """A report of either package as nested builtins with each
    dataclass's class name kept, so that two packages' reports compare
    with ``==`` field by field."""
    import dataclasses
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: plain(getattr(value, f.name))
                 for f in dataclasses.fields(value)})
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    return value
