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


def draw_cross_gates(np_tree, seed: int = 0, lo: float = 0.5,
                     hi: float = 1.0):
    """The VLM's cross-block gates (``gate_attn``, ``gate_mlp``) start at
    zero, so that tanh(0) = 0 and a freshly initialised cross block adds
    nothing: a parity test would pass with cross attention wrong or
    missing.  Give them seeded draws in [lo, hi] that bf16 holds exactly,
    as a trained checkpoint would have."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.startswith("gate_"):
                g = rng.uniform(lo, hi, np.shape(v)).astype(np.float32)
                out[k] = np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                                    .astype(jnp.float32))
            else:
                out[k] = v
        return out
    return walk(np_tree)


def both_params(model_jax, model_torch, seed: int = 0, fill_zeros=False,
                gates=False):
    """Initialise on the JAX side; return (jax params, torch params) holding
    identical values (with ``gates``, the cross gates drawn nonzero by
    :func:`draw_cross_gates`)."""
    params = model_jax.init(jax.random.PRNGKey(seed))
    np_tree = jax_tree_to_np(params)
    if fill_zeros or gates:
        if fill_zeros:
            np_tree = fill_zero_leaves(np_tree, seed)
        if gates:
            np_tree = draw_cross_gates(np_tree, seed)
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


def both_params_f32(model_jax, model_torch, seed: int = 0, gates=False,
                    fill_zeros=False):
    """:func:`both_params` with every leaf in float32 on both sides, for
    gradient parity (a bf16 gradient rounds at 2^-8 of its element); the
    JAX package's ``init`` runs jitted, which is faster than leaf by
    leaf."""
    np_tree = jax_tree_to_np(jax.jit(model_jax.init)(
        jax.random.PRNGKey(seed)))
    if fill_zeros:
        np_tree = fill_zero_leaves(np_tree, seed)
    if gates:
        np_tree = draw_cross_gates(np_tree, seed)
    tparams = from_numpy_tree(np_tree, "cpu", specs=model_torch.param_specs)
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                   np_tree),
            jax.tree_util.tree_map(lambda a: a.float(), tparams))


def np_batch(cfg, seed: int = 1, B: int = 2, S: int = 16) -> dict:
    """A training batch for ``cfg``'s family, drawn with numpy from
    ``seed`` (the shapes of ``tests/test_models_smoke.py::_batch``)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "vla":
        batch = {"patches": rng.standard_normal(
                     (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32),
                 "tokens": tokens[:, :8],
                 "actions": rng.uniform(
                     -1, 1, (B, cfg.action_horizon, cfg.action_dim)
                 ).astype(np.float32)}
    return batch


def vla_draws(cfg, key, batch: dict) -> dict:
    """What the JAX package's ``vla_loss`` draws from ``key``, as tensors,
    for the port's ``loss_fn(..., t=, noise=)``: the DiT's timesteps and
    noise, the diffusion head's initial noise."""
    B = batch["actions"].shape[0]
    if cfg.vla_action_head == "dit":
        k1, k2 = jax.random.split(key)
        draws = {"t": jax.random.randint(k1, (B,), 0, cfg.diffusion_steps),
                 "noise": jax.random.normal(k2, batch["actions"].shape)}
    elif cfg.vla_action_head == "diffusion":
        draws = {"noise": jax.random.normal(
            key, (B, cfg.action_horizon * cfg.action_dim))}
    else:
        draws = {}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
