"""``repro_torch.convert.from_numpy_tree``: weights carried across from the
JAX package keep their nesting, shapes and values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import build
from repro_torch.models.sharding import is_spec, tree_leaves

from _torch_port_util import jax_tree_to_np


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name", ["openvla-7b", "cogact-7b", "llama3.2-3b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_nesting_shapes_dtypes_equal_param_specs(name):
    mj = j_build(j_get_config(name).reduced())
    mt = build(get_config(name).reduced())
    np_tree = jax_tree_to_np(mj.init(jax.random.PRNGKey(0)))
    tree = from_numpy_tree(np_tree, "cpu", specs=mt.param_specs)
    flat, specs, ref = _flat(tree), _flat(mt.param_specs), _flat(np_tree)
    assert set(flat) == set(specs) == set(ref)
    for path, t in flat.items():
        assert is_spec(specs[path])
        assert tuple(t.shape) == tuple(specs[path].shape) == ref[path].shape
        assert t.dtype == specs[path].dtype == torch.bfloat16
        assert np.array_equal(t.float().numpy(), ref[path]), path
    # the port's own specs describe the same tree as the JAX package's
    j_specs = _flat(jax.tree_util.tree_map(
        lambda s: (s.shape, s.axes, s.init, s.scale), mj.param_specs,
        is_leaf=lambda x: hasattr(x, "axes")))
    assert {p: (s.shape, s.axes, s.init, s.scale)
            for p, s in specs.items()} == j_specs


def test_bf16_leaf_survives_the_float32_round_trip_bit_for_bit():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5)).astype(np.float32) * 7
                    ).astype(jnp.bfloat16)
    bits = np.asarray(x.view(jnp.uint16))
    t = from_numpy_tree({"w": np.asarray(x.astype(jnp.float32))}, "cpu",
                        dtype=torch.bfloat16)["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)


def test_missing_or_extra_key_or_wrong_shape_raises():
    mt = build(get_config("openvla-7b").reduced())
    np_tree = jax_tree_to_np(
        j_build(j_get_config("openvla-7b").reduced()).init(
            jax.random.PRNGKey(0)))
    missing = {k: v for k, v in np_tree.items() if k != "head"}
    with pytest.raises(KeyError, match="missing keys .*head"):
        from_numpy_tree(missing, "cpu", specs=mt.param_specs)
    extra = dict(np_tree, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra keys .*stray"):
        from_numpy_tree(extra, "cpu", specs=mt.param_specs)
    wrong = dict(np_tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        from_numpy_tree(wrong, "cpu", specs=mt.param_specs)
    nested = dict(np_tree, final_norm={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        from_numpy_tree(nested, "cpu", specs=mt.param_specs)


def test_without_specs_keeps_dtypes_and_owns_its_memory():
    src = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": {"ids": np.arange(4)}}
    out = from_numpy_tree(src, "cpu")
    assert out["a"].dtype == torch.float32 and out["b"]["ids"].dtype == torch.int64
    out["a"][0, 0] = 99.0
    assert src["a"][0, 0] == 0.0
    assert len(tree_leaves(out)) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            from_numpy_tree(src)
