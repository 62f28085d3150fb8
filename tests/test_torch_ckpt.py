"""Checkpoints and the data stream of the port: twins of the checkpoint
tests of ``tests/test_train_ckpt.py``, the on-disk format read across the
two packages both ways (bf16 bit-equal), the asynchronous writer's copy
to the host, and ``SyntheticStream`` batches ``==`` the JAX package's for
every family."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JSyntheticStream
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         load_checkpoint, restore_into,
                                         save_checkpoint)
from repro_torch.data.pipeline import DataConfig, SyntheticStream, to_device
from repro_torch.models.sharding import tree_leaves


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a tensor, for a bit-for-bit comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.uint8)


def _tree():
    return {"a": {"w": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
                  "b": torch.arange(5, dtype=torch.int32)},
            "m": torch.zeros((2, 2), dtype=torch.float32)}


def test_checkpoint_roundtrip_bf16():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, tree, extra={"foo": 1})
        step, loaded, extra = load_checkpoint(d)
        assert step == 7 and extra == {"foo": 1}
        live = {"a": {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
                      "b": torch.zeros(5, dtype=torch.int32)},
                "m": torch.ones((2, 2))}
        w = live["a"]["w"]
        restored = restore_into(live, loaded)
        assert restored["a"]["w"] is w                  # the live tensor
        for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_latest():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, {"x": torch.ones(1)}, keep=2)
        assert latest_step(d) == 5
        assert sorted(int(n.split("_")[1]) for n in os.listdir(d)
                      if n.startswith("step_")) == [4, 5]


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ck.save(3, {"x": torch.ones((256, 256))})
        ck.wait()
        assert latest_step(d) == 3


def test_async_checkpointer_copies_before_save_returns():
    """The optimizer updates parameters in place right after a save: what
    is written is the tree as it was when ``save`` returned."""
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        x = torch.full((512, 512), 2.0, dtype=torch.bfloat16)
        ck.save(1, {"x": x}, extra={"step": 1})
        x.mul_(3.0)                                      # the next update
        ck.wait()
        _, loaded, extra = load_checkpoint(d)
        assert extra == {"step": 1}
        assert torch.equal(loaded["x"], torch.full_like(x, 2.0))


def test_restore_into_refuses_another_shape_or_key():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"x": torch.ones(3)})
        _, loaded, _ = load_checkpoint(d)
        with pytest.raises(ValueError, match="shape"):
            restore_into({"x": torch.ones(4)}, loaded)
        with pytest.raises(KeyError):
            restore_into({"y": torch.ones(3)}, loaded)


def _mixed_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                       "n": rng.standard_normal(7).astype(np.float32)},
            "m": {"w": rng.standard_normal((4, 6)).astype(np.float32)},
            "ids": np.arange(9, dtype=np.int32)}


def test_a_reference_checkpoint_reads_in_the_port():
    src = _mixed_np()
    jtree = {"params": jax.tree_util.tree_map(
                 lambda a: jnp.asarray(a, jnp.bfloat16), src["params"]),
             "m": jax.tree_util.tree_map(jnp.asarray, src["m"]),
             "ids": jnp.asarray(src["ids"])}
    with tempfile.TemporaryDirectory() as d:
        j_ckpt.save_checkpoint(d, 5, jtree, extra={"data": {"step": 5}})
        step, loaded, extra = load_checkpoint(d)
    assert step == 5 and extra == {"data": {"step": 5}}
    for k in ("w", "n"):
        got = loaded["params"][k]
        want = np.asarray(jtree["params"][k]).view(np.int16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(loaded["m"]["w"].numpy(), src["m"]["w"])
    assert loaded["ids"].dtype == torch.int32
    np.testing.assert_array_equal(loaded["ids"].numpy(), src["ids"])


def test_a_port_checkpoint_reads_in_the_reference():
    src = _mixed_np(1)
    ttree = {"params": {k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in src["params"].items()},
             "m": {"w": torch.from_numpy(src["m"]["w"])},
             "ids": torch.from_numpy(src["ids"])}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 9, ttree, extra={"step": 9})
        step, loaded, extra = j_ckpt.load_checkpoint(d)
    assert step == 9 and extra == {"step": 9}
    for k in ("w", "n"):
        assert str(loaded["params"][k].dtype) == "bfloat16"
        np.testing.assert_array_equal(loaded["params"][k].view(np.int16),
                                      _bits(ttree["params"][k]))
    np.testing.assert_array_equal(loaded["m"]["w"], src["m"]["w"])
    np.testing.assert_array_equal(loaded["ids"], src["ids"])


FAMILIES = {"dense": {}, "moe": {}, "ssm": {}, "hybrid": {},
            "audio": {"d_model": 8},
            "vlm": {"d_model": 8, "n_vision_tokens": 5},
            "vla": {"n_patches": 6, "vit_dim": 12, "action_dim": 7,
                    "action_horizon": 4}}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_synthetic_stream_equals_the_reference(family):
    kw = dict(vocab_size=97, seq_len=70, global_batch=3, seed=4,
              family=family, **FAMILIES[family])
    ours, ref = SyntheticStream(DataConfig(**kw)), \
        JSyntheticStream(JDataConfig(**kw))
    for i in range(4):
        if i == 2:                                   # a restart replays
            ours.restore({"step": 1})
            ref.restore({"step": 1})
        a, b = ours.next(), ref.next()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.array_equal(a[k], b[k]), (family, k)
        assert ours.state() == ref.state()
    t = to_device(a, "cpu")
    assert all(torch.equal(t[k], torch.from_numpy(np.array(a[k])))
               for k in a)
