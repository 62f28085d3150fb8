"""``repro_torch.core.scene`` is the port's own copy of the reference's
scene-dynamics simulator: traces and matrices ``np.array_equal`` to
``repro.core.scene``'s on every named scene, seeds and lengths."""
import dataclasses

import numpy as np
import pytest

from repro.core import scene as j_scene
from repro_torch import core
from repro_torch.core import scene

CFGS = {**{name: name for name in j_scene.SCENES},
        "default": None,
        "no_ar": scene.SceneConfig(ar_rho=0.0, event_prob=0.3),
        "ceiling": scene.SceneConfig(mean_frac=0.6, ar_sigma=0.9,
                                     ceil_frac=0.7)}


def _both(cfg):
    """The same config as each package's own ``SceneConfig``."""
    if cfg is None or isinstance(cfg, str):
        return (scene.scene_config(cfg) if cfg else None,
                j_scene.scene_config(cfg) if cfg else None)
    return cfg, j_scene.SceneConfig(**dataclasses.asdict(cfg))


def test_named_scenes_equal_the_reference():
    assert set(scene.SCENES) == set(j_scene.SCENES)
    for name, c in scene.SCENES.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(
            j_scene.SCENES[name])
    assert dataclasses.asdict(scene.SceneConfig()) == dataclasses.asdict(
        j_scene.SceneConfig())
    assert core.SCENES is scene.SCENES
    assert core.generate_scene_trace is scene.generate_scene_trace


@pytest.mark.parametrize("name", sorted(CFGS))
def test_traces_and_matrices_equal_the_reference(name):
    c_t, c_j = _both(CFGS[name])
    for n in (0, 1, 24, 700):
        for seed in (0, 3, 12345):
            assert np.array_equal(scene.generate_scene_trace(n, c_t, seed),
                                  j_scene.generate_scene_trace(n, c_j, seed))
        seeds = [7, 0, 59_999_999 + 4, 2**31 - 1]
        a = scene.generate_scene_matrix(n, c_t, seeds)
        b = j_scene.generate_scene_matrix(n, c_j, seeds)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert scene.generate_scene_matrix(5, c_t, []).shape == (0, 5)


def test_matrix_blocks_equal_the_reference(monkeypatch):
    """More rows than one block of the matrix loop (the block size cut
    down on both sides)."""
    from repro.core import network as j_network
    from repro_torch.core import network
    monkeypatch.setattr(scene, "_MATRIX_BLOCK_ROWS", 3)
    monkeypatch.setattr(j_scene, "_MATRIX_BLOCK_ROWS", 3)
    assert network._MATRIX_BLOCK_ROWS == j_network._MATRIX_BLOCK_ROWS
    seeds = list(range(10))
    c_t, c_j = _both("slow")
    assert np.array_equal(scene.generate_scene_matrix(50, c_t, seeds),
                          j_scene.generate_scene_matrix(50, c_j, seeds))


def test_scene_config_resolution_matches_the_reference():
    c = scene.SceneConfig(mean_frac=0.3)
    assert scene.scene_config(c) is c
    with pytest.raises(KeyError, match="unknown scene"):
        scene.scene_config("nope")
    with pytest.raises(KeyError, match="unknown scene"):
        j_scene.scene_config("nope")
