"""The port's mesh and sharding rules against the JAX package's.

``make_rules``, ``resolve`` over every parameter of every config,
``spec_bytes``, ``opt_state_specs`` and ``zero_rules`` must be ``==`` to
the reference's for all twelve configs, on the production, multi-pod,
host and 2x4 meshes, every shape kind and both strategies.  The reference
gets a stand-in mesh (``axis_names`` and ``devices``, all that
``make_rules`` and ``opt_state_specs`` read); the port its own unbound
``Mesh``.  No process group is needed for any of it."""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.models import sharding as j_sh
from repro.train import optimizer as j_opt
from repro_torch.configs import get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.models import build
from repro_torch.models import sharding as sh
from repro_torch.train import optimizer as opt

MESHES = {
    "production": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "host": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
}
KINDS = ("train", "prefill", "decode", "long_decode")
STRATEGIES = ("tp", "fsdp")


def _stand_in(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _port_mesh(shape, names):
    return pmesh.Mesh(shape, names)


def _leaves(tree, is_leaf):
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k in sorted(tree)
                for p, v in _leaves(tree[k], is_leaf)]
    return [("", tree)]


def _dt(d) -> str:
    return str(d).split(".")[-1].rstrip("'>")


def test_production_and_host_meshes():
    prod, multi = (pmesh.make_production_mesh(),
                   pmesh.make_production_mesh(multi_pod=True))
    assert (prod.axis_names, prod.devices.shape) == (("data", "model"),
                                                     (16, 16))
    assert (multi.axis_names, multi.devices.shape) == (
        ("pod", "data", "model"), (2, 16, 16))
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    host = pmesh.make_host_mesh()
    assert (host.axis_names, host.devices.shape) == (("data", "model"),
                                                     (1, 1))
    assert not (prod.bound or host.bound) and host.local_rank("model") == 0


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh((2, 4), ("data", "model"), device="cpu")


def test_placements_map_specs_mesh_dim_by_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    m = _port_mesh((2, 2, 4), ("pod", "data", "model"))
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.P(None, ("data", "model")), m) == (
        Replicate(), Shard(1), Shard(1))
    assert sh.placements(sh.P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.P(("model", "data")), m)
    assert sh.P(("data",), None) == sh.P("data", None) == ("data", None)


def test_shard_is_identity_off_a_bound_mesh():
    x = torch.ones(2, 3)
    assert sh.shard(x, "batch", None) is x
    m = _port_mesh((2, 4), ("data", "model"))
    with sh.use_mesh(m, sh.make_rules(None, m)):
        assert sh.current_mesh() is m and sh.bound_mesh() is None
        assert sh.axis_size("model") == 4 and sh.axis_size("pod") == 1
        assert sh.shard(x, "batch", None) is x
    assert sh.current_mesh() is None


def test_the_mesh_context_follows_a_layer_into_another_thread():
    """Autograd recomputes a checkpointed layer in its own thread (on the
    card), where the thread-local context is empty: ``in_current_mesh``
    carries it along."""
    import threading
    m = _port_mesh((2, 4), ("data", "model"))
    rules = sh.make_rules(None, m)
    seen = {}
    with sh.use_mesh(m, rules):
        carried = sh.in_current_mesh(lambda: (sh.current_mesh(),
                                              sh.rule_flag("batch")))
    plain = sh.in_current_mesh(sh.current_mesh)        # off a mesh: as is
    for name, fn in (("carried", carried), ("plain", plain),
                     ("bare", sh.current_mesh)):
        t = threading.Thread(target=lambda n=name, f=fn: seen.update({n: f()}))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen["carried"] == (m, ("data",))
    assert seen["plain"] is None and seen["bare"] is None
    assert sh.current_mesh() is None


def test_shape_and_sharding_trees():
    cfg = get_config("llama3.2-3b")
    specs = build(cfg).param_specs
    shapes = sh.shape_tree(specs)
    wq = shapes["blocks"]["attn"]["wq"]
    assert wq.device.type == "meta" and wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == specs["blocks"]["attn"]["wq"].shape
    m = _port_mesh((2, 4), ("data", "model"))
    pl = sh.sharding_tree(specs, m, sh.make_rules(cfg, m))
    from torch.distributed.tensor import Replicate, Shard
    assert pl["blocks"]["attn"]["wq"] == (Replicate(), Shard(2))
    assert pl["embed"] == (Replicate(), Shard(0))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rules_resolve_and_zero_specs_equal_the_reference(arch, strategy):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jspecs, specs = j_build(jcfg).param_specs, build(cfg).param_specs
    jl = _leaves(jspecs, j_sh.is_spec)
    pl = _leaves(specs, sh.is_spec)
    assert [p for p, _ in jl] == [p for p, _ in pl]
    assert sh.spec_bytes(specs) == j_sh.spec_bytes(jspecs)
    for mname, (shape, names) in MESHES.items():
        jm, m = _stand_in(shape, names), _port_mesh(shape, names)
        for kind in KINDS:
            rules = sh.make_rules(cfg, m, kind, strategy)
            jrules = j_sh.make_rules(jcfg, jm, kind, strategy)
            assert rules == jrules, (mname, kind)
            for (path, js), (_, ps) in zip(jl, pl):
                assert ps.shape == js.shape and ps.axes == js.axes, path
                assert sh.resolve(ps.axes, rules) == \
                    j_sh.resolve(js.axes, jrules), (mname, kind, path)
            zr, jzr = opt.zero_rules(rules, m), j_opt.zero_rules(jrules, jm)
            assert zr == jzr, (mname, kind)
        # ZeRO-1 moments (train rules, as the dry run builds them)
        rules = sh.make_rules(cfg, m, "train", strategy)
        jrules = j_sh.make_rules(jcfg, jm, "train", strategy)
        for zero1 in (True, False):
            os_ = _leaves(opt.opt_state_specs(specs, m, rules, zero1),
                          sh.is_spec)
            jos = _leaves(j_opt.opt_state_specs(jspecs, jm, jrules, zero1),
                          j_sh.is_spec)
            for (path, js), (_, ps) in zip(jos, os_):
                assert (ps.shape, ps.axes, _dt(ps.dtype), ps.init) == \
                    (js.shape, js.axes, _dt(js.dtype), js.init), \
                    (mname, zero1, path)
            zrules, jzrules = opt.zero_rules(rules, m), \
                j_opt.zero_rules(jrules, jm)
            for (path, js), (_, ps) in zip(jos, os_):
                assert sh.resolve(ps.axes, zrules) == \
                    j_sh.resolve(js.axes, jzrules), (mname, path)
            assert sh.spec_bytes(opt.opt_state_specs(specs, m, rules,
                                                     zero1)) == \
                j_sh.spec_bytes(j_opt.opt_state_specs(jspecs, jm, jrules,
                                                      zero1))


def test_rules_without_a_mesh_equal_the_reference():
    cfg, jcfg = get_config("llama3.2-3b"), j_get_config("llama3.2-3b")
    for kind in KINDS:
        assert sh.make_rules(cfg, None, kind) == \
            j_sh.make_rules(jcfg, None, kind)
    assert opt.opt_state_specs(build(cfg).param_specs)["embed"].axes == \
        ("vocab", "d_model")
