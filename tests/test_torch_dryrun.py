"""The port's dry run (``repro_torch.launch.dryrun``): one step of a cell
on fake tensors over a fake process group of the mesh's size.

The cells run in one subprocess (a process holds one fake group at a time;
the dry run makes it again at another size); the JAX package's analytic
numbers come from another, since importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ASSIGNED, SHAPES, get_config, get_shape
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build
from repro_torch.models.sharding import make_rules

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")


def _run(code: str, timeout: int = 600) -> dict:
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


CELLS = """
import json
import torch
import repro_torch.configs as C
import repro_torch.launch.dryrun as dr
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build
from repro_torch.models.sharding import tree_map
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import init_state, make_train_step
MESH = {}
dr.make_production_mesh = lambda *, multi_pod=False: MESH[multi_pod]
out = {}
# the twin of tests/test_multidevice.py::test_dryrun_module_entrypoint_tiny
MESH[True] = Mesh((2, 2, 2), ("pod", "data", "model"))
C.ARCHS["mamba2-1.3b"] = C.get_config("mamba2-1.3b").replace(n_layers=2)
out["tiny"] = dr._cell("mamba2-1.3b", "long_500k", True)
# a reduced dense train step on 2 x 4, and the same step with no mesh
MESH[False] = Mesh((2, 4), ("data", "model"))
cfg = C.get_config("llama3.2-3b").reduced()
C.ARCHS["llama3.2-3b"] = cfg
out["train_2x4"] = dr._cell("llama3.2-3b", "train_4k", False)
model = build(cfg)
counter = dr.OpCounter()
with FakeTensorMode(), dr._clip_without_host_read():
    mk = lambda s: torch.empty(s.shape, dtype=s.dtype)
    state = init_state(tree_map(mk, model.param_specs))
    batch = tree_map(mk, model.input_specs(C.get_shape("train_4k")))
    step = make_train_step(model, OptConfig())
    with counter:
        step(state, batch)
out["train_no_mesh_flops"] = counter.global_flops()
# one rank: no wire
MESH[False] = Mesh((1, 1), ("data", "model"))
out["one_rank"] = dr._cell("llama3.2-3b", "train_4k", False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    return _run(CELLS)


def test_dryrun_module_entrypoint_tiny(cells):
    """``mamba2-1.3b`` at 2 layers, ``long_500k``, on the reference test's
    shrunken 2 x 2 x 2 mesh: the cell runs to ``ok``."""
    res = cells["tiny"]
    assert res["status"] == "ok", res
    assert res["n_devices"] == 8
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("cell", ["tiny", "train_2x4"])
def test_rank0_bytes_equal_the_analytic_ones(cells, cell):
    """Rank 0's shards of the parameters (and the ZeRO-1 moments of a train
    step) on the fake mesh hold the bytes ``_sharded_bytes`` gives, where
    every sharded dim divides."""
    res = cells[cell]
    assert res["per_device"]["every_sharded_dim_divides"]
    have = res["per_device"]["resident_bytes"]
    want = res["analytic_residency_per_device"]
    for key in ("params", "adam_moments"):
        if key in want:
            assert have[key] == want[key], key


def test_global_flops_count_the_step_once(cells):
    """The reduced dense train step's ``global.op_flops`` on 2 x 4 equals the
    same step's count with no mesh (region-local counts scaled by the
    ranks that split them), and rank 0's share is an eighth of it."""
    res = cells["train_2x4"]
    want = cells["train_no_mesh_flops"]
    assert want > 0
    assert res["global"]["op_flops"] == pytest.approx(want, rel=1e-6)
    assert res["per_device"]["op_flops"] == pytest.approx(want / 8,
                                                           rel=1e-6)


def test_one_rank_puts_nothing_on_the_wire(cells):
    res = cells["one_rank"]
    assert res["status"] == "ok"
    assert res["collectives"]["total_wire_bytes_per_device"] == 0
    assert res["global"]["op_flops"] == pytest.approx(
        cells["train_no_mesh_flops"], rel=1e-6)


REF_ANALYTIC = """
import json
import repro.launch.dryrun as dr
from repro.configs import ASSIGNED, SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.models import build
from repro.models.sharding import make_rules
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ASSIGNED:
        cfg = get_config(arch)
        model = build(cfg)
        for shape in SHAPES:
            for strategy in ("tp", "fsdp"):
                rules = make_rules(cfg, mesh, shape.kind, strategy=strategy)
                out["|".join((arch, shape.name, str(multi), strategy))] = {
                    "sharded": dr._sharded_bytes(model.param_specs, mesh,
                                                 rules),
                    "residency": dr.analytic_residency(model, cfg, shape,
                                                       mesh, rules),
                    "model_flops": dr.model_flops(cfg, shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_analytic():
    return _run(REF_ANALYTIC)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_numbers_equal_the_references(ref_analytic, arch, multi):
    """``_sharded_bytes``, ``analytic_residency`` and ``model_flops`` equal
    (``==``) the reference's for every shape and both strategies."""
    mesh = make_production_mesh(multi_pod=multi)
    cfg = get_config(arch)
    model = build(cfg)
    for shape in SHAPES:
        for strategy in ("tp", "fsdp"):
            rules = make_rules(cfg, mesh, shape.kind, strategy=strategy)
            want = ref_analytic["|".join((arch, shape.name, str(multi),
                                          strategy))]
            assert dr._sharded_bytes(model.param_specs, mesh, rules) \
                == want["sharded"]
            assert dr.analytic_residency(model, cfg, get_shape(shape.name),
                                         mesh, rules) == want["residency"]
            assert dr.model_flops(cfg, shape) == want["model_flops"]


def _defs(path: str, names) -> dict:
    tree = ast.parse(open(path).read())
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in names}


def test_comm_analysis_copies_are_the_references():
    """``CollectiveOp``, ``_wire_factor`` and ``summarize`` are the
    reference's ``launch/hlo_analysis.py`` code, syntax tree for syntax
    tree."""
    names = ("CollectiveOp", "_wire_factor", "summarize")
    port = _defs(os.path.join(ROOT, "src/repro_torch/launch/"
                                    "comm_analysis.py"), names)
    ref = _defs(os.path.join(ROOT, "src/repro/launch/hlo_analysis.py"),
                names)
    assert set(port) == set(names)
    assert port == ref
