"""The five families' losses on a 2 x 4 mesh, the port's gloo ranks
against the JAX package's own 2 x 4 run (8 fake host devices in one
subprocess, as ``tests/test_torch_spmd.py`` runs its 2 x 4 train step),
float32, from the same parameters, batch and VLA draws, within 1e-5."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_family_cases as FC
import _torch_spmd_util as U
from repro_torch.launch.ranks import run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = (FC.SSM, FC.HYBRID, FC.VLM, FC.ENCDEC, FC.OPENVLA, FC.COGACT)
LOSS_REL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _jax_losses_2x4(tmp) -> dict:
    """Each family's loss from the JAX package's jitted ``loss_fn`` with
    parameters and batch placed on a 2 x 4 mesh by its rules."""
    for i, name in enumerate(NAMES):
        c = FC.case(name)
        np.savez(os.path.join(tmp, f"p{i}.npz"), **_flat(c["params_np"]))
        np.savez(os.path.join(tmp, f"b{i}.npz"), **c["batch"])
    code = f"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_config
from repro.models import build
from repro.models.sharding import make_rules, sharding_tree, use_mesh
tmp = {str(tmp)!r}
mesh = make_mesh((2, 4), ("data", "model"))
out = {{}}
for i, (name, kw) in enumerate({[(n, FC.cfg_kw(n)) for n in NAMES]!r}):
    flat = dict(np.load(os.path.join(tmp, "p%d.npz" % i)))
    def unflat(specs, prefix=""):
        if isinstance(specs, dict):
            return {{k: unflat(v, prefix + k + "/") for k, v in specs.items()}}
        return jnp.asarray(flat[prefix[:-1]], jnp.float32)
    cfg = get_config(name).reduced().replace(**kw)
    model = build(cfg)
    rules = make_rules(cfg, mesh, "train")
    b = dict(np.load(os.path.join(tmp, "b%d.npz" % i)))
    with use_mesh(mesh, rules):
        params = jax.tree_util.tree_map(
            jax.device_put, unflat(model.param_specs),
            sharding_tree(model.param_specs, mesh, rules))
        batch = {{k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, P("data", *([None] * (v.ndim - 1))))) for k, v in b.items()}}
        out[name] = np.float32(jax.jit(model.loss_fn)(
            params, batch, jax.random.PRNGKey(2)))
np.savez(os.path.join(tmp, "losses.npz"), **out)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return {k: float(v) for k, v in
            np.load(os.path.join(tmp, "losses.npz")).items()}


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    jobs = []
    for name in NAMES:
        c = FC.case(name)
        jobs.append(("family_loss_rank", ((2, 4), name, c["kw"],
                                          c["params_np"], c["batch"],
                                          c["inject_np"])))
    ranks = run_ranks(U.jobs_rank, 8, str(tmp_path_factory.mktemp("ref")),
                      jobs)
    ref = _jax_losses_2x4(str(tmp_path_factory.mktemp("jax")))
    return ranks, ref


@pytest.mark.parametrize("name", NAMES)
def test_loss_on_2x4_equals_the_references_2x4(losses, name):
    ranks, ref = losses
    i = NAMES.index(name)
    for r in ranks:
        assert abs(r[i] - ref[name]) <= LOSS_REL * abs(ref[name]), \
            (name, r[i], ref[name])
