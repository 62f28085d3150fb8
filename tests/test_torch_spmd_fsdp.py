"""The ``fsdp`` (ZeRO-3) rules on a data x model mesh of gloo ranks,
float32, against the port on one rank: weights sharded over data and model
together, the batch over every rank, and each region on its rank's batch
rows with the axes the rules keep whole (the vocabulary, the heads, the
experts) whole.  The dense LMs, the MoE LMs and the 6 / 2-head Llama on
2 x 2, Llama and Mamba2 on 1 x 4: the loss and every gradient leaf of one
``loss_and_grads``; greedy decode of Llama and Mamba2 on 2 x 2; a spec
that names a mesh axis twice; and the dry run's ``fsdp`` + ``int8_ring``
train cell on a small fake mesh.  The other families are in
``test_torch_spmd_fsdp_families.py``, the JAX package's own 2 x 4 ``fsdp``
step in ``test_torch_spmd_fsdp_ref.py``.

One spawn of 4 ranks runs every job (``tests/_torch_spmd_util.py``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import _torch_family_cases as FC
import _torch_spmd_util as U
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.sharding import P, placements

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = (FC.UNEVEN, FC.PHI3, FC.COMMAND_R, FC.GLM4, FC.GRANITE, FC.MLA)
ONE_BY_FOUR = (FC.UNEVEN, FC.SSM)
DECODED = (FC.UNEVEN, FC.SSM)


def _jobs():
    jobs = []
    for name, shape in [(n, (2, 2)) for n in NAMES] + \
            [(n, (1, 4)) for n in ONE_BY_FOUR]:
        c = FC.case(name)
        jobs.append((("grad", name, shape),
                     ("family_grad_rank", (shape, name, c["kw"],
                                           c["params_np"], c["batch"], None,
                                           "fsdp"))))
    for name in DECODED:
        c = FC.case(name)
        jobs.append((("decode", name),
                     ("family_decode_rank", ((2, 2), name, c["kw"],
                                             c["params_np"],
                                             FC.decode_batch(name),
                                             FC.DECODE_STEPS, "prefill",
                                             "fsdp"))))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = _jobs()
    out = run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("fsdp")),
                    [j for _, j in jobs])
    return {key: [r[i] for r in out] for i, (key, _) in enumerate(jobs)}


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_equal_one_rank_2x2(ranks, name):
    """The loss within 1e-5 of one rank's and every gradient within 1e-5 of
    its leaf's largest (``FC.assert_grads_match``); the 6 / 2-head Llama
    runs its heads whole, unpadded, on each rank's batch row."""
    for loss, grads, _ in ranks["grad", name, (2, 2)]:
        FC.assert_grads_match(loss, grads, name)


@pytest.mark.parametrize("name", ONE_BY_FOUR)
def test_loss_and_gradients_equal_one_rank_1x4(ranks, name):
    """The same on 1 x 4; Mamba2's SSD scan (B7's plain version) handed
    each rank's one batch row with all its heads."""
    cfg = FC.case(name)["model"].cfg
    seq = FC.case(name)["batch"]["tokens"].shape[1]
    want = [(1, seq, cfg.ssm_nheads, cfg.ssm_headdim)] * cfg.n_layers \
        if cfg.family == "ssm" else []
    for loss, grads, seen in ranks["grad", name, (1, 4)]:
        FC.assert_grads_match(loss, grads, name)
        assert seen == want


@pytest.mark.parametrize("name", DECODED)
def test_greedy_decode_equals_one_rank(ranks, name):
    """Prefill and 8 greedy steps on 2 x 2, each rank its batch row: the
    tokens equal one rank's, the logits within 1e-4 of the largest."""
    for toks, logits, _ in ranks["decode", name]:
        FC.assert_decode_matches(toks, logits, name)


def test_placements_raise_on_a_mesh_axis_named_twice():
    """A spec that names a mesh axis in two tensor dims raises (JAX's
    ``DuplicateSpecError``); ``fsdp``'s weight and batch rules together
    are such a spec."""
    mesh = Mesh((2, 2), ("data", "model"))
    for bad in (P(("data", "model"), None, ("data", "model")),
                P("model", "model"), P(("data", "model"), "data")):
        with pytest.raises(ValueError, match="more than one tensor dim"):
            placements(bad, mesh)
    from torch.distributed.tensor import Replicate, Shard
    assert placements(P(("data", "model"), None), mesh) == (Shard(0),
                                                            Shard(0))
    assert placements(P(None, "model"), mesh) == (Replicate(), Shard(1))


DRYRUN = """
import json
import repro_torch.configs as C
import repro_torch.launch.dryrun as dr
from repro_torch.launch.mesh import Mesh
dr.make_production_mesh = lambda *, multi_pod=False: Mesh((2, 4),
                                                          ("data", "model"))
C.ARCHS["llama3.2-3b"] = C.get_config("llama3.2-3b").reduced()
res = dr._cell("llama3.2-3b", "train_4k", False,
               {"grad_compression": "int8_ring"}, strategy="fsdp")
print(json.dumps(res))
"""


def test_dryrun_fsdp_int8_ring_train_cell():
    """The dry run's train cell with ``strategy="fsdp"`` and
    ``grad_compression="int8_ring"`` on a 2 x 4 fake mesh (a subprocess:
    a process holds one fake group) reaches ``ok``, rank 0 holding the
    parameters' and moments' analytic bytes."""
    out = subprocess.run([sys.executable, "-c", DRYRUN], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "ok", res
    assert res["strategy"] == "fsdp" and res["n_devices"] == 8
    have = res["per_device"]["resident_bytes"]
    want = res["analytic_residency_per_device"]
    assert res["per_device"]["every_sharded_dim_divides"]
    for key in ("params", "adam_moments"):
        assert have[key] == want[key], key
