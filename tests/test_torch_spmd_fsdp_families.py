"""The SSM, hybrid, VLM, encoder-decoder and VLA families under the
``fsdp`` (ZeRO-3) rules on a 2 x 2 mesh of gloo ranks, float32, against
the port on one rank: the loss and every gradient leaf of one
``loss_and_grads``; the SSD scan (B7's plain version on the CPU) handed
each rank's batch row with all its heads.

One spawn of 4 ranks runs every job (``tests/_torch_spmd_util.py``)."""
from __future__ import annotations

import pytest

import _torch_family_cases as FC
import _torch_spmd_util as U
from repro_torch.launch.ranks import run_ranks

NAMES = (FC.SSM, FC.HYBRID, FC.VLM, FC.ENCDEC, FC.OPENVLA, FC.COGACT)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = []
    for name in NAMES:
        c = FC.case(name)
        jobs.append(("family_grad_rank", ((2, 2), name, c["kw"],
                                          c["params_np"], c["batch"],
                                          c["inject_np"], "fsdp")))
    out = run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("fsdpf")),
                    jobs)
    return {name: [r[i] for r in out] for i, name in enumerate(NAMES)}


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_equal_one_rank_2x2(ranks, name):
    cfg = FC.case(name)["model"].cfg
    seq = FC.case(name)["batch"]["tokens"].shape[1]
    want = [(1, seq, cfg.ssm_nheads, cfg.ssm_headdim)] * cfg.n_layers \
        if cfg.family == "ssm" else None
    for loss, grads, seen in ranks[name]:
        FC.assert_grads_match(loss, grads, name)
        if want is not None:
            assert seen == want
        elif cfg.family == "hybrid":
            assert seen and all(s[0] == 1 and s[2] == cfg.ssm_nheads
                                for s in seen)
        else:
            assert seen == []
