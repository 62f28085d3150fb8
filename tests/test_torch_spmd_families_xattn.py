"""The VLM (llama-3.2-vision-11b), the encoder-decoder
(seamless-m4t-large-v2) and the VLA (openvla-7b's detok head, cogact-7b's
DiT) on a data x model mesh of gloo ranks, float32, against the port on one
rank: the loss and every gradient leaf of one ``loss_and_grads`` on
2 x 2, 1 x 4 and 4 x 1 (cross, non-causal and causal attention on each
rank's heads); greedy tokens and logits over 8 steps with ``model`` 2 and
4 for the VLM and the encoder-decoder (a VLA serves whole requests).

One spawn of 4 ranks runs every job (``tests/_torch_spmd_util.py``)."""
from __future__ import annotations

import pytest

import _torch_family_cases as FC
import _torch_spmd_util as U
from repro_torch.launch.ranks import run_ranks

NAMES = (FC.VLM, FC.ENCDEC, FC.OPENVLA, FC.COGACT)
SERVED = (FC.VLM, FC.ENCDEC)
DECODE_MESHES = ((2, 2), (1, 4))      # model 2 and model 4


def _jobs():
    jobs = []
    for name in NAMES:
        c = FC.case(name)
        for shape in FC.MESHES:
            jobs.append((("grad", name, shape),
                         ("family_grad_rank", (shape, name, c["kw"],
                                               c["params_np"], c["batch"],
                                               c["inject_np"]))))
    for name in SERVED:
        c = FC.case(name)
        for shape in DECODE_MESHES:
            jobs.append((("decode", name, shape),
                         ("family_decode_rank", (shape, name, c["kw"],
                                                 c["params_np"],
                                                 FC.decode_batch(name),
                                                 FC.DECODE_STEPS))))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = _jobs()
    out = run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("famx")),
                    [j for _, j in jobs])
    return {key: [r[i] for r in out] for i, (key, _) in enumerate(jobs)}


@pytest.mark.parametrize("shape", FC.MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_equal_one_rank(ranks, name, shape):
    for loss, grads, seen in ranks["grad", name, shape]:
        FC.assert_grads_match(loss, grads, name)
        assert seen == []


@pytest.mark.parametrize("shape", DECODE_MESHES,
                         ids=lambda s: "model%d" % s[1])
@pytest.mark.parametrize("name", SERVED)
def test_greedy_decode_equals_one_rank(ranks, name, shape):
    for toks, logits, _ in ranks["decode", name, shape]:
        FC.assert_decode_matches(toks, logits, name)
