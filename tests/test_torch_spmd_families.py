"""The SSM (Mamba2) and hybrid (Zamba2) families on a data x model mesh of
gloo ranks, float32, against the port on one rank: the loss and every
gradient leaf of one ``loss_and_grads`` on 2 x 2, 1 x 4 and 4 x 1; greedy
tokens and logits over 8 steps with ``model`` 2 and 4; the SSD scan (B7's
plain version on the CPU) reached inside the region on each rank's heads.

One spawn of 4 ranks runs every job (``tests/_torch_spmd_util.py``), the
meshes made in turn on the same group."""
from __future__ import annotations

import pytest

import _torch_family_cases as FC
import _torch_spmd_util as U
from repro_torch.launch.ranks import run_ranks

NAMES = (FC.SSM, FC.HYBRID)
DECODE_MESHES = ((2, 2), (1, 4))      # model 2 and model 4


def _jobs():
    jobs = []
    for name in NAMES:
        c = FC.case(name)
        for shape in FC.MESHES:
            jobs.append((("grad", name, shape),
                         ("family_grad_rank", (shape, name, c["kw"],
                                               c["params_np"], c["batch"]))))
        for shape in DECODE_MESHES:
            jobs.append((("decode", name, shape),
                         ("family_decode_rank", (shape, name, c["kw"],
                                                 c["params_np"],
                                                 FC.decode_batch(name),
                                                 FC.DECODE_STEPS))))
    c = FC.case(FC.UNEVEN)
    jobs.append((("grad", FC.UNEVEN, (1, 4)),
                 ("family_grad_rank", ((1, 4), FC.UNEVEN, c["kw"],
                                       c["params_np"], c["batch"]))))
    jobs.append((("decode", FC.UNEVEN, (1, 4)),
                 ("family_decode_rank", ((1, 4), FC.UNEVEN, c["kw"],
                                         c["params_np"],
                                         FC.decode_batch(FC.UNEVEN),
                                         FC.DECODE_STEPS))))
    c = FC.case(FC.MLA)
    for key, fn, args in (("grad", "family_grad_rank", (c["batch"],)),
                          ("decode", "family_decode_rank",
                           (FC.decode_batch(FC.MLA), FC.DECODE_STEPS))):
        jobs.append(((key, FC.MLA, (2, 2)),
                     (fn, ((2, 2), FC.MLA, c["kw"], c["params_np"],
                           *args))))
    c = FC.case(FC.SSM)
    jobs.append((("zero1",), ("zero1_rank", ((2, 2), FC.SSM, c["kw"],
                                             c["params_np"], c["batch"],
                                             2))))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = _jobs()
    out = run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("fam")),
                    [j for _, j in jobs])
    return {key: [r[i] for r in out] for i, (key, _) in enumerate(jobs)}


def _heads_seen(cfg, shape, seq, n):
    """What B7 is handed n times on each rank of ``shape``: its local batch
    and heads."""
    data, model = shape
    return [(FC.BATCH // data, seq, cfg.ssm_nheads // model,
             cfg.ssm_headdim)] * n


@pytest.mark.parametrize("shape", FC.MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_equal_one_rank(ranks, name, shape):
    for loss, grads, _ in ranks["grad", name, shape]:
        FC.assert_grads_match(loss, grads, name)


@pytest.mark.parametrize("shape", FC.MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("name", NAMES)
def test_the_ssd_scan_runs_on_each_ranks_heads(ranks, name, shape):
    cfg = FC.case(name)["model"].cfg
    seq = FC.case(name)["batch"]["tokens"].shape[1]
    for _, _, seen in ranks["grad", name, shape]:
        assert seen == _heads_seen(cfg, shape, seq, cfg.n_layers)


@pytest.mark.parametrize("shape", DECODE_MESHES,
                         ids=lambda s: "model%d" % s[1])
@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_equals_one_rank(ranks, name, shape):
    cfg = FC.case(name)["model"].cfg
    for toks, logits, seen in ranks["decode", name, shape]:
        FC.assert_decode_matches(toks, logits, name)
        assert seen == _heads_seen(cfg, shape, FC.DECODE_PROMPT,
                                   cfg.n_layers)


def test_zero1_moments_give_the_same_steps(ranks):
    """Moments placed by the ZeRO-1 specs (``opt_state_specs`` under
    ``zero_rules``, sharded over data as the dry run places them): each
    rank updates its part of a parameter and the parts are gathered, and
    two steps give the losses, norms and parameters of moments placed as
    the parameters, bit for bit."""
    import torch
    from repro_torch.models.sharding import tree_leaves
    for plain, zero1 in ranks["zero1",]:
        assert zero1[3] > 0 and plain[3] == 0
        assert zero1[0] == plain[0] and zero1[1] == plain[1]
        for a, b in zip(tree_leaves(zero1[2]), tree_leaves(plain[2])):
            assert torch.equal(a, b)


def test_heads_model_does_not_divide(ranks):
    """Six query heads and two K/V heads over model 4 (as Llama-3.2-3B's 24
    over a 16-wide axis): the heads padded to 8, two a rank, each rank
    handed the K/V heads its own read; the loss, every gradient, and greedy
    decode equal one rank's."""
    for loss, grads, _ in ranks["grad", FC.UNEVEN, (1, 4)]:
        FC.assert_grads_match(loss, grads, FC.UNEVEN)
    for toks, logits, _ in ranks["decode", FC.UNEVEN, (1, 4)]:
        FC.assert_decode_matches(toks, logits, FC.UNEVEN)


def test_mla_on_local_heads(ranks):
    """deepseek-v2-lite-16b's MLA on 2 x 2: its causal prefill through B5's
    path on each rank's heads (not DTensors handed to the kernel), the
    absorbed decode on DTensors; the loss, every gradient and greedy decode
    equal one rank's (capacity factor 8: no choice dropped)."""
    for loss, grads, _ in ranks["grad", FC.MLA, (2, 2)]:
        FC.assert_grads_match(loss, grads, FC.MLA)
    for toks, logits, _ in ranks["decode", FC.MLA, (2, 2)]:
        FC.assert_decode_matches(toks, logits, FC.MLA)
