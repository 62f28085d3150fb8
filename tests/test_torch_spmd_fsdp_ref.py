"""The port's 2 x 4 ``fsdp`` (ZeRO-3) train step against the JAX package's
own on a 2 x 4 mesh of fake devices (``test_torch_spmd._jax_train_2x4``
with ``strategy="fsdp"``, the batch placed as those rules place it, each
run in a subprocess), float32, one step from the JAX package's initial
tree on a batch of 8 rows: without compression at the tolerances of
``test_sharded_train_step_2x4_equals_the_references_2x4``, and with
``grad_compression="int8_ring"`` within the ring's bound; each leaf's
change against the reference's.  Then three steps at lr 1e-3 from the
first, with and without the ring, against the port's on one rank.

One spawn of 8 gloo ranks runs the port's jobs
(``tests/_torch_spmd_util.py``)."""
from __future__ import annotations

import numpy as np
import pytest

import _torch_spmd_util as U
from repro_torch.data.pipeline import to_device
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import init_state, make_train_step
from test_torch_spmd import TRAIN_KW, _flat_np, _jax_init_np, _jax_train_2x4

LR0 = 1e-3 / 100                       # the default warm-up's step 0


def _batch() -> dict:
    """8 rows: one for each of the 8 ranks the ``fsdp`` batch shards over."""
    cfg = U.small_cfg("llama3.2-3b", **TRAIN_KW)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 16))
    toks = toks.astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch, init = _batch(), _jax_init_np()
    f32 = dict(TRAIN_KW, dtype="float32", remat=True)
    # one step at the default warm-up, as the JAX package's; then three at
    # the full lr from the first step, so that the moments that ZeRO-3
    # shards over data and model take part
    jobs = [("train_rank", ((2, 4), "llama3.2-3b", f32, init, batch, steps,
                            compression, 1e-3, True, warmup, "fsdp"))
            for steps, warmup in ((1, 100), (3, 1))
            for compression in (None, "int8_ring")]
    jobs.append(("sync_rank", ((2, 4), "llama3.2-3b", f32, init, batch,
                               "fsdp")))
    ranks = run_ranks(U.jobs_rank, 8,
                      str(tmp_path_factory.mktemp("fsdp_ref") / "ranks"),
                      jobs)
    ref = {c: _jax_train_2x4(init, batch,
                             str(tmp_path_factory.mktemp("jax")),
                             strategy="fsdp", compression=c)
           for c in (None, "int8_ring")}
    # the port's three steps on one rank, without compression
    model = build(U.small_cfg("llama3.2-3b", **f32))
    state = init_state(U._params(model, init, True))
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1))
    losses = []
    for _ in range(3):
        state, m = step(state, to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    return ranks, ref, (init, losses, state.params)


def _params_within(params, ref, tol):
    flat = _flat_np(tree_map(lambda t: t.numpy(), params))
    assert set(flat) == {k[2:] for k in ref if k.startswith("p:")}
    for name, got in flat.items():
        assert float(np.abs(got - ref["p:" + name]).max()) <= tol, name


def test_fsdp_train_step_2x4_equals_the_references_2x4(runs):
    """The loss and the gradient norm within 1e-5, each parameter within
    2 lr of the reference's, on every rank."""
    ranks, ref, _ = runs
    want = ref[None]
    for r in ranks:
        losses, norms, params = r[0]
        assert losses[0] == pytest.approx(float(want["loss"]), rel=1e-5)
        assert norms[0] == pytest.approx(float(want["grad_norm"]), rel=1e-5)
        _params_within(params, want, 2 * LR0)


def test_fsdp_int8_ring_train_step_2x4_within_the_rings_bound(runs):
    """With ``grad_compression="int8_ring"`` on both sides (the port rings
    each gradient still pending over data, the JAX package every gradient
    gathered whole): the loss within 1e-5 (the ring runs after it); the
    gradient norms within twice the ring's norm bound, sqrt(sum over
    leaves of n x bound^2) with the port's per-leaf bounds (``sync_rank``:
    2(N-1) x 0.5/127 x the data ranks' abs-max sum, which bounds the JAX
    package's ring on the averaged gradient too), of each other; each
    parameter within 2 lr of the reference's."""
    ranks, ref, _ = runs
    want = ref["int8_ring"]
    _, exact, bounds, _ = ranks[0][4]
    norm_bound = sum(g.numel() * b * b for g, b in
                     zip(tree_leaves(exact), bounds)) ** 0.5
    assert norm_bound < 0.1 * float(want["grad_norm"])
    for r in ranks:
        losses, norms, params = r[1]
        assert losses[0] == pytest.approx(float(want["loss"]), rel=1e-5)
        assert abs(norms[0] - float(want["grad_norm"])) <= 2 * norm_bound
        _params_within(params, want, 2 * LR0)



def _changes_off(params, ref: dict, p0: dict) -> dict:
    """By leaf, |(p - p0) - (p_ref - p0)| / |p_ref - p0| over its elements
    (``ref`` by flat name): a parameter left as it was is 1 off, one moved
    the wrong way 2."""
    flat, p0 = _flat_np(tree_map(lambda t: t.numpy(), params)), _flat_np(p0)
    assert set(flat) == set(ref)
    return {k: float(np.linalg.norm((got - ref[k]).astype(np.float64))
                     / np.linalg.norm((ref[k] - p0[k]).astype(np.float64)))
            for k, got in flat.items()}


def test_fsdp_train_step_2x4_changes_each_parameter_as_the_reference(runs):
    """Each leaf's change p1 - p0, on every rank, against the JAX
    package's uncompressed 2 x 4 ``fsdp`` step's, in norm over the leaf:
    within 1e-3 without compression (1.1e-4 measured); with the int8 ring
    within 0.5 (0.17 measured): its noise flips AdamW's first, sign-like
    step of the elements whose gradient lies within that noise."""
    ranks, ref, (p0, _, _) = runs
    want = {k[2:]: v for k, v in ref[None].items() if k.startswith("p:")}
    for r in ranks:
        for i, limit in ((0, 1e-3), (1, 0.5)):
            off = _changes_off(r[i][2], want, p0)
            assert max(off.values()) <= limit, (i, off)


def test_fsdp_three_steps_2x4_equal_one_rank(runs):
    """Three steps at lr 1e-3 from the first (the moments, sharded as their
    parameters over data and model, in the second and third): the losses
    within 1e-5 relative of the port's on one rank, and each leaf's change
    within 1e-3 of one rank's (9e-6 measured), on every rank."""
    ranks, _, (p0, losses, params) = runs
    want = _flat_np(tree_map(lambda t: t.detach().numpy(), params))
    for r in ranks:
        np.testing.assert_allclose(r[2][0], losses, rtol=1e-5)
        off = _changes_off(r[2][2], want, p0)
        assert max(off.values()) <= 1e-3, off


def test_fsdp_int8_ring_three_steps_2x4_against_one_rank(runs):
    """The same three steps with ``grad_compression="int8_ring"``: the
    first loss within 1e-5 relative (before any update), each later loss's
    change from the first within 1 % of one rank's, and each leaf's change
    within 0.5 of one rank's (the ring's noise, as above; 0.07 measured),
    on every rank."""
    ranks, _, (p0, losses, params) = runs
    want = _flat_np(tree_map(lambda t: t.detach().numpy(), params))
    for r in ranks:
        got = r[3][0]
        assert got[0] == pytest.approx(losses[0], rel=1e-5)
        for k in (1, 2):
            d = losses[k] - losses[0]
            assert abs(got[k] - got[0] - d) <= 1e-2 * abs(d), k
        off = _changes_off(r[3][2], want, p0)
        assert max(off.values()) <= 0.5, off
