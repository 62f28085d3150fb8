"""The port's SPMD layer on gloo ranks: the int8 ring and the sharded train
step (twins of ``tests/test_multidevice.py``'s ring and 2x4 train tests).

Ranks are spawned processes on the CPU (``repro_torch.launch.ranks``),
their process group initialised through a ``file://`` store under the
test's temporary directory; the JAX package's ring runs on 8 fake devices
in a subprocess, as ``tests/test_multidevice.py`` runs it.  Each module
fixture spawns its ranks once and several tests read what they gave."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_spmd_util as U
from repro_torch.data.pipeline import to_device
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build
from repro_torch.models.sharding import init_params, tree_leaves, tree_map
from repro_torch.train.compression import (_chunks, ring_allreduce_int8,
                                           ring_allreduce_int8_plain)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import (_compressed_sync, init_state,
                                          loss_and_grads, make_train_step)

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 8


def _ring_inputs():
    rng = np.random.default_rng(0)
    full = np.stack([np.full((33,), float(i + 1), np.float32)
                     for i in range(N)])                  # the reference's
    rand = rng.standard_normal((N, 37)).astype(np.float32)   # 37 % 8 != 0
    wide = rng.standard_normal((N, 3, 40)).astype(np.float32) * \
        np.logspace(-3, 2, N, dtype=np.float32)[:, None, None]
    return {"full": full, "rand": rand, "wide": wide}


def _jax_ring(xs: dict, tmp) -> dict:
    """The JAX package's ring on 8 fake devices: each device's output."""
    for k, v in xs.items():
        np.save(os.path.join(tmp, f"{k}.npy"), v)
    code = f"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.train.compression import ring_allreduce_int8
mesh = make_mesh((8,), ("data",))
for k in {list(xs)!r}:
    x = np.load(os.path.join({str(tmp)!r}, k + ".npy"))
    f = shard_map(lambda a: ring_allreduce_int8(a[0], "data")[None],
                  mesh=mesh, in_specs=(P("data"),), out_specs=P("data"))
    np.save(os.path.join({str(tmp)!r}, k + "_out.npy"),
            np.asarray(jax.jit(f)(jnp.asarray(x))))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {k: np.load(os.path.join(tmp, f"{k}_out.npy")) for k in xs}


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    xs = _ring_inputs()
    tmp = tmp_path_factory.mktemp("ring")
    ranks = run_ranks(U.jobs_rank, N, str(tmp / "ranks"),
                      [("ring_rank", ((N,), ("data",), "data", xs[k]))
                       for k in xs])
    return xs, ranks, _jax_ring(xs, str(tmp))


def test_ring_equals_the_reference_eight_devices(ring_run):
    xs, ranks, ref = ring_run
    for j, k in enumerate(xs):
        got = np.stack([ranks[r][j][0] for r in range(N)])
        np.testing.assert_allclose(got, ref[k], rtol=0, atol=1e-6 * float(
            np.abs(ref[k]).max()), err_msg=k)


def test_ring_within_its_bound_of_the_exact_sum(ring_run):
    xs, ranks, _ = ring_run
    got = np.stack([ranks[r][0][0] for r in range(N)])
    assert float(np.abs(got - float(sum(range(1, N + 1)))).max()) < 0.25
    for j, k in enumerate(xs):
        exact = xs[k].astype(np.float64).sum(0)
        got = np.stack([ranks[r][j][0] for r in range(N)])
        # 2(N-1) requantisations of chunks whose abs-max is at most the
        # sum of the ranks' abs-maxima: each within half a step of 1/127
        bound = 2 * (N - 1) * 0.5 / 127 * float(np.abs(xs[k]).max(
            axis=tuple(range(1, xs[k].ndim))).sum())
        assert float(np.abs(got - exact).max()) <= bound, k


def test_plain_ring_equals_the_ranks(ring_run):
    xs, ranks, _ = ring_run
    for j, k in enumerate(xs):
        plain = ring_allreduce_int8_plain(torch.from_numpy(xs[k])).numpy()
        got = np.stack([ranks[r][j][0] for r in range(N)])
        np.testing.assert_array_equal(got, plain, err_msg=k)


def test_ring_wire_counts(ring_run):
    xs, ranks, _ = ring_run
    # per rank: 2(N-1) hops of one int8 chunk and one float32 scale each
    per = [2 * (N - 1) * (_chunks(torch.from_numpy(xs[k][0]), N)[0].shape[1]
                          + 4) for k in xs]
    for r in range(N):
        wire = ranks[r][-1][1]
        assert wire["hops"] == 2 * (N - 1) * len(xs)
        assert wire["bytes"] == sum(per) and wire["host_bytes"] == 0


def test_ring_and_sync_off_a_mesh_return_their_input():
    x = torch.arange(6.0)
    assert ring_allreduce_int8(x, "data") is x
    g = {"w": torch.ones(3)}
    assert _compressed_sync(g, g) is g
    assert torch.equal(ring_allreduce_int8_plain(x[None])[0], x)


# ------------------------------------------------------------ train step
TRAIN_KW = dict(n_layers=2)


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _jax_train_2x4(params_np: dict, batch: dict, tmp, strategy: str = "tp",
                   compression=None) -> dict:
    """The JAX package's train step on a 2x4 mesh of fake devices (as
    ``tests/test_multidevice.py`` runs it), float32, one step under the
    rules of ``strategy`` with ``grad_compression=compression``, the batch
    placed as those rules place it: its loss, gradient norm and parameters
    by flat name."""
    np.savez(os.path.join(tmp, "params.npz"), **_flat_np(params_np))
    np.savez(os.path.join(tmp, "batch.npz"), **batch)
    code = f"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_config
from repro.models import build
from repro.models.sharding import make_rules, resolve, sharding_tree, use_mesh
from repro.train.optimizer import OptConfig
from repro.train.train_loop import init_state, make_train_step
tmp = {str(tmp)!r}
flat = dict(np.load(os.path.join(tmp, "params.npz")))
def unflat(specs, prefix=""):
    if isinstance(specs, dict):
        return {{k: unflat(v, prefix + k + "/") for k, v in specs.items()}}
    return jnp.asarray(flat[prefix[:-1]], jnp.float32)
mesh = make_mesh((2, 4), ("data", "model"))
cfg = get_config("llama3.2-3b").reduced().replace(n_layers=2, dtype="float32")
model = build(cfg)
rules = make_rules(cfg, mesh, "train", strategy={strategy!r})
b = dict(np.load(os.path.join(tmp, "batch.npz")))
with use_mesh(mesh, rules):
    params = unflat(model.param_specs)
    params = jax.tree_util.tree_map(jax.device_put, params,
                                    sharding_tree(model.param_specs, mesh, rules))
    step = jax.jit(make_train_step(model, OptConfig(lr=1e-3),
                                   grad_compression={compression!r}))
    spec = resolve(("batch", None))
    batch = {{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
             for k, v in b.items()}}
    state, m = step(init_state(params), batch, jax.random.PRNGKey(0))
out = {{"loss": np.float32(m["loss"]), "grad_norm": np.float32(m["grad_norm"])}}
def walk(t, prefix=""):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, prefix + k + "/")
    else:
        out["p:" + prefix[:-1]] = np.asarray(t, np.float32)
walk(state.params)
np.savez(os.path.join(tmp, "out.npz"), **out)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(os.path.join(tmp, "out.npz")))


def _train_inputs():
    cfg = U.small_cfg("llama3.2-3b", **TRAIN_KW)
    model = build(cfg)
    p = init_params(model.param_specs, torch.Generator().manual_seed(0),
                    "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return model, p, tree_map(lambda t: t.float().numpy(), p), batch


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    model, p, pnp, batch = _train_inputs()
    # remat on: each layer is recomputed in the backward under the mesh
    f32 = dict(TRAIN_KW, dtype="float32", remat=True)
    jobs = [("train_rank", ((2, 4), "llama3.2-3b", f32, pnp, batch, 3, None,
                            1e-3, True)),
            ("train_rank", ((2, 4), "llama3.2-3b", TRAIN_KW, pnp, batch, 5,
                            None, 1e-3, False)),
            # the int8 ring at the full lr from the first step, so that the
            # parameters move by ~lr an element and a wrong update shows
            ("train_rank", ((2, 4), "llama3.2-3b", f32, pnp, batch, 3,
                            "int8_ring", 1e-3, True, 1)),
            # the JAX package's own initial tree, for its 2x4 step
            ("train_rank", ((2, 4), "llama3.2-3b", f32, _jax_init_np(),
                            batch, 1, None, 1e-3, True)),
            ("sync_rank", ((2, 4), "llama3.2-3b", f32, pnp, batch)),
            ("fsdp_sync_rank", ((2, 4),))]
    ranks = run_ranks(U.jobs_rank, 8,
                      str(tmp_path_factory.mktemp("train") / "ranks"), jobs)
    # the port's one-rank steps on the same float32 parameters and batch,
    # with the default warm-up and with none
    cfg = U.small_cfg("llama3.2-3b", **f32)
    b = to_device(batch, "cpu")
    one = {}
    for warmup in (100, 1):
        ref = init_state(tree_map(lambda t: t.float().clone(), p))
        step = make_train_step(build(cfg), OptConfig(lr=1e-3,
                                                     warmup_steps=warmup))
        losses, norms = [], []
        for _ in range(3):
            ref, m = step(ref, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        one[warmup] = (losses, norms, ref.params)
    _, ref_grads = loss_and_grads(build(cfg), tree_map(
        lambda t: t.float().clone(), p), b)
    return ranks, one, (tree_map(lambda t: t.float(), p), ref_grads)


def _jax_init_np() -> dict:
    import jax
    from _torch_port_util import jax_tree_to_np
    from repro.configs import get_config as j_get_config
    from repro.models import build as j_build
    cfg = j_get_config("llama3.2-3b").reduced().replace(**TRAIN_KW)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax_tree_to_np(j_build(cfg).init(jax.random.PRNGKey(0))))


def test_sharded_train_step_2x4_equals_the_references_2x4(train_run,
                                                          tmp_path):
    """Both packages on a 2x4 mesh from the JAX package's initial tree and
    the same batch, float32, one step: the loss and the gradient norm
    within 1e-5, each parameter within 2 lr of the reference's (the
    one-device test's bounds, ``tests/test_torch_train.py``)."""
    ranks, _, _ = train_run
    _, _, _, batch = _train_inputs()
    ref = _jax_train_2x4(_jax_init_np(), batch, str(tmp_path))
    losses, norms, params = ranks[0][3]
    assert losses[0] == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert norms[0] == pytest.approx(float(ref["grad_norm"]), rel=1e-5)
    lr = 1e-3 / 100                                    # warm-up step 0
    flat = {k: v for k, v in _flat_np(tree_map(lambda t: t.numpy(),
                                               params)).items()}
    assert set(flat) == {k[2:] for k in ref if k.startswith("p:")}
    for name, got in flat.items():
        assert float(np.abs(got - ref["p:" + name]).max()) <= 2 * lr, name


def test_sharded_train_step_2x4_loss_falls(train_run):
    ranks, _, _ = train_run
    losses = ranks[0][1][0]
    assert losses[-1] < losses[0], losses
    assert all(r[1][0] == losses for r in ranks)


def test_sharded_train_step_2x4_equals_one_rank_f32(train_run):
    ranks, one, _ = train_run
    ref_losses, _, ref_params = one[100]
    losses, _, params = ranks[0][0]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    for a, b in zip(tree_leaves(params), tree_leaves(ref_params)):
        assert float((a - b).abs().max()) <= 1e-5
    for r in ranks[1:]:        # every rank holds the same parameters
        for a, b in zip(tree_leaves(r[0][2]), tree_leaves(params)):
            assert torch.equal(a, b)


def _delta_ratio(params, ref_params, p0) -> float:
    """|(p - p0) - (p_ref - p0)| / |p_ref - p0| over every element."""
    num = den = 0.0
    for a, b, c in zip(tree_leaves(params), tree_leaves(ref_params),
                       tree_leaves(p0)):
        num += float(((a - b).double() ** 2).sum())
        den += float(((b - c).double() ** 2).sum())
    return (num / den) ** 0.5


def test_int8_ring_sync_within_its_bound_of_the_exact_sum(train_run):
    """One step's gradients on the 2x4 mesh, float32, synced by the ring and
    exactly from the same autograd output: every gradient still a pending
    sum over data (the branch the ring runs), every element of the ring's
    within its bound of the exact one (2(N-1) x 0.5/127 x the sum of the
    data ranks' abs-max), the exact one within 1e-5 of the one-rank
    gradient (of each leaf's largest), and the ring not exact.  A sync
    that drops, keeps one rank's part of, halves or doubles the sum is off
    by half the gradient or more, past every leaf's bound."""
    ranks, _, (_, ref_grads) = train_run
    ring, exact, bounds, pls = ranks[0][4]
    assert all(pl.startswith("(Partial(sum)") for pl in pls), pls
    moved = False
    for r, e, g1, b in zip(tree_leaves(ring), tree_leaves(exact),
                           tree_leaves(ref_grads), bounds):
        assert float((r - e).abs().max()) <= b
        assert float((e - g1).abs().max()) <= 1e-5 * float(g1.abs().max())
        assert b < 0.5 * float(g1.abs().max())
        moved |= not torch.equal(r, e)
    assert moved


def _delta_ratio(params, ref_params, p0) -> float:
    """|(p - p0) - (p_ref - p0)| / |p_ref - p0| over every element."""
    num = den = 0.0
    for a, b, c in zip(tree_leaves(params), tree_leaves(ref_params),
                       tree_leaves(p0)):
        num += float(((a - b).double() ** 2).sum())
        den += float(((b - c).double() ** 2).sum())
    return (num / den) ** 0.5


def test_int8_ring_train_step_across_ranks(train_run):
    """``grad_compression="int8_ring"`` on the 2x4 mesh, float32, at lr 1e-3
    from the first step (no warm-up), against the port's one-rank step
    without the ring on the same parameters and batch:

    - the first loss (before any update) to 1e-6;
    - the first gradient norm within the ring's bound of the exact one,
      |(|a| - |b|)| <= |a - b| <= sqrt(sum over leaves of n x bound^2)
      with the sync test's bounds; the later norms within 1e-3 (a sync
      that drops or halves the sum is 50 % off or more);
    - each step's loss change from the first within 1 % of one rank's;
    - the parameters' change p - p0 within 0.5 of one rank's change, in
      norm over all elements (an update that is missing is 1 off): the
      ring's noise flips AdamW's first, sign-like step of the elements
      whose gradient lies within that noise (0.18 measured);
    - every element within 2.01 lr a step of one rank's (AdamW moves an
      element at most 1.001 lr a step here);
    the last two on every rank."""
    ranks, one, (p0, ref_grads) = train_run
    ref_losses, ref_norms, ref_params = one[1]
    losses, norms, params = ranks[0][2]
    _, _, bounds, _ = ranks[0][4]
    assert losses[0] == pytest.approx(ref_losses[0], rel=1e-6)
    norm_bound = sum(g.numel() * b * b for g, b in
                     zip(tree_leaves(ref_grads), bounds)) ** 0.5
    assert abs(norms[0] - ref_norms[0]) <= norm_bound
    assert norm_bound < 0.1 * ref_norms[0]
    np.testing.assert_allclose(norms[1:], ref_norms[1:], rtol=1e-3)
    for k in (1, 2):
        want = ref_losses[k] - ref_losses[0]
        assert abs(losses[k] - losses[0] - want) <= 1e-2 * abs(want), k
    # every rank: the ring leaves each chunk's owner its float sum and
    # the others its int8 copy, as the reference's devices, so the data
    # ranks' copies of a parameter differ by that rounding's update
    for r in ranks:
        params = r[2][2]
        assert _delta_ratio(params, ref_params, p0) <= 0.5
        for a, b in zip(tree_leaves(params), tree_leaves(ref_params)):
            assert float((a - b).abs().max()) <= 2.01 * 1e-3 * 3


def test_int8_ring_sync_under_fsdp_within_its_bound(train_run):
    """``_compressed_sync`` beside parameters placed by the ``fsdp`` rules
    (sharded over data and model on one dim) on 2 x 4: a gradient pending
    over data is rung, one already summed and sharded is gathered and
    placed back exact; every element of the ring's within 2(N-1) x 0.5/127
    x the data ranks' abs-max sum of the exact sync, each result placed as
    its parameter, the exact sync the same on every rank, and the ring not
    exact where it ran."""
    ranks, _, _ = train_run
    for r in ranks:
        out = r[5]
        for k, leaf in out.items():
            ring, exact = leaf["ring"], leaf["exact"]
            assert leaf["placements"][0] == leaf["placements"][1], k
            assert float((ring - exact).abs().max()) <= leaf["bound"], k
            assert leaf["bound"] < 0.5 * float(exact.abs().max()), k
            assert torch.equal(exact, ranks[0][5][k]["exact"]), k
        assert not torch.equal(out["a"]["ring"], out["a"]["exact"])
        assert not torch.equal(out["b"]["ring"], out["b"]["exact"])
        assert torch.equal(out["c"]["ring"], out["c"]["exact"])
