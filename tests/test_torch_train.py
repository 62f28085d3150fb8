"""The port's train step, optimizer, gradient compression, fault
supervisor and training entry point: one step against the JAX package's, and
twins of the training tests of ``tests/test_train_ckpt.py``.

One ``make_train_step`` step from the same float32 parameters and batch
(reduced configs in float32): the loss and the gradient norm within 1e-5
relative, each moment leaf within 1e-4 of its largest value (the
gradients agree to 1e-4 of their largest, ``tests/test_torch_losses.py``),
and the parameters within 2 lr: Adam's first step moves an element by
about ``lr · sign(g)``, so a tiny gradient whose sign differs between the
two libraries moves it by up to 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.train import optimizer as j_opt
from repro.train.train_loop import init_state as j_init_state
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.models.sharding import tree_leaves, tree_map
from repro_torch.runtime.fault import FaultPlan, Supervisor
from repro_torch.train.compression import _dequant, _quant, ef_compress
from repro_torch.train.optimizer import (OptConfig, _bias_corrections,
                                         adamw_update, clip_by_global_norm,
                                         lr_at)
from repro_torch.train.train_loop import (init_state, loss_and_grads,
                                          make_train_step)

from _torch_port_util import both_params_f32, np_batch

REL = 1e-5
MOMENT_REL = 1e-4


def _leaf_pairs(tree_j, tree_t):
    lj = jax.tree_util.tree_leaves_with_path(tree_j)
    lt = tree_leaves(tree_t)
    assert len(lj) == len(lt)
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32),
             b.detach().float().numpy()) for (p, a), b in zip(lj, lt)]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "openvla-7b"])
def test_one_train_step_matches_the_reference(arch):
    cj = j_get_config(arch).reduced().replace(dtype="float32")
    ct = get_config(arch).reduced().replace(dtype="float32")
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params_f32(mj, mt, 0)
    batch = np_batch(cj, 1)
    opt = dict(lr=1e-3, warmup_steps=3)
    sj, metj = jax.jit(j_make_train_step(mj, j_opt.OptConfig(**opt)))(
        j_init_state(pj), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(2))
    st, mett = make_train_step(mt, OptConfig(**opt))(
        init_state(pt), to_device(batch, "cpu"))
    assert st.step == 1 and mett["step"] == 0
    for k in ("loss", "grad_norm"):
        want = float(metj[k])
        assert abs(float(mett[k]) - want) <= REL * abs(want), k
    lr = lr_at(OptConfig(**opt), 0)
    assert lr == pytest.approx(1e-3 / 3, rel=1e-7)
    for name, a, b in _leaf_pairs(sj.params, st.params):
        assert float(np.abs(a - b).max()) <= 2 * lr, name
    for tj, tt in ((sj.m, st.m), (sj.v, st.v)):
        for name, a, b in _leaf_pairs(tj, tt):
            assert b.dtype == np.float32
            scale = float(np.abs(a).max())
            assert float(np.abs(a - b).max()) <= MOMENT_REL * scale, name


def test_optimizer_scalars_are_the_references():
    """Learning rate and bias corrections in float32, as the JAX package
    computes them (``1 - b ** t`` inside its ``adamw_update``)."""
    cfg = OptConfig(lr=6e-4, warmup_steps=30)
    jcfg = j_opt.OptConfig(lr=6e-4, warmup_steps=30)
    for step in (0, 1, 7, 29, 30, 500):
        assert lr_at(cfg, step) == float(j_opt.lr_at(jcfg, jnp.int32(step)))
        t = jnp.int32(step).astype(jnp.float32) + 1.0
        assert _bias_corrections(cfg, step) == (float(1 - jcfg.b1 ** t),
                                                float(1 - jcfg.b2 ** t))


# leaves of a small tree for the AdamW update
ADAM_SHAPES = {"a": (64, 48), "b": {"c": (3, 16, 32), "d": (17,)}}
ADAM_REL = 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [3, 7, 40])
def test_adamw_update_matches_the_reference(step, dtype):
    """``adamw_update`` against the JAX package's on the same parameters,
    clipped gradients and non-zero moments at a later step, where an
    element moves by much more or less than ``lr``: the parameters within
    ADAM_REL of the largest update of their leaf (a missing weight decay or
    bias correction is thousands of times that), ``m`` and ``v`` within
    ADAM_REL of their largest value."""
    rng = np.random.default_rng(step)

    def draw(f):
        return {"a": f(ADAM_SHAPES["a"]),
                "b": {k: f(s) for k, s in ADAM_SHAPES["b"].items()}}

    p = draw(lambda s: 0.02 * rng.standard_normal(s))
    g = draw(lambda s: 0.5 * rng.standard_normal(s))   # norm above the clip
    m = draw(lambda s: 0.01 * rng.standard_normal(s))
    v = draw(lambda s: (0.01 * rng.standard_normal(s)) ** 2 + 1e-6)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def j_tree(t, d):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32)
                                      .astype(d), t)

    def t_tree(t, d):
        return tree_map(lambda a: torch.from_numpy(
            np.asarray(a, np.float32)).to(d), t)

    opt = dict(lr=1e-2, warmup_steps=5)
    pj, mj, vj, gn_j = j_opt.adamw_update(
        j_opt.OptConfig(**opt), j_tree(p, jd), j_tree(g, jd),
        j_tree(m, jnp.float32), j_tree(v, jnp.float32), jnp.int32(step))
    p0 = t_tree(p, td)
    pt, mt, vt = t_tree(p, td), t_tree(m, torch.float32), t_tree(
        v, torch.float32)
    *_, gn_t = adamw_update(OptConfig(**opt), pt, t_tree(g, td), mt, vt, step)
    assert abs(float(gn_t) - float(gn_j)) <= REL * float(gn_j)
    assert float(gn_j) > OptConfig().grad_clip
    assert all(t.dtype == td for t in tree_leaves(pt))
    for (name, a, b), c in zip(_leaf_pairs(pj, pt), tree_leaves(p0)):
        moved = float(np.abs(a - c.float().numpy()).max())
        assert moved > 0, name
        assert float(np.abs(a - b).max()) <= ADAM_REL * moved, name
    for tj, tt in ((mj, mt), (vj, vt)):
        for name, a, b in _leaf_pairs(tj, tt):
            assert b.dtype == np.float32
            assert float(np.abs(a - b).max()) <= ADAM_REL * float(
                np.abs(a).max()), name


def _small_llama(**kw):
    return get_config("llama3.2-3b").reduced().replace(n_layers=2, **kw)


def _stream(cfg, S, B, seed=0):
    return SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                      global_batch=B, seed=seed))


def test_loss_decreases_dense():
    cfg = _small_llama()
    model = build(cfg)
    state = init_state(model.init(torch.Generator().manual_seed(0), "cpu"))
    step = make_train_step(model, OptConfig(lr=2e-3, warmup_steps=5))
    stream = _stream(cfg, 32, 4)
    losses = []
    for i in range(25):
        state, m = step(state, to_device(stream.next(), "cpu"),
                        torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7


def test_microbatched_equals_full_batch():
    cfg = _small_llama(dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    s1 = init_state(tree_map(torch.clone, params))
    s2 = init_state(tree_map(torch.clone, params))
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    batch = to_device(_stream(cfg, 16, 4).next(), "cpu")
    s1, m1 = make_train_step(model, opt, n_microbatches=1)(s1, batch)
    s2, m2 = make_train_step(model, opt, n_microbatches=2)(s2, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    # param updates agree up to f32 accumulation-order noise through Adam
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 5e-3


def test_microbatches_take_the_steps_one_draw():
    """Every microbatch of a VLA step draws the DiT's timesteps and noise
    from the generator's state at the start of the step."""
    cfg = get_config("cogact-7b").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = to_device(np_batch(cfg, 2, B=2), "cpu")
    seen = []
    loss_fn = model.loss_fn

    def recording(p, b, generator=None):
        seen.append(torch.randint(0, 1 << 30, (4,), generator=generator))
        return loss_fn(p, b, generator)

    model.loss_fn = recording
    step = make_train_step(model, OptConfig(), n_microbatches=2)
    step(init_state(params), batch, torch.Generator().manual_seed(5))
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_error_feedback_reduces_bias():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (64, 128)).astype(np.float32))}
    ef = tree_map(torch.zeros_like, g)
    acc = torch.zeros_like(g["w"])
    acc_plain = torch.zeros_like(g["w"])
    for _ in range(20):
        gq, ef = ef_compress(g, ef)
        acc = acc + gq["w"]
        acc_plain = acc_plain + _dequant(*_quant(g["w"]))
    err_ef = float((acc - 20 * g["w"]).abs().mean())
    err_plain = float((acc_plain - 20 * g["w"]).abs().mean())
    assert err_ef < err_plain


def test_quant_is_the_references():
    from repro.train.compression import _dequant as j_dequant
    from repro.train.compression import _quant as j_quant
    x = np.random.default_rng(1).normal(0, 3, (33, 65)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]                  # ties, if scale is 1
    q, s = _quant(torch.from_numpy(x))
    qj, sj = j_quant(jnp.asarray(x))
    assert float(s) == float(sj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_dequant(q, s).numpy(),
                                  np.asarray(j_dequant(qj, sj)))


def test_int8_ring_without_a_process_group_changes_nothing():
    cfg = _small_llama(dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = to_device(_stream(cfg, 8, 2).next(), "cpu")
    out = []
    for comp in (None, "int8_ring"):
        s = init_state(tree_map(torch.clone, params))
        s, m = make_train_step(model, OptConfig(), grad_compression=comp)(
            s, batch)
        out.append((m, s.params))
    assert float(out[0][0]["grad_norm"]) == float(out[1][0]["grad_norm"])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        make_train_step(model, OptConfig(), grad_compression="fp8")


def test_supervisor_restart_replays_data(tmp_path):
    cfg = _small_llama()
    model = build(cfg)
    state = init_state(model.init(torch.Generator().manual_seed(0), "cpu"))
    step = make_train_step(model, OptConfig(lr=1e-3))
    sup = Supervisor(str(tmp_path), ckpt_every=4)
    rep = sup.run(state, _stream(cfg, 16, 2), step, 12,
                  key_fn=launch_train.step_generator("cpu"),
                  fault_plan=FaultPlan(fail_at=(6,)))
    assert rep.steps_done == 12 and rep.restarts == 1


def test_a_restart_replays_the_uninterrupted_run_exactly(tmp_path):
    """Restored from step 4 (parameters, moments and the stream's position
    copied into the live tensors), steps 4-11 give the losses of the run
    that never failed, bit for bit on the CPU."""
    cfg = _small_llama()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    reps = []
    for fail_at, d in (((), tmp_path / "a"), ((6,), tmp_path / "b")):
        state = init_state(tree_map(torch.clone, params))
        live = tree_leaves(state.params)
        rep = Supervisor(str(d), ckpt_every=4).run(
            state, _stream(cfg, 16, 2), make_train_step(
                model, OptConfig(lr=1e-3, warmup_steps=2)), 12,
            key_fn=launch_train.step_generator("cpu"),
            fault_plan=FaultPlan(fail_at=fail_at))
        assert all(a is b for a, b in zip(live, tree_leaves(state.params)))
        reps.append(rep)
    full, failed = reps
    assert failed.restarts == 1 and len(failed.losses) == 12 + 2
    assert failed.losses[:6] == full.losses[:6]
    assert failed.losses[6:] == full.losses[4:]


def test_launch_train_on_the_cpu_survives_a_failure(capsys):
    rep = launch_train.main(["--device", "cpu", "--reduce", "smoke",
                             "--steps", "12", "--batch", "2", "--seq", "16",
                             "--ckpt-every", "4", "--fail-at", "6",
                             "--log-every", "4"])
    assert rep.steps_done == 12 and rep.restarts == 1
    assert all(np.isfinite(rep.losses))
    out = capsys.readouterr().out
    assert "device=cpu" in out and "1 restarts" in out


def test_the_train_entry_points_want_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1"])


def test_one_train_step_on_every_family():
    """The twin of ``tests/test_models_smoke.py::test_one_train_step``
    beside the gradients: on every reduced config one step's gradients
    are finite, and the parameters move."""
    from repro.configs import ARCHS
    for arch in sorted(ARCHS):
        cfg = get_config(arch).reduced()
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        before = tree_map(torch.clone, params)
        batch = to_device(np_batch(cfg, 1), "cpu")
        loss, grads = loss_and_grads(model, params, batch,
                                     torch.Generator().manual_seed(2))
        assert torch.isfinite(loss), arch
        assert all(torch.isfinite(g).all() for g in tree_leaves(grads)), arch
        state, m = make_train_step(model, OptConfig(lr=1e-3))(
            init_state(params), batch, torch.Generator().manual_seed(2))
        assert state.step == 1 and torch.isfinite(m["loss"])
        assert max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(tree_leaves(before), tree_leaves(state.params))) > 0


def test_the_global_norm_of_a_large_leaf_is_float32_exact():
    """The clip's norm of a 2e7-element leaf agrees with float64 to float32
    rounding (``torch.linalg.vector_norm`` on the CPU sums it 0.5 % off)."""
    g = torch.randn(20_000_000, generator=torch.Generator().manual_seed(0))
    g[:1000] *= 1000
    want = float(g.double().norm())
    _, norm = clip_by_global_norm({"g": g.clone(), "b": torch.ones(3)}, 1.0)
    assert abs(float(norm) - (want ** 2 + 3) ** 0.5) <= 1e-6 * want


def test_input_specs_match_the_reference():
    """``Model.input_specs`` of every config and shape kind: the keys,
    shapes, logical axes and dtypes of the JAX package's."""
    from repro.configs import ARCHS
    from repro.configs.base import SHAPES as J_SHAPES
    from repro_torch.configs.base import SHAPES
    for arch in sorted(ARCHS):
        mj, mt = j_build(j_get_config(arch)), build(get_config(arch))
        for sj, st in zip(J_SHAPES, SHAPES):
            want, got = mj.input_specs(sj), mt.input_specs(st)
            assert sorted(want) == sorted(got), (arch, st.kind)
            for k in want:
                assert got[k].shape == want[k].shape, (arch, st.kind, k)
                assert got[k].axes == want[k].axes, (arch, st.kind, k)
                assert str(got[k].dtype).split(".")[-1] == \
                    jnp.dtype(want[k].dtype).name, (arch, st.kind, k)
