"""Port parity: ``vla_forward`` of ``repro_torch`` against the JAX package
at converted weights — OpenVLA (detok head) and CogACT (DiT head), reduced
configs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.models import vla as j_vla
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models import vla as t_vla

from _torch_port_util import both_params, t2np, to_np

B, N_TOK = 2, 8


def _setup(name, dtype):
    cj = j_get_config(name).reduced().replace(n_layers=3, dtype=dtype)
    ct = get_config(name).reduced().replace(n_layers=3, dtype=dtype)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0, fill_zeros=True)
    rng = np.random.default_rng(7)
    patches = rng.standard_normal((B, cj.n_patches, cj.vit_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cj.vocab_size, (B, N_TOK))
    return cj, ct, mj, mt, pj, pt, patches, tokens


@pytest.fixture(scope="module", params=["openvla-7b", "cogact-7b"])
def f32_setup(request):
    return _setup(request.param, "float32")


def test_backbone_hidden_float32(f32_setup):
    """Final hidden state within 2e-4 (tests/test_runtime.py's tolerance for
    a forward in another summation order)."""
    cj, ct, mj, mt, pj, pt, patches, tokens = f32_setup
    ref = j_vla.vla_backbone(cj, pj, jnp.asarray(patches), jnp.asarray(tokens))
    got = t_vla.vla_backbone(ct, pt, torch.from_numpy(patches),
                             torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, cj.n_patches + N_TOK, cj.d_model)
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=2e-4, rtol=2e-4)


def test_vit_encode_float32(f32_setup):
    cj, ct, mj, mt, pj, pt, patches, tokens = f32_setup
    ref = j_vla.vit_encode(cj, pj["vit"], jnp.asarray(patches))
    got = t_vla.vit_encode(ct, pt["vit"], torch.from_numpy(patches))
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=2e-4, rtol=2e-4)


def test_forward_actions_float32(f32_setup):
    """detok: the same bins; DiT: within 1e-4 with the reference's own
    initial noise handed to the port."""
    cj, ct, mj, mt, pj, pt, patches, tokens = f32_setup
    key = jax.random.PRNGKey(3)
    batch_j = {"patches": jnp.asarray(patches), "tokens": jnp.asarray(tokens)}
    batch_t = {"patches": torch.from_numpy(patches),
               "tokens": torch.from_numpy(tokens)}
    ref = mj.forward(pj, batch_j, key)
    if cj.vla_action_head == "dit":
        noise = jax.random.normal(key, (B, cj.action_horizon, cj.action_dim),
                                  jnp.float32)
        got = mt.forward(pt, batch_t, noise=torch.from_numpy(
            np.array(noise)))
        assert tuple(got.shape) == (B, cj.action_horizon, cj.action_dim)
        np.testing.assert_allclose(t2np(got), to_np(ref), atol=1e-4)
        assert float(np.abs(to_np(ref)).max()) > 1e-2
    else:
        got = mt.forward(pt, batch_t)
        assert tuple(got.shape) == (B, 1, cj.action_dim)
        assert np.array_equal(t2np(got), to_np(ref))


def test_dit_denoise_float32():
    """One denoiser call, zero-initialised adaLN leaves filled so that every
    layer of the DiT is seen."""
    cj, ct, mj, mt, pj, pt, patches, tokens = _setup("cogact-7b", "float32")
    rng = np.random.default_rng(9)
    noisy = rng.standard_normal((B, cj.action_horizon, cj.action_dim)
                                ).astype(np.float32)
    cog = rng.standard_normal((B, cj.d_model)).astype(np.float32)
    t = np.array([1, 0])
    ref = j_vla.dit_denoise(cj, pj["action"], jnp.asarray(noisy),
                            jnp.asarray(t), jnp.asarray(cog))
    got = t_vla.dit_denoise(ct, pt["action"], torch.from_numpy(noisy),
                            torch.from_numpy(t), torch.from_numpy(cog))
    assert float(np.abs(to_np(ref)).max()) > 1e-3
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["openvla-7b", "cogact-7b"])
def test_backbone_hidden_bfloat16(name):
    """bf16: the two frameworks round at other places (XLA fuses where
    PyTorch writes bf16 between ops), so 5e-2 on a normalised state."""
    cj, ct, mj, mt, pj, pt, patches, tokens = _setup(name, "bfloat16")
    ref = j_vla.vla_backbone(cj, pj, jnp.asarray(patches), jnp.asarray(tokens))
    got = t_vla.vla_backbone(ct, pt, torch.from_numpy(patches),
                             torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=5e-2, rtol=5e-2)


def test_dense_lm_logits_float32():
    """The dense family through ``build(cfg).forward``."""
    from repro.models.transformer import lm_hidden, lm_logits
    cj = j_get_config("llama3.2-3b").reduced().replace(n_layers=3,
                                                       dtype="float32")
    ct = get_config("llama3.2-3b").reduced().replace(n_layers=3,
                                                     dtype="float32")
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=1)
    tokens = np.random.default_rng(2).integers(0, cj.vocab_size, (2, 12))
    h, _ = lm_hidden(cj, pj, jnp.asarray(tokens), remat=False)
    ref = lm_logits(cj, pj, h)
    got = mt.forward(pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("head", ["mlp", "lstm", "diffusion"])
def test_unported_heads_raise(head):
    """The three heads that raised before they were ported now build with
    the reference's parameter shapes; a head with no such name raises."""
    cfg = get_config("openvla-7b").reduced().replace(vla_action_head=head)
    specs = build(cfg).param_specs["action"]
    want = j_vla.action_head_specs(
        j_get_config("openvla-7b").reduced().replace(vla_action_head=head))
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(ValueError, match="unknown action head"):
        build(cfg.replace(vla_action_head=head + "_x"))


# ------------------------------------- the mlp, lstm and diffusion heads
# limit, stated before the first run: tests/test_runtime.py's 2e-4 for the
# action of a forward in another summation order (float32 activations)
HEAD_TOL = 2e-4
HEADS = ["mlp", "lstm", "diffusion"]


def _head_setup(head, dtype="float32"):
    """OpenVLA reduced (3 LLM layers) with ``head`` and a horizon of 4."""
    kw = dict(n_layers=3, dtype=dtype, vla_action_head=head)
    cj = j_get_config("openvla-7b").reduced().replace(**kw)
    ct = get_config("openvla-7b").reduced().replace(**kw)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=2)
    rng = np.random.default_rng(8)
    patches = rng.standard_normal((B, cj.n_patches, cj.vit_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cj.vocab_size, (B, N_TOK))
    return cj, ct, mj, mt, pj, pt, patches, tokens


def _ref_noise(cj, key):
    """The reference's own initial draw of the diffusion head."""
    return np.array(jax.random.normal(
        key, (B, cj.action_horizon * cj.action_dim)))


@pytest.mark.parametrize("head", HEADS)
def test_head_actions_match_the_reference(head):
    """The whole VLA forward; the diffusion head fed the reference's own
    noise."""
    cj, ct, mj, mt, pj, pt, patches, tokens = _head_setup(head)
    key = jax.random.PRNGKey(4)
    ref = mj.forward(pj, {"patches": jnp.asarray(patches),
                          "tokens": jnp.asarray(tokens)}, key)
    noise = torch.from_numpy(_ref_noise(cj, key)) if head == "diffusion" \
        else None
    got = mt.forward(pt, {"patches": torch.from_numpy(patches),
                          "tokens": torch.from_numpy(tokens)}, noise=noise)
    assert tuple(got.shape) == (B, cj.action_horizon, cj.action_dim)
    assert float(np.abs(to_np(ref)).max()) > 1e-3
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=HEAD_TOL,
                               rtol=HEAD_TOL)


@pytest.mark.parametrize("head", HEADS)
def test_head_alone_matches_the_reference_on_a_cognition_feature(
        head, monkeypatch):
    """The head alone on a random cognition feature (the LSTM's float32
    cell state, the diffusion head's float32 iterate): the reference
    reaches its heads only through ``vla_forward``, so its backbone is
    replaced by one whose last hidden state is that feature."""
    cj, ct, mj, mt, pj, pt, _, _ = _head_setup(head)
    cog = np.random.default_rng(9).standard_normal(
        (B, cj.d_model)).astype(np.float32)
    monkeypatch.setattr(j_vla, "vla_backbone",
                        lambda *a, **k: jnp.asarray(cog)[:, None, :])
    key = jax.random.PRNGKey(6)
    want = j_vla.vla_forward(cj, {"action": pj["action"]}, None, None, key)
    noise = torch.from_numpy(_ref_noise(cj, key)) if head == "diffusion" \
        else None
    got = t_vla.decode_action(ct, pt["action"], torch.from_numpy(cog), noise)
    assert float(np.abs(to_np(want)).max()) > 1e-3
    np.testing.assert_allclose(t2np(got), to_np(want), atol=HEAD_TOL,
                               rtol=HEAD_TOL)


@pytest.mark.parametrize("head", HEADS)
def test_split_executor_serves_the_head(head):
    """``VLASplitExecutor`` with the head: single-pool at every cut and a
    two-pool plan (the tail ships the cognition token only) equal the
    monolithic forward; with the int8 codec the action stays within the
    codec's error."""
    from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor
    cj, ct, mj, mt, pj, pt, patches, tokens = _head_setup(head)
    t_in = (torch.from_numpy(patches), torch.from_numpy(tokens))
    noise = t_vla.draw_noise(ct, B, "cpu", torch.Generator().manual_seed(3)) \
        if head == "diffusion" else None
    ref = mt.forward(pt, {"patches": t_in[0], "tokens": t_in[1]}, noise)
    Lv = ct.vit_layers
    ex = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3), device="cpu")
    for split in range(Lv + 1, Lv + 4):
        act, payload = ex.run(pt, *t_in, split, noise)
        assert set(payload) == {"x"}
        np.testing.assert_allclose(t2np(act), t2np(ref), atol=1e-5)
    end = Lv + ct.n_layers
    ex2 = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 2, pool2_start=end,
                                         pool2_end=end), device="cpu")
    act, legs = ex2.run(pt, *t_in, Lv + 1, noise)
    assert legs["down"]["x"].shape[1] == 1          # the cognition token
    np.testing.assert_allclose(t2np(act), t2np(ref), atol=1e-5)
    ex8 = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3, codec="int8"),
                           device="cpu")
    act, payload = ex8.run(pt, *t_in, Lv + 2, noise)
    assert set(payload) == {"q", "s"}
    assert torch.isfinite(act).all()
    scale = float(ref.abs().max())
    assert float((act - ref).abs().max()) <= 0.1 * max(scale, 1.0)
    if head == "diffusion":       # a generator in place of the noise
        a1, _ = ex.run(pt, *t_in, Lv + 2,
                       generator=torch.Generator().manual_seed(3))
        assert torch.equal(a1, ex.run(pt, *t_in, Lv + 2, noise)[0])


def test_init_makes_spec_shapes_from_a_generator():
    cfg = get_config("cogact-7b").reduced()
    model = build(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g, "cpu")
    from repro_torch.models.sharding import tree_leaves
    leaves, specs = tree_leaves(params), tree_leaves(model.param_specs)
    assert len(leaves) == len(specs)
    for t, s in zip(leaves, specs):
        assert tuple(t.shape) == tuple(s.shape) and t.dtype == s.dtype
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["blocks"]["mlp"]["wg"],
                       again["blocks"]["mlp"]["wg"])
    assert params["blocks"]["ln1"].eq(1).all()
    assert params["action"]["out"].eq(0).all()
    w = params["blocks"]["mlp"]["wg"].float()
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            model.init(torch.Generator().manual_seed(0))
