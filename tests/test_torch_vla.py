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
    cfg = get_config("openvla-7b").reduced().replace(vla_action_head=head)
    with pytest.raises(NotImplementedError, match="not ported"):
        build(cfg)


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
