"""Port parity: layers and attention of ``repro_torch`` against the JAX
functions on the same numpy inputs — 1e-5 in float32 (sums in another
order), 2e-2 in bfloat16 (rounding at other places)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn, layers as j_layers
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention as t_attn, layers as t_layers

from _torch_port_util import t2np, to_np

DTYPES = [("float32", jnp.float32, torch.float32, 1e-5),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]


def _pair(rng, shape, jdt, tdt, scale=1.0):
    a = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)
                    ).astype(jdt)
    return a, torch.from_numpy(np.array(to_np(a))).to(tdt)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_equal_field_for_field(name):
    import dataclasses
    a, b = j_get_config(name), get_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert a.n_params() == b.n_params()


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_rmsnorm(name, jdt, tdt, tol):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 9, 64), jdt, tdt, 2.0)
    wj, wt = _pair(rng, (64,), jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(t2np(t_layers.rmsnorm(xt, wt, 1e-5)),
                               to_np(j_layers.rmsnorm(xj, wj, 1e-5)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_apply_rope(name, jdt, tdt, tol, ndim):
    rng = np.random.default_rng(1)
    shape = (2, 11, 3, 16) if ndim == 4 else (2, 11, 16)
    xj, xt = _pair(rng, shape, jdt, tdt)
    got = t_layers.apply_rope(xt, torch.arange(11), 10_000.0)
    ref = j_layers.apply_rope(xj, jnp.arange(11), 10_000.0)
    assert got.dtype == tdt
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=tol)
    np.testing.assert_allclose(
        t_layers.rope_freqs(16, 500_000.0).numpy(),
        np.asarray(j_layers.rope_freqs(16, 500_000.0)), rtol=1e-6)


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_mlp(name, jdt, tdt, tol):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 7, 64), jdt, tdt)
    pj, pt = {}, {}
    for k, shape in (("wg", (64, 128)), ("wu", (64, 128)), ("wd", (128, 64))):
        pj[k], pt[k] = _pair(rng, shape, jnp.bfloat16, torch.bfloat16,
                             shape[0] ** -0.5)
    got, ref = t_layers.mlp(pt, xt), j_layers.mlp(pj, xj)
    assert got.dtype == tdt
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_embed_unembed_padded_vocab(name, jdt, tdt, tol):
    rng = np.random.default_rng(3)
    vocab = 250                                        # pads to 256
    assert t_layers.padded_vocab(vocab) == j_layers.padded_vocab(vocab) == 256
    wj, wt = _pair(rng, (256, 64), jnp.bfloat16, torch.bfloat16)
    xj, xt = _pair(rng, (2, 5, 64), jdt, tdt)
    got = t_layers.unembed(wt, xt, vocab)
    ref = j_layers.unembed(wj, xj, vocab)
    assert got.shape == (2, 5, 256)
    np.testing.assert_allclose(t2np(got)[..., :vocab], to_np(ref)[..., :vocab],
                               atol=tol, rtol=tol)
    assert (t2np(got)[..., vocab:] <= -9e29).all()
    assert np.array_equal(t2np(got)[..., vocab:], to_np(ref)[..., vocab:])
    toks = rng.integers(0, vocab, (2, 5))
    assert np.array_equal(
        t2np(t_layers.embed(wt, torch.from_numpy(toks))),
        to_np(j_layers.embed(wj, jnp.asarray(toks))))


def _attn_cfgs(n_heads, n_kv, dtype, qkv_bias=False):
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, dtype=dtype,
              qkv_bias=qkv_bias)
    return (j_get_config("llama3.2-3b").reduced().replace(**kw),
            get_config("llama3.2-3b").reduced().replace(**kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_attn_forward(name, jdt, tdt, tol, H, KV, causal):
    """Causal goes through the port's flash attention (plain version here),
    non-causal through the written-out ``_sdpa``; the JAX side runs its
    default XLA path."""
    cj, ct = _attn_cfgs(H, KV, name, qkv_bias=(KV == 2))
    rng = np.random.default_rng(4)
    hd = cj.resolved_head_dim
    pj, pt = {}, {}
    for k, shape in (("wq", (64, H * hd)), ("wk", (64, KV * hd)),
                     ("wv", (64, KV * hd)), ("wo", (H * hd, 64))):
        pj[k], pt[k] = _pair(rng, shape, jnp.bfloat16, torch.bfloat16,
                             shape[0] ** -0.5)
    if KV == 2:
        for k, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            pj[k], pt[k] = _pair(rng, (n,), jnp.bfloat16, torch.bfloat16, 0.1)
    xj, xt = _pair(rng, (2, 13, 64), jdt, tdt)
    ref, kv_ref = j_attn.attn_forward(cj, pj, xj, jnp.arange(13),
                                      causal=causal, return_kv=True)
    got, kv = t_attn.attn_forward(ct, pt, xt, torch.arange(13),
                                  causal=causal, return_kv=True)
    assert got.dtype == tdt and got.shape == (2, 13, 64)
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=tol, rtol=tol)
    for key in ("k", "v"):
        assert kv[key].shape == kv_ref[key].shape
        np.testing.assert_allclose(t2np(kv[key]), to_np(kv_ref[key]),
                                   atol=tol, rtol=tol)


def test_blocked_sdpa_matches_sdpa():
    """The blocked form (taken above 2048 x 2048 scores) against the direct
    one and the JAX blocked form, at small blocks."""
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (1, 40, 2, 16), jnp.float32, torch.float32)
    kj, kt = _pair(rng, (1, 2, 40, 16), jnp.float32, torch.float32)
    vj, vt = _pair(rng, (1, 2, 40, 16), jnp.float32, torch.float32)
    for causal in (True, False):
        direct = t_attn._sdpa(qt, kt, vt, causal=causal)
        blocked = t_attn._blocked_sdpa(qt, kt, vt, causal=causal, bq=16, bk=8)
        ref = j_attn._blocked_sdpa(qj, kj, vj, causal=causal, bq=16, bk=8)
        np.testing.assert_allclose(t2np(blocked), t2np(direct), atol=1e-5)
        np.testing.assert_allclose(t2np(blocked), to_np(ref), atol=1e-5)
