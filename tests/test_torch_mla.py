"""Port parity: multi-head latent attention (MLA, deepseek-v2-lite-16b) of
``repro_torch`` against the JAX package's XLA path at converted weights —
the prefill (decompressed per head: q/k head dim ``qk_nope + qk_rope``, v
head dim ``v_head_dim``), the absorbed-form decode against a random
latent cache, the cache specs, and the routing of the causal prefill into
the flash attention wrapper at unequal head dims.

Limits, stated before the first run: 1e-5 on the attention outputs and on
the cache entries in float32 (the two packages sum the same products in
another order); 2e-2 in bf16 (tests/test_torch_flash_attention.py's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models.transformer import _layer_slice as j_layer_slice
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import attention as t_attn
from repro_torch.models import build
from repro_torch.models.transformer import _layer_slice

from _torch_port_util import both_params, t2np, to_np

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
B, T = 2, 10


@pytest.fixture(scope="module")
def mla():
    cj = j_get_config(ARCH).reduced().replace(dtype="float32")
    ct = get_config(ARCH).reduced().replace(dtype="float32")
    pj, pt = both_params(j_build(cj), build(ct), seed=0)
    return dict(cj=cj, ct=ct,
                pj=j_layer_slice(pj["moe_blocks"], 0)["attn"],
                pt=_layer_slice(pt["moe_blocks"], 0)["attn"])


def test_specs_have_the_references_shapes():
    cfg_j, cfg_t = j_get_config(ARCH), get_config(ARCH)
    sj, st = j_attn.mla_specs(cfg_j, 4), t_attn.mla_specs(cfg_t, 4)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in sj.items()}
    cj = j_attn.mla_cache_specs(cfg_j, 2, 64)
    ct = t_attn.mla_cache_specs(cfg_t, 2, 64)
    assert {k: tuple(v.shape) for k, v in ct.items()} == \
        {k: tuple(v.shape) for k, v in cj.items()}
    assert tuple(ct["c_kv"].shape) == (2, 64, 512)
    assert tuple(ct["k_pe"].shape) == (2, 64, 64)


@pytest.mark.parametrize("S,causal", [(T, True), (T, False), (1, True),
                                      (65, True)])
def test_mla_forward_matches_the_reference(mla, S, causal):
    """Output and the (c_kv, k_pe) cache entries of one MLA layer."""
    cj, ct = mla["cj"], mla["ct"]
    x = np.random.default_rng(S).standard_normal(
        (B, S, cj.d_model)).astype(np.float32)
    pos = np.arange(S)
    yj, kvj = j_attn.mla_forward(cj, mla["pj"], jnp.asarray(x),
                                 jnp.asarray(pos), causal=causal,
                                 return_kv=True)
    yt, kvt = t_attn.mla_forward(ct, mla["pt"], torch.from_numpy(x),
                                 torch.from_numpy(pos), causal=causal,
                                 return_kv=True)
    assert tuple(yt.shape) == (B, S, cj.d_model)
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=TOL)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(t2np(kvt[name]), to_np(kvj[name]),
                                   atol=TOL)


@pytest.mark.parametrize("pos", [0, 3, 9])
def test_mla_decode_matches_the_reference(mla, pos):
    """Absorbed-form decode from a random latent cache: the output and the
    updated cache; the port writes the new entries in place."""
    cj, ct = mla["cj"], mla["ct"]
    rng = np.random.default_rng(pos + 10)
    x = rng.standard_normal((B, 1, cj.d_model)).astype(np.float32)
    cache = {"c_kv": rng.standard_normal((B, T, cj.kv_lora_rank)),
             "k_pe": rng.standard_normal((B, T, cj.qk_rope_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    yj, cj_new = j_attn.mla_decode(cj, mla["pj"], jnp.asarray(x),
                                   jnp.int32(pos),
                                   {k: jnp.asarray(v) for k, v in
                                    cache.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    yt, ct_new = t_attn.mla_decode(ct, mla["pt"], torch.from_numpy(x),
                                   pos, tc)
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=TOL)
    for k in cache:
        assert ct_new[k] is tc[k]                     # in place
        np.testing.assert_allclose(t2np(ct_new[k]), to_np(cj_new[k]),
                                   atol=TOL)
    # a position held as a tensor gives the same step
    tc2 = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    yt2, _ = t_attn.mla_decode(ct, mla["pt"], torch.from_numpy(x),
                               torch.tensor(pos), tc2)
    assert torch.equal(yt, yt2)


@pytest.mark.parametrize("name,jdt,tdt,tol", [
    ("float32", jnp.float32, torch.float32, TOL),
    ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_plain_attention_at_192_128_matches_the_reference(name, jdt, tdt,
                                                          tol):
    """The plain B5 at deepseek-v2-lite-16b's head dims (q/k 192, v 128),
    causal, against the JAX package's XLA attention (``_sdpa``, which
    scales by the q/k head dim as ``mla_forward`` does)."""
    H, D, Dv, S = 4, 192, 128, 70
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((1, S, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, S, H, Dv)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = j_attn._sdpa(qj, kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
                        causal=True)
    got = fa.flash_attention(*(torch.from_numpy(np.array(to_np(a))).to(tdt)
                               for a in (qj, kj, vj)), causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (1, S, H, Dv)
    np.testing.assert_allclose(t2np(got), to_np(want), atol=tol)


def test_the_causal_prefill_goes_to_the_flash_attention_wrapper(mla,
                                                                 monkeypatch):
    """``mla_forward``'s causal prefill calls the B5 wrapper once with q
    and k at qk_nope + qk_rope and v at v_head_dim, the RoPE key the same
    in every head; S = 1 and non-causal calls do not."""
    ct = mla["ct"]
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), causal))
        qr = ct.qk_rope_dim
        assert torch.equal(k[..., -qr:], k[:, :, :1, -qr:].expand_as(
            k[..., -qr:]))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(fa, "flash_attention", spy)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, ct.d_model)).astype(np.float32))
    pos = torch.arange(T)
    t_attn.mla_forward(ct, mla["pt"], x, pos)
    Dqk = ct.qk_nope_dim + ct.qk_rope_dim
    H = ct.n_heads
    assert seen == [((B, T, H, Dqk), (B, T, H, Dqk), (B, T, H, ct.v_head_dim),
                     True)]
    t_attn.mla_forward(ct, mla["pt"], x[:, :1], pos[:1])
    t_attn.mla_forward(ct, mla["pt"], x, pos, causal=False)
    assert len(seen) == 1
