"""Port parity: the plain version of ``repro_torch``'s flash attention
against the Pallas kernel of the JAX package (interpret mode) and, where
that kernel asserts on a ragged sequence, against its jnp reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops, ref as j_ref
from repro_torch.kernels.flash_attention import ops as t_ops

from _torch_port_util import t2np, to_np

DTYPES = [("float32", jnp.float32, torch.float32, 5e-6),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]


def _qkv(B, S, T, H, KV, D, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)):
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(jdt)
        out_j.append(a)
        out_t.append(torch.from_numpy(np.array(to_np(a))).to(tdt))
    return out_j, out_t


@pytest.mark.parametrize("B,S,H,KV,D", [
    (1, 128, 2, 2, 32),      # MHA
    (2, 256, 4, 2, 64),      # GQA 2x
    (1, 384, 8, 2, 32),      # GQA 4x, non-pow2 seq blocks
])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_plain_matches_pallas_interpret(B, S, H, KV, D, name, jdt, tdt, tol):
    """Tolerances of tests/test_kernels.py: sums run in another order
    (5e-6 in float32); bf16 rounds the probabilities at another place."""
    (q, k, v), (qt, kt, vt) = _qkv(B, S, S, H, KV, D, jdt, tdt, 0)
    ref = j_ops.flash_attention(q, k, v, causal=True, impl="interpret",
                                bq=128, bk=128)
    out = t_ops.flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == tdt and tuple(out.shape) == (B, S, H, D)
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=tol)


def test_plain_matches_pallas_interpret_noncausal():
    (q, k, v), (qt, kt, vt) = _qkv(2, 128, 128, 2, 2, 32, jnp.float32,
                                   torch.float32, 1)
    ref = j_ops.flash_attention(q, k, v, causal=False, impl="interpret",
                                bq=64, bk=64)
    out = t_ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=5e-6)


@pytest.mark.parametrize("S,T,causal", [(33, 33, True), (273, 273, True),
                                        (33, 50, False), (1, 1, True)])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_plain_matches_jnp_reference_at_ragged_lengths(S, T, causal, name,
                                                       jdt, tdt, tol):
    """273 = 256 patches + 17 tokens is the served sequence; the Pallas
    kernel asserts ``S % block == 0`` there, so the jnp reference stands
    in."""
    (q, k, v), (qt, kt, vt) = _qkv(1, S, T, 4, 2, 16, jdt, tdt, 2)
    ref = j_ref.attention(q, k, v, causal=causal)
    out = t_ops.flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=tol)
    assert t_ops.flash_attention.launches == 0     # CPU: no kernel launched


# ------------------------------------- the kernel's arithmetic, written out
LOG2E = 1.4426950408889634
BQ = BK = 64                 # query rows per block, keys per K/V tile


def _kernel_arithmetic(q, k, v, causal):
    """What csrc/flash_attention.cu computes, in PyTorch: 64-row query
    tiles, heaviest first as the grid runs them, each walking 64-key K/V
    tiles in order up to its diagonal when causal; an online softmax in
    exp2 units with ``D^-0.5 * log2 e`` folded into one multiply, float32
    (m, l, acc), p = 0 while m <= -0.5e30, p rounded to v's type before
    p . v while l sums the unrounded p, l == 0 -> 1.  GQA by index: query
    head h reads KV head h // group.  (The float32 kernel walks the same
    tiles with exp in natural units.)"""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    kv_of = torch.arange(H) // (H // KV)
    kk, vv = k[:, :, kv_of].float(), v[:, :, kv_of]
    scale_log2 = float(torch.tensor(D ** -0.5) * LOG2E)
    out = torch.empty_like(q)
    for q0 in reversed(range(0, S, BQ)):
        rows = torch.arange(q0, min(q0 + BQ, S))
        qf = q[:, q0:q0 + BQ].float()
        m = torch.full((B, len(rows), H), -1e30)
        l = torch.zeros((B, len(rows), H))
        acc = torch.zeros((B, len(rows), H, D))
        k_end = min(T, q0 + BQ) if causal else T
        for k0 in range(0, k_end, BK):
            cols = torch.arange(k0, min(k0 + BK, T))
            s = torch.einsum("brhd,bthd->brht", qf,
                             kk[:, k0:k0 + BK]) * scale_log2
            if causal:
                s = s.masked_fill((cols[None, :] > rows[:, None])[None, :,
                                                                   None],
                                  -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where((m_new <= -0.5e30)[..., None], 0.0,
                            torch.exp2(s - m_new[..., None]))
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "brht,bthd->brhd", p.to(v.dtype).float(),
                vv[:, k0:k0 + BK].float())
            m = m_new
        l = torch.where(l == 0, 1.0, l)
        out[:, q0:q0 + BQ] = (acc / l[..., None]).to(q.dtype)
    return out


@pytest.mark.parametrize("S", [17, 273])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tdt,tol", [(torch.float32, 1e-5),
                                     (torch.bfloat16, 2e-2)])
def test_kernel_arithmetic_matches_the_plain_version(S, causal, tdt, tol):
    """17 tokens (serve_lm's requests) is less than one query tile; 273
    (the VLA sequence) ends in a ragged tile of 17 rows."""
    g = torch.Generator().manual_seed(S + causal)
    q = torch.randn((2, S, 6, 32), generator=g).to(tdt)
    k = torch.randn((2, S, 2, 32), generator=g).to(tdt)
    v = torch.randn((2, S, 2, 32), generator=g).to(tdt)
    got = _kernel_arithmetic(q, k, v, causal)
    want = t_ops.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(t2np(got), t2np(want), atol=tol)
