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
