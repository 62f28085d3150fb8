"""Port parity: the plain version of ``repro_torch``'s flash-decode against
the Pallas kernel of the JAX package (interpret mode) and its jnp
reference; the kernel's split-and-combine arithmetic, written out in
PyTorch, against the plain version; the wrapper's checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_ops, ref as j_ref
from repro_torch.kernels.decode_attention import ops as t_ops

from _torch_port_util import t2np, to_np

H100_SMS = 132       # the split plan of an H100 SXM

DTYPES = [("float32", jnp.float32, torch.float32, 1e-5),
          ("bfloat16", jnp.bfloat16, torch.bfloat16, 2e-2)]
SHAPES = [(2, 4, 2, 256, 32), (1, 8, 8, 512, 64)]    # tests/test_kernels.py


def _qkv(B, H, KV, T, D, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for shape in ((B, H, D), (B, KV, T, D), (B, KV, T, D)):
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        ).astype(jdt)
        out_j.append(a)
        out_t.append(torch.from_numpy(np.array(to_np(a))).to(tdt))
    return out_j, out_t


@pytest.mark.parametrize("kv_len", [1, 7, 100, 256])
@pytest.mark.parametrize("B,H,KV,T,D", SHAPES)
def test_plain_matches_pallas_interpret(B, H, KV, T, D, kv_len):
    """The sweep and tolerance of tests/test_kernels.py (float32, 1e-5)."""
    (q, k, v), (qt, kt, vt) = _qkv(B, H, KV, T, D, jnp.float32,
                                   torch.float32, kv_len)
    ref = j_ops.decode_attention(q, k, v, jnp.int32(kv_len),
                                 impl="interpret", bk=128)
    out = t_ops.decode_attention(qt, kt, vt, kv_len)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, 1, H, D)
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=1e-5)


@pytest.mark.parametrize("kv_len", [1, 7, 100, 256])
@pytest.mark.parametrize("B,H,KV,T,D", SHAPES)
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_plain_matches_jnp_reference(B, H, KV, T, D, kv_len, name, jdt, tdt,
                                     tol):
    (q, k, v), (qt, kt, vt) = _qkv(B, H, KV, T, D, jdt, tdt, 100 + kv_len)
    ref = j_ref.decode_attention(q, k, v, kv_len)
    out = t_ops.decode_attention(qt, kt, vt, kv_len)
    assert out.dtype == tdt
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=tol)


def test_plain_matches_pallas_interpret_bf16():
    """tests/test_kernels.py::test_decode_attention_bf16: q given as
    (B, H, D) after dropping the token axis, kv_len 200, 2e-2."""
    (q, k, v), (qt, kt, vt) = _qkv(2, 4, 2, 256, 32, jnp.bfloat16,
                                   torch.bfloat16, 3)
    ref = j_ops.decode_attention(q, k, v, jnp.int32(200), impl="interpret",
                                 bk=128)
    out = t_ops.decode_attention(qt, kt, vt, 200)
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=2e-2)


@pytest.mark.parametrize("kv_len", [1, 100, 200])
@pytest.mark.parametrize("name,jdt,tdt,tol", DTYPES)
def test_ragged_buffer_against_jnp_reference(kv_len, name, jdt, tdt, tol):
    """T = 200 is no multiple of the Pallas kernel's block (it asserts);
    the served buffer (prompt + steps) is ragged too."""
    (q, k, v), (qt, kt, vt) = _qkv(1, 6, 2, 200, 16, jdt, tdt, kv_len)
    ref = j_ref.decode_attention(q, k, v, kv_len)
    out = t_ops.decode_attention(qt[:, None], kt, vt, torch.tensor(kv_len))
    np.testing.assert_allclose(t2np(out), to_np(ref), atol=tol)


# ------------------------------------- the kernel's arithmetic, written out
LOG2E = 1.4426950408889634
WARPS, WARP_KEYS = 4, 16     # bf16: each 64-key tile shared out to 4 warps
F32_TILE = 32                # float32: the block's 32-key tiles


def _online(qf, kk, vv, steps, scale, exp):
    """One online softmax of a query row over ``steps`` (ranges of keys,
    one per step): float32 (m, l, acc), p rounded to v's type before p . v
    while l sums the unrounded p.  An empty step changes nothing."""
    m, l, acc = -1e30, torch.tensor(0.0), torch.zeros(qf.shape[0])
    for r in steps:
        if not len(r):
            continue
        sc = (kk[r.start:r.stop] @ qf) * scale
        m_new = max(m, sc.max().item())
        p = exp(sc - m_new)
        alpha = exp(torch.tensor(m - m_new))
        l = alpha * l + p.sum()
        acc = alpha * acc + p.to(vv.dtype).float() @ vv[r.start:r.stop].float()
        m = m_new
    return m, l, acc


def _merge(states, exp):
    """(m, l, acc) states merged by log-sum-exp, in the order given."""
    m = max(sm for sm, _, _ in states)
    w = [exp(torch.tensor(sm - m)) for sm, _, _ in states]
    return (m, sum(wi * sl for wi, (_, sl, _) in zip(w, states)),
            sum(wi * sa for wi, (_, _, sa) in zip(w, states)))


def _kernel_arithmetic(q, k, v, kv_len):
    """What csrc/decode_attention.cu computes, in PyTorch.  The KV axis is
    cut by ``split_plan``.  bfloat16: each split's 64-key tiles are shared
    out to four warps of 16 keys; each warp runs its own online softmax in
    exp2 units (scale * log2 e folded into one multiply) and the four merge
    at the end of the split, warp 0 to 3.  float32: one online softmax over
    32-key tiles in exp.  Where more than one split is live, the last to
    arrive merges every live split's state in split order, so the order does
    not depend on which block came last; one live split is its own output.
    Dead splits are never read."""
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    chunk, n_split = t_ops.split_plan(T, B * KV, H100_SMS)
    L = min(int(kv_len), T)
    bf16 = q.dtype == torch.bfloat16
    exp = torch.exp2 if bf16 else torch.exp
    scale = float(torch.tensor(D ** -0.5) * LOG2E) if bf16 else D ** -0.5
    out = torch.empty((B, 1, H, D), dtype=q.dtype)
    for b in range(B):
        for h in range(H):
            qf = q[b, h].float()
            kk, vv = k[b, h // G].float(), v[b, h // G]
            parts = []
            for s in range(n_split):
                lo = s * chunk
                if lo >= L:
                    continue
                hi = min(lo + chunk, L)
                if bf16:
                    lanes = [[range(min(t0 + WARP_KEYS * w, hi),
                                    min(t0 + WARP_KEYS * (w + 1), hi))
                              for t0 in range(lo, hi, t_ops.TILE)]
                             for w in range(WARPS)]
                else:
                    lanes = [[range(t0, min(t0 + F32_TILE, hi))
                              for t0 in range(lo, hi, F32_TILE)]]
                parts.append(_merge([_online(qf, kk, vv, steps, scale, exp)
                                     for steps in lanes], exp))
            _, l, acc = parts[0] if len(parts) == 1 else _merge(parts, exp)
            out[b, 0, h] = (acc / (l if l != 0 else 1.0)).to(q.dtype)
    return out


@pytest.mark.parametrize("B,H,KV,T,D,kv_len", [
    (1, 24, 8, 576, 16, 513),    # the served 3 x GQA and buffer, narrow heads
    (2, 4, 2, 256, 32, 100),
    (1, 2, 1, 200, 16, 200),     # ragged buffer, every key live
    (1, 3, 1, 1000, 16, 33),     # several splits, all but one dead
    (1, 32, 2, 300, 32, 290),    # GQA 16x: a full 16-row group, ragged tail
])
@pytest.mark.parametrize("tdt,tol", [(torch.float32, 1e-5),
                                     (torch.bfloat16, 2e-2)])
def test_kernel_arithmetic_matches_the_plain_version(B, H, KV, T, D, kv_len,
                                                     tdt, tol):
    g = torch.Generator().manual_seed(T + kv_len)
    q, k, v = (torch.randn(s, generator=g).to(tdt)
               for s in ((B, H, D), (B, KV, T, D), (B, KV, T, D)))
    chunk, n_split = t_ops.split_plan(T, B * KV, H100_SMS)
    assert n_split > 1                   # the merge is exercised
    got = _kernel_arithmetic(q, k, v, kv_len)
    want = t_ops.decode_attention_plain(q, k, v, kv_len)
    np.testing.assert_allclose(t2np(got), t2np(want), atol=tol)


@pytest.mark.parametrize("T,n_bkv", [(1, 1), (31, 8), (32, 8), (576, 8),
                                     (576, 32), (8192, 8), (8192, 1),
                                     (200, 2), (100000, 4)])
def test_split_plan_covers_the_buffer_in_whole_tiles(T, n_bkv):
    chunk, n_split = t_ops.split_plan(T, n_bkv, H100_SMS)
    assert chunk % t_ops.TILE == 0 and chunk > 0
    assert (n_split - 1) * chunk < T <= n_split * chunk
    assert n_split <= 65535
    if T >= 2 * t_ops.TILE * H100_SMS:            # enough tiles for a wave
        assert n_split * n_bkv <= t_ops.BLOCKS_PER_SM * H100_SMS


def test_split_plan_at_the_served_shapes():
    """Batch 1 and 4 of Llama-3.2-3B (8 KV heads) and Zamba2-1.2B (32) at
    the 576-position buffer, and an 8192-position cache: as many splits as
    one wave of two blocks per SM holds, never more, where the buffer has
    that many 64-key tiles, else one tile per split."""
    assert t_ops.TILE == 64 and t_ops.BLOCKS_PER_SM == 2
    assert t_ops.split_plan(576, 8, H100_SMS) == (64, 9)
    assert t_ops.split_plan(576, 32, H100_SMS) == (128, 5)
    assert t_ops.split_plan(576, 128, H100_SMS) == (320, 2)
    assert t_ops.split_plan(8192, 8, H100_SMS) == (256, 32)
    assert t_ops.split_plan(8192, 1, H100_SMS) == (64, 128)
    assert t_ops.split_plan(8192, 8, 66) == (512, 16)     # half the SMs


def test_token_axis_and_tensor_kv_len_are_taken():
    (_, _, _), (q, k, v) = _qkv(2, 4, 2, 64, 16, jnp.float32, torch.float32, 9)
    a = t_ops.decode_attention(q, k, v, 40)
    b = t_ops.decode_attention(q[:, None], k, v, torch.tensor(40))
    c = t_ops.decode_attention(q, k, v, 4000)          # past T: all of it
    d = t_ops.decode_attention(q, k, v, 64)
    assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.parametrize("bad", [0, -3])
def test_an_empty_cache_raises(bad):
    q = torch.zeros((1, 2, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="empty cache"):
        t_ops.decode_attention(q, k, k, bad)
    with pytest.raises(TypeError):
        t_ops.decode_attention(q, k, k, torch.tensor([1.5]))
