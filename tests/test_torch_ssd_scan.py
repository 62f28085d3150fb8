"""Port parity: the plain version of ``repro_torch``'s SSD scan against the
Pallas kernel of the JAX package (interpret mode), its jnp reference and
the per-token recurrence; the kernel's arithmetic (row blocks, decays from
differences, the carried state, column tiles, zero padding past T),
written out in PyTorch, against the plain version; the wrapper's checks."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as j_ops, ref as j_ref
from repro.models.ssm import ssd_chunked as j_ssd_chunked, \
    ssd_step as j_ssd_step
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ops as t_ops
from repro_torch.models.ssm import ssd_chunked, ssd_step

from _torch_port_util import t2np, to_np

H100_SMS = 132       # the column tiling of an H100 SXM

# (B, T, H, P, N, chunk): tests/test_kernels.py's sweep, the reduced
# configs' widths, a ragged T and a T shorter than one chunk
SWEEP = [(2, 128, 3, 16, 32, 32), (1, 256, 2, 32, 16, 64),
         (1, 64, 1, 8, 8, 64)]
SHAPES = SWEEP + [(2, 70, 8, 16, 16, 32),      # reduced mamba2 / zamba2
                  (1, 100, 2, 16, 32, 32),     # ragged: 3 chunks + 4
                  (2, 17, 3, 8, 16, 64)]       # T < chunk
IDS = [f"B{b}T{t}H{h}P{p}N{n}c{c}" for b, t, h, p, n, c in SHAPES]


def _inputs(B, T, H, P, N, seed, jdt=jnp.float32):
    """The distribution of tests/test_kernels.py, drawn with numpy:
    x * 0.5, dt = softplus(normal), A = -exp(0.3 normal), B and C * 0.3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, T, N)).astype(np.float32) * 0.3
    j = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm).astype(jdt), jnp.asarray(Cm).astype(jdt)]
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    t = [torch.from_numpy(np.array(to_np(a))) for a in j]
    t[0], t[3], t[4] = t[0].to(tdt), t[3].to(tdt), t[4].to(tdt)
    return j, t


@pytest.mark.parametrize("B,T,H,P,N,chunk", SWEEP, ids=IDS[:3])
def test_plain_matches_pallas_interpret(B, T, H, P, N, chunk):
    """The sweep and tolerance of tests/test_kernels.py (float32, 2e-5)."""
    (x, dt, A, Bm, Cm), t = _inputs(B, T, H, P, N, 4)
    y_ref, s_ref = j_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                  impl="interpret")
    y, s = t_ops.ssd_scan(*t, chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert tuple(y.shape) == (B, T, H, P) and tuple(s.shape) == (B, H, N, P)
    np.testing.assert_allclose(t2np(y), to_np(y_ref), atol=2e-5)
    np.testing.assert_allclose(t2np(s), to_np(s_ref), atol=2e-5)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SHAPES, ids=IDS)
def test_plain_matches_jnp_reference(B, T, H, P, N, chunk):
    (x, dt, A, Bm, Cm), t = _inputs(B, T, H, P, N, T + N)
    y_ref, s_ref = j_ref.ssd(x, dt, A, Bm, Cm, chunk)
    y, s = t_ops.ssd_scan(*t, chunk=chunk)
    np.testing.assert_allclose(t2np(y), to_np(y_ref), atol=2e-5)
    np.testing.assert_allclose(t2np(s), to_np(s_ref), atol=2e-5)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SHAPES[3:], ids=IDS[3:])
def test_plain_matches_pallas_interpret_ragged(B, T, H, P, N, chunk):
    """The reference wrapper pads a ragged T (and runs T < chunk as one
    chunk of T) before its Pallas kernel: the same answer."""
    (x, dt, A, Bm, Cm), t = _inputs(B, T, H, P, N, 7 * T)
    y_ref, s_ref = j_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                  impl="interpret")
    y, s = t_ops.ssd_scan(*t, chunk=chunk)
    np.testing.assert_allclose(t2np(y), to_np(y_ref), atol=2e-5)
    np.testing.assert_allclose(t2np(s), to_np(s_ref), atol=2e-5)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [(1, 48, 2, 8, 16, 16),
                                             (2, 40, 3, 16, 16, 32)])
def test_state_equals_the_per_token_recurrence(B, T, H, P, N, chunk):
    """tests/test_kernels.py::test_ssd_state_equals_sequential (1e-4): the
    port's chunked scan against the port's ``ssd_step`` and the
    reference's, token by token."""
    (x, dt, A, Bm, Cm), t = _inputs(B, T, H, P, N, 5)
    y_k, s_k = t_ops.ssd_scan(*t, chunk=chunk)
    S_t = torch.zeros((B, H, N, P))
    S_j = jnp.zeros((B, H, N, P))
    ys_t, ys_j = [], []
    for i in range(T):
        y, S_t = ssd_step(S_t, t[0][:, i], t[1][:, i], t[2], t[3][:, i],
                          t[4][:, i])
        ys_t.append(y)
        yj, S_j = j_ssd_step(S_j, x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i])
        ys_j.append(yj)
        np.testing.assert_allclose(t2np(y), to_np(yj), atol=1e-5)
    np.testing.assert_allclose(t2np(S_t), to_np(S_j), atol=1e-5)
    np.testing.assert_allclose(t2np(s_k), t2np(S_t), atol=1e-4)
    np.testing.assert_allclose(t2np(y_k), t2np(torch.stack(ys_t, 1)),
                               atol=1e-4)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [(2, 128, 3, 16, 32, 32),
                                             (1, 100, 4, 16, 16, 32),
                                             (1, 300, 2, 16, 32, 256)])
def test_bf16_plain_matches_the_jnp_reference(B, T, H, P, N, chunk):
    """In bfloat16 the plain version rounds xdt, the scores and the
    incoming chunk states to bf16 where the reference does; the two agree
    within 2e-2 (a few bf16 steps of outputs of order 1), the state (float32
    in both) within 2e-2 as well."""
    (x, dt, A, Bm, Cm), t = _inputs(B, T, H, P, N, 11, jnp.bfloat16)
    y_ref, s_ref = j_ssd_chunked(x, dt, A, Bm, Cm, chunk)
    y, s = ssd_chunked(*t, chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(t2np(y), to_np(y_ref), atol=2e-2)
    np.testing.assert_allclose(t2np(s), to_np(s_ref), atol=2e-2)


def test_initial_state_matches_the_reference():
    (x, dt, A, Bm, Cm), t = _inputs(1, 50, 2, 8, 16, 3)
    s0 = np.random.default_rng(9).standard_normal((1, 2, 16, 8)).astype(
        np.float32)
    y_ref, s_ref = j_ssd_chunked(x, dt, A, Bm, Cm, 16,
                                 initial_state=jnp.asarray(s0))
    y, s = ssd_chunked(*t, 16, initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(t2np(y), to_np(y_ref), atol=2e-5)
    np.testing.assert_allclose(t2np(s), to_np(s_ref), atol=2e-5)


# ------------------------------------- the kernel's arithmetic, written out
def _kernel_arithmetic(x, dt, A, Bm, Cm, chunk, n_sm=H100_SMS):
    """What csrc/ssd_scan.cu computes, in float32 PyTorch: one program per
    (batch, head, column tile of ``p_tile``), the chunks in order with the
    state carried, the cumsum of dt * A per chunk, each chunk cut into row
    blocks of ``ROWS`` positions, the cumsum of dt * A accumulated in
    float64 and rounded once, scores only for key blocks at or below
    the diagonal with the decay exp(cs_i - cs_j) taken for i >= j alone,
    positions past T read as zeros, y rounded to x's type once."""
    B, T, H, P = x.shape
    R = t_ops.ROWS
    pt = t_ops.p_tile(P, B * H, n_sm)
    y = torch.zeros((B, T, H, P), dtype=x.dtype)
    state = torch.zeros((B, H, Bm.shape[-1], P))
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    for b in range(B):
        for h in range(H):
            for p0 in range(0, P, pt):
                p1 = min(p0 + pt, P)
                S = torch.zeros((Bm.shape[-1], p1 - p0))
                for c0 in range(0, T, chunk):
                    qe = min(chunk, T - c0)
                    d = torch.zeros(t_ops.MAX_CHUNK)     # one per thread
                    d[:qe] = dtf[b, c0:c0 + qe, h]
                    cs = torch.cumsum((d * A[h].float()).double(),
                                      0).float()
                    cs_last = cs[qe - 1]
                    nb = -(-qe // R)

                    def rows(t, j0):           # positions j0.. of the chunk
                        out = torch.zeros((R,) + t.shape[1:])
                        n = min(R, qe - j0)
                        out[:n] = t[c0 + j0:c0 + j0 + n]
                        return out

                    for ib in range(nb):
                        i0 = ib * R
                        Ci = rows(Cf[b], i0)
                        ii = i0 + torch.arange(R)
                        acc = (Ci @ S) * torch.exp(cs[ii])[:, None]
                        for jb in range(ib + 1):
                            j0 = jb * R
                            jj = j0 + torch.arange(R)
                            xdt = rows(xf[b, :, h, p0:p1], j0) * d[jj, None]
                            sc = Ci @ rows(Bf[b], j0).T
                            keep = ii[:, None] >= jj[None, :]
                            diff = torch.where(keep, cs[ii][:, None]
                                               - cs[jj][None, :],
                                               torch.zeros(()))
                            sc = torch.where(keep, sc * torch.exp(diff),
                                             torch.zeros(()))
                            assert diff.max() <= 0    # no exp of a positive
                            acc = acc + sc @ xdt
                        n = min(R, qe - i0)
                        y[b, c0 + i0:c0 + i0 + n, h, p0:p1] = \
                            acc[:n].to(x.dtype)
                    w = torch.exp(cs_last - cs)
                    upd = torch.zeros_like(S)
                    for jb in range(nb):
                        j0 = jb * R
                        jj = j0 + torch.arange(R)
                        wx = rows(xf[b, :, h, p0:p1], j0) * (d[jj] * w[jj]
                                                             )[:, None]
                        upd = upd + rows(Bf[b], j0).T @ wx
                    S = torch.exp(cs_last) * S + upd
                state[b, h, :, p0:p1] = S
    return y, state


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 300, 2, 64, 16, 256),     # served chunk and head dim, 2 column tiles
    (1, 130, 2, 16, 8, 128),      # row blocks 64 + 64 + 2, one column tile
    (2, 17, 3, 8, 16, 32),        # T < chunk, one ragged row block
    (1, 100, 2, 32, 32, 40),      # chunk no multiple of the row block
])
def test_kernel_arithmetic_matches_the_plain_version(B, T, H, P, N, chunk):
    (_, _, A, _, _), (x, dt, _, Bm, Cm) = _inputs(B, T, H, P, N, T)
    A = torch.from_numpy(np.array(to_np(A)))
    got_y, got_s = _kernel_arithmetic(x, dt, A, Bm, Cm, chunk)
    want_y, want_s = t_ops.ssd_scan_plain(x, dt, A, Bm, Cm, chunk)
    np.testing.assert_allclose(t2np(got_y), t2np(want_y), atol=2e-5)
    np.testing.assert_allclose(t2np(got_s), t2np(want_s), atol=2e-5)


def test_kernel_arithmetic_survives_a_long_decayed_chunk():
    """A = -1 (``A_log`` initialised to zero) and dt about 0.7 take the
    cumulative dA of a 256-position chunk to about -180: exp(-cs_j) would
    overflow float32, the differences the kernel takes do not."""
    B, T, H, P, N = 1, 256, 1, 8, 8
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, T, H, P)).astype(np.float32))
    dt = torch.full((B, T, H), 0.7)
    A = -torch.ones(H)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, T, N)).astype(
        np.float32)) * 0.3 for _ in range(2))
    assert torch.isinf(torch.exp(-torch.cumsum(dt[0, :, 0] * A, 0)[-1]))
    got_y, got_s = _kernel_arithmetic(x, dt, A, Bm, Cm, 256)
    want_y, want_s = t_ops.ssd_scan_plain(x, dt, A, Bm, Cm, 256)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    np.testing.assert_allclose(t2np(got_y), t2np(want_y), atol=2e-5)
    np.testing.assert_allclose(t2np(got_s), t2np(want_s), atol=2e-5)


@pytest.mark.parametrize("P,n_bh,want", [(8, 1, 32), (16, 500, 32),
                                         (32, 4, 32), (64, 64, 32),
                                         (64, 131, 32), (64, 132, 64),
                                         (64, 256, 64)])
def test_p_tile_splits_a_head_only_when_the_card_is_not_full(P, n_bh, want):
    assert t_ops.p_tile(P, n_bh, H100_SMS) == want


# ------------------------------------------------------------ the wrapper
def test_a_cpu_tensor_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(t_ops.ssd_scan, "launches", 0)
    _, t = _inputs(1, 20, 2, 8, 16, 0)
    y, s = t_ops.ssd_scan(*t, chunk=8)
    want_y, want_s = ssd_chunked(*t, 8)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    assert t_ops.ssd_scan.launches == 0


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(t_ops, "_device_kind", lambda ts: "cuda")
    monkeypatch.setattr(t_ops, "sm_count", lambda d: H100_SMS)
    monkeypatch.setattr(t_ops.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(t_ops.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(t_ops.ssd_scan, "launches", 0)
    return fake


def test_a_cuda_tensor_launches_the_kernel_in_the_model_layout(fake_card):
    """Mamba2-1.3B's served widths at batch 1: x read where the model keeps
    it (a view of the conv output, no copy), 64 (batch, head) pairs, so the
    head dim runs as two 32-column tiles; the launch is counted."""
    B, T, H, P, N = 1, 512, 64, 64, 128
    xi = torch.zeros((B, T, H * P), dtype=torch.bfloat16)
    x = xi.reshape(B, T, H, P)
    dt = torch.zeros((B, T, H))
    A = -torch.ones(H)
    Bm = torch.zeros((B, T, N), dtype=torch.bfloat16)
    y, s = t_ops.ssd_scan(x, dt, A, Bm, Bm, chunk=256)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert tuple(s.shape) == (B, H, N, P) and s.dtype == torch.float32
    ((name, a),) = fake_card.calls
    assert name == "rt_ssd_scan" and a[0] == xi.data_ptr()
    assert a[7:14] == (B, T, H, P, N, 256, 32)
    assert a[14:17] == (T * H * P, H * P, P)               # x
    assert a[17:19] == (T * H, H)                          # dt
    assert a[19:23] == (T * N, N, T * N, N)                # B, C
    assert a[23] == 1                                      # bfloat16
    assert t_ops.ssd_scan.launches == 1
    t_ops.ssd_scan(x.expand(4, T, H, P).contiguous(), dt.expand(4, T, H),
                   A, Bm.expand(4, T, N), Bm.expand(4, T, N), chunk=256)
    assert fake_card.calls[-1][1][13] == 64     # 256 pairs fill the card


@pytest.mark.parametrize("N,P", [(48, 64), (256, 64), (128, 128), (64, 24)])
def test_an_uninstantiated_state_or_head_dim_raises_on_the_card(fake_card,
                                                                N, P):
    x = torch.zeros((1, 8, 2, P))
    Bm = torch.zeros((1, 8, N))
    with pytest.raises(ValueError, match="built for"):
        t_ops.ssd_scan(x, torch.zeros((1, 8, 2)), -torch.ones(2), Bm, Bm,
                       chunk=8)
    assert not fake_card.calls and t_ops.ssd_scan.launches == 0


def test_what_the_kernel_does_not_take_raises_before_a_launch(fake_card):
    x = torch.zeros((1, 8, 2, 16))
    dt, A, Bm = torch.zeros((1, 8, 2)), -torch.ones(2), torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="chunk"):
        t_ops.ssd_scan(x, dt, A, Bm, Bm, chunk=512)
    with pytest.raises(TypeError):
        t_ops.ssd_scan(x.half(), dt, A, Bm.half(), Bm.half(), chunk=8)
    with pytest.raises(TypeError):
        t_ops.ssd_scan(x, dt, A, Bm.bfloat16(), Bm, chunk=8)
    with pytest.raises(ValueError, match="belong together"):
        t_ops.ssd_scan(x, dt[:, :4], A, Bm, Bm, chunk=8)
    with pytest.raises(ValueError):
        t_ops.ssd_scan(x, dt, A, Bm, Bm[..., :8], chunk=8)
    assert not fake_card.calls and t_ops.ssd_scan.launches == 0


def test_a_device_with_no_version_raises():
    m = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        t_ops.ssd_scan(m, m[..., 0], m[0, 0, :, 0], m[..., 0, :],
                       m[..., 0, :], chunk=8)
    with pytest.raises(ValueError):                   # mixed devices
        t_ops.ssd_scan(torch.zeros(1, 8, 2, 16), m[..., 0], m[0, 0, :, 0],
                       m[..., 0, :], m[..., 0, :], chunk=8)
