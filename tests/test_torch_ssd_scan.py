"""Port parity: the plain version of ``repro_torch``'s SSD scan against the
Pallas kernel of the JAX package (interpret mode), its jnp reference and
the per-token recurrence; the kernels' arithmetic (chunk states in
parallel, the state passed between chunks, row-block outputs, decays from
differences, bf16 pieces of the float32 operands, zero padding past T),
written out in PyTorch, against the plain version; the launch plan; the
wrapper's checks."""
import contextlib
import pathlib
import re
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

# (B, T, H, P, N, chunk): tests/test_kernels.py's sweep, the reduced
# configs' widths, a ragged T and a T shorter than one chunk
SWEEP = [(2, 128, 3, 16, 32, 32), (1, 256, 2, 32, 16, 64),
         (1, 64, 1, 8, 8, 64)]
SHAPES = SWEEP + [(2, 70, 8, 16, 16, 32),      # reduced mamba2 / zamba2
                  (1, 100, 2, 16, 32, 32),     # ragged: 3 chunks + 4
                  (2, 17, 3, 8, 16, 64)]       # T < chunk
IDS = [f"B{b}T{t}H{h}P{p}N{n}c{c}" for b, t, h, p, n, c in SHAPES]
# bf16 pieces of y's float32 operands for bf16 inputs, as the CUDA source
# fixes them (OutPieces<bf16>)
Y_PIECES = int(re.search(
    r"struct OutPieces<bf16> \{ static constexpr int value = (\d); \}",
    (pathlib.Path(t_ops.__file__).parents[1] / "csrc" / "ssd_scan.cu"
     ).read_text()).group(1))


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
def _pieces(v, n):
    """v (float32) as n bf16 pieces, each held in float32: v - sum of the
    pieces is below 2^-8n of |v|; a bf16 v is its own single piece."""
    out, r = [], v.float()
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def _mm(a, b, pa, pb):
    """a @ b as the kernel's tensor cores take it: a in ``pa`` bf16 pieces,
    b in ``pb``, the cross products of order below max(pa, pb) summed in
    float32 (the bf16 products are exact)."""
    A, Bp, m = _pieces(a, pa), _pieces(b, pb), max(pa, pb)
    return sum(A[i] @ Bp[j] for i in range(pa) for j in range(pb)
               if i + j < m)


def _kernel_arithmetic(x, dt, A, Bm, Cm, chunk):
    """What csrc/ssd_scan.cu computes, in PyTorch.  (1) Per (batch, head,
    chunk), with no dependency between chunks: the cumsum of dt * A
    accumulated in float64 and rounded once, and the chunk's own state
    B^T @ (x dt exp(cs_last - cs)) over 64-position key blocks.  (2) The
    state passed from chunk to chunk, S * exp(cs_last) + S_c, the state
    entering each chunk kept (the kernel folds this into the staging of
    (3)).  (3) Per (batch, head, chunk, 64-row block): exp(cs) (C @ S_in),
    then for each key block at or below the diagonal the scores C B_j^T
    (one 64 x 64 tile, which the kernel computes once per (batch, chunk)
    for all heads), the decay exp(cs_i - cs_j) taken for i >= j alone,
    times x dt; y rounded to x's type once.  For bf16 inputs every product
    takes its operands as bf16 pieces on the tensor cores: B and C one
    piece (they are exact), the chunk states' float32 operand three, y's
    float32 operands ``Y_PIECES``.  For float32 inputs the kernels run scalar
    float32 FMAs on operands rebuilt exactly from three pieces, which three
    pieces of every operand here reproduce.  Positions past T are zeros."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    R = t_ops.ROWS
    bf = x.dtype == torch.bfloat16
    pc, pv = (1, Y_PIECES) if bf else (3, 3)
    plan = t_ops.launch_plan(B, T, H, P, N, chunk)
    nc = plan.n_chunks
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    ws_state = torch.zeros((B, H, nc, N, P))
    ws_cs = torch.zeros((B, H, nc, chunk))
    y = torch.zeros((B, T, H, P), dtype=x.dtype)
    state = torch.zeros((B, H, N, P))

    def span(c):
        return c * chunk, min(chunk, T - c * chunk)

    for b in range(B):                            # (1) chunk states
        for h in range(H):
            for c in range(nc):
                c0, qe = span(c)
                d = dtf[b, c0:c0 + qe, h]
                cs = torch.cumsum((d * A[h].float()).double(), 0).float()
                ws_cs[b, h, c, :qe] = cs
                w = torch.exp(cs[qe - 1] - cs)
                for j0 in range(0, qe, R):
                    j1 = min(j0 + R, qe)
                    v = xf[b, c0 + j0:c0 + j1, h] * d[j0:j1, None] \
                        * w[j0:j1, None]
                    ws_state[b, h, c] += _mm(Bf[b, c0 + j0:c0 + j1].T, v,
                                             pc, 3)
    for b in range(B):                            # (2) state passing
        for h in range(H):
            S = torch.zeros((N, P))
            for c in range(nc):
                _, qe = span(c)
                v = ws_state[b, h, c].clone()
                ws_state[b, h, c] = S
                S = S * torch.exp(ws_cs[b, h, c, qe - 1]) + v
            state[b, h] = S
    for b in range(B):                            # (3) outputs
        for h in range(H):
            for c in range(nc):
                c0, qe = span(c)
                cs = ws_cs[b, h, c]
                d = dtf[b, c0:c0 + qe, h]
                for i0 in range(0, qe, R):
                    i1 = min(i0 + R, qe)
                    ii = torch.arange(i0, i1)
                    Ci = Cf[b, c0 + i0:c0 + i1]
                    acc = torch.zeros((i1 - i0, P))
                    if c > 0:
                        acc = _mm(Ci, ws_state[b, h, c], pc, pv) \
                            * torch.exp(cs[ii])[:, None]
                    for j0 in range(0, i1, R):
                        j1 = min(j0 + R, qe)
                        jj = torch.arange(j0, j1)
                        sc = _mm(Ci, Bf[b, c0 + j0:c0 + j1].T, pc, pc)
                        keep = ii[:, None] >= jj[None, :]
                        diff = torch.where(keep, cs[ii][:, None]
                                           - cs[jj][None, :],
                                           torch.zeros(()))
                        assert diff.max() <= 0    # no exp of a positive
                        sc = torch.where(keep, sc * torch.exp(diff),
                                         torch.zeros(()))
                        xdt = xf[b, c0 + j0:c0 + j1, h] * d[j0:j1, None]
                        acc = acc + _mm(sc, xdt, pv, pv)
                    y[b, c0 + i0:c0 + i1, h] = acc.to(x.dtype)
    return y, state


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 300, 2, 64, 16, 256),     # served chunk and head dim, a ragged chunk
    (1, 130, 2, 16, 8, 128),      # row blocks 64 + 64 + 2
    (2, 17, 3, 8, 16, 32),        # T < chunk, one ragged row block
    (1, 100, 2, 32, 32, 40),      # chunk no multiple of the row block
    (1, 160, 2, 64, 128, 128),    # Mamba2's N and P, two chunks
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


def test_bf16_kernel_arithmetic_holds_the_card_limits():
    """bf16 inputs at the kernel's pieces, Mamba2's N and P, two chunks of
    the served 256: against the plain version fed the same inputs upcast,
    the limits chip_smoke.py holds the kernel to on the card — the state
    within 2e-5 of max(1, its largest value), y within two bf16 units of
    its largest value."""
    B, T, H, P, N, chunk = 1, 300, 2, 64, 128, 256
    (_, _, A, _, _), (x, dt, _, Bm, Cm) = _inputs(B, T, H, P, N, 21,
                                                  jnp.bfloat16)
    A = torch.from_numpy(np.array(to_np(A)))
    got_y, got_s = _kernel_arithmetic(x, dt, A, Bm, Cm, chunk)
    want_y, want_s = t_ops.ssd_scan_plain(x.float(), dt, A, Bm.float(),
                                          Cm.float(), chunk)
    assert got_y.dtype == torch.bfloat16
    s_max = want_s.abs().max().item()
    y_max = want_y.abs().max().item()
    assert (got_s - want_s).abs().max().item() <= 2e-5 * max(1.0, s_max)
    assert (got_y.float() - want_y).abs().max().item() <= 2 * 2.0 ** -8 \
        * y_max


@pytest.mark.parametrize("shape,want", [
    # Mamba2-1.3B and Zamba2-1.2B at their served widths, batch 1 and 4:
    # 10 C B^T tiles a (batch, chunk) of 256, 512 output blocks at batch 1
    ((1, 512, 64, 64, 128, 256), ((74, 2, 2), (64, 2, 4), 2)),
    ((4, 512, 64, 64, 128, 256), ((296, 2, 2), (256, 2, 4), 2)),
    ((1, 512, 64, 64, 64, 256), ((74, 2, 1), (64, 2, 4), 2)),
    ((4, 512, 64, 64, 64, 256), ((296, 2, 1), (256, 2, 4), 2)),
    ((1, 300, 2, 16, 32, 256), ((12, 2, 1), (2, 2, 4), 2)),    # ragged
    ((2, 17, 3, 8, 16, 64), ((8, 1, 1), (6, 1, 1), 1)),        # T < chunk
    ((1, 5, 1, 8, 8, 1), ((2, 5, 1), (1, 5, 1), 5)),           # chunk 1
    ((1, 100, 2, 32, 32, 40), ((3, 3, 1), (2, 3, 1), 3)),
])
def test_launch_plan_cuts_the_scan_for_the_card(shape, want):
    B, T, H, P, N, chunk = shape
    plan = t_ops.launch_plan(B, T, H, P, N, chunk)
    assert (plan.state_grid, plan.out_grid, plan.n_chunks) == want
    assert plan.ws_state == B * H * plan.n_chunks * N * P
    assert plan.ws_cs == B * H * plan.n_chunks * chunk
    assert plan.ws_cb == B * plan.n_chunks * (plan.out_grid[2] * 64) ** 2


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
    monkeypatch.setattr(t_ops.torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(t_ops.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(t_ops.ssd_scan, "launches", 0)
    return fake


def test_a_cuda_tensor_launches_the_kernel_in_the_model_layout(fake_card):
    """Mamba2-1.3B's served widths at batch 1: x read where the model keeps
    it (a view of the conv output, no copy), the launch plan's chunk count
    and one fresh float32 workspace of its three sizes (C B^T on a 16-byte
    boundary); the launch is counted."""
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
    assert a[5:7] == (y.data_ptr(), s.data_ptr())
    plan = t_ops.launch_plan(B, T, H, P, N, 256)
    assert a[8] - a[7] == 4 * plan.ws_state        # one float32 workspace
    assert a[9] - a[8] == 4 * plan.ws_cs and a[9] % 16 == 0
    assert a[10:17] == (B, T, H, P, N, 256, 2)
    assert a[17:20] == (T * H * P, H * P, P)               # x
    assert a[20:22] == (T * H, H)                          # dt
    assert a[22:26] == (T * N, N, T * N, N)                # B, C
    assert a[26] == 1                                      # bfloat16
    assert len(a) == len(_build.SIGNATURES["rt_ssd_scan"])
    assert t_ops.ssd_scan.launches == 1
    t_ops.ssd_scan(x.expand(4, T, H, P).contiguous(), dt.expand(4, T, H),
                   A, Bm.expand(4, T, N), Bm.expand(4, T, N), chunk=200)
    b = fake_card.calls[-1][1]
    assert b[10:17] == (4, T, H, P, N, 200, 3)
    assert b[9] - b[8] == 4 * 4 * 64 * 3 * 200      # 16-byte aligned already


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
