"""The port's training losses and their gradients against the JAX
package's, and the backward of the two kernels the training forward
reaches (B5 flash attention, B7 the SSD scan).

Reduced configs in float32 with float32 parameters on both sides (the
JAX package's ``init_params`` converted with ``convert.from_numpy_tree``),
batches drawn with numpy from a seed; the JAX side runs at its default
``attn_impl="xla"``.  A VLA's random draws (the DiT's timesteps and noise,
the diffusion head's initial noise) are taken from the JAX key as the
reference takes them and handed to the port as numpy.  Tolerances: the
loss within 1e-5 relative; each gradient leaf within 1e-4 of that leaf's
largest gradient; the kernels' plain backward within 1e-5 of the largest
reference gradient (at least 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.models import build as j_build
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import build
from repro_torch.models import moe as t_moe
from repro_torch.models.sharding import tree_leaves
from repro_torch.train.train_loop import loss_and_grads

from _torch_port_util import both_params_f32, np_batch, vla_draws

LOSS_REL, GRAD_REL, VJP_TOL = 1e-5, 1e-4, 1e-5
HEADS = ("mlp", "lstm", "diffusion")


@functools.lru_cache(maxsize=None)
def _setup(arch, head=None, seed=0):
    """Models, parameters, batch, key and the key's VLA draws of one case,
    shared by the loss and the gradient test (nothing here mutates them)."""
    kw = {"dtype": "float32"}
    if head:
        kw["vla_action_head"] = head
    cj = j_get_config(arch).reduced().replace(**kw)
    ct = get_config(arch).reduced().replace(**kw)
    mj, mt = j_build(cj), build(ct)
    # the VLM's cross gates and the DiT's adaLN-zero leaves start at zero,
    # which would leave the layers behind them with zero gradients
    pj, pt = both_params_f32(mj, mt, seed, gates=cj.family == "vlm",
                             fill_zeros=cj.vla_action_head == "dit")
    batch = np_batch(cj, seed + 1)
    key = jax.random.PRNGKey(seed + 2)
    inject = vla_draws(cj, key, batch) if cj.family == "vla" else {}
    return mj, mt, pj, pt, batch, key, inject


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, head=None):
    mj, _, pj, _, batch, key, _ = _setup(arch, head)
    loss, grads = jax.jit(jax.value_and_grad(mj.loss_fn))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(loss), grads


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


GRAD_ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m", "mamba2-1.3b",
              "zamba2-1.2b", "llama-3.2-vision-11b", "seamless-m4t-large-v2",
              "openvla-7b", "cogact-7b"]


CASES = [(a, None) for a in sorted(ARCHS)] + [("openvla-7b", h)
                                             for h in HEADS]


@pytest.mark.parametrize("arch,head", CASES,
                         ids=[a + (f"-{h}" if h else "") for a, h in CASES])
def test_loss_matches_the_reference(arch, head):
    mj, mt, pj, pt, batch, key, inject = _setup(arch, head)
    if head is None and arch in GRAD_ARCHS:     # one compile for both tests
        want = _jax_value_and_grad(arch)[0]
    else:
        want = float(jax.jit(mj.loss_fn)(pj, {k: jnp.asarray(v)
                                              for k, v in batch.items()}, key))
    got = mt.loss_fn(pt, _torch_batch(batch), None, **inject)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= LOSS_REL * abs(want), (float(got), want)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_the_reference(arch, monkeypatch):
    mj, mt, pj, pt, batch, key, inject = _setup(arch)
    probs = []
    route = t_moe._route

    def recording_route(x2d, router, k):
        out = route(x2d, router, k)
        probs.append((torch.softmax(x2d.float() @ router.float(), -1)
                      .detach(), k))
        return out

    monkeypatch.setattr(t_moe, "_route", recording_route)
    gj = _jax_value_and_grad(arch)[1]
    loss, gt = loss_and_grads(mt, pt, _torch_batch(batch), **inject)
    assert all(not p.requires_grad for p in tree_leaves(pt))
    # an MoE top-k tie would let the two libraries pick different experts
    assert (len(probs) > 0) == (mt.cfg.family == "moe")
    for p, k in probs:
        top = torch.sort(p, dim=-1, descending=True).values[:, :k + 1]
        assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-4
    leaves_j = jax.tree_util.tree_leaves_with_path(gj)
    leaves_t = tree_leaves(gt)
    assert len(leaves_j) == len(leaves_t)
    nonzero = 0
    for (path, a), b in zip(leaves_j, leaves_t):
        a = np.asarray(a, np.float32)
        b = b.detach().numpy()
        assert a.shape == b.shape, path
        scale = float(np.abs(a).max())
        nonzero += scale > 0
        assert float(np.abs(a - b).max()) <= GRAD_REL * scale, \
            (jax.tree_util.keystr(path), float(np.abs(a - b).max()), scale)
    assert nonzero >= len(leaves_t) - 1     # DiT: the unused LM head


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b"])
def test_remat_recomputes_and_changes_nothing(arch, monkeypatch):
    """With ``remat`` every layer's forward runs again in the backward
    (each attention or scan twice), and the loss and gradients stay
    bit-equal to the run without it."""
    cfg = get_config(arch).reduced().replace(dtype="float32")
    batch = _torch_batch(np_batch(cfg, 3))
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    for mod, name in ((fa_ops, "flash_attention_plain"),
                      (ssd_ops, "ssd_scan_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, **k:
                            calls.append(1) or _f(*a, **k))
    out = {}
    for remat in (False, True):
        calls.clear()
        m = build(cfg.replace(remat=remat))
        out[remat] = loss_and_grads(m, params, batch)
        out[remat] += (len(calls),)
    assert out[True][2] == 2 * out[False][2] == 2 * cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, b)


# ------------------------------------------------------ the kernels' backward
def _close(got, want, tol=VJP_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("B,S,T,H,KV,D,Dv,causal", [
    (2, 24, 24, 4, 2, 16, 16, True),      # GQA
    (1, 17, 17, 4, 4, 32, 32, True),
    (2, 9, 9, 6, 2, 24, 16, True),        # the reduced MLA's (24, 16)
    (1, 16, 16, 4, 1, 16, 16, False)])
def test_flash_attention_vjp_plain_matches_jax_vjp(B, S, T, H, KV, D, Dv,
                                                   causal):
    rng = np.random.default_rng(S * H + D)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, Dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    want = jax.jit(lambda a, b, c, g: jax.vjp(
        lambda *x: j_fa_ref.attention(*x, causal), a, b, c)[1](g))(
        *(jnp.asarray(x) for x in (q, k, v, do)))
    got = fa_ops.flash_attention_vjp_plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


def _ssd_inputs(B, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(
                np.float32) * 0.5,
            -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32) * 0.5,
            rng.standard_normal((B, T, N)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("B,T,H,P,N,chunk,with_state", [
    (2, 32, 4, 8, 16, 8, False),
    (1, 29, 2, 16, 8, 8, True),           # a ragged last chunk
    (2, 16, 3, 8, 8, 32, True)])          # one chunk shorter than `chunk`
def test_ssd_vjp_plain_matches_jax_vjp(B, T, H, P, N, chunk, with_state):
    x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, T + H)
    rng = np.random.default_rng(7)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ds = rng.standard_normal((B, H, N, P)).astype(np.float32)
    want = jax.jit(lambda ins, cot: jax.vjp(
        lambda *a: j_ssd_chunked(*a, chunk), *ins)[1](cot))(
        tuple(jnp.asarray(t) for t in (x, dt, A, Bm, Cm)),
        (jnp.asarray(dy), jnp.asarray(ds if with_state
                                      else np.zeros_like(ds))))
    got = ssd_ops.ssd_scan_vjp_plain(
        *(torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)), chunk,
        torch.from_numpy(dy), torch.from_numpy(ds) if with_state else None)
    for g, w in zip(got, want):
        _close(g, w)


def test_the_kernel_functions_launch_once_and_differentiate_the_plain(
        monkeypatch):
    """Through the autograd Functions (on a stand-in card whose launch is
    the plain version): one counted launch a forward and none in the
    backward, and gradients equal to the plain version's own autograd —
    the final state's gradient may be absent."""
    monkeypatch.setattr(fa_ops, "_device_kind", lambda ts, name: "cuda")
    monkeypatch.setattr(fa_ops, "_launch", lambda q, k, v, causal: (
        setattr(fa_ops.flash_attention, "launches",
                fa_ops.flash_attention.launches + 1)
        or fa_ops.flash_attention_plain(q, k, v, causal=causal)))
    monkeypatch.setattr(fa_ops.flash_attention, "launches", 0)
    rng = np.random.default_rng(0)
    qkv = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))]
    ins = [t.clone().requires_grad_(True) for t in qkv]
    out = fa_ops.flash_attention(*ins, causal=True)
    assert out.grad_fn is not None and "FlashAttentionFn" in str(
        type(out.grad_fn))
    out.square().sum().backward()
    assert fa_ops.flash_attention.launches == 1
    ref = [t.clone().requires_grad_(True) for t in qkv]
    fa_ops.flash_attention_plain(*ref, causal=True).square().sum().backward()
    for a, b in zip(ins, ref):
        assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-6)
    with torch.no_grad():                           # serving: no Function
        assert fa_ops.flash_attention(*ins).grad_fn is None

    monkeypatch.setattr(ssd_ops, "_device_kind", lambda ts: "cuda")
    monkeypatch.setattr(ssd_ops, "_launch", lambda *a: (
        setattr(ssd_ops.ssd_scan, "launches", ssd_ops.ssd_scan.launches + 1)
        or ssd_ops.ssd_scan_plain(*a)))
    monkeypatch.setattr(ssd_ops.ssd_scan, "launches", 0)
    base = [torch.from_numpy(t) for t in _ssd_inputs(2, 20, 2, 8, 8, 3)]
    ins = [t.clone().requires_grad_(True) for t in base]
    y, state = ssd_ops.ssd_scan(*ins, chunk=8)
    y.square().sum().backward()                     # the state is dropped
    assert ssd_ops.ssd_scan.launches == 1
    ref = [t.clone().requires_grad_(True) for t in base]
    ssd_ops.ssd_scan_plain(*ref, 8)[0].square().sum().backward()
    for a, b in zip(ins, ref):
        assert a.grad.dtype == b.dtype
        assert torch.allclose(a.grad, b.grad, rtol=0, atol=1e-5)


def test_the_ssd_gradient_stays_finite_at_a_full_chunk():
    """At a 256-position chunk with Mamba2-1.3B's values at init (dt =
    softplus(0), A = -1) the decay above the diagonal, exp(+177),
    overflows: the JAX package's ``where`` after the exp passes NaN to dt
    and A, the port masks before the exp and stays finite, with the same
    forward."""
    B, T, H, P, N = 1, 256, 2, 8, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.full((B, T, H), np.log(2.0), np.float32)
    A = -np.ones(H, np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    ins = tuple(jnp.asarray(t) for t in (x, dt, A, Bm, Cm))
    yj, _ = jax.jit(lambda *a: j_ssd_chunked(*a, T))(*ins)
    gj = jax.jit(jax.grad(lambda *a: j_ssd_chunked(*a, T)[0].sum(),
                          argnums=(1, 2)))(*ins)
    assert all(bool(jnp.isnan(g).any()) for g in gj)     # the reference
    dy = torch.ones(x.shape)
    got = ssd_ops.ssd_scan_vjp_plain(
        *(torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)), T, dy)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    y, _ = ssd_ops.ssd_scan_plain(
        *(torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)), T)
    _close(y, yj)
