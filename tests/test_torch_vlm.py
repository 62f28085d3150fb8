"""Port parity: the VLM family of ``repro_torch`` (llama-3.2-vision-11b:
a decoder LM with a tanh-gated cross-attention block after every
``cross_attn_every`` dense blocks) — cross attention, the cross layer, the
full forward, prefill + decode, greedy generation and the cache trees —
against the JAX package at converted weights, reduced configs in float32
activations (bf16 weights, as the specs store them).

The cross gates are zero at init, which would hide the whole cross path,
so both sides' gates are overwritten with the same seeded draws in
[0.5, 1.0] (``_torch_port_util.draw_cross_gates``) before anything is
compared, and a second vision draw must move the logits.

Limits, stated before the first run: ``cross_attn_forward`` (both routes)
and the cross layer within 1e-5; the hidden states of the full forward
within 1e-5; the logits of ``Model.forward`` and the port's prefill and
every decode step against the JAX package's own within 1e-4 (logits reach
27 here, where float32 rounds at 2e-6, and the two libraries sum the
products in other orders); prefill + decode against the full forward
within 2e-3 (tests/test_decode_equivalence.py); greedy tokens equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn, build as j_build
from repro.models import vlm as j_vlm
from repro.models.layers import rmsnorm as j_rmsnorm, unembed as j_unembed
from repro.models.transformer import _layer_slice as j_layer_slice
from repro.runtime.kvcache import pad_cache as j_pad_cache
from repro.runtime.serving import greedy_generate as j_greedy
from repro_torch.configs import get_config
from repro_torch.models import attention as t_attn, build
from repro_torch.models import vlm as t_vlm
from repro_torch.models.transformer import _layer_slice
from repro_torch.runtime.kvcache import pad_cache
from repro_torch.runtime.serving import greedy_generate

from _torch_port_util import both_params, t2np, to_np

ARCH = "llama-3.2-vision-11b"
B, P, T = 2, 4, 8
TIGHT, LOGITS, FULL = 1e-5, 1e-4, 2e-3
KV = [None, 2]          # the reduced config's own 4 KV heads (MHA), and GQA


def _cfgs(kv=None, **kw):
    kw = dict(dtype="float32", **kw)
    if kv:
        kw["n_kv_heads"] = kv
    return (j_get_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


@pytest.fixture(scope="module", params=KV, ids=["kv-own", "kv2"])
def vlm(request):
    cj, ct = _cfgs(request.param)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0, gates=True)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cj.vocab_size, (B, T))
    vision = [rng.standard_normal((B, cj.n_vision_tokens, cj.d_model))
              .astype(np.float32) for _ in range(2)]
    return dict(cj=cj, ct=ct, mj=mj, mt=mt, pj=pj, pt=pt,
                tj=jnp.asarray(tokens, jnp.int32),
                tt=torch.from_numpy(tokens).to(torch.int32),
                vj=[jnp.asarray(v) for v in vision],
                vt=[torch.from_numpy(v) for v in vision])


def _j_full(v, vision):
    cj, pj = v["cj"], v["pj"]
    x = j_vlm._hidden(cj, pj, v["tj"], vision, remat=False)
    w = pj["embed"] if cj.tie_embeddings else pj["head"]
    return x, j_unembed(w, j_rmsnorm(x, pj["final_norm"], cj.norm_eps),
                        cj.vocab_size)


def test_the_gates_are_drawn_nonzero(vlm):
    g = vlm["pt"]["cross_blocks"]
    for name in ("gate_attn", "gate_mlp"):
        assert tuple(g[name].shape) == (t_vlm._n_cross(vlm["ct"]), 1)
        assert (g[name].float() >= 0.5).all() and (g[name].float() <= 1).all()
        np.testing.assert_array_equal(
            t2np(g[name]), to_np(vlm["pj"]["cross_blocks"][name]))


# ---------------------------------------------------------- cross attention
@pytest.mark.parametrize("route", ["kv_x", "kv_cache"])
def test_cross_attn_forward_matches_the_reference(vlm, route):
    """Q from x; K/V from the vision embeddings (prefill) or from a flat
    (B, T, KV*hd) cache (decode), one query token and five."""
    cj, ct = vlm["cj"], vlm["ct"]
    pj = j_layer_slice(vlm["pj"]["cross_blocks"], 1)["attn"]
    pt = _layer_slice(vlm["pt"]["cross_blocks"], 1)["attn"]
    rng = np.random.default_rng(2)
    kvd = ct.n_kv_heads * ct.resolved_head_dim
    for S in (1, 5):
        x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
        if route == "kv_x":
            kw_j, kw_t = {"kv_x": vlm["vj"][0]}, {"kv_x": vlm["vt"][0]}
        else:
            c = {n: rng.standard_normal((B, ct.n_vision_tokens, kvd))
                 .astype(np.float32) for n in ("k", "v")}
            kw_j = {"kv_cache": {n: jnp.asarray(a) for n, a in c.items()}}
            kw_t = {"kv_cache": {n: torch.from_numpy(a)
                                 for n, a in c.items()}}
        yj, cache_j = j_attn.cross_attn_forward(cj, pj, jnp.asarray(x),
                                                **kw_j)
        yt, cache_t = t_attn.cross_attn_forward(ct, pt, torch.from_numpy(x),
                                                **kw_t)
        assert tuple(yt.shape) == (B, S, ct.d_model)
        np.testing.assert_allclose(t2np(yt), to_np(yj), atol=TIGHT)
        for n in ("k", "v"):
            assert tuple(cache_t[n].shape) == (B, ct.n_vision_tokens, kvd)
            np.testing.assert_allclose(t2np(cache_t[n]), to_np(cache_j[n]),
                                       atol=TIGHT)
        if route == "kv_cache":
            assert cache_t is kw_t["kv_cache"]      # handed back as it came


def test_cross_layer_matches_the_reference_and_its_gates_act(vlm):
    """The gated cross layer within 1e-5, and with both gates at zero it
    is the identity: what a freshly initialised checkpoint hides."""
    cj, ct = vlm["cj"], vlm["ct"]
    pj = j_layer_slice(vlm["pj"]["cross_blocks"], 0)
    pt = _layer_slice(vlm["pt"]["cross_blocks"], 0)
    x = np.random.default_rng(3).standard_normal(
        (B, 5, ct.d_model)).astype(np.float32)
    yj = j_vlm._cross_layer(cj, pj, jnp.asarray(x), vision=vlm["vj"][0])
    yt = t_vlm._cross_layer(ct, pt, torch.from_numpy(x), vision=vlm["vt"][0])
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=TIGHT)
    assert (yt - torch.from_numpy(x)).abs().max().item() > 1e-2
    shut = dict(pt, gate_attn=torch.zeros_like(pt["gate_attn"]),
                gate_mlp=torch.zeros_like(pt["gate_mlp"]))
    y0 = t_vlm._cross_layer(ct, shut, torch.from_numpy(x),
                            vision=vlm["vt"][0])
    assert torch.equal(y0, torch.from_numpy(x))


# ----------------------------------------------------------- full forward
def test_forward_matches_the_reference(vlm):
    hj, fj = _j_full(vlm, vlm["vj"][0])
    ht = t_vlm._hidden(vlm["ct"], vlm["pt"], vlm["tt"], vlm["vt"][0])
    np.testing.assert_allclose(t2np(ht), to_np(hj), atol=TIGHT)
    ft = vlm["mt"].forward(vlm["pt"], {"tokens": vlm["tt"],
                                       "vision": vlm["vt"][0]})
    V = vlm["ct"].vocab_size
    assert tuple(ft.shape[:2]) == (B, T) and ft.dtype == torch.float32
    np.testing.assert_allclose(t2np(ft)[..., :V], to_np(fj)[..., :V],
                               atol=LOGITS)


def test_a_second_vision_draw_moves_the_logits(vlm):
    """The cross path is live: another image gives other logits at every
    position, in the full forward and in the decode steps."""
    mt, pt, tt, ct = vlm["mt"], vlm["pt"], vlm["tt"], vlm["ct"]
    a, b = (mt.forward(pt, {"tokens": tt, "vision": v}) for v in vlm["vt"])
    moved = (a - b).abs().amax(-1)
    assert (moved > 1e-2).all(), moved
    _, bj = _j_full(vlm, vlm["vj"][1])
    np.testing.assert_allclose(t2np(b)[..., :ct.vocab_size],
                               to_np(bj)[..., :ct.vocab_size], atol=LOGITS)
    steps = []
    for v in vlm["vt"]:
        _, cache = mt.prefill(pt, {"tokens": tt[:, :P], "vision": v})
        cache = pad_cache(cache, mt.cache_specs(B, T))
        steps.append(mt.decode(pt, cache, tt[:, P:P + 1], P)[0])
    assert ((steps[0] - steps[1]).abs().amax(-1) > 1e-2).all()


# --------------------------------------------------------- prefill, decode
def test_prefill_then_decode_equals_the_full_forward(vlm):
    """The twin of tests/test_decode_equivalence.py::
    test_vlm_decode_matches_forward, two caches deep per group and four
    steps, each against the JAX full forward (2e-3) and against the JAX
    package's own prefill and decode (1e-4)."""
    cj, ct, mj, mt = vlm["cj"], vlm["ct"], vlm["mj"], vlm["mt"]
    pj, pt, tj, tt = vlm["pj"], vlm["pt"], vlm["tj"], vlm["tt"]
    V = ct.vocab_size
    _, full = _j_full(vlm, vlm["vj"][0])
    full = to_np(full)[..., :V]
    lj, cache_j = mj.prefill(pj, {"tokens": tj[:, :P], "vision": vlm["vj"][0]})
    lt, cache_t = mt.prefill(pt, {"tokens": tt[:, :P], "vision": vlm["vt"][0]})
    np.testing.assert_allclose(t2np(lt)[:, 0, :V], full[:, P - 1], atol=FULL)
    np.testing.assert_allclose(t2np(lt), to_np(lj), atol=LOGITS)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            np.testing.assert_allclose(t2np(cache_t[part][n]),
                                       to_np(cache_j[part][n]), atol=LOGITS)
    cache_j = j_pad_cache(cache_j, mj.cache_specs(B, T))
    cache_t = pad_cache(cache_t, mt.cache_specs(B, T))
    held = {n: cache_t["self"][n] for n in ("k", "v")}
    for i in range(P, T):
        lj, cache_j = mj.decode(pj, cache_j, tj[:, i:i + 1], jnp.int32(i))
        lt, cache_t = mt.decode(pt, cache_t, tt[:, i:i + 1], i)
        np.testing.assert_allclose(t2np(lt)[:, 0, :V], full[:, i], atol=FULL)
        np.testing.assert_allclose(t2np(lt), to_np(lj), atol=LOGITS)
        for n in ("k", "v"):
            # written in place through the groups' views
            assert cache_t["self"][n] is held[n]
            assert cache_t["self"][n][:, :, i].abs().amax(-1).min() > 0
            np.testing.assert_allclose(t2np(cache_t["self"][n]),
                                       to_np(cache_j["self"][n]),
                                       atol=LOGITS)


def test_greedy_tokens_equal_the_reference(vlm):
    n = 6
    bj = {"tokens": vlm["tj"][:, :P], "vision": vlm["vj"][0]}
    bt = {"tokens": vlm["tt"][:, :P], "vision": vlm["vt"][0]}
    want = np.asarray(j_greedy(vlm["mj"], vlm["pj"], bj, n))
    got = greedy_generate(vlm["mt"], vlm["pt"], bt, n)
    assert got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_specs_match_the_reference(vlm):
    sj, st = vlm["mj"].cache_specs(B, T), vlm["mt"].cache_specs(B, T)
    assert sorted(sj) == sorted(st) == ["cross", "self"]
    ct = vlm["ct"]
    for part in ("self", "cross"):
        for n in ("k", "v"):
            a, b = sj[part][n], st[part][n]
            assert tuple(a.shape) == tuple(b.shape)
            assert a.axes == b.axes and b.init == "zeros"
            assert str(a.dtype) == str(b.dtype).split(".")[-1]
    assert tuple(st["cross"]["k"].shape) == (
        t_vlm._n_cross(ct), B, ct.n_vision_tokens,
        ct.n_kv_heads * ct.resolved_head_dim)
    assert st["self"]["k"].shape[0] == ct.n_layers


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_specs_have_the_references_shapes():
    cj, ct = _cfgs()
    assert _shapes(t_vlm.vlm_specs(ct)) == _shapes(j_vlm.vlm_specs(cj))
    full = get_config(ARCH)
    assert _shapes(t_vlm.vlm_specs(full)) == _shapes(
        j_vlm.vlm_specs(j_get_config(ARCH)))
    assert t_vlm._n_cross(full) == 8


# ------------------------------------------------------------- smoke twin
def test_prefill_decode_shapes():
    """The port's twin of tests/test_models_smoke.py::
    test_prefill_decode_shapes for llama-3.2-vision-11b: the reduced
    config as it stands (bf16 activations)."""
    cfg = get_config(ARCH).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 8))),
             "vision": torch.from_numpy(rng.standard_normal(
                 (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))}
    logits, cache = model.prefill(params, batch)
    assert tuple(logits.shape[:2]) == (2, 1)
    cache = pad_cache(cache, model.cache_specs(2, 16, src_len=8))
    l2, cache = model.decode(params, cache, batch["tokens"][:, :1], 8)
    assert tuple(l2.shape[:2]) == (2, 1)
    assert torch.isfinite(l2.float()).all()
