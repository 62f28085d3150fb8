"""Port parity: the encoder-decoder family of ``repro_torch``
(seamless-m4t-large-v2: a stub frontend projection, a non-causal encoder
with RoPE, a decoder of causal self attention + cross attention + MLP) —
cross attention, the encoder, the teacher-forced forward, prefill +
decode, greedy generation through ``greedy_generate(..., src_len=...)``
and the cache trees — against the JAX package at converted weights,
reduced configs in float32 activations (bf16 weights, as the specs store
them).

Limits, stated before the first run: ``cross_attn_forward`` (both routes)
and ``encode`` within 1e-5; the logits of ``Model.forward`` and the port's
prefill and every decode step against the JAX package's own within 1e-4
(logits reach 25 here, where float32 rounds at 2e-6, and the two
libraries sum the products in other orders); prefill + decode against the
teacher-forced forward within 2e-3 (tests/test_decode_equivalence.py);
greedy tokens equal; a second frames draw moves the logits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn, build as j_build
from repro.models import encdec as j_ed
from repro.models.layers import embed as j_embed, rmsnorm as j_rmsnorm, \
    unembed as j_unembed
from repro.models.transformer import _layer_slice as j_layer_slice, \
    run_stack as j_run_stack
from repro.runtime.kvcache import pad_cache as j_pad_cache
from repro.runtime.serving import greedy_generate as j_greedy
from repro_torch.configs import get_config
from repro_torch.models import attention as t_attn, build
from repro_torch.models import encdec as t_ed
from repro_torch.models.transformer import _layer_slice
from repro_torch.runtime.kvcache import pad_cache
from repro_torch.runtime.serving import greedy_generate, prefill_and_pad

from _torch_port_util import both_params, t2np, to_np

ARCH = "seamless-m4t-large-v2"
B, S_SRC, P, T = 2, 12, 4, 8
TIGHT, LOGITS, FULL = 1e-5, 1e-4, 2e-3
KV = [None, 2]          # the reduced config's own 4 KV heads (MHA), and GQA


def _cfgs(kv=None, **kw):
    kw = dict(dtype="float32", **kw)
    if kv:
        kw["n_kv_heads"] = kv
    return (j_get_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


@pytest.fixture(scope="module", params=KV, ids=["kv-own", "kv2"])
def ed(request):
    cj, ct = _cfgs(request.param)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cj.vocab_size, (B, T))
    frames = [rng.standard_normal((B, S_SRC, cj.d_model)).astype(np.float32)
              for _ in range(2)]
    return dict(cj=cj, ct=ct, mj=mj, mt=mt, pj=pj, pt=pt,
                tj=jnp.asarray(tokens, jnp.int32),
                tt=torch.from_numpy(tokens).to(torch.int32),
                fj=[jnp.asarray(f) for f in frames],
                ft=[torch.from_numpy(f) for f in frames])


def _j_teacher_forced(e, frames):
    """tests/test_decode_equivalence.py::
    test_encdec_decode_matches_teacher_forcing's full decoder pass, with
    the pad slots of the vocabulary masked as the port masks them."""
    cj, pj, tokens = e["cj"], e["pj"], e["tj"]
    enc_out = j_ed.encode(cj, pj, frames, remat=False)
    x = j_embed(pj["embed"], tokens).astype(jnp.dtype(cj.dtype))
    positions = jnp.arange(tokens.shape[1])

    def one(pl, h):
        h, _, _ = j_ed._dec_block(cj, pl, h, positions, enc_out=enc_out)
        return h, None, jnp.float32(0)

    x, _, _ = j_run_stack(cj, pj["dec_blocks"], x, one, cj.n_dec_layers,
                          remat=False)
    x = j_rmsnorm(x, pj["final_norm"], cj.norm_eps)
    w = pj["embed"] if cj.tie_embeddings else pj["head"]
    return j_unembed(w, x, cj.vocab_size)


# ---------------------------------------------------------- cross attention
@pytest.mark.parametrize("route", ["kv_x", "kv_cache"])
def test_cross_attn_forward_matches_the_reference(ed, route):
    """The decoder's cross attention: K/V from the encoder output
    (prefill) or from a flat (B, S_src, KV*hd) cache (decode), one query
    token and five."""
    cj, ct = ed["cj"], ed["ct"]
    pj = j_layer_slice(ed["pj"]["dec_blocks"], 1)["cross_attn"]
    pt = _layer_slice(ed["pt"]["dec_blocks"], 1)["cross_attn"]
    rng = np.random.default_rng(2)
    kvd = ct.n_kv_heads * ct.resolved_head_dim
    for S in (1, 5):
        x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
        if route == "kv_x":
            kw_j, kw_t = {"kv_x": ed["fj"][0]}, {"kv_x": ed["ft"][0]}
        else:
            c = {n: rng.standard_normal((B, S_SRC, kvd)).astype(np.float32)
                 for n in ("k", "v")}
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
            np.testing.assert_allclose(t2np(cache_t[n]), to_np(cache_j[n]),
                                       atol=TIGHT)


# ----------------------------------------------------------------- encoder
def test_encode_matches_the_reference(ed):
    """The frontend projection, the non-causal encoder with RoPE over
    arange(S_src), and the encoder norm."""
    for fj, ft in zip(ed["fj"], ed["ft"]):
        want = j_ed.encode(ed["cj"], ed["pj"], fj, remat=False)
        got = t_ed.encode(ed["ct"], ed["pt"], ft)
        assert tuple(got.shape) == (B, S_SRC, ed["ct"].d_model)
        np.testing.assert_allclose(t2np(got), to_np(want), atol=TIGHT)


def test_the_encoder_is_not_causal_and_sees_positions(ed):
    """Changing the last frame moves the first position's output (no
    causal mask), and reversing the frames does not just reverse the
    output (RoPE)."""
    ct, pt, f = ed["ct"], ed["pt"], ed["ft"][0]
    a = t_ed.encode(ct, pt, f)
    g = f.clone()
    g[:, -1] += 1.0
    assert (t_ed.encode(ct, pt, g)[:, 0] - a[:, 0]).abs().max() > 1e-4
    r = t_ed.encode(ct, pt, f.flip(1)).flip(1)
    assert (r - a).abs().max() > 1e-4


# ----------------------------------------------------------- full forward
def test_forward_matches_the_reference(ed):
    want = to_np(_j_teacher_forced(ed, ed["fj"][0]))
    got = ed["mt"].forward(ed["pt"], {"frames": ed["ft"][0],
                                      "tokens": ed["tt"]})
    V = ed["ct"].vocab_size
    assert tuple(got.shape[:2]) == (B, T) and got.dtype == torch.float32
    np.testing.assert_allclose(t2np(got)[..., :V], want[..., :V],
                               atol=LOGITS)


def test_a_second_frames_draw_moves_the_logits(ed):
    """Cross attention is live: another source gives other logits at
    every decoder position, in the forward and in a decode step."""
    mt, pt, tt, ct = ed["mt"], ed["pt"], ed["tt"], ed["ct"]
    a, b = (mt.forward(pt, {"frames": f, "tokens": tt}) for f in ed["ft"])
    assert ((a - b).abs().amax(-1) > 1e-2).all()
    want = to_np(_j_teacher_forced(ed, ed["fj"][1]))
    np.testing.assert_allclose(t2np(b)[..., :ct.vocab_size],
                               want[..., :ct.vocab_size], atol=LOGITS)
    steps = []
    for f in ed["ft"]:
        _, cache = prefill_and_pad(mt, pt, {"frames": f, "tokens": tt[:, :P]},
                                   T, src_len=S_SRC)
        steps.append(mt.decode(pt, cache, tt[:, P:P + 1], P)[0])
    assert ((steps[0] - steps[1]).abs().amax(-1) > 1e-2).all()


# --------------------------------------------------------- prefill, decode
def test_prefill_then_decode_equals_teacher_forcing(ed):
    """The twin of tests/test_decode_equivalence.py::
    test_encdec_decode_matches_teacher_forcing: the prefill and four
    decode steps against the JAX teacher-forced pass (2e-3) and against
    the JAX package's own prefill and decode (1e-4), the caches too; the
    self cache is written in place."""
    cj, ct, mj, mt = ed["cj"], ed["ct"], ed["mj"], ed["mt"]
    pj, pt, tj, tt = ed["pj"], ed["pt"], ed["tj"], ed["tt"]
    V = ct.vocab_size
    full = to_np(_j_teacher_forced(ed, ed["fj"][0]))[..., :V]
    lj, cache_j = mj.prefill(pj, {"frames": ed["fj"][0], "tokens": tj[:, :P]})
    lt, cache_t = mt.prefill(pt, {"frames": ed["ft"][0], "tokens": tt[:, :P]})
    np.testing.assert_allclose(t2np(lt)[:, 0, :V], full[:, P - 1], atol=FULL)
    np.testing.assert_allclose(t2np(lt), to_np(lj), atol=LOGITS)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            np.testing.assert_allclose(t2np(cache_t[part][n]),
                                       to_np(cache_j[part][n]), atol=LOGITS)
    cache_j = j_pad_cache(cache_j, mj.cache_specs(B, T, src_len=S_SRC))
    cache_t = pad_cache(cache_t, mt.cache_specs(B, T, src_len=S_SRC))
    held = {n: cache_t["self"][n] for n in ("k", "v")}
    for i in range(P, T):
        lj, cache_j = mj.decode(pj, cache_j, tj[:, i:i + 1], jnp.int32(i))
        lt, cache_t = mt.decode(pt, cache_t, tt[:, i:i + 1], i)
        np.testing.assert_allclose(t2np(lt)[:, 0, :V], full[:, i], atol=FULL)
        np.testing.assert_allclose(t2np(lt), to_np(lj), atol=LOGITS)
        for n in ("k", "v"):
            assert cache_t["self"][n] is held[n]
            np.testing.assert_allclose(t2np(cache_t["self"][n]),
                                       to_np(cache_j["self"][n]),
                                       atol=LOGITS)


def test_greedy_tokens_equal_the_reference(ed):
    """``greedy_generate`` with the frames in the batch and ``src_len``
    passed through to ``cache_specs``, as the JAX package's."""
    n = 6
    bj = {"frames": ed["fj"][0], "tokens": ed["tj"][:, :P]}
    bt = {"frames": ed["ft"][0], "tokens": ed["tt"][:, :P]}
    want = np.asarray(j_greedy(ed["mj"], ed["pj"], bj, n, src_len=S_SRC))
    got = greedy_generate(ed["mt"], ed["pt"], bt, n, src_len=S_SRC)
    assert got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_specs_match_the_reference(ed):
    sj = ed["mj"].cache_specs(B, T, src_len=S_SRC)
    st = ed["mt"].cache_specs(B, T, src_len=S_SRC)
    assert sorted(sj) == sorted(st) == ["cross", "self"]
    ct = ed["ct"]
    for part, length in (("self", T), ("cross", S_SRC)):
        for n in ("k", "v"):
            a, b = sj[part][n], st[part][n]
            assert tuple(a.shape) == tuple(b.shape) == (
                ct.n_dec_layers, B, length,
                ct.n_kv_heads * ct.resolved_head_dim)
            assert a.axes == b.axes and b.init == "zeros"
            assert str(a.dtype) == str(b.dtype).split(".")[-1]
    # without src_len the source is taken to be max_len long, as there
    assert tuple(ed["mt"].cache_specs(B, T)["cross"]["k"].shape) == tuple(
        ed["mj"].cache_specs(B, T)["cross"]["k"].shape)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_specs_have_the_references_shapes():
    cj, ct = _cfgs()
    assert _shapes(t_ed.encdec_specs(ct)) == _shapes(j_ed.encdec_specs(cj))
    full = get_config(ARCH)
    specs = t_ed.encdec_specs(full)
    assert _shapes(specs) == _shapes(j_ed.encdec_specs(j_get_config(ARCH)))
    assert specs["embed"].shape == (256208, 1024)     # 256 206 padded to 16
    assert specs["frontend_proj"].shape == (1024, 1024)


# ------------------------------------------------------------- smoke twin
def test_prefill_decode_shapes():
    """The port's twin of tests/test_models_smoke.py::
    test_prefill_decode_shapes for seamless-m4t-large-v2: the reduced
    config as it stands (bf16 activations), 8 frames and 8 tokens."""
    cfg = get_config(ARCH).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 8))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, 8, cfg.d_model)).astype(np.float32))}
    logits, cache = model.prefill(params, batch)
    assert tuple(logits.shape[:2]) == (2, 1)
    cache = pad_cache(cache, model.cache_specs(2, 16, src_len=8))
    l2, cache = model.decode(params, cache, batch["tokens"][:, :1], 8)
    assert tuple(l2.shape[:2]) == (2, 1)
    assert torch.isfinite(l2.float()).all()
