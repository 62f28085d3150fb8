"""Port parity: the MoE family of ``repro_torch`` — routing, capacity and
drops, the padded expert table, the fixed-order combine, and the MoE LMs
(granite-moe-3b-a800m, GQA; deepseek-v2-lite-16b, MLA with a dense first
layer and shared experts) through ``build`` — against the JAX package at
converted weights, reduced configs in float32 activations (bf16 weights,
as the specs store them).

Limits, stated before the first run: ``moe_ffn`` output and aux loss
within 1e-5 with the expert ids equal; the full forward within 2e-4
(tests/test_runtime.py's limit for a forward in another summation order);
prefill + decode against the full forward within 2e-3 at
``moe_capacity_factor=8`` (tests/test_decode_equivalence.py's setting:
GShard drops depend on the token count); greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro.models.transformer import (_layer_slice as j_layer_slice,
                                      lm_hidden as j_lm_hidden,
                                      lm_logits as j_lm_logits)
from repro.runtime.kvcache import pad_cache as j_pad_cache
from repro.runtime.serving import greedy_generate as j_greedy
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models import moe as t_moe
from repro_torch.models.transformer import _layer_slice
from repro_torch.runtime.kvcache import pad_cache
from repro_torch.runtime.serving import greedy_generate

from _torch_port_util import both_params, t2np, to_np

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
MOE_TOL = 1e-5


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (j_get_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _models(arch, seed=0, **kw):
    cj, ct = _cfgs(arch, **kw)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=seed)
    return cj, ct, mj, mt, pj, pt


# ------------------------------------------------------------ pure helpers
def test_padded_expert_count_and_capacity_are_the_references():
    for E in list(range(1, 70)) + [160]:
        assert t_moe.padded_expert_count(E) == j_moe.padded_expert_count(E)
    assert t_moe.padded_expert_count(40) == 48      # granite's table
    assert t_moe.padded_expert_count(64) == 64      # deepseek's
    for T in (1, 4, 17, 512, 2048):
        for E, k in ((40, 8), (64, 6), (10, 3)):
            for f in (0.5, 1.25, 8.0):
                assert t_moe.capacity(T, E, k, f) == j_moe.capacity(T, E, k, f)


def test_specs_have_the_references_shapes():
    for arch in ARCHS:
        cfg = get_config(arch)
        j = j_moe.moe_specs(j_get_config(arch), 3)
        t = t_moe.moe_specs(cfg, 3)
        assert _shapes(t) == _shapes(j)
        assert t["wg"].shape[1] == t_moe.padded_expert_count(cfg.n_experts)
        assert ("shared" in t) == bool(cfg.n_shared_experts)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


# ------------------------------------------------------------- moe_ffn
# (arch, n_experts, top_k, capacity factor): granite reduced with a padded
# table (10 experts -> 16), GShard drops at factor 0.5, none at 8;
# deepseek reduced (4 experts top-2 plus a shared expert)
FFN_CASES = [("granite-moe-3b-a800m", 10, 3, 0.5),
             ("granite-moe-3b-a800m", 10, 3, 1.25),
             ("granite-moe-3b-a800m", 10, 3, 8.0),
             ("deepseek-v2-lite-16b", None, None, 1.25),
             ("deepseek-v2-lite-16b", None, None, 0.5)]


@pytest.mark.parametrize("arch,E,k,factor", FFN_CASES)
def test_moe_ffn_matches_the_reference(arch, E, k, factor):
    kw = {"moe_capacity_factor": factor}
    if E:
        kw.update(n_experts=E, moe_top_k=k)
    cj, ct, _, _, pj, pt = _models(arch, seed=3, **kw)
    name = "moe_blocks"
    p_j = j_layer_slice(pj[name], 0)["moe"]
    p_t = _layer_slice(pt[name], 0)["moe"]
    assert p_t["wg"].shape[0] == t_moe.padded_expert_count(ct.n_experts)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cj.d_model)).astype(np.float32)
    # routing: the same experts in the same order
    gj, ej, aj = j_moe._route(jnp.asarray(x).reshape(32, -1), p_j["router"],
                              cj.moe_top_k)
    gt, et, at = t_moe._route(torch.from_numpy(x).reshape(32, -1),
                              p_t["router"], ct.moe_top_k)
    assert np.array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(t2np(gt), to_np(gj), atol=MOE_TOL)
    np.testing.assert_allclose(float(at), float(aj), atol=MOE_TOL)
    # how many choices the capacity drops, as the reference counts them
    C = t_moe.capacity(32, ct.n_experts, ct.moe_top_k, factor)
    load = np.bincount(np.asarray(ej).reshape(-1), minlength=ct.n_experts)
    dropped = int(np.maximum(load - C, 0).sum())
    if factor == 0.5:
        assert dropped > 0
    if factor == 8.0:
        assert dropped == 0
    yj, auxj = j_moe.moe_ffn(cj, p_j, jnp.asarray(x))
    yt, auxt = t_moe.moe_ffn(ct, p_t, torch.from_numpy(x))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=MOE_TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), atol=MOE_TOL)


def test_the_combine_is_a_fixed_order_sum():
    """The combine adds each token's choices in increasing expert id:
    within 1e-6 of adding the kept slots' contributions one expert at a
    time in that order, written out per token (products of one row rather
    than of the batched buffer), with the choices past an expert's
    capacity left out; repeated calls are bit-equal."""
    cj, ct, _, _, _, pt = _models("granite-moe-3b-a800m", seed=5,
                                  n_experts=10, moe_top_k=3,
                                  moe_capacity_factor=0.5)
    p = _layer_slice(pt["moe_blocks"], 0)["moe"]
    x2d = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (24, ct.d_model)).astype(np.float32))
    gates, eids, _ = t_moe._route(x2d, p["router"], ct.moe_top_k)
    C = t_moe.capacity(24, ct.n_experts, ct.moe_top_k, 0.5)
    y = t_moe._local_expert_ffn(x2d, gates, eids, p["wg"], p["wu"], p["wd"],
                                E=ct.n_experts, C=C)
    want = torch.zeros_like(x2d)
    seen = np.zeros(ct.n_experts, dtype=int)
    wg, wu, wd = (p[n].float() for n in ("wg", "wu", "wd"))
    for e in range(ct.n_experts):               # expert-major slot order
        for t in range(24):
            hit = (eids[t] == e).nonzero()
            if not len(hit):
                continue
            if seen[e] < C:
                xe = x2d[t:t + 1]
                h = torch.nn.functional.silu(xe @ wg[e]) * (xe @ wu[e])
                want[t] = want[t] + ((h @ wd[e])[0] * gates[t, hit[0, 0]])
            seen[e] += 1
    assert (seen > C).any()                     # some choice was dropped
    np.testing.assert_allclose(t2np(y), t2np(want), atol=1e-6)
    y2 = t_moe._local_expert_ffn(x2d, gates, eids, p["wg"], p["wu"], p["wd"],
                                 E=ct.n_experts, C=C)
    assert torch.equal(y, y2)


# --------------------------------------------------------- the MoE LMs
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    cj, ct, mj, mt, pj, pt = _models(arch)
    if arch == "deepseek-v2-lite-16b":
        assert set(pt) >= {"dense_blocks", "moe_blocks"}
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (2, 10))
    hj, auxj = j_lm_hidden(cj, pj, jnp.asarray(tokens), remat=False)
    ref = j_lm_logits(cj, pj, hj)
    got = mt.forward(pt, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(t2np(got), to_np(ref), atol=2e-4, rtol=2e-4)
    from repro_torch.models.transformer import lm_hidden
    _, auxt = lm_hidden(ct, pt, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(auxt), float(auxj), atol=MOE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_decode_equivalence.py in the port: prefill + five decode
    steps against the port's full forward, within 2e-3."""
    cj, ct, mj, mt, pj, pt = _models(arch, moe_capacity_factor=8.0)
    B, P, T = 2, 5, 10
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, ct.vocab_size, (B, T)))
    full = mt.forward(pt, {"tokens": tokens})
    logits, cache = mt.prefill(pt, {"tokens": tokens[:, :P]})
    assert torch.allclose(logits[:, 0], full[:, P - 1], atol=2e-3)
    cache = pad_cache(cache, mt.cache_specs(B, T, src_len=P))
    errs = []
    for i in range(P, T):
        logits, cache = mt.decode(pt, cache, tokens[:, i:i + 1], i)
        errs.append((logits[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Logits of the prefill and of each step, and the cache leaves after
    the prefill, against the JAX package's serving path."""
    cj, ct, mj, mt, pj, pt = _models(arch, moe_capacity_factor=8.0)
    B, P, T = 2, 5, 9
    tokens = np.random.default_rng(2).integers(0, cj.vocab_size, (B, T))
    lj, cj_cache = mj.prefill(pj, {"tokens": jnp.asarray(tokens[:, :P])})
    lt, ct_cache = mt.prefill(pt, {"tokens": torch.from_numpy(tokens[:, :P])})
    np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4, rtol=2e-4)
    assert set(ct_cache) == set(cj_cache)
    for g in ct_cache:
        assert set(ct_cache[g]) == set(cj_cache[g])
        for leaf in ct_cache[g]:
            np.testing.assert_allclose(t2np(ct_cache[g][leaf]),
                                       to_np(cj_cache[g][leaf]), atol=2e-4)
    cj_cache = j_pad_cache(cj_cache, mj.cache_specs(B, T))
    ct_cache = pad_cache(ct_cache, mt.cache_specs(B, T))
    for i in range(P, T):
        lj, cj_cache = mj.decode(pj, cj_cache, jnp.asarray(tokens[:, i:i + 1]),
                                 jnp.int32(i))
        lt, ct_cache = mt.decode(pt, ct_cache,
                                 torch.from_numpy(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_references(arch):
    cj, ct, mj, mt, pj, pt = _models(arch)
    tokens = np.random.default_rng(3).integers(0, cj.vocab_size, (2, 6))
    want = j_greedy(mj, pj, {"tokens": jnp.asarray(tokens, jnp.int32)},
                    n_steps=6)
    got = greedy_generate(mt, pt, {"tokens": torch.from_numpy(tokens)}, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_are_the_references(arch):
    cj, ct = _cfgs(arch)
    sj = j_build(cj).cache_specs(3, 20)
    st = build(ct).cache_specs(3, 20)
    assert set(sj) == set(st)
    for g in st:
        assert {k: tuple(s.shape) for k, s in st[g].items()} == \
            {k: tuple(s.shape) for k, s in sj[g].items()}
