"""Port parity: the LM serving path of ``repro_torch`` — one-token
attention decode, prefill, decode, cache specs and padding, greedy
generation — against the JAX package at converted weights, and the
analytic KV accounting held equal to the reference's copy."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, get_config as j_get_config
from repro.core.structure import Workload as J_Workload, \
    build_graph as j_build_graph
from repro.models import attention as j_attn, build as j_build
from repro.models.transformer import _layer_slice as j_layer_slice
from repro.runtime import kvcache as j_kv
from repro.runtime.serving import greedy_generate as j_greedy
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.structure import Workload, build_graph
from repro_torch.models import attention as t_attn, build
from repro_torch.models.transformer import (_layer_slice, lm_hidden,
                                            lm_logits)
from repro_torch.runtime import kvcache as t_kv
from repro_torch.runtime.serving import greedy_generate, make_serve_step

from _torch_port_util import both_params, jax_tree_to_np, t2np, to_np

B, P, T = 2, 5, 10
# (arch, n_kv_heads or None for the reduced config's own): llama3.2-3b
# reduced has n_kv_heads == n_heads, so GQA is switched on by hand; glm4-9b
# reduced is GQA (2 of 4) and is also run without it
CASES = [("llama3.2-3b", None), ("llama3.2-3b", 2), ("glm4-9b", None),
         ("glm4-9b", 4)]
IDS = [f"{a}-kv{k or 'own'}" for a, k in CASES]


def _cfgs(arch, kv, **kw):
    cj = j_get_config(arch).reduced().replace(dtype="float32", **kw)
    ct = get_config(arch).reduced().replace(dtype="float32", **kw)
    if kv:
        cj, ct = cj.replace(n_kv_heads=kv), ct.replace(n_kv_heads=kv)
    return cj, ct


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def lm(request):
    arch, kv = request.param
    cj, ct = _cfgs(arch, kv)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0)
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (B, T))
    return dict(cj=cj, ct=ct, mj=mj, mt=mt, pj=pj, pt=pt, tokens=tokens,
                tj=jnp.asarray(tokens, jnp.int32),
                tt=torch.from_numpy(tokens).to(torch.int32))


def _t_cache(np_tree):
    return from_numpy_tree(np_tree, "cpu")


# ------------------------------------------------------------ attn_decode
@pytest.mark.parametrize("pos", [0, 3, 9])
def test_attn_decode_matches_the_reference(lm, pos):
    """Output and the updated cache, from a random cache prefix, with the
    reference's non-kernel path (the same arithmetic as its plain B6)."""
    cj, ct = lm["cj"], lm["ct"]
    rng = np.random.default_rng(pos)
    KVhd = cj.n_kv_heads * cj.resolved_head_dim
    x = rng.standard_normal((B, 1, cj.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((B, T, KVhd)).astype(np.float32)
             for n in ("k", "v")}
    pj = j_layer_slice(lm["pj"]["blocks"], 0)["attn"]
    pt = _layer_slice(lm["pt"]["blocks"], 0)["attn"]
    yj, cj_new = j_attn.attn_decode(cj, pj, jnp.asarray(x), jnp.int32(pos),
                                    {n: jnp.asarray(a) for n, a in
                                     cache.items()})
    tc = _t_cache(cache)
    yt, ct_new = t_attn.attn_decode(ct, pt, torch.from_numpy(x), pos, tc)
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=2e-5)
    for n in ("k", "v"):
        assert ct_new[n] is tc[n]                    # updated in place
        np.testing.assert_allclose(t2np(ct_new[n]), to_np(cj_new[n]),
                                   atol=2e-5)
        assert np.array_equal(t2np(ct_new[n])[:, pos + 1:],
                              cache[n][:, pos + 1:])


def test_attn_decode_takes_a_tensor_position(lm):
    ct = lm["ct"]
    pt = _layer_slice(lm["pt"]["blocks"], 0)["attn"]
    g = torch.Generator().manual_seed(0)
    KVhd = ct.n_kv_heads * ct.resolved_head_dim
    x = torch.randn((B, 1, ct.d_model), generator=g)
    c0 = {n: torch.randn((B, T, KVhd), generator=g) for n in ("k", "v")}
    c1 = {n: a.clone() for n, a in c0.items()}
    y0, _ = t_attn.attn_decode(ct, pt, x, 4, c0)
    y1, _ = t_attn.attn_decode(ct, pt, x, torch.tensor(4), c1)
    assert torch.equal(y0, y1)
    assert all(torch.equal(c0[n], c1[n]) for n in c0)


# ------------------------------------------------- prefill, decode, specs
def test_cache_specs_match_the_reference(lm):
    sj = lm["mj"].cache_specs(B, T)
    st = lm["mt"].cache_specs(B, T)
    assert list(sj) == list(st) == ["blocks"]
    for n in ("k", "v"):
        a, b = sj["blocks"][n], st["blocks"][n]
        assert tuple(a.shape) == tuple(b.shape)
        assert a.axes == b.axes and b.init == "zeros"
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
    zj = j_kv.alloc_cache(lm["mj"], B, T)
    zt = t_kv.alloc_cache(lm["mt"], B, T, device="cpu")
    assert t_kv.cache_bytes(zt) == j_kv.cache_bytes(zj)
    assert not any(t.any() for t in (zt["blocks"]["k"], zt["blocks"]["v"]))


def test_prefill_pad_and_decode_match_the_reference(lm):
    """Per-step logits within 2e-4 and the caches after each step, from the
    same prefill; the port's own prefilled cache stands in for the
    reference's after padding (same layout: the converted reference cache
    gives the same logits)."""
    mj, mt, pj, pt = lm["mj"], lm["mt"], lm["pj"], lm["pt"]
    tj, tt = lm["tj"], lm["tt"]
    lj, cache_j = mj.prefill(pj, {"tokens": tj[:, :P]})
    lt, cache_t = mt.prefill(pt, {"tokens": tt[:, :P]})
    np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(t2np(cache_t["blocks"][n]),
                                   to_np(cache_j["blocks"][n]), atol=2e-4)
    cache_j = j_kv.pad_cache(cache_j, mj.cache_specs(B, T))
    cache_t = t_kv.pad_cache(cache_t, mt.cache_specs(B, T))
    from_ref = _t_cache(jax_tree_to_np(cache_j))
    assert {n: tuple(a.shape) for n, a in cache_t["blocks"].items()} == \
        {n: tuple(a.shape) for n, a in from_ref["blocks"].items()}
    for i in range(P, T):
        lj, cache_j = mj.decode(pj, cache_j, tj[:, i:i + 1], jnp.int32(i))
        lt, cache_t = mt.decode(pt, cache_t, tt[:, i:i + 1], i)
        lr, from_ref = mt.decode(pt, from_ref, tt[:, i:i + 1], i)
        np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4)
        np.testing.assert_allclose(t2np(lr), to_np(lj), atol=2e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(t2np(cache_t["blocks"][n]),
                                       to_np(cache_j["blocks"][n]),
                                       atol=2e-4)


def test_prefill_then_decode_equals_the_full_forward(lm):
    """The port-side twin of tests/test_decode_equivalence.py for the dense
    archs: 2e-3, as there."""
    ct, mt, pt, tt = lm["ct"], lm["mt"], lm["pt"], lm["tt"]
    h, _ = lm_hidden(ct, pt, tt)
    full = lm_logits(ct, pt, h)
    logits, cache = mt.prefill(pt, {"tokens": tt[:, :P]})
    assert (logits[:, 0] - full[:, P - 1]).abs().max().item() < 2e-3
    cache = t_kv.pad_cache(cache, mt.cache_specs(B, T))
    step = make_serve_step(mt)
    errs = []
    for i in range(P, T):
        logits, cache = step(pt, cache, tt[:, i:i + 1], i)
        errs.append((logits[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 2e-3, errs


def test_greedy_generate_tokens_equal_the_reference(lm):
    out_j = j_greedy(lm["mj"], lm["pj"], {"tokens": lm["tj"][:, :P]},
                     n_steps=6)
    out_t = greedy_generate(lm["mt"], lm["pt"], {"tokens": lm["tt"][:, :P]},
                            n_steps=6)
    assert out_t.dtype == torch.int32 and tuple(out_t.shape) == (B, 6)
    assert np.array_equal(out_t.numpy(), np.asarray(out_j))


def test_greedy_generate_with_a_longer_buffer(lm):
    """``max_len`` past prompt + steps leaves dead cache at the end, which
    the mask keeps out: the same tokens."""
    a = greedy_generate(lm["mt"], lm["pt"], {"tokens": lm["tt"][:, :P]},
                        n_steps=4)
    b = greedy_generate(lm["mt"], lm["pt"], {"tokens": lm["tt"][:, :P]},
                        n_steps=4, max_len=P + 11)
    assert torch.equal(a, b)


def test_pad_cache_matches_the_reference_and_refuses_to_shrink():
    rng = np.random.default_rng(0)
    tree = {"blocks": {"k": rng.standard_normal((3, 2, 4, 8)).astype(
        np.float32)}}
    from repro.models.sharding import spec as j_spec
    from repro_torch.models.sharding import spec as t_spec
    sj = {"blocks": {"k": j_spec((3, 2, 9, 8), (None,) * 4,
                                 dtype=jnp.float32)}}
    st = {"blocks": {"k": t_spec((3, 2, 9, 8), (None,) * 4,
                                 dtype=torch.float32)}}
    pj = j_kv.pad_cache(jax.tree_util.tree_map(jnp.asarray, tree), sj)
    pt = t_kv.pad_cache(_t_cache(tree), st)
    assert np.array_equal(t2np(pt["blocks"]["k"]), to_np(pj["blocks"]["k"]))
    small = {"blocks": {"k": t_spec((3, 2, 3, 8), (None,) * 4)}}
    with pytest.raises(ValueError, match="larger"):
        t_kv.pad_cache(_t_cache(tree), small)


def test_vla_has_no_decode_path():
    mt = build(get_config("openvla-7b").reduced())
    assert mt.cache_specs(1, 8) == {}
    with pytest.raises(NotImplementedError):
        mt.prefill({}, {})
    with pytest.raises(NotImplementedError):
        mt.decode({}, {}, None, 0)


# --------------------------------------------- analytic KV accounting, ==
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
NUMPY_DEFS = ("KV_KINDS", "kv_bytes_per_token", "request_kv_tokens",
              "graph_kv_cumsum", "ReferenceLedger")


def _defs(path):
    out = {}
    for n in ast.parse(path.read_text()).body:
        name = getattr(n, "name", None)
        if isinstance(n, ast.Assign):
            name = n.targets[0].id
        if name in NUMPY_DEFS:
            out[name] = ast.dump(n)
    return out


def test_the_numpy_accounting_is_the_reference_code():
    ours = _defs(SRC / "repro_torch" / "runtime" / "kvcache.py")
    theirs = _defs(SRC / "repro" / "runtime" / "kvcache.py")
    assert set(ours) == set(theirs) == set(NUMPY_DEFS)
    assert ours == theirs


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_kv_accounting_equal_on_every_config(name):
    for wl_kw in ({}, {"s_new": 17, "decode_steps": 0},
                  {"s_ctx": 512, "s_new": 1, "decode_steps": 64,
                   "batch": 4}):
        wj, wt = J_Workload(**wl_kw), Workload(**wl_kw)
        cj, ct = j_get_config(name), get_config(name)
        for ab in (1, 2):
            assert t_kv.kv_bytes_per_token(ct, ab) == \
                j_kv.kv_bytes_per_token(cj, ab)
        assert t_kv.request_kv_tokens(wt) == j_kv.request_kv_tokens(wj)
        a = t_kv.graph_kv_cumsum(build_graph(ct, wt), ct, wt)
        b = j_kv.graph_kv_cumsum(j_build_graph(cj, wj), cj, wj)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reference_ledger_equal():
    ours, theirs = t_kv.ReferenceLedger(100.0), j_kv.ReferenceLedger(100.0)
    for key, n in [(1, 40), (2, 40), (1, 30), (3, 50), (4, 500), (2, 10)]:
        assert ours.put(key, n) == theirs.put(key, n)
        assert ours.total_bytes == theirs.total_bytes
    ours.drop(4)
    theirs.drop(4)
    ours.drop(99)
    assert ours.total_bytes == theirs.total_bytes
    assert list(ours._bytes.items()) == list(theirs._bytes.items())
