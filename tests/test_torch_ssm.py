"""Port parity: the SSM (``mamba2-1.3b``) and hybrid (``zamba2-1.2b``)
families of ``repro_torch`` — Mamba2 blocks in forward, prefill and decode,
the hybrid backbone, prefill + decode against the full forward, greedy
generation and the cache trees — against the JAX package at converted
weights, reduced configs, float32 unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build as j_build, hybrid as j_hybrid, ssm as j_ssm
from repro.models.transformer import _layer_slice as j_layer_slice
from repro.runtime import kvcache as j_kv
from repro.runtime.serving import greedy_generate as j_greedy
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import build, hybrid as t_hybrid, ssm as t_ssm
from repro_torch.models.transformer import _layer_slice
from repro_torch.runtime import kvcache as t_kv
from repro_torch.runtime.serving import greedy_generate, make_serve_step

from _torch_port_util import both_params, jax_tree_to_np, t2np, to_np

ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
B, P, T = 2, 5, 10


def _cfgs(arch, **kw):
    return (j_get_config(arch).reduced().replace(dtype="float32", **kw),
            get_config(arch).reduced().replace(dtype="float32", **kw))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cj, ct = _cfgs(request.param)
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=0)
    # the reduced chunk is 32: 48 positions make two chunks, the last ragged
    tokens = np.random.default_rng(1).integers(0, cj.vocab_size, (B, 48))
    return dict(arch=request.param, cj=cj, ct=ct, mj=mj, mt=mt, pj=pj, pt=pt,
                tokens=tokens, tj=jnp.asarray(tokens, jnp.int32),
                tt=torch.from_numpy(tokens).to(torch.int32))


def _layer0(lm):
    return (j_layer_slice(lm["pj"]["mamba"], 0),
            _layer_slice(lm["pt"]["mamba"], 0))


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _j_full_logits(lm, tokens):
    """The full forward as tests/test_decode_equivalence.py composes it."""
    cfg, params = lm["cj"], lm["pj"]
    from repro.models.layers import embed, rmsnorm, unembed
    if cfg.family == "ssm":
        from repro.models.transformer import run_stack
        x = embed(params["embed"], tokens).astype(jnp.dtype(cfg.dtype))

        def one(pl, h):
            return h + j_ssm.mamba_forward(cfg, pl, h), None, jnp.float32(0)

        x, _, _ = run_stack(cfg, params["mamba"], x, one, cfg.n_layers,
                            remat=False)
    else:
        x = j_hybrid.hybrid_hidden(cfg, params, tokens, remat=False)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab_size)


def _leaves_in_jax_order(tree):
    """Leaves of a nested dict in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_in_jax_order(tree[k])]
    return [tree]


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("S", [10, 40])
def test_mamba_forward_matches_the_reference(lm, S):
    """One block over one chunk and over two (the second ragged)."""
    cj, ct = lm["cj"], lm["ct"]
    pj, pt = _layer0(lm)
    x = _x(cj, S, S)
    yj = j_ssm.mamba_forward(cj, pj, jnp.asarray(x))
    yt = t_ssm.mamba_forward(ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=2e-4)


@pytest.mark.parametrize("S", [2, 10, 40])
def test_mamba_prefill_matches_the_reference(lm, S):
    """The output and all four state leaves; S = 2 is shorter than the
    conv's tail, which is zero-padded in front."""
    cj, ct = lm["cj"], lm["ct"]
    pj, pt = _layer0(lm)
    x = _x(cj, S, 100 + S)
    yj, sj = j_ssm.mamba_prefill(cj, pj, jnp.asarray(x))
    yt, st = t_ssm.mamba_prefill(ct, pt, torch.from_numpy(x))
    np.testing.assert_allclose(t2np(yt), to_np(yj), atol=2e-4)
    assert set(st) == set(sj) == {"ssd", "conv_x", "conv_B", "conv_C"}
    for k in sj:
        assert tuple(st[k].shape) == tuple(sj[k].shape)
        np.testing.assert_allclose(t2np(st[k]), to_np(sj[k]), atol=2e-4)


def test_mamba_decode_matches_the_reference_and_writes_in_place(lm):
    """Three steps from a random state: the output and the state after each
    step, written into the state tensors the step was given."""
    cj, ct = lm["cj"], lm["ct"]
    pj, pt = _layer0(lm)
    rng = np.random.default_rng(7)
    specs = t_ssm.ssm_state_specs(ct, B)
    state_np = {k: rng.standard_normal(s.shape).astype(np.float32)
                for k, s in specs.items()}
    sj = {k: jnp.asarray(a) for k, a in state_np.items()}
    st = from_numpy_tree(state_np, "cpu")
    held = dict(st)
    for i in range(3):
        x = _x(cj, 1, 200 + i)
        yj, sj = j_ssm.mamba_decode(cj, pj, jnp.asarray(x), sj)
        yt, st = t_ssm.mamba_decode(ct, pt, torch.from_numpy(x), st)
        np.testing.assert_allclose(t2np(yt), to_np(yj), atol=2e-4)
        for k in sj:
            assert st[k] is held[k]                  # updated in place
            np.testing.assert_allclose(t2np(st[k]), to_np(sj[k]), atol=2e-4)


def test_hybrid_hidden_matches_the_reference():
    cj, ct = _cfgs("zamba2-1.2b")
    mj, mt = j_build(cj), build(ct)
    pj, pt = both_params(mj, mt, seed=3)
    tokens = np.random.default_rng(4).integers(0, cj.vocab_size, (B, 40))
    hj = j_hybrid.hybrid_hidden(cj, pj, jnp.asarray(tokens), remat=False)
    ht = t_hybrid.hybrid_hidden(ct, pt, torch.from_numpy(tokens))
    np.testing.assert_allclose(t2np(ht), to_np(hj), atol=2e-4)
    assert t_hybrid.n_sites(ct) == j_hybrid.n_sites(cj) == 2
    assert t_hybrid._groups(ct) == j_hybrid._groups(cj)
    full = get_config("zamba2-1.2b")
    assert t_hybrid._groups(full) == j_hybrid._groups(
        j_get_config("zamba2-1.2b"))
    assert t_hybrid.n_sites(full) == 7


# ------------------------------------------------- the model and serving
def test_build_serves_both_families(lm):
    """``build`` no longer raises for ``ssm`` and ``hybrid``; the spec tree
    is the reference's, leaf for leaf."""
    sj = jax.tree_util.tree_leaves_with_path(
        lm["mj"].param_specs, is_leaf=lambda v: hasattr(v, "axes"))
    st = _leaves_in_jax_order(lm["mt"].param_specs)
    assert len(sj) == len(st)
    for (_, a), b in zip(sj, st):
        assert tuple(a.shape) == tuple(b.shape) and a.axes == b.axes
        assert a.init == b.init and a.scale == b.scale
    for arch in ARCHS:
        m = build(get_config(arch))
        assert callable(m.prefill) and callable(m.decode)


def test_forward_matches_the_reference_full_logits(lm):
    full_j = _j_full_logits(lm, lm["tj"])
    full_t = lm["mt"].forward(lm["pt"], {"tokens": lm["tt"]})
    assert tuple(full_t.shape) == tuple(full_j.shape)
    np.testing.assert_allclose(t2np(full_t), to_np(full_j), atol=2e-4)


@pytest.mark.parametrize("prompt", [5, 37])
def test_prefill_then_decode_equals_the_full_forward(lm, prompt):
    """The port-side twin of tests/test_decode_equivalence.py, 2e-3 as
    there; six steps, from a one-chunk prompt and from a prompt of two
    chunks (the second ragged).  A state not written in place would decode
    every step from the prefill's state and drift from the second step."""
    mt, pt, tt = lm["mt"], lm["pt"], lm["tt"]
    steps = 6
    full = mt.forward(pt, {"tokens": tt[:, :prompt + steps]})
    logits, cache = mt.prefill(pt, {"tokens": tt[:, :prompt]})
    assert (logits[:, 0] - full[:, prompt - 1]).abs().max().item() < 2e-3
    cache = t_kv.pad_cache(cache, mt.cache_specs(B, prompt + steps))
    step = make_serve_step(mt)
    errs = []
    for i in range(prompt, prompt + steps):
        logits, cache = step(pt, cache, tt[:, i:i + 1], i)
        errs.append((logits[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 2e-3, errs


def test_prefill_and_decode_match_the_reference(lm):
    """Per-step logits within 2e-4 and the caches after each step."""
    mj, mt, pj, pt = lm["mj"], lm["mt"], lm["pj"], lm["pt"]
    tj, tt = lm["tj"], lm["tt"]
    lj, cache_j = mj.prefill(pj, {"tokens": tj[:, :P]})
    lt, cache_t = mt.prefill(pt, {"tokens": tt[:, :P]})
    np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4)
    cache_j = j_kv.pad_cache(cache_j, mj.cache_specs(B, T))
    cache_t = t_kv.pad_cache(cache_t, mt.cache_specs(B, T))
    for i in range(P, T):
        lj, cache_j = mj.decode(pj, cache_j, tj[:, i:i + 1], jnp.int32(i))
        lt, cache_t = mt.decode(pt, cache_t, tt[:, i:i + 1], i)
        np.testing.assert_allclose(t2np(lt), to_np(lj), atol=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(cache_j),
                    _leaves_in_jax_order(cache_t)):
        np.testing.assert_allclose(t2np(b), to_np(a), atol=2e-4)


def test_greedy_generate_tokens_equal_the_reference(lm):
    out_j = j_greedy(lm["mj"], lm["pj"], {"tokens": lm["tj"][:, :P]},
                     n_steps=6)
    out_t = greedy_generate(lm["mt"], lm["pt"], {"tokens": lm["tt"][:, :P]},
                            n_steps=6)
    assert out_t.dtype == torch.int32 and tuple(out_t.shape) == (B, 6)
    assert np.array_equal(out_t.numpy(), np.asarray(out_j))


def test_greedy_generate_from_a_two_chunk_prompt(lm):
    out_j = j_greedy(lm["mj"], lm["pj"], {"tokens": lm["tj"][:, :37]},
                     n_steps=3)
    out_t = greedy_generate(lm["mt"], lm["pt"], {"tokens": lm["tt"][:, :37]},
                            n_steps=3)
    assert np.array_equal(out_t.numpy(), np.asarray(out_j))


def test_cache_specs_pad_and_bytes_match_the_reference(lm):
    """The SSM state has no sequence axis: ``cache_specs`` ignores
    ``max_len`` for ``ssm``, and ``pad_cache`` hands its leaves on as they
    are; the hybrid's attention caches pad along the sequence."""
    mj, mt = lm["mj"], lm["mt"]
    sj, st = mj.cache_specs(B, T), mt.cache_specs(B, T)
    lj = jax.tree_util.tree_leaves(sj, is_leaf=lambda v: hasattr(v, "axes"))
    lt = _leaves_in_jax_order(st)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape) and a.axes == b.axes
        assert jnp.dtype(a.dtype).name == str(b.dtype).split(".")[-1] \
            and b.init == "zeros"
    if lm["arch"] == "mamba2-1.3b":
        assert mt.cache_specs(B, 7) == mt.cache_specs(B, 500) == st
    zj = j_kv.alloc_cache(mj, B, T)
    zt = t_kv.alloc_cache(mt, B, T, device="cpu")
    assert t_kv.cache_bytes(zt) == j_kv.cache_bytes(zj)
    _, cache = mt.prefill(lm["pt"], {"tokens": lm["tt"][:, :P]})
    padded = t_kv.pad_cache(cache, st)
    ssm_before = cache["ssm"] if "ssm" in cache else cache
    ssm_after = padded["ssm"] if "ssm" in padded else padded
    for k in ssm_before:
        assert ssm_after[k] is ssm_before[k]         # nothing to pad
    if "attn" in padded:
        for k in ("k", "v"):
            a, b = cache["attn"][k], padded["attn"][k]
            assert b.shape[2] == T and torch.equal(b[:, :, :P], a)
            assert not b[:, :, P:].any()


def test_full_width_cache_bytes():
    """The decode state of the served configs, counted from the specs:
    Mamba2-1.3B's is about 102 MB at batch 1 (48 layers of a 64 x 128 x 64
    float32 SSD state and three bf16 conv tails), Zamba2-1.2B's KV caches
    of its 7 sites about 132 MB at batch 4 x 576 positions."""
    def nbytes(tree):
        from repro_torch.models.sharding import tree_leaves
        return sum(int(np.prod(s.shape)) * torch.empty(
            (), dtype=s.dtype).element_size() for s in tree_leaves(tree))
    m = build(get_config("mamba2-1.3b"))
    assert nbytes(m.cache_specs(1, 0)) == 48 * (64 * 128 * 64 * 4
                                                + 3 * (4096 + 2 * 128) * 2)
    assert nbytes(m.cache_specs(4, 0)) == 4 * nbytes(m.cache_specs(1, 0))
    z = build(get_config("zamba2-1.2b"))
    kv = nbytes(z.cache_specs(4, 576)["attn"])
    assert kv == 7 * 2 * 4 * 576 * 32 * 64 * 2 == 132_120_576


def test_the_scan_runs_through_the_wrapper(lm, monkeypatch):
    """Prefill and the full forward reach the SSD scan through its wrapper
    once per Mamba layer; a decode step does not."""
    calls = []
    plain = ssd_ops.ssd_scan

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_scan", counting)
    mt, pt, tt, L = lm["mt"], lm["pt"], lm["tt"], lm["ct"].n_layers
    mt.forward(pt, {"tokens": tt[:, :T]})
    assert len(calls) == L
    _, cache = mt.prefill(pt, {"tokens": tt[:, :P]})
    assert len(calls) == 2 * L
    cache = t_kv.pad_cache(cache, mt.cache_specs(B, T))
    mt.decode(pt, cache, tt[:, P:P + 1], P)
    assert len(calls) == 2 * L


def test_bf16_final_hidden_state_matches_the_reference():
    """bfloat16 end to end, each package in its own roundings (XLA fuses
    where PyTorch writes bf16 between ops; the JAX package's bf16 sigmoid
    rounds after every step of 1 / (1 + exp(-x))): the final hidden state,
    after the final norm, within 5e-2 relative in norm.  The SSD's inner
    values (y up to ~20, the gate to ~35 at these widths) turn one-step
    bf16 differences into about 1 % (Mamba2, 2 layers) and 2 % (Zamba2, 4
    layers and 2 shared blocks) of the state; single elements of the
    normalised state then differ by up to ~0.2 in both directions."""
    from repro.models.layers import rmsnorm as j_rmsnorm
    from repro_torch.models.layers import rmsnorm as t_rmsnorm
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        cj, ct = cj.replace(dtype="bfloat16"), ct.replace(dtype="bfloat16")
        mj, mt = j_build(cj), build(ct)
        pj, pt = both_params(mj, mt, seed=5)
        tokens = np.random.default_rng(6).integers(0, cj.vocab_size, (B, 40))
        if arch == "mamba2-1.3b":
            from repro.models.layers import embed
            from repro.models.transformer import run_stack
            x = embed(pj["embed"], jnp.asarray(tokens)).astype(jnp.bfloat16)

            def one(pl, h):
                return h + j_ssm.mamba_forward(cj, pl, h), None, \
                    jnp.float32(0)

            hj, _, _ = run_stack(cj, pj["mamba"], x, one, cj.n_layers,
                                 remat=False)
            ht = t_ssm.ssm_lm_hidden(ct, pt, torch.from_numpy(tokens))
        else:
            hj = j_hybrid.hybrid_hidden(cj, pj, jnp.asarray(tokens),
                                        remat=False)
            ht = t_hybrid.hybrid_hidden(ct, pt, torch.from_numpy(tokens))
        assert ht.dtype == torch.bfloat16
        hj = to_np(j_rmsnorm(hj, pj["final_norm"], cj.norm_eps))
        ht = t2np(t_rmsnorm(ht, pt["final_norm"], ct.norm_eps))
        assert np.isfinite(ht).all()
        rel = np.linalg.norm(ht - hj) / np.linalg.norm(hj)
        assert rel < 5e-2, (arch, rel)


def test_converted_weights_are_checked_against_the_spec_tree(lm):
    """``from_numpy_tree(..., specs=)`` takes the JAX package's parameter
    tree of either family, and refuses one with a leaf missing."""
    np_tree = jax_tree_to_np(lm["pj"])
    t = from_numpy_tree(np_tree, "cpu", specs=lm["mt"].param_specs)
    assert t["mamba"]["A_log"].dtype == torch.bfloat16
    del np_tree["mamba"]["D"]
    with pytest.raises(KeyError, match="D"):
        from_numpy_tree(np_tree, "cpu", specs=lm["mt"].param_specs)
