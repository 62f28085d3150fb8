"""The port's model code on a mesh of gloo ranks: expert parallelism, the
sequence- and tensor-parallel decode, the int8-ring projection and flash
attention on local heads (twins of ``tests/test_multidevice.py``'s MoE
test, and of the JAX package's ``decode_attn="sp"`` and
``tp_collective="int8_ring"`` paths).

Each module fixture spawns its ranks once (``repro_torch.launch.ranks``,
a ``file://`` store under the test's temporary directory) and runs several
jobs in them; the tests hold what came back against the JAX package and
the port on one rank, in float32."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_spmd_util as U
from _torch_port_util import jax_tree_to_np
from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe
from repro.models.sharding import init_params as j_init_params
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import build
from repro_torch.models.attention import attn_forward, attn_specs
from repro_torch.models.layers import dense
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.sharding import init_params, tree_map
from repro_torch.runtime.serving import greedy_generate

LLAMA = "llama3.2-3b"
GRANITE = "granite-moe-3b-a800m"


# ------------------------------------------------------------------ MoE
def _moe_case(**kw):
    jcfg = j_get_config(GRANITE).reduced().replace(dtype="float32", **kw)
    jp = j_init_params(j_moe.moe_specs(jcfg), jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 16, jcfg.d_model)), np.float32)
    y, aux = j_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    return jax_tree_to_np(jp), x, np.asarray(y), float(aux)


MOE_KW = {"1x8": dict(n_experts=8, moe_top_k=2),
          "1x3": dict(n_experts=5, moe_top_k=2)}   # 16-row table over 3


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    out = {}
    for name, shape in (("1x8", (1, 8)), ("1x3", (1, 3)), ("2x2", (2, 2))):
        kw = MOE_KW.get(name, MOE_KW["1x8"])
        pnp, x, y_ref, aux_ref = _moe_case(**kw)
        c = np.random.default_rng(4).standard_normal(x.shape).astype(
            np.float32)
        ranks = run_ranks(U.jobs_rank, shape[0] * shape[1],
                          str(tmp_path_factory.mktemp("moe") / name),
                          [("moe_rank", (shape, GRANITE,
                                         dict(kw, dtype="float32"), pnp, x)),
                           ("moe_grad_rank", (shape, GRANITE,
                                              dict(kw, dtype="float32"), pnp,
                                              x, c))])
        out[name] = (pnp, x, y_ref, aux_ref, [r[0] for r in ranks],
                     c, [r[1] for r in ranks])
    return out


@pytest.mark.parametrize("mesh", ["1x8", "1x3", "2x2"])
def test_moe_expert_parallel_matches_one_device(moe_run, mesh):
    pnp, x, y_ref, aux_ref, ranks, _, _ = moe_run[mesh]
    cfg = U.small_cfg(GRANITE, dtype="float32",
                      **MOE_KW.get(mesh, MOE_KW["1x8"]))
    specs = moe_specs(cfg)
    assert specs["wg"].shape[0] % int(mesh[2:]) == (1 if mesh == "1x3"
                                                    else 0)
    p = tree_map(lambda t: t.float(),
                 from_numpy_tree(pnp, "cpu", specs=specs))
    y1, aux1 = moe_ffn(cfg, p, torch.from_numpy(x))
    for y, aux in ranks:
        assert float(np.abs(y.numpy() - y_ref).max()) < 1e-4
        assert float((y - y1).abs().max()) < 1e-4
        assert aux == pytest.approx(aux_ref, rel=1e-5)
        assert aux == pytest.approx(float(aux1), rel=1e-5)


@pytest.mark.parametrize("mesh", ["1x8", "1x3", "2x2"])
def test_moe_expert_parallel_gradients_match_one_device(moe_run, mesh):
    """The region's gradients: x and the router are read by every model
    rank for its own experts, the tables by every data rank for its own
    tokens; each arrives summed."""
    pnp, x, _, _, _, c, grads = moe_run[mesh]
    cfg = U.small_cfg(GRANITE, dtype="float32",
                      **MOE_KW.get(mesh, MOE_KW["1x8"]))
    p = tree_map(lambda t: t.float(),
                 from_numpy_tree(pnp, "cpu", specs=moe_specs(cfg)))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [xt, p["router"], p["wg"], p["wd"]]
    for t in leaves[1:]:
        t.requires_grad_(True)
    y, aux = moe_ffn(cfg, p, xt)
    ((y * torch.from_numpy(c)).sum() + aux).backward()
    for r in grads:
        for got, t in zip(r, leaves):
            scale = max(float(t.grad.abs().max()), 1e-6)
            assert float((got - t.grad).abs().max()) <= 1e-5 * scale


# ----------------------------------------------- decode, projection, B5
PROMPT_LEN, STEPS = 12, 6
DEC = {"sp": dict(n_layers=2, dtype="float32", decode_attn="sp"),
       "tp": dict(n_layers=2, dtype="float32"),
       "tp_kv2": dict(n_layers=2, dtype="float32", n_kv_heads=2)}


def _llama(kw):
    cfg = U.small_cfg(LLAMA, **kw)
    model = build(cfg)
    p = tree_map(lambda t: t.float(), init_params(
        model.param_specs, torch.Generator().manual_seed(0), "cpu"))
    return cfg, model, p, tree_map(lambda t: t.numpy(), p)


@pytest.fixture(scope="module")
def mesh4_run(tmp_path_factory):
    prompt = np.random.default_rng(2).integers(
        0, 256, (1, PROMPT_LEN)).astype(np.int32)
    ref, jobs = {}, []
    for name, kw in DEC.items():
        cfg, model, p, pnp = _llama(kw)
        toks = greedy_generate(model, p, {"tokens": torch.from_numpy(prompt)},
                               STEPS)
        ref[name] = (toks, pnp)
        jobs.append(("decode_rank", ((1, 4), LLAMA, kw, pnp, prompt, STEPS,
                                     False, "long_decode")))
    # int8 ring on the row-parallel projections, fed the one-rank tokens
    jobs.append(("decode_rank", ((1, 4), LLAMA, DEC["tp"], ref["tp"][1],
                                 prompt, STEPS, True, "long_decode",
                                 ref["tp"][0].numpy())))
    jobs.append(("decode_rank", ((1, 4), LLAMA, DEC["tp"], ref["tp"][1],
                                 prompt, STEPS, False, "long_decode",
                                 ref["tp"][0].numpy())))
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    jobs.append(("proj_rank", ((1, 4), h, w)))
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    attn = {}
    for kv in (4, 2):
        cfg = U.small_cfg(LLAMA, dtype="float32", n_kv_heads=kv)
        specs = attn_specs(cfg)
        ap = tree_map(lambda t: t.float(), init_params(
            specs, torch.Generator().manual_seed(kv), "cpu"))
        attn[kv] = (cfg, ap)
        jobs.append(("attn_rank", ((2, 2) if kv == 4 else (1, 4), LLAMA,
                                   dict(dtype="float32", n_kv_heads=kv),
                                   tree_map(lambda t: t.numpy(), ap), x)))
    # one int8-ring train step on data 2 x model 2 (for the host group's
    # twin below)
    _, _, tp, tpnp = _llama(dict(n_layers=2))
    toks = rng.integers(0, 256, (4, 8)).astype(np.int32)
    jobs.append(("train_rank", ((2, 2), LLAMA, dict(n_layers=2,
                                                    dtype="float32"),
                                tpnp, {"tokens": toks,
                                       "labels": np.roll(toks, -1, 1)},
                                1, "int8_ring", 1e-3, True, 1)))
    ranks = run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("m4")),
                      jobs)
    return prompt, ref, ranks, (h, w), (x, attn), jobs


@pytest.mark.parametrize("mode", ["sp", "tp", "tp_kv2"])
def test_decode_on_the_model_axis_gives_the_one_rank_tokens(mesh4_run,
                                                            mode):
    _, ref, ranks, _, _, _ = mesh4_run
    j = list(DEC).index(mode)
    for r in ranks:
        assert torch.equal(r[j][0], ref[mode][0]), mode


def test_int8_ring_projections_logits_within_bound(mesh4_run):
    _, _, ranks, _, _, _ = mesh4_run
    exact, ring = ranks[0][4][1], ranks[0][3][1]
    assert torch.equal(ranks[0][3][0], ranks[0][4][0])     # forced tokens
    # int8 on the wire of every row-parallel combine: logits within 2 % of
    # their largest magnitude, and the int8 run is not the exact one
    scale = float(exact.abs().max())
    err = float((ring - exact).abs().max())
    assert 0 < err <= 0.02 * scale, (err, scale)


def test_int8_ring_proj_within_the_ring_bound(mesh4_run):
    _, _, ranks, (h, w), _, _ = mesh4_run
    exact = dense(torch.from_numpy(h), torch.from_numpy(w)).numpy()
    parts = [h[..., 8 * r:8 * (r + 1)] @ w[8 * r:8 * (r + 1)]
             for r in range(4)]
    bound = 2 * 3 * 0.5 / 127 * sum(float(np.abs(p).max()) for p in parts)
    for r in ranks:
        got = r[5].numpy()
        assert float(np.abs(got - exact).max()) <= bound


@pytest.mark.parametrize("kv", [4, 2])
def test_flash_attention_on_local_heads(mesh4_run, kv):
    """B5's path on each rank's heads: 4 KV heads over model = 2 (local
    GQA), and 2 KV heads over model = 4 (each rank handed the K/V head its
    query head reads); forward and the gradient of x against one rank."""
    _, _, ranks, _, (x, attn), _ = mesh4_run
    cfg, ap = attn[kv]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = attn_forward(cfg, ap, xt, torch.arange(x.shape[1]))
    y.sum().backward()
    j = 6 if kv == 4 else 7
    for r in ranks:
        got_y, got_g = r[j]
        assert float((got_y - y.detach()).abs().max()) < 1e-5
        assert float((got_g - xt.grad).abs().max()) < 1e-5


# the host group on the CPU: the jobs of the decode, the int8-ring
# projection and the int8-ring train step again, on ``hostgloo``
HOSTGLOO_JOBS = (0, 1, 5, 8)


@pytest.fixture(scope="module")
def hostgloo_run(mesh4_run, tmp_path_factory):
    jobs = [mesh4_run[-1][j] for j in HOSTGLOO_JOBS] + [("staged_rank", ())]
    return run_ranks(U.jobs_rank, 4, str(tmp_path_factory.mktemp("hg")),
                     jobs, backend="hostgloo")


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_host_group_gives_gloos_results_on_the_cpu(mesh4_run, hostgloo_run):
    """``launch/host_group.py`` (the card's backend for several ranks on
    one device) carries the sp / tp decode's collectives, the int8 ring's
    hops and the train step's reductions; on CPU tensors it is gloo, so
    every result is bit-equal to the gloo ranks', and it ran collectives
    with nothing to stage."""
    ranks = mesh4_run[2]
    for r, h in zip(ranks, hostgloo_run):
        for i, j in enumerate(HOSTGLOO_JOBS):
            assert _same(h[i], r[j]), mesh4_run[-1][j][0]
        staged = h[-1]
        assert staged["ops"] > 0 and staged["bytes"] == 0, staged
