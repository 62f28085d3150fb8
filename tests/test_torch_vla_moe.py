"""A VLA over a sparse-expert trunk with latent attention (Kimi-VL-A3B's
language model under the benchmark's ViT and CogACT's DiT head), on the
CPU: the dropless dispatch against a loop over the experts, the capacity
path as it was, the grouped trunk through the split executor, the ``moe``
span and its counters, and the planner's graph of the configuration.

The configuration is the benchmark's own file; the tests shrink its
widths (8 experts, top-2, width 64, ``kv_lora_rank`` 32) or keep them
where only shapes are read.  The comparisons are exact (float32 on the
CPU, one order of operations on both sides) but one, which says why."""
import json
import pathlib

import pytest
import torch
import torch.nn.functional as F

from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.telemetry import FlightRecorder
from repro_torch.models import build
from repro_torch.models import moe as M
from repro_torch.models import vla as V
from repro_torch.models.layers import dense, mlp
from repro_torch.models.sharding import tree_leaves
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILE = ROOT / "ecc_bench" / "configs" / "vla16b-a3b-vitl-dit.json"
FULL = ModelConfig(**json.loads(FILE.read_text())["config"])
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
             kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
             n_experts=8, moe_top_k=2, moe_d_ff=64, vit_layers=2,
             vit_dim=32, n_patches=16, dit_layers=2, dit_dim=32,
             dit_heads=2, diffusion_steps=2, action_horizon=4,
             dtype="float32")


def _small(**kw):
    return FULL.replace(**{**SMALL, "n_layers": 4, **kw})


def _params(cfg, seed=0):
    return build(cfg).init(torch.Generator().manual_seed(seed), "cpu")


def _inputs(cfg, B=2, S=5, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, cfg.n_patches, cfg.vit_dim, generator=g),
            torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            torch.randn(B, cfg.action_horizon, cfg.action_dim, generator=g))


def _loop_ffn(x2d, gates, eids, wg, wu, wd):
    """Each expert on its own rows, in token order, and each token's
    choices added in increasing expert id, in float32."""
    T, d = x2d.shape
    contrib = {}
    for e in range(wg.shape[0]):
        rows, slot = (eids == e).nonzero(as_tuple=True)
        if rows.numel():
            xe = x2d[rows]
            out = dense(F.silu(dense(xe, wg[e])) * dense(xe, wu[e]), wd[e])
            out = out * gates[rows, slot, None].to(out.dtype)
            for r, o in zip(rows.tolist(), out):
                contrib.setdefault(r, []).append((e, o))
    y = torch.zeros(T, d, dtype=torch.float32)
    for r, parts in contrib.items():
        acc = None
        for _, o in sorted(parts, key=lambda eo: eo[0]):
            acc = o.float() if acc is None else acc + o
        y[r] = acc
    return y.to(x2d.dtype)


def _choices(g, T, E, k):
    """k distinct experts a token, expert 1 chosen by nobody and expert
    E - 1 by every token."""
    rows = []
    for _ in range(T):
        others = [e for e in torch.randperm(E, generator=g).tolist()
                  if e not in (1, E - 1)]
        rows.append([E - 1] + others[:k - 1])
    return torch.tensor(rows)


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (64, 16, 6), (5, 8, 3)])
def test_dropless_dispatch_equals_a_loop_over_the_experts(T, E, k):
    """Whole numbers throughout the expert products (every gate input past
    20, where float32's sigmoid is 1 and SiLU the identity), so that each
    product is exact whatever rows it is batched with: the dispatch, the
    grouping and the combine's order are what is compared, exactly."""
    g = torch.Generator().manual_seed(T + E + k)
    d, f = 32, 48
    x = torch.randint(1, 4, (T, d), generator=g).float()
    wg = torch.randint(1, 3, (E, d, f), generator=g).float()
    wu, wd = (torch.randint(-2, 3, shape, generator=g).float()
              for shape in ((E, d, f), (E, f, d)))
    gates = torch.rand(T, k, generator=g)
    eids = _choices(g, T, E, k)
    got = M._dropless_expert_ffn(x, gates, eids, wg, wu, wd)
    assert torch.equal(got, _loop_ffn(x, gates, eids, wg, wu, wd))


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (64, 16, 6)])
def test_dropless_dispatch_is_close_to_the_loop_at_random_weights(T, E, k):
    """At random weights the products' rows depend on their batch by a
    rounding (vector and scalar tails of the CPU's kernels): within 1e-6."""
    g = torch.Generator().manual_seed(T * E * k)
    d, f = 32, 48
    x = torch.randn(T, d, generator=g)
    wg, wu = (torch.randn(E, d, f, generator=g) * d ** -0.5 for _ in "gu")
    wd = torch.randn(E, f, d, generator=g) * f ** -0.5
    gates, eids = torch.rand(T, k, generator=g), _choices(g, T, E, k)
    torch.testing.assert_close(
        M._dropless_expert_ffn(x, gates, eids, wg, wu, wd),
        _loop_ffn(x, gates, eids, wg, wu, wd), rtol=1e-6, atol=1e-6)


def test_grouped_product_runs_each_group_on_its_rows():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(7, 4, generator=g), torch.randn(3, 4, 5, generator=g)
    ends = torch.tensor([2, 2, 7], dtype=torch.int32)
    want = torch.cat([x[:2] @ w[0], x[2:] @ w[2]])
    assert torch.equal(M.grouped_mm(x, w, ends), want)


def test_sigmoid_routing_follows_the_equations():
    """The biased scores choose; the unbiased ones weigh, normalised over
    the chosen and scaled."""
    cfg = _small()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(50, cfg.d_model, generator=g)
    p = {"router": torch.randn(cfg.d_model, 8, generator=g) * 0.2,
         "bias": torch.randn(8, generator=g) * 0.3}
    gates, eids, aux = M.route(cfg, p, x)
    s = torch.sigmoid(x @ p["router"])
    want = torch.topk(s + p["bias"], 2, dim=-1).indices
    assert torch.equal(eids, want) and aux == 0.0
    chosen = s.gather(1, want)
    torch.testing.assert_close(gates, 2.446 * chosen / chosen.sum(-1,
                                                                  True))
    # the bias moves some choices, and without it others are made
    unbiased = torch.topk(s, 2, dim=-1).indices
    assert not torch.equal(unbiased, want)


def test_the_capacity_path_is_as_it_was():
    """A config without the new fields routes by softmax, drops past the
    capacity and adds the shared expert, as before them."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    assert (cfg.moe_score, cfg.moe_routed_scale) == ("softmax", 1.0)
    assert "bias" not in M.moe_specs(cfg)
    p = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    pm = {k: (v[0] if not isinstance(v, dict) else
              {n: w[0] for n, w in v.items()})
          for k, v in p["moe_blocks"]["moe"].items()}
    x = torch.randn(2, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    rec = FlightRecorder(mode="full")
    rec.open_run("cpu")
    got, aux = M.moe_ffn(cfg, pm, x, rec)
    x2d = x.reshape(-1, cfg.d_model)
    gates, eids, aux_w = M._route(x2d, pm["router"], cfg.moe_top_k)
    C = M.capacity(18, cfg.n_experts, cfg.moe_top_k,
                   cfg.moe_capacity_factor)
    want = M._local_expert_ffn(x2d, gates, eids, pm["wg"], pm["wu"],
                               pm["wd"], E=cfg.n_experts, C=C
                               ).reshape(x.shape) + mlp(pm["shared"], x)
    assert torch.equal(got, want) and torch.equal(aux, aux_w)
    assert rec.metrics.snapshot()["counters"] == {M.CAPACITY: 1}


def test_existing_vla_trees_keep_their_leaves():
    """A dense VLA's parameter tree is the one it was: one ``blocks`` stack
    between the embedding and the final norm."""
    specs = build(get_config("cogact-7b")).param_specs
    assert list(specs) == ["vit", "embed", "blocks", "final_norm", "head",
                           "action"]
    assert specs["blocks"]["mlp"]["wg"].shape == (32, 4096, 11008)


def test_the_trunk_is_grouped_with_mla_and_experts():
    specs = build(FULL).param_specs
    assert list(specs) == ["vit", "embed", "dense_blocks", "moe_blocks",
                           "final_norm", "head", "action"]
    assert specs["dense_blocks"]["mlp"]["wg"].shape == (1, 2048, 11264)
    assert specs["moe_blocks"]["moe"]["wg"].shape == (26, 64, 2048, 1408)
    assert specs["moe_blocks"]["moe"]["shared"]["wd"].shape == (26, 2816,
                                                                2048)
    bias = specs["moe_blocks"]["moe"]["bias"]
    assert bias.shape == (26, 64) and bias.dtype == torch.float32
    assert bias.scale == 0.05 and bias.init == "zeros"
    assert specs["moe_blocks"]["attn"]["wkv_a"].shape == (26, 2048, 576)
    n = sum(s.shape.numel() if hasattr(s.shape, "numel") else
            torch.Size(s.shape).numel() for s in tree_leaves(specs))
    assert n == json.loads(FILE.read_text())["parameters"] == 16495387264


@pytest.mark.parametrize("lo,hi", [(0, 4), (1, 3)])
def test_every_cut_gives_the_whole_forward(lo, hi):
    """A pool across the dense/MoE boundary and one inside the MoE group:
    every cut in it, split or not, gives ``vla_forward``'s action and the
    same payload at the same cut."""
    cfg = _small()
    params = _params(cfg)
    patches, tokens, noise = _inputs(cfg)
    want = V.vla_forward(cfg, params, patches, tokens, noise=noise)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv + lo, Lv + hi), device="cpu")
    whole = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + cfg.n_layers),
                             device="cpu")
    for cut in range(lo, hi + 1):
        action, payload = ex.run(params, patches, tokens, Lv + cut,
                                 noise=noise)
        assert torch.equal(action, want)
        _, same = whole.run(params, patches, tokens, Lv + cut, noise=noise)
        assert torch.equal(payload["x"], same["x"])


def test_a_run_keeps_its_choices_beside_what_it_ships():
    """Over a trunk with experts the payload keeps each MoE block's choice,
    in block order, as routed, and the wire counts only what it ships; a
    dense VLA's payload is the plain dict it was."""
    from repro_torch.runtime.partition import Shipped, payload_bytes
    cfg = _small()
    params = _params(cfg)
    patches, tokens, noise = _inputs(cfg)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + 4, codec="int8"),
                          device="cpu")
    seen = []
    route = M.route

    def watched(*a):
        out = route(*a)
        seen.append(out[1])
        return out
    M.route = watched
    try:
        _, payload = ex.run(params, patches, tokens, Lv + 2, noise=noise)
    finally:
        M.route = route
    assert isinstance(payload, Shipped) and set(payload) == {"q", "s"}
    assert len(payload.choices) == 3 == len(seen)
    assert all(torch.equal(a, b) for a, b in zip(payload.choices, seen))
    assert payload.choices[0].shape == (2 * (cfg.n_patches + 5), 2)
    assert payload_bytes(payload) == payload_bytes(dict(payload))
    dense = get_config("cogact-7b").reduced()
    dense = dense.replace(vla_action_head="dit", dtype="float32")
    ex = VLASplitExecutor(dense, SplitPlan(dense.vit_layers,
                                           dense.vit_layers + 2),
                          device="cpu")
    _, payload = ex.run(_params(dense), *_inputs(dense)[:2],
                        dense.vit_layers + 1, noise=_inputs(dense)[2])
    assert type(payload) is dict


def test_moe_spans_nest_in_the_tiers_and_count_the_dispatch():
    cfg = _small(n_layers=5)
    params = _params(cfg)
    patches, tokens, noise = _inputs(cfg)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + 5), device="cpu")
    rec = FlightRecorder(mode="full")
    plain, _ = ex.run(params, patches, tokens, Lv + 3, noise=noise)
    action, _ = ex.run(params, patches, tokens, Lv + 3, noise=noise,
                       recorder=rec)
    assert torch.equal(action, plain)
    spans = [(s.name, s.parent) for grp in rec.spans.items for s in grp]
    assert spans.count(("moe", "edge_blocks")) == 2     # blocks 1, 2
    assert spans.count(("moe", "cloud_blocks")) == 2    # blocks 3, 4
    assert rec.metrics.snapshot()["counters"][M.DROPLESS] == 4
    assert M.CAPACITY not in rec.metrics.snapshot()["counters"]


def test_full_depth_counts_26_dropless_calls_a_step():
    """The configuration's depth and expert count at small widths: a step
    calls the dropless FFN once in each of the 26 MoE layers."""
    cfg = FULL.replace(**{**SMALL, "n_experts": 64, "moe_top_k": 6})
    assert cfg.n_layers == 27 and cfg.first_dense_layers == 1
    params = _params(cfg)
    patches, tokens, noise = _inputs(cfg, B=1, S=3)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + 6), device="cpu")
    rec = FlightRecorder(mode="full")
    ex.run(params, patches, tokens, Lv + 4, noise=noise, recorder=rec)
    counters = rec.metrics.snapshot()["counters"]
    assert counters[M.DROPLESS] == 26 and M.CAPACITY not in counters


def test_moe_under_the_profiler_is_a_range():
    from torch.profiler import ProfilerActivity, profile
    cfg = _small()
    params = _params(cfg)
    patches, tokens, noise = _inputs(cfg)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + 4), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run(params, patches, tokens, Lv + 2, noise=noise)
    names = [e.name for e in prof.events()]
    assert names.count("roboecc.moe") == 3


def test_the_graph_holds_every_expert_and_counts_the_chosen():
    """The planner's graph of the configuration: each MoE layer's resident
    weights over all 64 experts, its operations over the router, the 6
    chosen experts and the shared one, attention as MLA."""
    w = core.Workload(s_new=17, decode_steps=0)
    g = core.build_graph(FULL, w)
    names = [c.name for c in g]
    assert names[:25] == [f"vit.{i}" for i in range(24)] + ["vit.proj"]
    assert names[25:52] == [f"llm.{i}" for i in range(27)]
    assert names[52:] == [f"dit.{i}" for i in range(12)]
    d, E, f, S, T = 2048, 64, 1408, 17, w.s_ctx
    attn_w = d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d
    moe_w = E * 3 * d * f + d * E + 2 * 3 * d * f
    layer = {c.name: c for c in g}
    assert layer["llm.1"].kind == "moe" and layer["llm.0"].kind == "llm"
    assert layer["llm.1"].weight_bytes == 2 * (attn_w + moe_w) \
        == 2 * 584_843_264
    assert layer["llm.0"].weight_bytes == 2 * (attn_w + 3 * d * 11264)
    mla = 2 * S * d * 16 * 192 + 2 * S * d * 576 + 2 * S * 512 * 16 * 256 \
        + 2 * S * 16 * 128 * d + 2 * S * T * 16 * 192 + 2 * S * T * 16 * 128
    assert layer["llm.1"].flops == mla + 2 * S * d * E + 2 * S * 8 * 3 * d * f
    trunk = sum(c.weight_bytes for c in g if c.name.startswith("llm."))
    assert trunk == 2 * (27 * attn_w + 3 * d * 11264 + 26 * moe_w)
    # the dense branch of the JAX package's structure would count about a
    # seventh of the weights a MoE layer holds
    from repro_torch.core import structure
    dense = {c.name: c for c in structure.build_graph(FULL, w)}
    assert 6.5 < layer["llm.1"].weight_bytes / dense["llm.1"].weight_bytes


def test_the_graph_of_every_registered_config_is_structures():
    from repro_torch.configs import ARCHS
    from repro_torch.core import structure
    for cfg in ARCHS.values():
        assert core.build_graph(cfg) == structure.build_graph(cfg)
