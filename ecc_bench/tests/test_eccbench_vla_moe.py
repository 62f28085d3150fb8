"""The cell of a VLA over a sparse-expert trunk with latent attention
(``vla16b-a3b-vitl-dit.fleet64-ecc``) on the CPU, at a size it runs in
seconds: the frozen reference against the port in float32 at cuts on both
sides of the dense/MoE boundary, the reference following the program's
choice of experts at a near-tie and not past it, whole runs that come out
correct under the cell's own limits, and faults in the router and the
combine that do not.

``tiny.py`` cuts every cell's shared widths; the MoE and MLA widths are cut
here (8 experts, top-2, width 64, ``kv_lora_rank`` 32), with 4 blocks: the
dense one and 3 MoE blocks."""
import pytest
import torch

from ecc_bench import catalog, harness, weights, work, work_moe
from ecc_bench.reference import vla_moe as ref
from ecc_bench.tests import tiny
from ecc_bench.tests.test_eccbench_guard import _loaded

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build
from repro_torch.models import moe as M
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

CELL = "vla16b-a3b-vitl-dit.fleet64-ecc"
SEED = 2 ** 31 + 77                     # larger than 32 signed bits
MOE = dict(n_layers=4, n_heads=4, n_kv_heads=4, kv_lora_rank=32,
           qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32, n_experts=8,
           moe_top_k=2, moe_d_ff=64)
MARGIN = 1e-5    # the least gap between the k-th and (k+1)-th choice:
#                   ten times the two sides' float32 difference in a score


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny cell's operations are too small to
    share, and under the suite's parallel workers a thread per core each
    spends most of a run waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(limited=True):
    c = tiny.cell(CELL)
    c.config["config"].update(MOE)
    if limited:
        c.limits = catalog.cell(CELL).limits
    return c


def _setup(seed=3):
    cell = _cell(False)
    c = dict(cell.config["config"], dtype="float32")
    cfg = ModelConfig(**c)
    params = weights.draw(build(cfg).param_specs, seed, "cpu")
    fleet = cell.family.Inputs({"config": c}, cell.traffic, seed, "cpu")
    return c, cfg, params, fleet


@pytest.mark.parametrize("edge_blocks", [0, 1, 2, 3])
def test_reference_matches_the_port_in_float32(monkeypatch, edge_blocks):
    """Cuts before and after the dense block and inside the MoE group;
    every token's choice clear of the next expert by ``MARGIN``, so that
    no near-tie decides a choice on one side and not the other."""
    c, cfg, params, fleet = _setup()
    gaps = []
    route = ref.route

    def watched(*a):
        out = route(*a)
        top = out[2].topk(c["moe_top_k"] + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return out
    monkeypatch.setattr(ref, "route", watched)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + cfg.n_layers), device="cpu")
    patches, noise = fleet.images(0), fleet.noise(0)
    action, payload = ex.run(params, patches, fleet.tokens, Lv + edge_blocks,
                             noise=noise)
    want = ref.request(c, params, patches, fleet.tokens, edge_blocks, "",
                       noise)
    assert len(gaps) == 3 and min(gaps) > MARGIN
    torch.testing.assert_close(payload["x"], want["wire"], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(action, want["action"], rtol=1e-4, atol=1e-4)
    # the program's choices, followed, are the reference's own here
    led = ref.request(c, params, patches, fleet.tokens, edge_blocks, "",
                      noise, choices=payload.choices)
    assert all(torch.equal(led[k], want[k]) for k in want)


def test_the_reference_follows_a_near_tie_and_not_past_it():
    """A choice of ``k`` distinct experts none more than ``TIE`` below the
    k-th biased score is followed, its gates the reference's own scores;
    one further below, a repeated expert, or another ``k`` is not."""
    pick = torch.tensor([[0.9, 0.5, 0.5 - ref.TIE / 2, 0.1],
                         [0.9, 0.5, 0.5 - 2 * ref.TIE, 0.1],
                         [0.9, 0.5, 0.4, 0.1]])
    theirs = torch.tensor([[0, 2], [0, 2], [0, 0]])
    assert ref.followed(pick, theirs, 2).tolist() == [True, False, False]
    assert not ref.followed(pick, theirs[:, :1], 2).any()
    assert not ref.followed(pick, None, 2).any()
    c = {"moe_top_k": 2, "moe_routed_scale": 2.0}
    m = {"router": [torch.logit(pick)], "bias": [torch.zeros(4)]}
    chosen, gates, _ = ref.route(c, m, 0, torch.eye(3), None, theirs)
    assert chosen[0].tolist() == [0, 2]
    assert [sorted(r) for r in chosen[1:].tolist()] == [[0, 1], [0, 1]]
    s = pick.gather(1, chosen)
    torch.testing.assert_close(gates, 2.0 * s / s.sum(-1, keepdim=True))


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(trace):
    cell = _cell()
    out = harness.run(cell, SEED, 0.2, bool(trace), "cpu")
    assert out["correct"] is True, out["check"]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in want
                                   if m["source"] != "device_trace"}
    assert all(e["value"] > 0 for e in out["metrics"].values())
    if trace:
        assert "moe_ffn_ms" in out["metrics"]


def _combine_drops_a_choice(orig):
    """The combine adds every choice but the last."""
    def ffn(x2d, gates, eids, wg, wu, wd):
        return orig(x2d, gates[:, :-1], eids[:, :-1], wg, wu, wd)
    return ffn


def _router_unscaled(orig):
    """The gates left without the routed scale."""
    def route_sigmoid(x2d, router, bias, top_k, scale):
        return orig(x2d, router, bias, top_k, 1.0)
    return route_sigmoid


def _router_unbiased(orig):
    """The choice made on the scores alone, the bias left out."""
    def route_sigmoid(x2d, router, bias, top_k, scale):
        return orig(x2d, router, None, top_k, scale)
    return route_sigmoid


@pytest.mark.parametrize("attr,fault", [
    ("_dropless_expert_ffn", _combine_drops_a_choice),
    ("_route_sigmoid", _router_unscaled),
    ("_route_sigmoid", _router_unbiased)])
def test_a_fault_in_the_router_or_the_combine_is_not_correct(
        monkeypatch, attr, fault):
    """Under the cell's own limits."""
    cell = _cell()
    monkeypatch.setattr(M, attr, fault(getattr(M, attr)))
    out = harness.run(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is False, out["check"]


def test_the_control_is_held_to_the_programs_choices():
    from ecc_bench.check import Kept
    fam = catalog.cell(CELL).family
    kept = Kept(3, {"edge_blocks": 17, "codec": "int4"},
                fam._Payload({"q4": torch.zeros(1)}, ["choices"]),
                torch.zeros(2))
    low = fam.as_control(_full(), kept, {"wire": torch.ones(1),
                                         "action": torch.ones(2)})
    assert low.payload.choices == ["choices"] == fam._choices(low)
    assert set(low.payload) == {"x"} and low.step == 3


def test_the_reference_loads_nothing_of_either_package():
    top = _loaded(["ecc_bench.reference.vla_moe"])
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


# ------------------------------------------------------------ the readers
def _full():
    return catalog.cell(CELL).config["config"]


def test_work_moe_counts_the_cells_expert_products():
    c, T = _full(), 64 * 273
    flops, nbytes = work_moe.routed(c, T)
    assert flops == 2 * 17_472 * 6 * 3 * 2048 * 1408 == 1_813_751_267_328
    assert nbytes == 2 * (64 * 3 * 2048 * 1408 + 2 * 104_832 * 2048) \
        == 1_966_080_000
    flops, nbytes = work_moe.shared(c, T)
    assert flops == 2 * 17_472 * 3 * 2048 * 2816 == 604_583_755_776
    assert nbytes == 2 * (3 * 2048 * 2816 + 2 * 17_472 * 2048)
    assert work_moe.moe_layers(c) == 26
    assert work.least_seconds(*work_moe.routed(c, T))[1] == "flops"


def test_the_dense_readers_read_the_configuration():
    """``work.py`` counts each trunk block as a dense one (q, k, v, o at
    head dim 128 and a SwiGLU of ``d_ff``): the step's operations about 3 %
    above the sparse trunk's (PERF.md), and no key missing."""
    c = _full()
    block = 2 * 273 * (4 * 2048 ** 2 + 3 * 2048 * 11264) \
        + 2 * 16 * 128 * 273 * 274
    assert work.llm_block_flops(c, 273) == block == 47_253_233_664
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    sparse = 2 * 273 * (mla + 2048 * 64 + 3 * 2048 * 1408 * 8) \
        + 273 * 274 * 16 * (192 + 128)
    assert 1.02 < block / sparse < 1.04
    assert work.action_flops(c, 17) > 27 * block


def _reading(spans=None, trace=None, steps=2, config=None):
    step = harness.Step(0, 0.0, 1.0, 64, 17, "int4", 1, None)
    return harness.Reading(config or _full(), 273, 1.0, 1.0, [step] * steps,
                           1, spans or {}, trace)


def test_moe_ffn_ms_sums_a_steps_spans():
    read = catalog.cell(CELL).metric_reader("moe_ffn_ms").read
    spans = [1.0] * 26 + [2.0] * 26
    assert read(_reading({"moe": spans})) == 39.0        # (26 + 52) / 2
    assert read(_reading({})) is None                    # no moe span
    assert read(_reading({"moe": spans[:-1]})) is None   # not 26 a step
    dense = catalog.cell("vla7b-vitl-dit.fleet64-ecc").config["config"]
    assert read(_reading({"moe": spans}, config=dense)) is None


def test_moe_roofline_share_reads_the_grouped_products():
    from ecc_bench import devtrace
    read = catalog.cell(CELL).metric_reader("moe_roofline_share").read
    grouped = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel"
               "_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblem"
               "ShapeIN4cute5tupleIJiiiEEEEE")
    least = work.least_seconds(*work_moe.routed(_full(), 64 * 273))[0]
    ops = [devtrace.Op(grouped, 0.0, 2e6 * least * 26),
           devtrace.Op("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 0.0, 1e9),
           devtrace.Op("void at::native::elementwise_kernel", 0.0, 1e9)]
    trace = devtrace.DeviceTrace(0.0, 1e9, ops, steps=[_reading().steps[0]])
    assert read(_reading(trace=trace)) == pytest.approx(50.0)
    assert read(_reading()) is None
    none = devtrace.DeviceTrace(0.0, 1e9, ops[1:],
                                steps=[_reading().steps[0]])
    assert read(_reading(trace=none)) is None


def test_the_mla_prefill_geometry_is_built_in_the_flash_attention():
    from repro_torch.kernels.flash_attention import ops as fa
    c = _full()
    assert (c["qk_nope_dim"] + c["qk_rope_dim"], c["v_head_dim"]) \
        in fa.HEAD_DIM_PAIRS
