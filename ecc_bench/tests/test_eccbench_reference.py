"""The frozen reference against the port's own plain path, at a reduced
size on the CPU in float32, where the two have to agree to rounding.

This test imports both; the reference itself imports neither the port nor
the JAX package (``test_eccbench_guard.py``)."""
import pytest
import torch

from ecc_bench import weights
from ecc_bench.reference import codec as wire
from ecc_bench.reference import vla as ref
from ecc_bench.tests import tiny

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.activation_codec import ref as port_codec
from repro_torch.models import build
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

CELLS = ["vla7b-vitl-detok.fleet32-int8", "vla7b-vitl-dit.fleet64-ecc"]


def _setup(name, seed=3):
    cell = tiny.cell(name)
    c = dict(cell.config["config"], dtype="float32")
    cfg = ModelConfig(**c)
    params = weights.draw(build(cfg).param_specs, seed, "cpu")
    fleet = cell.family.Inputs({"config": c}, cell.traffic, seed, "cpu")
    return c, cfg, params, fleet


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("edge_blocks", [0, 1, 2])
def test_reference_matches_the_port_in_float32(name, edge_blocks):
    c, cfg, params, fleet = _setup(name)
    Lv = cfg.vit_layers
    ex = VLASplitExecutor(cfg, SplitPlan(Lv, Lv + cfg.n_layers), device="cpu")
    patches, noise = fleet.images(0), fleet.noise(0)
    action, payload = ex.run(params, patches, fleet.tokens, Lv + edge_blocks,
                             noise=noise)
    want = ref.request(c, params, patches, fleet.tokens, edge_blocks, "",
                       noise)
    torch.testing.assert_close(payload["x"], want["wire"], rtol=1e-4,
                               atol=1e-4)
    if c["vla_action_head"] == "detok":
        logits = want["logits"]
        top2 = logits.topk(2, dim=-1).values
        assert (top2[..., 0] - top2[..., 1]).min() > 1e-3   # no near-tie
        bins = (logits.argmax(-1) % 256).float() / 127.5 - 1.0
        torch.testing.assert_close(action.reshape(bins.shape), bins)
    else:
        torch.testing.assert_close(action, want["action"], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(2, 5, 256), (1, 3, 512)])
def test_frozen_codec_equals_the_ports_plain_codec(codec, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 3
    if codec == "int8":
        q, s = wire.quantize_int8(x)
        q_p, s_p = port_codec.quantize_int8(x)
        out_p = port_codec.dequantize_int8(q_p, s_p, torch.float32)
        out = wire.dequantize_int8(q, s)
    else:
        q, s = wire.quantize_int4(x)
        q_p, s_p = port_codec.quantize_int4(x)
        out_p = port_codec.dequantize_int4(q_p, s_p, torch.float32)
        out = wire.dequantize_int4(q, s)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert torch.equal(out, out_p)
    assert torch.equal(wire.roundtrip(x, codec), out)


def test_decode_payload_reads_each_format():
    x = torch.randn(2, 3, 256)
    assert torch.equal(wire.decode_payload({"x": x}), x)
    q, s = wire.quantize_int8(x)
    assert torch.equal(wire.decode_payload({"q": q, "s": s}),
                       wire.dequantize_int8(q, s))
    q4, s4 = wire.quantize_int4(x)
    assert torch.equal(wire.decode_payload({"q4": q4, "s": s4}),
                       wire.dequantize_int4(q4, s4))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_departs_from_the_reference(name):
    """float8 products move the reference's outputs by far more than
    float32 rounding does."""
    c, cfg, params, fleet = _setup(name)
    patches, noise = fleet.images(1), fleet.noise(1)
    full = ref.request(c, params, patches, fleet.tokens, 1, "", noise)
    low = ref.request(c, params, patches, fleet.tokens, 1, "", noise,
                      lowp="fp8")
    rel = ((low["wire"] - full["wire"]).norm() / full["wire"].norm()).item()
    assert 1e-2 < rel < 0.5
    with pytest.raises(ValueError):
        ref.linear(patches, params["vit"]["proj"][:c["vit_dim"]], "int3")


@pytest.mark.parametrize("codec", ["", "int8"])
@pytest.mark.parametrize("name", CELLS)
def test_the_cloud_part_alone_continues_the_request(name, codec):
    """``cloud`` from the activation after the wire gives what ``request``
    gives, so a request can be judged from the payload it shipped."""
    c, cfg, params, fleet = _setup(name)
    patches, noise = fleet.images(2), fleet.noise(2)
    whole = ref.request(c, params, patches, fleet.tokens, 1, codec, noise)
    rest = ref.cloud(c, params, whole["wire"], 1, noise)
    assert set(rest) == set(whole) - {"wire"}
    for k, v in rest.items():
        assert torch.equal(v, whole[k])
