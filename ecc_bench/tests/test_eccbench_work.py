"""The work counts against values worked out by hand for both cells."""
import json

import pytest

from ecc_bench import catalog, work


def _config(name):
    return json.loads((catalog.HERE / "configs" / f"{name}.json")
                      .read_text())["config"]


def test_openvla_action():
    c = _config("vla7b-vitl-detok")
    # ViT block: 2 * 256 * (4 + 12) * 1024^2 + 4 * 256^2 * 1024
    vit_block = 2 * 256 * 16 * 1024 ** 2 + 4 * 256 ** 2 * 1024
    assert vit_block == 8_858_370_048
    assert work.vit_flops(c) == 24 * vit_block + 2 * 256 * 1024 * 4096
    # LLM block over 273 positions: q, k, v, o and the SwiGLU MLP, and
    # 2 * 2 * 32 * 128 * 273 * 274 / 2 of causal attention
    block = 2 * 273 * (4 * 4096 ** 2 + 3 * 4096 * 11008) \
        + 2 * 32 * 128 * 273 * 274
    assert block == 111_109_619_712
    assert work.llm_block_flops(c, 273) == block
    assert work.head_flops(c) == 2 * 7 * 4096 * 32064 == 1_838_678_016
    assert work.action_flops(c, 17) == 3_772_094_873_600


def test_cogact_action():
    c = _config("vla7b-vitl-dit")
    block = 2 * 768 * 4608 + 8 * 16 * 768 ** 2 + 4 * 16 * 16 * 768 \
        + 4 * 16 * 768 * 3072
    assert block == 234_356_736
    step = 2 * 16 * 7 * 768 + 2 * 4096 * 768 + 2 * 64 * 768 + 12 * block \
        + 2 * 768 * 1536 + 2 * 16 * 768 * 7
    assert work.dit_flops(c) == 10 * step == 28_213_739_520
    assert work.action_flops(c, 17) == 3_798_469_935_104


def test_causal_attention_of_the_cells():
    flops, nbytes = work.causal_attention(16, 273, 32, 32, 128)
    assert flops == 9_804_447_744
    assert nbytes == 16 * 273 * 4 * 4096 * 2 == 143_130_624
    least, bound = work.least_seconds(flops, nbytes)
    assert bound == "bytes"
    assert least == pytest.approx(143_130_624 / 3.35e12)
    flops64, bytes64 = work.causal_attention(64, 273, 32, 32, 128)
    assert (flops64, bytes64) == (4 * flops, 4 * nbytes)


def test_codec_bytes_of_the_cells():
    n = 16 * 273 * 4096
    assert work.codec_bytes(16, 273, 4096, "int8") \
        == 2 * (2 * n + n + n // 32) == 108_466_176
    n = 64 * 273 * 4096
    assert work.codec_bytes(64, 273, 4096, "int4") \
        == 2 * (2 * n + n // 2 + n // 32) == 362_299_392


def test_least_seconds_flops_bound():
    t, bound = work.least_seconds(989e12, 1.0)
    assert (t, bound) == (1.0, "flops")
