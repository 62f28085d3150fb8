"""Whole runs of both cells at a tiny size on the CPU, past the harness's
look for a card: sound runs come out correct under the cells' own limits,
and a run whose timed path is broken underneath comes out not correct.
The control (the reference in float8) is read at a small size here; at
the cells' own size ``python3 -m ecc_bench.calibrate`` reads it on the
card (PERF.md gives its readings)."""
import pytest
import torch

from ecc_bench import calibrate, catalog, harness
from ecc_bench.tests import tiny

from repro_torch.models import vla as V
from repro_torch.runtime import partition

CELLS = ["vla7b-vitl-detok.fleet32-int8", "vla7b-vitl-dit.fleet64-ecc"]
SEED = 2 ** 31 + 77                     # larger than 32 signed bits


def _limited(name):
    """The tiny cell under the cell's own limits."""
    c = tiny.cell(name)
    c.limits = catalog.cell(name).limits
    return c


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, trace):
    cell = _limited(name)
    out = harness.run(cell, SEED, 0.2, bool(trace), "cpu")
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    want = cell.per_layer if trace else cell.end_to_end
    # on the CPU there is no device trace: every other reading exists
    assert set(out["metrics"]) == {m["name"] for m in want
                                   if m["source"] != "device_trace"}
    assert all(e["value"] > 0 for e in out["metrics"].values())


def test_the_same_seed_gives_the_same_inputs():
    cell = tiny.cell(CELLS[1])
    a = harness.Run(cell, SEED, "cpu")
    b = harness.Run(cell, SEED, "cpu")
    assert torch.equal(a.inputs.tokens, b.inputs.tokens)
    assert torch.equal(a.inputs.images(5), b.inputs.images(5))
    assert torch.equal(a.inputs.noise(5), b.inputs.noise(5))
    assert torch.equal(a.params["vit"]["proj"], b.params["vit"]["proj"])
    assert not torch.equal(a.inputs.images(5), a.inputs.images(6))


def _altered_bins(orig):
    def detokenize(logits):
        act = orig(logits).clone()
        bins = torch.round((act[0] + 1.0) * 127.5)
        act[0] = torch.remainder(bins + 128, 256) / 127.5 - 1.0
        return act
    return detokenize


def _altered_chunk(orig):
    def dit_sample(cfg, p, cognition, noise):
        out = orig(cfg, p, cognition, noise).clone()
        out[0] = -out[0]
        return out
    return dit_sample


def _one_chunk_off(orig):
    """One request's chunk off by a fifth of its norm: a fault in one
    answer, which a step's norm over all of them dilutes."""
    def dit_sample(cfg, p, cognition, noise):
        out = orig(cfg, p, cognition, noise).clone()
        out[-1] = out[-1] + 0.2 * out[-1].norm() * torch.ones_like(
            out[-1]) / out[-1].numel() ** 0.5
        return out
    return dit_sample


def _altered_payload(orig):
    def encode_activation(x, wire_codec):
        x = x.clone()
        x[0, : x.shape[1] // 2] = 0
        return orig(x, wire_codec)
    return encode_activation


FAULTS = [(CELLS[0], V, "detokenize", _altered_bins, "logit_gap"),
          (CELLS[1], V, "dit_sample", _altered_chunk, "action_err"),
          (CELLS[1], V, "dit_sample", _one_chunk_off, "chunk_err"),
          (CELLS[0], partition, "encode_activation", _altered_payload,
           "payload_err"),
          (CELLS[1], partition, "encode_activation", _altered_payload,
           "payload_err")]


@pytest.mark.parametrize("name,module,attr,fault,number", FAULTS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        monkeypatch, name, module, attr, fault, number):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    out = harness.run(_limited(name), SEED, 0.2, False, "cpu")
    assert out["correct"] is False
    e = out["check"][number]
    assert not e["value"] <= e["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_separates_at_a_small_size(name):
    """At a small size the float8 control reads at least three times what
    the program reads on every number, as it does at the cells' own size,
    where it also fails the limits (PERF.md)."""
    for r in calibrate.readings(tiny.cell(name), [11, 12, 13], 0.1, 3,
                                "cpu"):
        for k, v in r["program"].items():
            assert r["control"][k] >= 3 * v, (k, r)

