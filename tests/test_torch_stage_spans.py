"""The stages of the port's split executors and controller
(``core.telemetry.stage``): with a ``FlightRecorder``, one group a tier, the
tier's span followed by the stages nested in it; while ``torch.profiler``
records, FUNCTION-scope ``roboecc.*`` ranges nested the same way, recorder
or not; with neither, no clock, no event and no synchronisation.  Outputs
and payloads are bit-equal in every case.  On the card the spans are timed
by CUDA events and resolve without a synchronisation: a stand-in event
holds that logic here."""
import ast
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.core import telemetry as tel
from repro_torch.core.telemetry import FlightRecorder, stage
from repro_torch.models import build
from repro_torch.runtime import partition, trace_export
from repro_torch.runtime.partition import SplitPlan, VLASplitExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]

EDGE = ["edge_fwd", "vit", "edge_blocks", "encode"]
CLOUD = ["cloud_fwd", "decode", "cloud_blocks", "action_head"]
CLOUD_TWO_POOL = ["cloud_fwd", "decode", "cloud_blocks", "encode", "decode",
                  "edge_blocks", "action_head"]


def _setup(name):
    cfg = get_config(name).reduced().replace(n_layers=4, dtype="float32")
    params = build(cfg).init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(8)
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 6)))
    return cfg, params, patches, tokens


@pytest.fixture(scope="module", params=["openvla-7b", "cogact-7b"])
def vla(request):
    return _setup(request.param)


def _plan(cfg, two_pool):
    Lv = cfg.vit_layers
    kw = dict(pool2_start=Lv + 3, pool2_end=Lv + 4, codec2="int8") \
        if two_pool else {}
    return SplitPlan(Lv + 1, Lv + 3, codec="int8", **kw)


def _run(ex, vla, split, recorder=None):
    """One run; a DiT head draws the same noise each time (seed 0)."""
    cfg, params, patches, tokens = vla
    return ex.run(params, patches, tokens, split, split2=cfg.vit_layers + 3,
                  recorder=recorder)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _equal(x, y)
    else:
        assert torch.equal(a, b)


def _check_group(group, names, lane, req):
    top = group[0]
    assert [s.name for s in group] == names
    assert [s.parent for s in group] == [""] + [names[0]] * (len(names) - 1)
    assert {s.lane for s in group} == {lane}
    assert {s.cat for s in group} == {"executor"}
    assert {s.req for s in group} == {req}
    end = top.t0_s + top.dur_s
    for prev, s in zip(group[1:], group[2:]):
        # each stage starts where the one before it ended
        assert s.t0_s == pytest.approx(prev.t0_s + prev.dur_s, abs=1e-9)
    for s in group:
        assert s.dur_s >= 0.0
        assert top.t0_s <= s.t0_s and s.t0_s + s.dur_s <= end + 1e-9


@pytest.mark.parametrize("two_pool", [False, True])
def test_a_recorded_run_records_the_stage_tree(vla, two_pool):
    cfg, *_ = vla
    ex = VLASplitExecutor(cfg, _plan(cfg, two_pool), device="cpu")
    rec = FlightRecorder("full")
    Lv = cfg.vit_layers
    for split in (Lv + 1, Lv + 3):
        plain = _run(ex, vla, split)
        traced = _run(ex, vla, split, rec)
        _equal(plain, traced)
    groups = rec.spans.items
    assert len(groups) == 4
    for run, (edge, cloud) in enumerate(zip(groups[::2], groups[1::2])):
        _check_group(edge, EDGE, "executor:edge", run)
        _check_group(cloud, CLOUD_TWO_POOL if two_pool else CLOUD,
                     "executor:cloud", run)
        assert cloud[0].t0_s == pytest.approx(
            edge[0].t0_s + edge[0].dur_s, abs=1e-9)
    # the Chrome trace puts each stage on its tier's row, under its parent
    events = [e for e in trace_export.chrome_trace(rec)["traceEvents"]
              if e["ph"] == "X"]
    assert len(events) == sum(len(g) for g in groups)
    for e in events:
        if e["name"] in ("edge_fwd", "cloud_fwd"):
            assert "parent" not in e["args"]
        else:
            assert e["args"]["parent"] in ("edge_fwd", "cloud_fwd")


@pytest.mark.parametrize("two_pool", [False, True])
def test_outputs_are_bit_equal_with_a_recorder_and_under_the_profiler(
        vla, two_pool):
    cfg, *_ = vla
    ex = VLASplitExecutor(cfg, _plan(cfg, two_pool), device="cpu")
    split = cfg.vit_layers + 2
    plain = _run(ex, vla, split)
    _equal(plain, _run(ex, vla, split, FlightRecorder("full")))
    rec = FlightRecorder("full")
    with profile(activities=[ProfilerActivity.CPU]):
        _equal(plain, _run(ex, vla, split))
        _equal(plain, _run(ex, vla, split, rec))
    assert len(rec.spans.items) == 2


def _range_tree(prof):
    """Each ``roboecc.*`` range of the profiled host events, with the
    nearest ``roboecc.*`` range that encloses it."""
    out = []
    for e in prof.events():
        if not e.name.startswith(tel.RANGE_PREFIX):
            continue
        assert not e.is_user_annotation
        assert e.device_type == torch.autograd.DeviceType.CPU
        p = e.cpu_parent
        while p is not None and not p.name.startswith(tel.RANGE_PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(tel.RANGE_PREFIX):],
                    "" if p is None else p.name[len(tel.RANGE_PREFIX):]))
    return sorted(out)


def _tree(*groups):
    return sorted((n, "" if i == 0 else g[0])
                  for g in groups for i, n in enumerate(g))


@pytest.mark.parametrize("two_pool", [False, True])
def test_the_profiler_holds_the_tree_as_function_ranges(vla, two_pool):
    """No recorder: the ranges alone, on the host, FUNCTION-scope (no
    user annotation, so no device-side twin)."""
    cfg, *_ = vla
    ex = VLASplitExecutor(cfg, _plan(cfg, two_pool), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(ex, vla, cfg.vit_layers + 2)
    assert _range_tree(prof) == _tree(
        EDGE, CLOUD_TWO_POOL if two_pool else CLOUD)


def _controller():
    ctl = core.RoboECC(get_config("cogact-7b"), core.ORIN, core.A100,
                       workload=core.Workload(s_new=17, decode_steps=0),
                       cloud_budget_bytes=12e9,
                       thresholds=core.Thresholds(high=1.5e6, low=-1.5e6),
                       adjust_codecs=["identity", "int8", "int4"])
    trace = core.generate_trace(400, seed=1)
    ctl.fit_predictor(trace[:200], core.PredictorConfig(epochs=2, hidden=8),
                      device="cpu")
    net = core.NetworkSim(trace[200:])
    net.step(ctl.predictor.cfg.window)
    return ctl, net


def test_a_tick_holds_predict_and_adjust():
    ctl, net = _controller()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = ctl.tick(net)
    assert _range_tree(prof) == [("adjust", "tick"), ("predict", "tick"),
                                 ("tick", "")]
    assert r.adjust_overhead_s > 0.0 and r.decision is not None


def test_stages_off_read_no_clock_and_record_no_event(vla, monkeypatch):
    """No recorder and no profiler: neither the stages' clock nor a CUDA
    event is touched, by a run or by a tick."""
    cfg, *_ = vla
    ex = VLASplitExecutor(cfg, _plan(cfg, False), device="cpu")
    ctl, net = _controller()

    def refuse(*a, **k):
        raise AssertionError("a stage read a clock or made an event")
    monkeypatch.setattr(tel, "_now", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    ctl.tick(net)
    for name in ("perf_counter", "perf_counter_ns", "monotonic", "time"):
        monkeypatch.setattr(time, name, refuse)
    _run(ex, vla, cfg.vit_layers + 2)


def test_the_partition_module_never_synchronises():
    tree = ast.parse((ROOT / "src/repro_torch/runtime/partition.py")
                     .read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "synchronize" not in names and "perf_counter" not in names
    assert not hasattr(partition, "time")


# ----------------------------------------------- spans timed by CUDA events
class _Card:
    """A stand-in for the card's events: the k-th record (from 1) reads
    ``ms(k)`` on the device clock, tens of milliseconds apart as a
    request's stages are; an event completes when the test says so or when it
    is synchronised (with every event before it, in stream order); times
    between events in float32 milliseconds, as the card gives them."""

    def __init__(self):
        self.events, self.syncs = [], 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t, self.done = None, False

            def record(self, stream):
                assert stream == "stream"
                self.t = card.ms(len(card.events) + 1)
                card.events.append(self)

            def query(self):
                return self.done

            def synchronize(self):
                card.syncs += 1
                card.finish(len(card.events))

            def elapsed_time(self, end):
                assert self.done and end.done
                return float(np.float32(end.t - self.t))

        self.Event = Event

    @staticmethod
    def ms(k):
        return 41.5 * k + 1.1 * k * k

    def finish(self, n):
        for ev in self.events[:n]:
            ev.done = True


def _stages(rec):
    with stage("edge_fwd", rec, "executor:edge"):
        with stage("vit", rec):
            pass
        with stage("edge_blocks", rec):
            pass
    with stage("cloud_fwd", rec, "executor:cloud"):
        with stage("action_head", rec):
            pass


def test_event_timed_spans_wait_for_the_device_not_for_a_sync(monkeypatch):
    card = _Card()
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(tel, "_now", lambda: 100.0)
    rec = FlightRecorder("full")
    rec.open_run("cuda")
    _stages(rec)
    # edge_fwd's start, vit's, vit's end = edge_blocks' start,
    # edge_blocks' end, edge_fwd's end = cloud_fwd's start, action_head's
    # two, cloud_fwd's end
    assert len(card.events) == 8
    assert rec._spans.n_seen == 0 and card.syncs == 0
    card.finish(5)                  # the device passed edge_fwd's end
    rec.open_run("cuda")
    assert rec._spans.n_seen == 1 and card.syncs == 0
    _stages(rec)
    card.finish(8)                  # and the first run's cloud_fwd
    assert rec._spans.n_seen == 1
    groups = rec.spans.items        # keeps it, then waits for the second run
    assert card.syncs == 1 and len(groups) == 4
    assert [[s.req for s in g] for g in groups] == \
        [[0, 0, 0], [0, 0], [1, 1, 1], [1, 1]]
    (e, vit, blocks), (c, head) = groups[:2]
    # device times from the run's first event, anchored at the host time
    # when it was recorded
    ms = card.ms
    assert (e.t0_s, e.dur_s) == (100.0, pytest.approx((ms(5) - ms(1)) / 1e3))
    assert (vit.t0_s, vit.dur_s) == (
        pytest.approx(100.0 + (ms(2) - ms(1)) / 1e3),
        pytest.approx((ms(3) - ms(2)) / 1e3))
    # a boundary two stages share reads the same in both (float32 times
    # read apart would differ by some 1e-9 s)
    assert abs(blocks.t0_s - (vit.t0_s + vit.dur_s)) <= 1e-12
    assert abs(c.t0_s - (e.t0_s + e.dur_s)) <= 1e-12
    assert (head.parent, c.dur_s) == ("cloud_fwd",
                                      pytest.approx((ms(8) - ms(5)) / 1e3))
    assert groups[2][0].t0_s == 100.0


def test_a_stage_with_a_recorder_needs_an_open_run():
    with pytest.raises(RuntimeError, match="open_run"):
        with stage("edge_fwd", FlightRecorder("full"), "executor:edge"):
            pass
