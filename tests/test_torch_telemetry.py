"""The flight recorder in the port: ``repro_torch.core.telemetry`` and
``repro_torch.runtime.trace_export`` are the port's own copies of the
reference's, fed the same streams and held ``==`` to it (the port's
``Span`` has one field more, ``parent``, empty outside the executors'
stages); and both split executors of the port take a ``FlightRecorder``
and record the reference's two ``executor:*`` spans a request (the VLA
executor nests its stages in them), with outputs and payloads bit-equal
to a run without one."""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import telemetry as j_tel
from repro.models import build as j_build
from repro.runtime import partition as j_part
from repro.runtime import trace_export as j_trace
from repro_torch.configs import get_config
from repro_torch.core import telemetry as tel
from repro_torch.models import build
from repro_torch.runtime import trace_export
from repro_torch.runtime.partition import (LMSplitExecutor, SplitPlan,
                                           VLASplitExecutor)

from _torch_port_util import both_params


def _streams():
    rng = np.random.default_rng(0)
    return {
        "two_values": [0.0, 1.0],
        "lognormal": list(rng.lognormal(0.0, 1.5, 3000)),
        "ties": [float(v) for v in rng.integers(0, 5, 700)],
        "sorted": list(np.linspace(-3.0, 7.0, 513)),
        "one": [42.0],
        "heavy_tail": list(rng.pareto(1.2, 2000)),
    }


Q = (0.0, 1e-3, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 1.0)


@pytest.mark.parametrize("mc", [8, 16, 128])
@pytest.mark.parametrize("name", sorted(_streams()))
def test_quantile_sketch_equals_the_reference(name, mc):
    """The sketch the reference computes, whatever its accuracy: at
    ``[0.0, 1.0]``, ``mc = 16`` both give 0.0 at q = 0.25 (numpy's
    quantile is 0.25; see ROADMAP, known state of the reference)."""
    xs = _streams()[name]
    a, b = tel.QuantileSketch(mc), j_tel.QuantileSketch(mc)
    for i, x in enumerate(xs):
        a.add(x)
        b.add(x)
        if i % 97 == 0:                    # quantiles between the adds too
            assert a.quantile(0.5) == b.quantile(0.5)
    assert a.snapshot() == b.snapshot()
    assert [a.quantile(q) for q in Q] == [b.quantile(q) for q in Q]
    assert a._cent == b._cent and a.n_centroids == b.n_centroids
    if name == "two_values" and mc == 16:
        assert a.quantile(0.25) == 0.0
    c, d = tel.QuantileSketch(mc), j_tel.QuantileSketch(mc)
    c.extend(xs)
    d.extend(xs)
    assert c.snapshot() == d.snapshot()


def test_empty_sketch_and_reservoir_edges_equal_the_reference():
    assert tel.QuantileSketch().snapshot() == j_tel.QuantileSketch() \
        .snapshot() == {"n": 0}
    assert math.isnan(tel.QuantileSketch().quantile(0.5))
    assert math.isnan(tel.QuantileSketch().mean)
    for mod in (tel, j_tel):
        with pytest.raises(ValueError, match="cap"):
            mod.Reservoir(0)
    assert tel.QuantileSketch(3).max_centroids == 8


@pytest.mark.parametrize("cap,n,seed", [(1, 50, 0), (16, 10, 1),
                                        (16, 5000, 2), (100, 3000, 7)])
def test_reservoir_equals_the_reference(cap, n, seed):
    a, b = tel.Reservoir(cap, seed), j_tel.Reservoir(cap, seed)
    kept = [(a.offer(i), b.offer(i)) for i in range(n)]
    assert all(x == y for x, y in kept)
    assert a.items == b.items and a.n_seen == b.n_seen == n
    assert len(a) == len(b) == min(cap, n)


def _feed_registry(m):
    rng = np.random.default_rng(5)
    for i in range(600):
        m.inc(f"c{i % 3}")
        m.inc("weighted", 0.5 * i)
        m.set_gauge(f"g{i % 2}", rng.random())
        m.observe(f"h{i % 4}", float(rng.exponential(2.0)))
    return m.snapshot()


def test_metrics_registry_equals_the_reference():
    assert _feed_registry(tel.MetricsRegistry(32)) == \
        _feed_registry(j_tel.MetricsRegistry(32))


def _feed_drift(d):
    rng = np.random.default_rng(9)
    for i in range(400):
        pred = {k: float(rng.random()) for k in tel.DRIFT_STAGES}
        meas = {k: float(rng.random()) for k in tel.DRIFT_STAGES}
        if i % 3:
            pred["wire_bytes"] = meas["wire_bytes"] = float(i)
        if i % 5 == 0:
            del pred["queue_s"]
        d.join(pred, meas)
    d.n_pred_saturated = 3
    return d.summary()


def test_drift_audit_equals_the_reference():
    assert tel.DRIFT_STAGES == j_tel.DRIFT_STAGES
    assert tel.DRIFT_EXTRAS == j_tel.DRIFT_EXTRAS
    assert _feed_drift(tel.DriftAudit(64)) == _feed_drift(j_tel.DriftAudit(64))


def _feed_recorder(mod, mode, cap=50):
    """The same calls into either package's recorder: request groups with
    every optional stage, continuous-tier hooks, free spans."""
    r = mod.FlightRecorder(mode, cap=cap, sample_every=8, seed=3,
                           max_centroids=32)
    rng = np.random.default_rng(2)
    wanted = []
    for key in range(300):
        wanted.append(r.want(key))
        if not wanted[-1]:
            continue
        t = float(key) * 0.05
        st = [float(v) for v in rng.exponential(0.01, 6)]
        if key % 4 == 0:
            r.cont_open(key)
            r.cont_admit(key, st[3], t, 1e6 * st[0], "cloud1")
            if key % 8 == 0:
                r.cont_preempt(key, t + 0.001, "cloud1")
            cont = r.pop_cont(key)
            extra = cont["spans"]
        else:
            extra = ()
        r.record_request(
            req=key, lane=f"robot:{'openvla-7b' if key % 2 else 'cogact-7b'}",
            t0_s=t, edge_s=st[0], uplink_s=st[1] + st[4] + st[5],
            queue_s=st[2] if key % 3 else 0.0, service_s=st[3],
            down_s=st[4] if key % 5 == 0 else 0.0,
            total_s=sum(st[:4]), replica="cloud0" if key % 7 else None,
            enc_s=st[4] if key % 2 else 0.0, dec_s=st[5] if key % 2 else 0.0,
            pred={k: 0.01 for k in mod.DRIFT_STAGES} if key % 3 == 0
            else None,
            extra_spans=extra, outcome="ok" if key % 11 else "hedged",
            wire_bytes=1e4 if key % 2 else None,
            bubble_frac=0.1 if key % 6 == 0 else None)
        if key % 10 == 0:
            r.record_span(mod.Span("edge_fwd", "executor", t, 0.002,
                                   "executor:edge"))
    r.cont_admit(999, 0.1, 0.0, 1.0, "cloud0")       # never opened: no-op
    r.cont_preempt(999, 0.0, "cloud0")
    assert r.pop_cont(999) is None
    return r, wanted


REF_FIELDS = [f.name for f in dataclasses.fields(j_tel.Span)]


def _ref_tuple(span):
    """A span as the reference's fields; the port's one more, ``parent``,
    is empty outside the executors' stages."""
    assert getattr(span, "parent", "") == ""
    return tuple(getattr(span, f) for f in REF_FIELDS)


def _span_groups(r):
    return [[_ref_tuple(s) for s in g] for g in r.spans.items]


@pytest.mark.parametrize("mode,cap", [("full", 50), ("full", 10_000),
                                      ("sampled", 50)])
def test_flight_recorder_and_chrome_trace_equal_the_reference(mode, cap,
                                                              tmp_path):
    a, wa = _feed_recorder(tel, mode, cap)
    b, wb = _feed_recorder(j_tel, mode, cap)
    assert wa == wb
    assert a.snapshot() == b.snapshot()
    assert _span_groups(a) == _span_groups(b)
    ta, tb = trace_export.chrome_trace(a), j_trace.chrome_trace(b)
    assert ta == tb
    path = trace_export.export_chrome_trace(a, str(tmp_path / "t.trace.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(tb))
    for mod in (tel, j_tel):
        with pytest.raises(ValueError, match="telemetry mode"):
            mod.FlightRecorder("off")
    assert tel._HASH_KNUTH == j_tel._HASH_KNUTH


def test_cont_observer_forwards_like_the_reference():
    out = []
    for mod in (tel, j_tel):
        r = mod.FlightRecorder("full")
        obs = mod.ContObserver(r, "cloud2")
        r.cont_open(4)
        obs.on_admit(4, 0.25, 1.0, 3e6)
        obs.on_preempt(4, 1.5)
        st = r.pop_cont(4)
        out.append((st["queue_s"], st["replica"], st["preempts"],
                    [_ref_tuple(s) for s in st["spans"]],
                    r.snapshot()))
    assert out[0] == out[1]


# ------------------------------------------------------ executor spans
def _span_shape(rec, top=False):
    """What the reference's executor spans fix: one group a span, two a
    request, edge then cloud, on the executor lanes, time-ordered.  With
    ``top``, of the port's VLA executor, which nests its stages in them:
    the first span of each group."""
    if top:
        spans = [g[0] for g in rec.spans.items]
    else:
        spans = [s for g in rec.spans.items for s in g]
        assert all(len(g) == 1 for g in rec.spans.items)
    for e, c in zip(spans[::2], spans[1::2]):
        assert e.t0_s <= c.t0_s
        assert c.t0_s == pytest.approx(e.t0_s + e.dur_s, abs=1e-9)
        assert e.dur_s >= 0.0 and c.dur_s >= 0.0
    return [(s.name, s.cat, s.lane, s.req) for s in spans]


def _unnumbered(shape):
    """The reference's executor spans carry no run number."""
    return [(name, cat, lane) for name, cat, lane, _ in shape]


def _equal_outputs(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_outputs(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b, strict=True):
            _equal_outputs(x, y)
    else:
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def lm():
    cj = j_get_config("llama3.2-3b").reduced().replace(n_layers=4,
                                                       dtype="float32")
    ct = get_config("llama3.2-3b").reduced().replace(n_layers=4,
                                                     dtype="float32")
    pj, pt = both_params(j_build(cj), build(ct), seed=0)
    tokens = np.random.default_rng(4).integers(0, cj.vocab_size, (2, 9))
    return cj, ct, pj, pt, tokens


@pytest.mark.parametrize("two_pool", [False, True])
def test_lm_executor_spans_match_the_reference(lm, two_pool):
    cj, ct, pj, pt, tokens = lm
    kw = dict(pool2_start=3, pool2_end=4, codec2="int8") if two_pool else {}
    ex = LMSplitExecutor(ct, SplitPlan(1, 3, codec="int8", **kw),
                         device="cpu")
    jex = j_part.LMSplitExecutor(cj, j_part.SplitPlan(1, 3, codec="int8",
                                                      **kw))
    tt = torch.from_numpy(tokens)
    rec, jrec = tel.FlightRecorder("full"), j_tel.FlightRecorder("full")
    for split in (1, 2, 3):
        plain = ex.run(pt, tt, split, split2=3)
        traced = ex.run(pt, tt, split, split2=3, recorder=rec)
        _equal_outputs(plain, traced)
        jex.run(pj, jnp.asarray(tokens), split, split2=3, recorder=jrec)
    got = _span_shape(rec)
    assert got == _span_shape(jrec)
    assert got == [("edge_fwd", "executor", "executor:edge", -1),
                   ("cloud_fwd", "executor", "executor:cloud", -1)] * 3
    assert rec.snapshot() == jrec.snapshot()
    ta, tb = trace_export.chrome_trace(rec), j_trace.chrome_trace(jrec)
    strip = lambda t: [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                       for e in t["traceEvents"]]
    assert strip(ta) == strip(tb)


@pytest.fixture(scope="module")
def vla():
    cj = j_get_config("openvla-7b").reduced().replace(n_layers=4,
                                                      dtype="float32")
    ct = get_config("openvla-7b").reduced().replace(n_layers=4,
                                                    dtype="float32")
    pj, pt = both_params(j_build(cj), build(ct), seed=1)
    rng = np.random.default_rng(8)
    patches = rng.standard_normal((1, cj.n_patches, cj.vit_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cj.vocab_size, (1, 6))
    return cj, ct, pj, pt, patches, tokens


@pytest.mark.parametrize("two_pool", [False, True])
def test_vla_executor_spans_match_the_reference(vla, two_pool):
    cj, ct, pj, pt, patches, tokens = vla
    Lv, end = ct.vit_layers, ct.vit_layers + ct.n_layers
    kw = dict(pool2_start=end, pool2_end=end, codec2="int8") if two_pool \
        else {}
    ex = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3, codec="int8", **kw),
                          device="cpu")
    jex = j_part.VLASplitExecutor(
        cj, j_part.SplitPlan(Lv + 1, Lv + 3, codec="int8", **kw))
    tp, tt = torch.from_numpy(patches), torch.from_numpy(tokens)
    rec, jrec = tel.FlightRecorder("full"), j_tel.FlightRecorder("full")
    for split in (Lv + 1, Lv + 3):
        plain = ex.run(pt, tp, tt, split)
        traced = ex.run(pt, tp, tt, split, recorder=rec)
        _equal_outputs(plain, traced)
        jex.run(pj, jnp.asarray(patches), jnp.asarray(tokens), split,
                jax.random.PRNGKey(0), recorder=jrec)
    got = _span_shape(rec, top=True)
    assert _unnumbered(got) == _unnumbered(_span_shape(jrec)) == \
        [("edge_fwd", "executor", "executor:edge"),
         ("cloud_fwd", "executor", "executor:cloud")] * 2
    assert [req for *_, req in got] == [0, 0, 1, 1]
    assert rec.snapshot() == jrec.snapshot()


def test_streamed_runs_record_nothing_and_sampled_mode_keeps_every_span(vla):
    """``run_streamed`` takes no recorder, as in the reference; the
    executor offers its spans whatever the recorder's sampling mode."""
    cj, ct, pj, pt, patches, tokens = vla
    Lv = ct.vit_layers
    ex = VLASplitExecutor(ct, SplitPlan(Lv + 1, Lv + 3, codec="int8"),
                          device="cpu")
    tp, tt = torch.from_numpy(patches), torch.from_numpy(tokens)
    rec = tel.FlightRecorder("sampled", sample_every=1000)
    a, _ = ex.run(pt, tp, tt, Lv + 2, recorder=rec)
    s, _ = ex.run_streamed(pt, tp, tt, Lv + 2, n_chunks=3)
    assert torch.equal(a, s)
    assert rec.spans.n_seen == 2 and rec.n_recorded == 0
