"""The port's fleet simulator against the reference's, beyond the
feature matrix of ``tests/test_torch_fleet.py``: the vectorised robot
phase of the event engine, open arrivals with SLO admission and
autoscaling, the flight recorder inside the fleet (the variants of
``tests/test_telemetry.py``, each engine and mode), its Chrome trace, and
the scene / temporal-delta axis.  Every report equals the reference's
field by field, including where the reference's two engines disagree
with each other (continuous batching with queue-aware planning and a KV
budget: ``kw2``)."""
import dataclasses

import pytest

from repro.core.codec import make_delta_codec
from repro.runtime import fleet as j_fleet
from repro.runtime import trace_export as j_trace
from repro_torch.runtime import fleet, trace_export

from _torch_port_util import plain, to_port
from test_engine_parity import _cfg
from test_telemetry import FLEET_VARIANTS, _cfg as _tel_cfg
from test_torch_fleet import _run_both, assert_reports_equal


@pytest.mark.parametrize("continuous,chaos", [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_vectorized_axis_equals_the_reference(continuous, chaos):
    cfg = _cfg(continuous=continuous, streamed=True, multicut=True,
               chaos=chaos)
    for vec in (False, True):
        assert_reports_equal(*_run_both(dataclasses.replace(
            cfg, engine="events", vectorized=vec)))


def test_open_arrivals_and_autoscale_equal_the_reference():
    cfg = dataclasses.replace(
        _cfg(continuous=True, streamed=True, multicut=True),
        engine="events", n_replicas=3,
        arrival_processes=(j_fleet.ArrivalProcess("users", rate_hz=12.0),
                           j_fleet.ArrivalProcess("night", kind="diurnal",
                                                  rate_hz=6.0, bw_bps=2e6)),
        slo_s=2.0, autoscale=True)
    for vec in (False, True):
        rep_t, rep_j = _run_both(dataclasses.replace(cfg, vectorized=vec))
        assert_reports_equal(rep_t, rep_j)
        assert rep_t.n_open_arrivals > 0 and rep_t.processes


@pytest.mark.parametrize("variant", range(len(FLEET_VARIANTS)),
                         ids=["kw0", "kw1", "kw2"])
def test_recorder_variants_equal_the_reference(variant):
    """Each (engine, mode) report equals the reference's, metrics
    included.  Whether the recorder-off reports of the two engines agree
    is taken from the reference as it stands: at ``kw2`` they differ in
    the same fields in both packages."""
    kw = FLEET_VARIANTS[variant]
    reps = {}
    for engine in ("ticks", "events"):
        for mode in ("off", "sampled", "full"):
            rep_t, rep_j = _run_both(_tel_cfg(mode, engine, **kw))
            assert_reports_equal(rep_t, rep_j)
            reps[engine, mode] = (rep_t, rep_j)
    diff = []
    for pkg in (0, 1):
        a, b = (plain(dataclasses.replace(reps[e, "off"][pkg], metrics=None))
                for e in ("ticks", "events"))
        diff.append(sorted(k for k in a[1] if a[1][k] != b[1][k]))
    assert diff[0] == diff[1]
    if variant == 2:
        assert "robots" in diff[0]
    full = reps["ticks", "full"][0].metrics
    assert full["n_recorded"] > reps["ticks", "sampled"][0].metrics[
        "n_recorded"] > 0


def test_fleet_chrome_trace_equals_the_reference():
    cfg = _tel_cfg("full", "events", continuous=True, telemetry_cap=64)
    sims = (fleet.FleetSimulator(to_port(cfg)),
            j_fleet.FleetSimulator(cfg))
    reps = [s.run() for s in sims]
    assert_reports_equal(*reps)
    ta = trace_export.chrome_trace(sims[0].recorder)
    tb = j_trace.chrome_trace(sims[1].recorder)
    assert ta == tb and len(ta["traceEvents"]) > 10


@pytest.mark.parametrize("budget,drift", [(None, 0), (1.2e6, 15)])
def test_scene_delta_axis_equals_the_reference(budget, drift):
    d = make_delta_codec(change_frac=0.02, name="delta")
    cfg = dataclasses.replace(
        _cfg(continuous=True, streamed=True, multicut=True),
        codecs=("identity", d, "int8"), scene="dynamic",
        delta_drift_every=drift, delta_ref_budget_bytes=budget)
    for engine, vec in (("ticks", True), ("events", False),
                        ("events", True)):
        rep_t, rep_j = _run_both(dataclasses.replace(cfg, engine=engine,
                                                     vectorized=vec))
        assert_reports_equal(rep_t, rep_j)
        assert rep_t.n_keyframes > 0 and rep_t.total_wire_bytes > 0
        if budget is not None:
            assert rep_t.n_ref_evictions > 0
        if drift:
            assert rep_t.n_delta_replans > 0


@pytest.mark.parametrize("scene", ["static", "slow", "dynamic"])
def test_scene_classes_with_delta_and_int4_equal_the_reference(scene):
    """The byte comparison of ``tests/test_codec.py`` (the delta codec
    against int4 on each scene class), in both packages."""
    d = make_delta_codec(change_frac=0.02, resync_every=16, name="delta")
    for codec in (d, "int4"):
        cfg = j_fleet.FleetConfig(n_robots=8, n_ticks=60, seed=3,
                                  archs=("openvla-7b",), continuous=True,
                                  codecs=("identity", codec), scene=scene)
        rep_t, rep_j = _run_both(cfg)
        assert_reports_equal(rep_t, rep_j)
        assert rep_t.total_wire_bytes > 0
