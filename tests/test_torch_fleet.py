"""``repro_torch.runtime.fleet`` and ``runtime.events`` are the port's own
copies of the reference's fleet simulator: on the feature matrix of
``tests/test_engine_parity.py`` (micro / continuous x plain / streamed x
single- / multi-cut, the default outage schedule), each engine's
``FleetReport`` of the port equals the reference's, field by field and
bit for bit.  The vectorised axis, open arrivals, the flight recorder and
the scene / delta axis are in ``tests/test_torch_fleet_engines.py``."""
import dataclasses
import itertools

import pytest

from repro.runtime import fleet as j_fleet
from repro_torch.runtime import events, fleet

from _torch_port_util import plain, to_port
from test_engine_parity import _cfg

MATRIX = list(itertools.product([False, True], repeat=3))


def _run_both(cfg_j):
    """One config through both packages: (port report, reference report)."""
    cfg_t = to_port(cfg_j)
    assert type(cfg_t) is fleet.FleetConfig
    return fleet.run_fleet(cfg_t), j_fleet.run_fleet(cfg_j)


def assert_reports_equal(rep_t, rep_j):
    assert type(rep_t) is fleet.FleetReport
    a, b = plain(rep_t), plain(rep_j)
    if a != b:
        diffs = [k for k in a[1] if a[1][k] != b[1][k]]
        raise AssertionError(f"port and reference differ on {diffs}")
    assert rep_t.summary() == rep_j.summary()


@pytest.mark.parametrize("engine", ["ticks", "events"])
@pytest.mark.parametrize("continuous,streamed,multicut", MATRIX)
def test_fleet_report_equals_the_reference(continuous, streamed, multicut,
                                           engine):
    cfg = dataclasses.replace(_cfg(continuous, streamed, multicut),
                              engine=engine)
    rep_t, rep_j = _run_both(cfg)
    assert_reports_equal(rep_t, rep_j)
    assert rep_t.n_requests > 0


@pytest.mark.parametrize("case", ["calm", "single_replica_outage",
                                  "leave_at_tick_zero", "same_tick_order"])
def test_replica_schedules_equal_the_reference(case):
    cfg = _cfg(chaos=False, continuous=case == "single_replica_outage")
    R = j_fleet.ReplicaEvent
    cfg = dataclasses.replace(cfg, **{
        "calm": {},
        "single_replica_outage": dict(
            n_replicas=1, replica_events=(R(20, "cloud0", "leave"),
                                          R(40, "cloud0", "join"))),
        "leave_at_tick_zero": dict(replica_events=(R(0, "cloud1", "leave"),)),
        "same_tick_order": dict(replica_events=(R(30, "cloud1", "join"),
                                                R(30, "cloud1", "leave"))),
    }[case])
    for engine in ("ticks", "events"):
        assert_reports_equal(*_run_both(dataclasses.replace(cfg,
                                                            engine=engine)))


def test_config_defaults_and_outage_schedule_equal_the_reference():
    assert plain(fleet.FleetConfig()) == plain(j_fleet.FleetConfig())
    for n in (1, 2, 3):
        cfg = j_fleet.FleetConfig(n_replicas=n, n_ticks=77)
        assert plain(fleet.outage_schedule(to_port(cfg))) == \
            plain(j_fleet.outage_schedule(cfg))
    assert sorted([fleet.ReplicaEvent(3, "b", "leave"),
                   fleet.ReplicaEvent(3, "b", "join")])[-1].kind == "leave"
    assert events.EventEngine.__module__ == "repro_torch.runtime.events"
