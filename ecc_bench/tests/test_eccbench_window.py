"""The wire bytes are counted over the window's first ``wire_steps`` steps,
so that a run that serves the same ticks faster reads the same bytes; the
closed loop's window holds at least that many steps."""
import time

import pytest

from ecc_bench import catalog, harness

DIT = "vla7b-vitl-dit.fleet64-ecc"
DETOK = "vla7b-vitl-detok.fleet32-int8"
# one request's payload at the cut: 273 positions of 4096 bf16 values, or
# their codes with a float32 scale per 128 columns of a row
PAYLOAD = {"": 273 * 4096 * 2,
           "int8": 273 * 4096 + 273 * 32 * 4,
           "int4": 273 * 4096 // 2 + 273 * 32 * 4}
# the window's ticks (from 1) on which the DiT cell's controller ships raw
# on its bandwidth trace; int4 on the others
RAW_TICKS = {8, 9, 10, 11, 45, 71, 75, 76, 77, 78}


class _Run:
    """A run whose steps follow a cell's codec pattern, each ``step_s``
    long on the host's clock as the steps report it."""

    def __init__(self, name: str, step_s: float):
        self.cell = catalog.cell(name)
        self.robots = int(self.cell.traffic["robots"])
        self.step_s = step_s
        self.ticks = 0
        self.t = None

    def codec(self, tick: int) -> str:
        if "plan" in self.cell.traffic:
            return self.cell.traffic["plan"]["codec"]
        return "" if tick in RAW_TICKS else "int4"

    def step(self, recorder=None, keep=False) -> harness.Step:
        self.ticks += 1
        if self.t is None:
            self.t = time.perf_counter()
        t0, self.t = self.t, self.t + self.step_s
        codec = self.codec(self.ticks)
        return harness.Step(self.ticks, t0, self.t, self.robots, 3, codec,
                            self.robots * PAYLOAD[codec], None)


def _window(name: str, step_s: float):
    run = _Run(name, step_s)
    return run.cell, run.cell.loop.window(run, 30.0)


def _wire(cell, steps) -> float:
    r = harness.Reading(cell.config["config"], 273, 0.0,
                        steps[-1].t1 - steps[0].t0, steps,
                        int(cell.traffic["wire_steps"]))
    return cell.metric_reader("wire_bytes_per_action").read(r)


@pytest.mark.parametrize("n", [40, 43, 45, 50])
def test_the_wire_reads_the_same_however_many_ticks_fit(n):
    """A window that fits ``n`` steps in its 30 s (the DiT cell fits 40 to
    45) reads (4 raw + 38 int4) / 42 steps; counted over every step it
    would read 758 284.8 at 40 and 776 533 at 45."""
    cell, steps = _window(DIT, 30.0 / (n - 0.5))
    assert len(steps) == max(n, 42)
    assert _wire(cell, steps) == 750_464


@pytest.mark.parametrize("name,value", [(DIT, 750_464), (DETOK, 1_153_152)])
def test_a_window_whose_steps_outrun_it_is_extended(name, value):
    cell, steps = _window(name, 31.0)
    assert len(steps) == int(cell.traffic["wire_steps"]) == 42
    assert steps[-1].t1 - steps[0].t0 == pytest.approx(42 * 31.0)
    assert _wire(cell, steps) == value


def test_the_wire_reader_refuses_a_short_window():
    cell, steps = _window(DIT, 31.0)
    with pytest.raises(ValueError, match="first 42"):
        _wire(cell, steps[:41])
