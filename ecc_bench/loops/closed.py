"""The closed loop with no think time (``"loop": "closed"``): every client
sends its next request when its answer returns, so each step serves every
client as one batch, and the next step starts when the last one's answers
are on the host.  A loop module gives ``window(run, seconds, recorder)``:
the steps of the measured window, each offered to the comparison's
sample.  The window lasts ``seconds`` and holds at least the traffic's
``wire_steps`` steps, over which the wire bytes are counted."""
from __future__ import annotations

import time
from typing import List


def window(run, seconds: float, recorder=None) -> List:
    if run.cell.traffic.get("think_s", 0) != 0:
        raise ValueError("the closed loop has no think time, not "
                         f"{run.cell.traffic['think_s']} s")
    wire_steps = int(run.cell.traffic["wire_steps"])
    steps: List = []
    w0 = time.perf_counter()
    while (len(steps) < wire_steps or not steps
           or steps[-1].t1 - w0 < seconds):
        steps.append(run.step(recorder, keep=True))
    return steps
