"""actions_per_s: every action returned in the window over the window's
seconds (host clock).  A step's window runs from the first step's inputs to
the last step's actions on the host; the last step is whole."""
from ecc_bench import stats


def read(r):
    return stats.rate(r.actions, r.window_s)
