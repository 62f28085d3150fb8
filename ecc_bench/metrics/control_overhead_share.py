"""control_overhead_share (layer: control; moves actions_per_s): the
controller's own measured overhead of each tick (``adjust_overhead_s``: the
LSTM's forecast and the adjustment), summed over the window, as a share of
the window's seconds.  Nothing to read in a cell without a controller."""


def read(r):
    ticks = [s.overhead_s for s in r.steps if s.overhead_s is not None]
    if not ticks:
        return None
    return 100.0 * sum(ticks) / r.window_s
