"""device_idle_share (layer: device; moves actions_per_s): one minus the
union of the device operations' intervals in the profiler's trace of the
traced steps, over the traced window."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
