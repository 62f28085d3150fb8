"""launches_per_action (layer: host dispatch; moves actions_per_s): kernel
launches in the profiler's trace of the traced steps (copies and fills not
counted) over the actions those steps returned."""


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    return len(r.trace.kernels) / sum(s.requests for s in r.trace.steps)
