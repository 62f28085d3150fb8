"""wire_bytes_per_action: the bytes of every tensor in the payloads that
the window's first ``wire_steps`` steps shipped (the traffic states how
many), counted by the benchmark from what the executor returned, over
those steps' actions.  A fixed stretch of steps, so that a run that serves
the same ticks faster reads the same bytes: under a controller a step is
one tick of a fixed bandwidth trace, and a faster step fits more ticks,
and another mix of codecs, into the window."""


def read(r):
    if len(r.steps) < r.wire_steps:
        raise ValueError(f"the window holds {len(r.steps)} steps; the wire "
                         f"is counted over its first {r.wire_steps}")
    counted = r.steps[:r.wire_steps]
    return (sum(s.wire_bytes for s in counted)
            / sum(s.requests for s in counted))
