"""wire_bytes_per_action: the bytes of every tensor in the payloads the
window's requests shipped, counted by the benchmark from what the executor
returned, over the actions."""


def read(r):
    return sum(s.wire_bytes for s in r.steps) / r.actions
