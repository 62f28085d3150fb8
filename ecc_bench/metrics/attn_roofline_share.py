"""attn_roofline_share (layer: kernels; moves actions_per_s): the least
time of the LLM blocks' causal attention of the traced steps over the
device time the trace gives the kernels that implement it.

The least time of one block's attention over a step's batch counts q, k,
v and o once each and the causal pairs' products
(``work.causal_attention``), against 989 TFLOP/s and 3.35 TB/s; each
traced step holds ``n_layers`` of them.  Kernel names attributed to the
operation: ``flash_attention``."""
from ecc_bench import work

PATTERN = r"flash_attention"


def read(r):
    t = r.trace
    if t is None or not t.steps:
        return None
    device_s = t.seconds(PATTERN)
    if device_s <= 0.0:
        return None
    c = r.config
    hd = c["head_dim"] or c["d_model"] // c["n_heads"]
    least = sum(work.least_seconds(*work.causal_attention(
        s.requests, r.seq, c["n_heads"], c["n_kv_heads"], hd))[0]
        for s in t.steps)
    return 100.0 * least * c["n_layers"] / device_s
