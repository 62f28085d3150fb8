"""moe_ffn_ms (layer: executor, MoE FFN; moves actions_per_s): the sum of
one step's ``moe`` spans (each MoE layer's FFN: routing, the dispatch, the
routed and shared expert products and the combine), timed on the device
by the program's flight recorder, median over the window's steps.  A step
runs every MoE layer once, edge and cloud together, so the window's spans
fall into consecutive runs of that many; nothing to read in a cell whose
trunk has no experts, or from a program that records no ``moe`` span."""
from ecc_bench import stats, work_moe


def read(r):
    spans = r.spans_ms.get("moe")
    if not spans or not r.config.get("n_experts"):
        return None
    n = work_moe.moe_layers(r.config)
    if len(spans) != n * len(r.steps):
        return None
    return stats.median([sum(spans[i:i + n])
                         for i in range(0, len(spans), n)])
