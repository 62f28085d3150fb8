"""moe_roofline_share (layer: kernels; moves actions_per_s): the least time
of the routed expert products of the traced steps over the device time the
trace gives the kernels that run them.

The least time of one MoE layer's routed products over a step's batch
counts the operations of ``moe_top_k`` SwiGLUs a token and the bytes of
every expert's weights and of the dispatched rows read and written once
(``work_moe.routed``), against 989 TFLOP/s and 3.35 TB/s; each traced step
holds every MoE layer once.  Kernel names attributed to the operation: the
library's grouped product (CUTLASS's ``GemmUniversal`` over a
``GroupProblemShape``, and the ``prepare_grouped_gemm_data`` kernel that
sets up its groups), which no other product of the program launches.  The
shared experts run as plain products, under names the trunk's other
products share, so they are left out of both sides."""
from ecc_bench import work, work_moe

PATTERN = r"GroupProblemShape|prepare_grouped_gemm"


def read(r):
    t = r.trace
    c = r.config
    if t is None or not t.steps or not c.get("n_experts"):
        return None
    device_s = t.seconds(PATTERN)
    if device_s <= 0.0:
        return None
    least = sum(work.least_seconds(*work_moe.routed(c, s.requests * r.seq))[0]
                for s in t.steps)
    return 100.0 * least * work_moe.moe_layers(c) / device_s
