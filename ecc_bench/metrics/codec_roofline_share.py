"""codec_roofline_share (layer: kernels; moves actions_per_s): the least
time of the cut activation's quantize and dequantize in the traced steps
that shipped through a codec, over the device time the trace gives the
codec's kernels.  Bytes only (``work.codec_bytes``: the activation read and
written back, codes and float32 scales written and read), against
3.35 TB/s.  Kernel names attributed to the operation: ``quantize_int8``,
``quantize_int4`` and their ``dequantize_`` twins.  About 5 us of a step of
more than 100 ms, so it cannot visibly move actions_per_s: it keeps a
slower codec kernel from hiding."""
from ecc_bench import work

PATTERN = r"quantize_int[48]"


def read(r):
    t = r.trace
    if t is None:
        return None
    coded = [s for s in t.steps if s.codec]
    device_s = t.seconds(PATTERN)
    if not coded or device_s <= 0.0:
        return None
    least = sum(work.least_seconds(0.0, work.codec_bytes(
        s.requests, r.seq, r.config["d_model"], s.codec))[0] for s in coded)
    return 100.0 * least / device_s
