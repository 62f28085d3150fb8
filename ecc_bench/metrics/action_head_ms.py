"""action_head_ms (layer: executor, action head; moves actions_per_s): the
median over the window's steps of the executor's ``action_head`` span (the
final norm and ``detokenize``, or the whole DDIM loop of ``dit_sample``),
timed on the device by the program's flight recorder."""
from ecc_bench import stats


def read(r):
    spans = r.spans_ms.get("action_head")
    return stats.median(spans) if spans else None
