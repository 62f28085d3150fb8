"""cloud_stage_ms (layer: executor, cloud stage; moves action_p95_ms): the
median over the window's steps of the executor's ``cloud_fwd`` span
(decode, the cloud's LLM blocks, the final norm and the action head)."""
from ecc_bench import stats


def read(r):
    spans = r.spans_ms.get("cloud_fwd")
    return stats.median(spans) if spans else None
