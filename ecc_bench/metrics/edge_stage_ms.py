"""edge_stage_ms (layer: executor, edge stage; moves action_p95_ms): the
median over the window's steps of the executor's ``edge_fwd`` span (ViT,
embedding, the edge's LLM blocks and the encode), recorded by the
program's flight recorder, which times it on the device by CUDA events
and synchronises nothing."""
from ecc_bench import stats


def read(r):
    spans = r.spans_ms.get("edge_fwd")
    return stats.median(spans) if spans else None
