"""action_p95_ms: the nearest-rank 95th percentile over every request of
the window, from its inputs issued to the device (before the controller's
tick, where the cell has one) to its action on the host (host clock)."""
from ecc_bench import stats


def read(r):
    return stats.percentile(r.request_ms, 95)
