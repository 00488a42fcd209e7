"""95th percentile of time to first token over every request due in the
window: first token known on the host minus the time it was due. A
request that failed or never came counts as missing (+inf)."""

from bench.readers import open_loop_requests, percentile


def read(run):
    reqs = open_loop_requests(run)
    ttft = [r.token_times[0] - r.due_at if r.failed is None and r.token_times
            else float("inf") for r in reqs]
    p = percentile(ttft, 95)
    return None if p is None else 1e3 * p
