"""50th percentile of every gap between consecutive tokens of the
requests due in the window (host clock)."""

from bench.readers import open_loop_requests, percentile


def read(run):
    gaps = [b - a for r in open_loop_requests(run)
            for a, b in zip(r.token_times, r.token_times[1:])]
    p = percentile(gaps, 50)
    return None if p is None else 1e3 * p
