"""Arithmetic that the metric readers share: percentiles, the events of
the window and of the traced slice, the whole step's share of the
device's peaks, a kernel's share of its roofline and the idle share.

A reader gets the run's record (`run.Run`) and returns a number, or None
where its run holds nothing to read: then the metric is left out of the
result line, never reported as 0.
"""

from __future__ import annotations

import math
import re

# the kernels of each attention wrapper, by the names the profiler gives
KERNELS = {
    "flash": re.compile(r"\b(flash_kernel|flash_mma_kernel|empty_rows_kernel)\b"),
    "decode": re.compile(r"\b(decode_split_kernel|merge_kernel)\b"),
}


def percentile(values, q: float) -> float | None:
    """The q-th percentile by linear interpolation between the closest
    ranks (numpy's default); +inf counts as larger than any value."""
    v = sorted(values)
    if not v:
        return None
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]):
        return v[hi] if x > lo or math.isinf(v[lo]) else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def in_window(run, events):
    """Events (start, end, ...) that began and ended inside the window."""
    t0, t1 = run.window["t0"], run.window["t1"]
    return [e for e in events if e[0] >= t0 and e[1] <= t1]


def in_slice(run, events):
    """Events inside the traced slice."""
    t0, t1 = run.slice["t_start"], run.slice["t_end"]
    return [e for e in events if e[0] >= t0 and e[1] <= t1]


def open_loop_requests(run):
    """The requests due in the window (an open loop's)."""
    return [r for r in run.served if r.due_at is not None]


def window_seconds(run) -> float:
    """The window's host seconds, less those a traced run spent starting
    and stopping the profiler."""
    extra = run.slice["overhead_s"] if run.slice is not None else 0.0
    return run.window["seconds"] - extra


def mfu(run) -> float | None:
    """The window's model FLOPs (every prefill and decode step in it, by
    the benchmark's count) over its seconds, as % of the bf16 peak."""
    if run.peaks is None:
        return None
    c = run.counts
    flops = sum(c.prefill_flops(n) for _, _, n in in_window(run, run.prefills))
    flops += sum(c.decode_flops(ls) for _, _, ls in in_window(run, run.steps))
    if not flops:
        return None
    return 100.0 * flops / window_seconds(run) / run.peaks["bf16_flops"]


def hbm_share(run) -> float | None:
    """The window's HBM bytes (by the benchmark's count) over its seconds,
    as % of the HBM peak."""
    if run.peaks is None:
        return None
    c = run.counts
    nbytes = sum(c.prefill_bytes(n)
                 for _, _, n in in_window(run, run.prefills))
    nbytes += sum(c.decode_bytes(ls) for _, _, ls in in_window(run, run.steps))
    if not nbytes:
        return None
    return 100.0 * nbytes / window_seconds(run) / run.peaks["hbm_bytes_s"]


def roofline(run, kernel: str) -> float | None:
    """% of its roofline that attention kernel `kernel` ("flash" or
    "decode") reached in the traced slice: the least time the slice's
    calls could take (the larger of FLOPs at the bf16 peak and bytes at
    the HBM peak, call by call, once in each of the step's attention
    layers) over the device time of its kernels."""
    if run.slice is None or run.peaks is None:
        return None
    pat = KERNELS[kernel]
    spent = sum(s for n, s in run.slice["kernel_s"].items() if pat.search(n))
    if spent <= 0:
        return None
    c, pk, layers = run.counts, run.peaks, run.counts.attn_layers
    if kernel == "flash":
        calls = [(c.flash_flops(n), c.flash_bytes(n))
                 for _, _, n in in_slice(run, run.prefills)]
    else:
        calls = [(c.decode_attn_flops(ls), c.decode_attn_bytes(ls))
                 for _, _, ls in in_slice(run, run.steps) if ls]
    if not calls:
        return None
    least = layers * sum(max(f / pk["bf16_flops"], b / pk["hbm_bytes_s"])
                         for f, b in calls)
    return 100.0 * least / spent


def idle_share(run) -> float | None:
    """% of the traced slice in which no operation ran on the device (None
    where none ran: no device was traced)."""
    if (run.slice is None or run.slice["window_s"] <= 0
            or run.slice["busy_s"] <= 0):
        return None
    return 100.0 * (1.0 - run.slice["busy_s"] / run.slice["window_s"])
