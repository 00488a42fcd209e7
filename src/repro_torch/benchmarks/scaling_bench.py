"""Strong scaling with DPU count (full paper §5.2): the port's twin of the
repository's `benchmarks/scaling_bench.py`.

Fixed paper-scale inputs, system size swept 64 -> 2556 DPUs through the
calibrated model (`core.perf_model`, `core.pim_model`). Streaming
workloads scale near-linearly until the launch-overhead floor;
inter-DPU-bound workloads (BFS, NW, MLP) saturate early because the host
channel does not scale (Takeaway 3). Every number is the modelled UPMEM
system's; nothing runs on the card.
"""

from __future__ import annotations

import dataclasses

from .. import prim
from ..core.perf_model import time_on_pim
from ..core.pim_model import UPMEM_2556

DPUS = (64, 160, 320, 640, 1280, 2556)


def speedups() -> dict[str, list[float]]:
    """Workload -> its modelled speedup over 64 DPUs at each DPU count of
    DPUS, at the workload's paper-scale size (REF_N)."""
    out = {}
    for name, mod in prim.WORKLOADS.items():
        c = mod.counts_l(mod.REF_N) if name == "HST-L" \
            else mod.counts(mod.REF_N)
        times = [time_on_pim(c, dataclasses.replace(UPMEM_2556, n_dpus=n))
                 .total_s for n in DPUS]
        out[name] = [times[0] / t for t in times]
    return out


def table() -> list[dict]:
    """One row per PrIM workload: `speedups` rounded to 2 places, and the
    ideal at 2556 DPUs."""
    return [{"benchmark": name,
             **{f"{n}": round(x, 2) for n, x in zip(DPUS, xs)},
             "ideal_2556": round(2556 / 64, 1)}
            for name, xs in speedups().items()]


def run(report):
    report.section("Strong scaling vs #DPUs (calibrated model, "
                   "time normalized to 64 DPUs)")
    rows = table()
    report.table(rows)
    # the paper's qualitative split, asserted
    by = {r["benchmark"]: r["2556"] for r in rows}
    assert by["VA"] > 10.0, by["VA"]           # streaming: scales
    assert by["BFS"] < 3.0, by["BFS"]          # host-channel bound (KT3)
    assert by["NW"] < by["RED"]                # wavefront < local reduce
    report.note("streaming workloads scale with DPUs until the launch "
                "overhead floor; BFS/NW/MLP saturate early — their "
                "inter-DPU traffic rides the fixed host channel (KT3).")
