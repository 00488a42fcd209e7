"""Paper Table I + Fig. 4: the PrIM suite (the port's twin of the
repository's `benchmarks/prim_bench.py`).

Part 1 — Table I: run every workload bank-parallel (one bank per card, as
the reference's mesh gives one bank per device) against its oracle `ref`
at the reference's CPU-sized inputs, and report correctness and the host
wall-clock of one call each (the first includes the kernels' build on the
card). The card's times at PrIM's own sizes come from `chip_smoke.py`
phase 9.

Part 2 — Fig. 4: the calibrated cross-system comparison at paper-scale
reference inputs, with the paper's four KT4 anchors printed against the
model's geomeans. Every number of Part 2 belongs to the modelled UPMEM,
Xeon and Titan V systems (`core.perf_model`), none to the card.
"""

from __future__ import annotations

import time
import zlib

import torch

from .. import prim
from ..core.bank_parallel import BankGrid
from ..core.perf_model import Figure4, compare
from ..device import resolve_device

SIZES = {"NW": 128, "MLP": 128, "BFS": 256, "GEMV": 512}
SPMV_RTOL = 1e-5    # of each row's sum of |products|: the sum's order


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def agrees(name: str, got, want, inputs: dict) -> bool:
    """got equals want: as the same bits, SpMV within SPMV_RTOL of each
    row's magnitude (its 16 products may be summed in another order)."""
    got, want = _leaves(got), _leaves(want)
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        if name == "SpMV":
            x, cols, vals = inputs["x"], inputs["cols"], inputs["vals"]
            scale = (vals * x[cols.long()]).abs().sum(-1)
            if bool(((g - w).abs() > SPMV_RTOL * scale).any()):
                return False
        elif not torch.equal(g, w):
            return False
    return True


def fig4() -> Figure4:
    """The Fig. 4 comparison at each workload's paper-scale size."""
    return Figure4([compare(c) for c in prim.all_ref_counts()])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(report, device=None):
    """Table I on `device` (default: the card) and the modelled Fig. 4."""
    dev = resolve_device(device)
    grid = BankGrid(1, dev)
    report.section("Table I — PrIM workloads: bank-parallel run vs oracle "
                   f"({grid.n_banks} bank on {dev})")
    rows = []
    for name, mod in prim.WORKLOADS.items():
        n = SIZES.get(name, 4096)
        gen = torch.Generator(device=dev).manual_seed(zlib.crc32(
            name.encode()))
        inputs = prim.make_inputs(name, n, gen, dev)
        _sync(dev)
        t0 = time.perf_counter()
        got = mod.run_pim(grid, **inputs)
        _sync(dev)
        dt_pim = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        want = mod.ref(**inputs)
        _sync(dev)
        dt_ref = (time.perf_counter() - t0) * 1e6
        ok = agrees(name, got, want, inputs)
        rows.append({"benchmark": name, "n": n, "correct": ok,
                     "suitable(fig4)": mod.SUITABLE,
                     "us_per_call_pim": round(dt_pim, 0),
                     "us_per_call_ref": round(dt_ref, 0)})
        assert ok, name
    report.table(rows)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    report.note(f"wall-clock on the host clock ({where}; the first call "
                "includes the kernels' build); relative structure only — "
                "the cross-system numbers below are the calibrated model.")

    report.section("Fig. 4 — cross-system comparison (calibrated model of "
                   "the UPMEM, Xeon and Titan V systems, paper-scale inputs)")
    fig = fig4()
    report.raw(fig.render())
    report.note(f"anchors (modelled): 2556/CPU "
                f"{fig.avg_speedup_2556_vs_cpu:.1f}x (paper 23.2x), 640/CPU "
                f"{fig.avg_speedup_640_vs_cpu:.1f}x (paper 10.1x), "
                "2556/GPU suitable "
                f"{fig.avg_speedup_2556_vs_gpu_suitable:.2f}x (paper 2.54x), "
                "energy-eff 640 "
                f"{fig.avg_energy_eff_640_vs_cpu:.2f}x (paper 1.64x).")
