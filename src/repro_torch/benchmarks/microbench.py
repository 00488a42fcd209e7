"""Paper Fig. 2 + Fig. 3: microbenchmark characterization (the port's twin
of the repository's `benchmarks/microbench.py`).

Fig. 2 — arithmetic throughput vs operational intensity:
  * UPMEM DPU curve from the calibrated instruction model (the paper's
    measured shape: compute-saturated from 0.25 op/byte, ~70 MOPS at
    1 add/int32, rising to the ~350 MOPS pipeline roof),
  * TPU v5e curve from the machine model (balance at ~240 FLOP/byte) —
    the Takeaway-1 INVERSION this framework is built around. Both curves
    are modelled machines (`core.pim_model`), not measurements,
  * the streaming kernel (`kernels.ops.stream_ops`, CUDA on the card,
    the plain PyTorch version on the CPU) validated against its plain
    version at every sweep point. The H100's own measured curve at
    PrIM's size comes from `chip_smoke.py` phase 6; the host-clock
    times printed here are of one small call each (the first includes
    the kernel build) and are no throughput.

Fig. 3 — per-op/dtype arithmetic throughput on one DPU (model), with the
paper's orderings asserted.
"""

from __future__ import annotations

import time

import torch

from ..core.pim_model import TPU_V5E, UPMEM_2556
from ..device import resolve_device
from ..kernels import ops, ref

SWEEP_N = 1 << 16          # the reference's validation size, int32
SWEEP_K = (1, 4, 16)


def fig2_rows():
    dpu = UPMEM_2556
    rows = []
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        oi = k / 4.0                               # int32: k adds / 4 bytes
        # DPU: pipeline model (4 bookkeeping instr + k adds per element)
        els = dpu.freq_hz / (4 + k)
        mops_dpu = k * els / 1e6
        # memory roof for reference
        roof_dpu = oi * dpu.mram_bw / 1e6
        # TPU v5e: same sweep against the machine model (VPU int roof
        # approximated at peak_flops/4 for 32-bit lanes)
        tpu_compute = TPU_V5E.peak_flops / 4
        tpu_mem = oi * TPU_V5E.hbm_bw
        gops_tpu = min(tpu_compute, tpu_mem) / 1e9
        rows.append({"oi_op_per_byte": oi, "dpu_mops": mops_dpu,
                     "dpu_mem_roof_mops": roof_dpu,
                     "dpu_bound": "compute" if mops_dpu < roof_dpu else "memory",
                     "tpu_gops": gops_tpu,
                     "tpu_bound": "compute" if tpu_compute < tpu_mem else "memory"})
    return rows


def fig3_rows():
    dpu = UPMEM_2556
    rows = []
    for dtype in ("int32", "int64", "float", "double"):
        for op in ("add", "sub", "mul", "div"):
            rows.append({"op": op, "dtype": dtype,
                         "mops_per_dpu": dpu.op_throughput(op, dtype) / 1e6})
    return rows


def run(report, device=None):
    """Fig. 2 and Fig. 3 tables with the reference's assertions, and the
    stream_ops validation sweep on `device` (default: the card)."""
    dev = resolve_device(device)
    report.section("Fig. 2 — throughput vs operational intensity "
                   "(DPU model + TPU machine model)")
    rows = fig2_rows()
    report.table(rows)
    # paper's claims, checked live
    knee = rows[0]
    assert knee["dpu_bound"] == "compute", "KT1: DPU compute-bound at OI=0.25"
    report.note("DPU is compute-bound from OI=0.25 op/B (paper KT1); "
                f"TPU stays memory-bound until ~{TPU_V5E.balance:.0f} "
                "FLOP/B — the inversion DESIGN.md §2 documents.")

    # kernel validation sweep
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 127, (SWEEP_N,), generator=gen,
                      dtype=torch.int32).to(dev)
    t_rows = []
    for k in SWEEP_K:
        t0 = time.perf_counter()
        got = ops.stream_ops(x, k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) * 1e6
        ok = bool(torch.equal(got, ref.microbench_stream(x, k)))
        t_rows.append({"ops_per_elem": k, "kernel_ok": ok,
                       "us_per_call_host": round(dt, 1)})
        assert ok
    where = (f"CUDA kernel on {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else f"plain PyTorch version on {dev}")
    report.section(f"Fig. 2 kernel validation ({where})")
    report.table(t_rows)

    report.section("Fig. 3 — arithmetic throughput per op/dtype "
                   "(one DPU, calibrated model)")
    rows3 = fig3_rows()
    report.table(rows3)
    by = {(r["op"], r["dtype"]): r["mops_per_dpu"] for r in rows3}
    assert by[("add", "int32")] > 5 * by[("mul", "int32")]
    assert by[("add", "int32")] > by[("add", "float")] > by[("add", "double")]
    report.note("orderings match paper Fig. 3: add/sub ~10x mul/div; "
                "int >> float >> double (KT2).")
