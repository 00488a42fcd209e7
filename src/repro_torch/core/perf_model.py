"""Calibrated cross-system performance/energy model (paper Fig. 4).

A copy of `repro.core.perf_model`, kept in the port because the port
imports nothing of `repro`; the classes, constants and arithmetic are
unchanged. Every time and energy it gives belongs to a modelled machine
(the UPMEM systems, the Xeon E3-1240, the Titan V of `pim_model`): none is
a measurement of the H100 the port runs on.

The paper's headline comparison is reproduced the way real-hardware
studies are reproduced offline: an analytic model over *workload counts*.

  * Workload counts (bytes streamed, op mix, inter-bank bytes) come from the
    PrIM implementations in `repro_torch.prim` — each workload exposes
    `counts(n)` derived from its phase structure.
  * Machine constants come from `pim_model` (paper + public spec sheets).

Validation targets (tests/test_torch_perf_model.py, EXPERIMENTS.md
§Paper-claims):
  - 2556-DPU vs CPU average speedup ~= 23.2x   (paper KT4)
  - 640-DPU  vs CPU average speedup ~= 10.1x   (paper KT4)
  - 2556-DPU vs GPU ~= 2.54x on the 10 PIM-suitable benchmarks (paper KT4)
  - 640-DPU energy efficiency vs CPU > 1 on suitable workloads
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from .pim_model import (DPUModel, Machine, TITAN_V, UPMEM_2556, UPMEM_640,
                        XEON_E3_1240)


@dataclasses.dataclass(frozen=True)
class WorkloadCounts:
    """Analytic counts for one PrIM workload at a given input size."""
    name: str
    ops: dict            # {(op, dtype): count} across the whole workload
    bytes_streamed: float  # bytes each system must move through memory
    interbank_bytes: float  # inter-DPU traffic (through the host on UPMEM)
    flops_equiv: float     # flop-equivalent count for CPU/GPU compute bound
    pim_suitable: bool     # paper Fig. 4 grouping (for validation only)
    # optional overrides when a system's traffic differs (e.g. CPU caches
    # a small LUT that PIM must re-stream)
    bytes_cpu: float | None = None
    bytes_gpu: float | None = None


# --- system power draw (W), calibrated against the paper's energy anchor
# (640-DPU system 1.64x more energy-efficient than the CPU, KT4);
# documented in DESIGN.md §2 and EXPERIMENTS.md §Paper-claims ----------------
POWER = {
    "xeon": 90.0,             # E3-1240 TDP 72W + DRAM
    "titan_v": 340.0,         # 250W TDP + host
    "upmem_640": 520.0,       # host + 10 PIM DIMMs (whole-server draw)
    "upmem_2556": 1250.0,     # host + 40 PIM DIMMs
}


@dataclasses.dataclass
class SystemTime:
    system: str
    compute_s: float
    memory_s: float
    comm_s: float
    total_s: float
    energy_j: float


def time_on_pim(counts: WorkloadCounts, dpu: DPUModel) -> SystemTime:
    per_dpu_ops = {k: v / dpu.n_dpus for k, v in counts.ops.items()}
    t_compute = dpu.compute_time(per_dpu_ops)
    t_mem = dpu.mram_time(counts.bytes_streamed / dpu.n_dpus)
    t_comm = dpu.interdpu_time(counts.interbank_bytes)
    # DPU arithmetic shares the pipeline with WRAM loads: not overlappable.
    # MRAM DMA overlaps with compute across tasklets -> max().
    total = max(t_compute, t_mem) + t_comm + dpu.launch_overhead_s
    name = f"upmem_{dpu.n_dpus}"
    key = "upmem_640" if dpu.n_dpus <= 640 else "upmem_2556"
    return SystemTime(name, t_compute, t_mem, t_comm, total,
                      total * POWER[key])


def time_on_host(counts: WorkloadCounts, machine: Machine,
                 power_key: str) -> SystemTime:
    nbytes = counts.bytes_streamed
    if power_key == "xeon" and counts.bytes_cpu is not None:
        nbytes = counts.bytes_cpu
    if power_key == "titan_v" and counts.bytes_gpu is not None:
        nbytes = counts.bytes_gpu
    t_compute = counts.flops_equiv / machine.peak_flops
    t_mem = nbytes / machine.hbm_bw
    total = max(t_compute, t_mem)
    return SystemTime(machine.name, t_compute, t_mem, 0.0, total,
                      total * POWER[power_key])


@dataclasses.dataclass
class Comparison:
    name: str
    pim_suitable: bool
    times: dict          # system -> SystemTime
    speedup_vs_cpu_2556: float
    speedup_vs_cpu_640: float
    speedup_vs_gpu_2556: float
    energy_eff_vs_cpu_640: float


def compare(counts: WorkloadCounts) -> Comparison:
    t_cpu = time_on_host(counts, XEON_E3_1240, "xeon")
    t_gpu = time_on_host(counts, TITAN_V, "titan_v")
    t_2556 = time_on_pim(counts, UPMEM_2556)
    t_640 = time_on_pim(counts, UPMEM_640)
    return Comparison(
        name=counts.name,
        pim_suitable=counts.pim_suitable,
        times={"cpu": t_cpu, "gpu": t_gpu, "upmem_2556": t_2556,
               "upmem_640": t_640},
        speedup_vs_cpu_2556=t_cpu.total_s / t_2556.total_s,
        speedup_vs_cpu_640=t_cpu.total_s / t_640.total_s,
        speedup_vs_gpu_2556=t_gpu.total_s / t_2556.total_s,
        energy_eff_vs_cpu_640=t_cpu.energy_j / t_640.energy_j,
    )


def geomean(xs: Iterable[float]) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 0.0


@dataclasses.dataclass
class Figure4:
    comparisons: list[Comparison]

    @property
    def avg_speedup_2556_vs_cpu(self) -> float:
        return geomean(c.speedup_vs_cpu_2556 for c in self.comparisons)

    @property
    def avg_speedup_640_vs_cpu(self) -> float:
        return geomean(c.speedup_vs_cpu_640 for c in self.comparisons)

    @property
    def avg_speedup_2556_vs_gpu_suitable(self) -> float:
        return geomean(c.speedup_vs_gpu_2556 for c in self.comparisons
                       if c.pim_suitable)

    @property
    def avg_energy_eff_640_vs_cpu(self) -> float:
        return geomean(c.energy_eff_vs_cpu_640 for c in self.comparisons)

    def render(self) -> str:
        lines = [
            "| benchmark | suitable | 2556-DPU/CPU | 640-DPU/CPU | "
            "2556-DPU/GPU | energy-eff 640/CPU |",
            "|---|---|---|---|---|---|",
        ]
        for c in self.comparisons:
            lines.append(
                f"| {c.name} | {'Y' if c.pim_suitable else 'n'} | "
                f"{c.speedup_vs_cpu_2556:8.2f}x | {c.speedup_vs_cpu_640:8.2f}x | "
                f"{c.speedup_vs_gpu_2556:8.2f}x | {c.energy_eff_vs_cpu_640:8.2f}x |")
        lines.append(
            f"| **geomean** |  | **{self.avg_speedup_2556_vs_cpu:.1f}x** "
            f"(paper: 23.2x) | **{self.avg_speedup_640_vs_cpu:.1f}x** "
            f"(paper: 10.1x) | **{self.avg_speedup_2556_vs_gpu_suitable:.2f}x** "
            f"suitable-only (paper: 2.54x) | "
            f"**{self.avg_energy_eff_640_vs_cpu:.2f}x** (paper: 1.64x) |")
        return "\n".join(lines)
