"""Machine models: TPU v5e target + the paper's four measured systems.

A copy of `repro.core.pim_model`, kept in the port because the port
imports nothing of `repro`; the classes and constants are unchanged.
Every number here belongs to a modelled machine: none is a
measurement of the H100 the port runs on.

The UPMEM DPU model is an instruction-level analytic model calibrated against
the paper's published measurements (Figs. 2-4 of Gomez-Luna et al. 2021 and
the full arXiv:2105.03814 characterization):

  * DPU: 350 MHz in-order core, fine-grained multithreaded over tasklets;
    the 14-stage pipeline sustains ~1 instruction/cycle once >=11 tasklets
    are resident. Only integer add/sub/bitwise are native; 32-bit mul/div
    and all floating point are software routines (Takeaway 2).
  * MRAM streaming bandwidth ~630 MB/s/DPU sustained (700 MB/s theoretical).
  * No DPU<->DPU channel: inter-DPU traffic goes through the host over the
    DDR4 bus (Takeaway 3).

Validation targets (EXPERIMENTS.md §Paper-claims): 2556-DPU vs CPU ~ 23.2x,
640-DPU vs CPU ~ 10.1x, 2556-DPU vs Titan V ~ 2.54x on the 10 PIM-suitable
benchmarks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Machine:
    """A roofline machine: peak compute, memory bandwidth, interconnect."""
    name: str
    peak_flops: float          # per chip, FLOP/s (dominant dtype)
    hbm_bw: float              # per chip, bytes/s
    link_bw: float             # per chip, bytes/s over the interconnect
    mem_per_chip: float        # bytes
    n_chips: int = 1

    @property
    def balance(self) -> float:
        """Machine balance point, FLOP/byte: workloads below it are
        memory-bound (paper Takeaway 1, inverted for TPU — see DESIGN.md)."""
        return self.peak_flops / self.hbm_bw


# --- the target machine for the dry-run roofline (per-spec constants) ------
TPU_V5E = Machine(
    name="tpu_v5e",
    peak_flops=197e12,         # bf16
    hbm_bw=819e9,
    link_bw=50e9,              # per ICI link
    mem_per_chip=16 * 2**30,
)

# --- the paper's processor-centric baselines -------------------------------
# Intel Xeon E3-1240 v6 (4C/8T, 2ch DDR4-2400): ~38.4 GB/s theoretical,
# ~25 GB/s STREAM; PrIM-class kernels (mixed stride, short loops) sustain
# ~0.6 of STREAM -> 15 GB/s (calibrated against the paper's Fig. 4 anchors,
# see EXPERIMENTS.md §Paper-claims).
XEON_E3_1240 = Machine("xeon_e3_1240v6", 460e9, 15e9, 0.0, 64 * 2**30)

# NVIDIA Titan V: 652.8 GB/s HBM2 peak; PrIM-class kernels achieve ~0.5 of
# peak (calibrated, same anchors) -> 324 GB/s. 13.8 TFLOP/s f32.
TITAN_V = Machine("titan_v", 13.8e12, 324e9, 0.0, 12 * 2**30)


# --- the UPMEM DPU ----------------------------------------------------------

#: software-routine cost of one arithmetic op, in pipeline instruction slots.
#: Calibrated so that (a) INT32 add at 1 op/element sustains ~70 MOPS/DPU,
#: matching the paper's measured ~58-70 MOPS band, (b) mul/div are roughly an
#: order of magnitude slower (paper Fig. 3), and (c) floating point lands in
#: the measured single-digit-MOPS bands of the full characterization
#: (arXiv:2105.03814 Fig. 3: FADD ~4 MOPS, FMUL ~2 MOPS, FDIV <1 MOPS/DPU —
#: every FP op is a software routine on the int-only pipeline).
#: "transc" is a software libm routine (exp/log/tanh/rsqrt...): range
#: reduction + polynomial, i.e. a dozen-plus FP mul/adds.
#: The "int8" band is the native one: the DPU ALU is 32-bit but the HW
#: multiplier is 8x8 -> an int8 x int8 product is a single multiplier pass
#: (arXiv:2105.03814 measures INT8 mul at the add-band MOPS, vs 32 slots
#: for the int32 software ladder) — this band is what makes quantized
#: expert GEMMs PIM-suitable (KT2 flipped, DESIGN.md §15).
DPU_OP_COST = {
    ("add", "int8"): 1, ("sub", "int8"): 1,
    ("bitwise", "int8"): 1, ("compare", "int8"): 1,
    ("mul", "int8"): 2, ("div", "int8"): 16,
    ("add", "int32"): 1, ("sub", "int32"): 1,
    ("bitwise", "int32"): 1, ("bitwise", "int64"): 2,
    ("compare", "int32"): 1, ("compare", "int64"): 2,
    ("add", "int64"): 2, ("sub", "int64"): 2,
    ("mul", "int32"): 32, ("mul", "int64"): 64,     # 8x8 HW multiplier only
    ("div", "int32"): 56, ("div", "int64"): 110,
    ("add", "float"): 90, ("sub", "float"): 90,
    ("mul", "float"): 175, ("div", "float"): 700,
    ("add", "double"): 180, ("sub", "double"): 180,
    ("mul", "double"): 360, ("div", "double"): 1400,
    ("compare", "float"): 45, ("compare", "double"): 80,
    ("transc", "float"): 2500, ("transc", "double"): 5000,
}

#: bookkeeping instructions per streamed element (WRAM ld/st + loop control)
DPU_LOOP_OVERHEAD = 4


@dataclasses.dataclass(frozen=True)
class DPUModel:
    """Analytic model of one UPMEM DPU (and of a whole UPMEM system)."""
    n_dpus: int
    freq_hz: float = 350e6
    ipc: float = 1.0                    # with >=11 resident tasklets
    mram_bw: float = 630e6              # bytes/s/DPU, sustained streaming
    wram_bytes: int = 64 * 1024
    mram_bytes: int = 64 * 2**20
    # host<->MRAM aggregate bandwidth for parallel transfers (full paper,
    # 2556-DPU system); scaled linearly in ranks for smaller systems.
    host_to_dpu_bw: float = 6.68e9
    dpu_to_host_bw: float = 4.74e9
    # fixed cost per DPU program launch + host sync (measured ~ms in the
    # full paper; this is what makes strong scaling sublinear from 640 to
    # 2556 DPUs — the paper's 10.1x vs 23.2x ratio is NOT linear in DPUs)
    launch_overhead_s: float = 5e-4

    def op_throughput(self, op: str, dtype: str, ops_per_elem: float = 1.0) -> float:
        """Sustained MOPS/DPU for a streaming kernel doing `ops_per_elem`
        ops of (op, dtype) per element held in WRAM (paper Fig. 3 setup)."""
        cost = DPU_OP_COST.get((op, dtype), 32)
        instr_per_elem = DPU_LOOP_OVERHEAD + cost * ops_per_elem
        elems_per_s = self.freq_hz * self.ipc / instr_per_elem
        return elems_per_s * ops_per_elem

    def compute_time(self, op_counts: dict[tuple[str, str], float]) -> float:
        """Seconds for op_counts {(op,dtype): n_ops} on ONE DPU. The
        per-element bookkeeping (WRAM ld/st + loop control) is charged once
        per streamed element — approximated by the LARGEST op count, since
        ops on the same element share one loop iteration."""
        instr = 0.0
        for (op, dtype), n in op_counts.items():
            instr += DPU_OP_COST.get((op, dtype), 32) * n
        if op_counts:
            instr += DPU_LOOP_OVERHEAD * max(op_counts.values())
        return instr / (self.freq_hz * self.ipc)

    def mram_time(self, bytes_streamed: float) -> float:
        """Seconds to stream bytes through one DPU's MRAM."""
        return bytes_streamed / self.mram_bw

    def interdpu_time(self, bytes_exchanged: float) -> float:
        """Inter-DPU communication = retrieve + re-copy through the host
        (Takeaway 3: no direct channel). host_to_dpu_bw/dpu_to_host_bw are
        the SYSTEM's measured parallel-transfer bandwidths (each UPMEM
        server has its own host; they do not scale with DPU count)."""
        return (bytes_exchanged / self.dpu_to_host_bw
                + bytes_exchanged / self.host_to_dpu_bw)

    @property
    def aggregate_mram_bw(self) -> float:
        return self.mram_bw * self.n_dpus

    def as_machine(self) -> Machine:
        """Roofline view of the whole UPMEM system: 'compute' measured in
        int32-add-equivalent ops/s."""
        add_peak = self.op_throughput("add", "int32", ops_per_elem=64.0)
        return Machine(
            name=f"upmem_{self.n_dpus}dpu",
            peak_flops=add_peak * self.n_dpus,
            hbm_bw=self.aggregate_mram_bw,
            link_bw=self.dpu_to_host_bw,
            mem_per_chip=self.mram_bytes,
            n_chips=self.n_dpus,
        )


UPMEM_2556 = DPUModel(n_dpus=2556)
UPMEM_640 = DPUModel(n_dpus=640)

MACHINES = {
    "tpu_v5e": TPU_V5E,
    "xeon": XEON_E3_1240,
    "titan_v": TITAN_V,
    "upmem_2556": UPMEM_2556.as_machine(),
    "upmem_640": UPMEM_640.as_machine(),
}
