"""Three-term roofline analysis of PyTorch programs.

A copy of `repro.core.roofline`, kept in the port because the port imports
nothing of `repro`. Implements the paper's characterization methodology
(Williams et al. roofline, as applied by Gomez-Luna et al. to the UPMEM
system) for one step of a program:

    compute term    = census FLOPs / (chips x peak FLOP/s)
    memory term     = census bytes / (chips x HBM bandwidth)
    collective term = coll_bytes   / (chips x link bandwidth)

All inputs come from `census.analyze_program` (one device's program) plus
the modelled machine constants in `pim_model`: the terms are the modelled
machine's (TPU v5e by default), not times of the card the port runs on.
The dominant term is the bottleneck; the "useful-compute ratio"
MODEL_FLOPS / census FLOPS catches recompute and sharding waste.
`roofline_of_fn` takes the place of the reference's
`roofline_of_compiled`: it counts a function on fake tensors instead of
a compiled XLA executable.
"""

from __future__ import annotations

import dataclasses
import json

from .census import ProgramAnalysis, analyze_program
from .pim_model import Machine, TPU_V5E


@dataclasses.dataclass
class RooflineReport:
    name: str
    machine: str
    n_chips: int
    # per-device raw quantities (from the SPMD module)
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    # the three terms, in seconds
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float            # analytic 6ND-style global count
    hlo_flops_global: float
    useful_compute_ratio: float   # model_flops / hlo_flops_global
    # achieved fraction of the dominant roof if the step ran at the
    # max(terms) bound (what fraction of roofline the step reaches if
    # perfectly overlapped: step_time = max(terms))
    roofline_fraction: float
    arithmetic_intensity: float   # flops/byte, per device
    collective_breakdown: dict
    # for memory-dominant steps (decode!): analytic minimum bytes the step
    # must stream (params + state, once) / bytes it actually streams —
    # 1.0 = bandwidth roof. 0 when the caller provides no model_bytes.
    memory_roof_fraction: float = 0.0
    model_bytes: float = 0.0
    note: str = ""

    def to_row(self) -> dict:
        return {
            "name": self.name,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_compute_ratio": self.useful_compute_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_roof_fraction": self.memory_roof_fraction,
            "arithmetic_intensity": self.arithmetic_intensity,
        }


def roofline_from_analysis(
    analysis: ProgramAnalysis,
    *,
    name: str,
    n_chips: int,
    model_flops: float,
    model_bytes: float = 0.0,
    machine: Machine = TPU_V5E,
    note: str = "",
) -> RooflineReport:
    compute_s = analysis.flops / machine.peak_flops
    memory_s = analysis.hbm_bytes / machine.hbm_bw
    collective_s = (analysis.collective_bytes / machine.link_bw
                    if machine.link_bw else 0.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    hlo_flops_global = analysis.flops * n_chips
    useful = model_flops / hlo_flops_global if hlo_flops_global else 0.0
    # if the step runs at max(terms) (perfect overlap), the fraction of the
    # compute roofline achieved on USEFUL flops is:
    step_time = max(terms.values())
    useful_flops_per_device = model_flops / n_chips
    roofline_fraction = (useful_flops_per_device / machine.peak_flops
                         / step_time if step_time else 0.0)
    return RooflineReport(
        name=name,
        machine=machine.name,
        n_chips=n_chips,
        flops_per_device=analysis.flops,
        hbm_bytes_per_device=analysis.hbm_bytes,
        collective_bytes_per_device=analysis.collective_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        hlo_flops_global=hlo_flops_global,
        useful_compute_ratio=useful,
        roofline_fraction=roofline_fraction,
        arithmetic_intensity=(analysis.flops / analysis.hbm_bytes
                              if analysis.hbm_bytes else 0.0),
        collective_breakdown=analysis.collective_breakdown,
        memory_roof_fraction=(model_bytes / n_chips / analysis.hbm_bytes
                              if model_bytes and analysis.hbm_bytes else 0.0),
        model_bytes=model_bytes,
        note=note,
    )


def roofline_of_fn(
    fn,
    *example_args,
    name: str,
    n_chips: int,
    model_flops: float,
    machine: Machine = TPU_V5E,
    note: str = "",
) -> tuple[RooflineReport, ProgramAnalysis]:
    """Census `fn(*example_args)` (on fake tensors: nothing runs on the
    card) and score it on `machine`."""
    analysis = analyze_program(fn, *example_args)
    report = roofline_from_analysis(
        analysis, name=name, n_chips=n_chips, model_flops=model_flops,
        machine=machine, note=note)
    return report, analysis


def what_would_move_it(report: RooflineReport) -> str:
    """One-sentence §Roofline guidance for the dominant term."""
    if report.dominant == "compute":
        if report.useful_compute_ratio < 0.6:
            return ("compute-bound with low useful ratio "
                    f"({report.useful_compute_ratio:.2f}): cut remat recompute "
                    "and sharding-replicated matmuls before anything else")
        return ("compute-bound at high useful ratio: only larger per-chip "
                "tiles / lower precision move this")
    if report.dominant == "memory":
        return ("memory-bound: fuse elementwise chains, keep weights/KV in "
                "bf16 or lower, and raise arithmetic intensity (larger batch "
                "per chip) — the PIM-suitability regime of the paper")
    return ("collective-bound: reshard to cut the largest collective "
            f"({max(report.collective_breakdown, key=report.collective_breakdown.get) if report.collective_breakdown else 'n/a'}), "
            "overlap collectives with compute, or move the traffic to a "
            "bank-local phase (paper Takeaway 3)")


def render_markdown_table(reports: list[RooflineReport]) -> str:
    hdr = ("| cell | dominant | compute (s) | memory (s) | collective (s) | "
           "AI (F/B) | useful | roofline frac | note |\n"
           "|---|---|---|---|---|---|---|---|---|")
    rows = []
    for r in reports:
        rows.append(
            f"| {r.name} | **{r.dominant}** | {r.compute_s:.4f} | "
            f"{r.memory_s:.4f} | {r.collective_s:.4f} | "
            f"{r.arithmetic_intensity:.1f} | {r.useful_compute_ratio:.2f} | "
            f"{r.roofline_fraction:.3f} | {r.note or what_would_move_it(r)} |")
    return "\n".join([hdr] + rows)


def dump_reports(reports: list[RooflineReport], path: str) -> None:
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(r) for r in reports], f, indent=1)
