"""Workload suitability scoring — the paper's Key Takeaways 1-3 as code.

A copy of `repro.core.suitability`, kept in the port because the port
imports nothing of `repro`; it scores the census of `core.census`
(`ProgramAnalysis`, with `HloAnalysis`'s field names) unchanged.

Given a `ProgramAnalysis` of any workload (a PrIM kernel or an LM
train/prefill/decode step), score the three criteria the paper distills:

  KT1  memory-boundedness : operational intensity vs the machine balance
  KT2  op-mix simplicity  : fraction of simple (add/sub/bitwise/compare)
                            arithmetic vs mul/div/transcendental
  KT3  communication      : collective traffic per byte of local traffic

and produce the paper's verdict: a workload is PIM-suitable iff it is
memory-bound AND simple-op AND low-communication. The same scoring, run with
the TPU machine model, classifies which LM serving stage benefits from the
bank-parallel (weight-stationary, bandwidth-roof) execution path.
"""

from __future__ import annotations

import dataclasses

from .census import ProgramAnalysis, op_mix
from .pim_model import Machine, MACHINES


@dataclasses.dataclass
class SuitabilityReport:
    name: str
    machine: str
    operational_intensity: float      # flops / hbm byte
    machine_balance: float            # machine flops / byte
    memory_bound: bool                # KT1
    simple_frac: float
    complex_frac: float
    simple_ops: bool                  # KT2: <30% complex arithmetic
    comm_ratio: float                 # collective bytes / hbm bytes
    low_comm: bool                    # KT3: <5% of traffic is inter-bank
    pim_suitable: bool
    takeaways: list[str]


# paper-derived thresholds
COMPLEX_FRAC_THRESHOLD = 0.30
COMM_RATIO_THRESHOLD = 0.05


def score(analysis: ProgramAnalysis, *, name: str,
          machine: Machine | str = "upmem_2556") -> SuitabilityReport:
    m = MACHINES[machine] if isinstance(machine, str) else machine
    oi = analysis.flops / analysis.hbm_bytes if analysis.hbm_bytes else float("inf")
    mix = op_mix(analysis)
    comm = (analysis.collective_bytes / analysis.hbm_bytes
            if analysis.hbm_bytes else 0.0)

    memory_bound = oi < m.balance
    simple = mix["complex_frac"] < COMPLEX_FRAC_THRESHOLD
    low_comm = comm < COMM_RATIO_THRESHOLD
    takeaways = []
    takeaways.append(
        f"KT1: OI={oi:.3g} {'<' if memory_bound else '>='} balance "
        f"{m.balance:.3g} -> {'memory-bound (suitable)' if memory_bound else 'compute-bound'}")
    takeaways.append(
        f"KT2: complex-op fraction {mix['complex_frac']:.2f} -> "
        f"{'simple-op (suitable)' if simple else 'complex-op heavy'}")
    takeaways.append(
        f"KT3: inter-bank/local traffic {comm:.3g} -> "
        f"{'low-communication (suitable)' if low_comm else 'communication-heavy'}")
    return SuitabilityReport(
        name=name,
        machine=m.name,
        operational_intensity=oi,
        machine_balance=m.balance,
        memory_bound=memory_bound,
        simple_frac=mix["simple_frac"],
        complex_frac=mix["complex_frac"],
        simple_ops=simple,
        comm_ratio=comm,
        low_comm=low_comm,
        pim_suitable=memory_bound and simple and low_comm,
        takeaways=takeaways,
    )
