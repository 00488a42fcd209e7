"""repro_torch.core — the paper's contribution as a composable library
(the port of `repro.core`).

Layers:
  * pim_model      — machine models (TPU v5e target; UPMEM/CPU/GPU
                     baselines), copied unchanged: model constants, not
                     measurements of the H100
  * bank_parallel  — the UPMEM bank-parallel execution model (`BankGrid`)
  * census         — FLOP/byte/op-mix census of a PyTorch program, traced
                     on fake tensors (the counterpart of `hlo_analysis`)
  * roofline       — the three-term roofline characterization engine
  * suitability    — Key-Takeaway-1/2/3 workload scoring
  * perf_model     — calibrated cross-system comparison (paper Fig. 4)
"""

from .bank_parallel import BANKS, BankGrid, assert_local
from .census import ProgramAnalysis, analyze_program, op_mix
from .perf_model import Comparison, Figure4, WorkloadCounts, compare
from .pim_model import (DPU_LOOP_OVERHEAD, DPU_OP_COST, MACHINES, TITAN_V,
                        TPU_V5E, UPMEM_2556, UPMEM_640, XEON_E3_1240,
                        DPUModel, Machine)
from .roofline import (RooflineReport, render_markdown_table,
                       roofline_from_analysis, roofline_of_fn,
                       what_would_move_it)
from .suitability import SuitabilityReport, score
