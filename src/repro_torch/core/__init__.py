"""repro_torch.core — the ported part of `repro.core`.

Only `pim_model` is ported so far: the modelled machines (TPU v5e, Xeon,
Titan V, the UPMEM DPU and its systems), copied unchanged because they use
no framework. They are model constants, not measurements of the H100.
"""

from .pim_model import (DPU_LOOP_OVERHEAD, DPU_OP_COST, MACHINES, TITAN_V,
                        TPU_V5E, UPMEM_2556, UPMEM_640, XEON_E3_1240,
                        DPUModel, Machine)
