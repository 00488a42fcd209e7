"""VA — vector addition (dense linear algebra). Table I: sequential, add,
int32, no intra/inter-DPU sync. The canonical PIM-suitable workload.

Port: one bank-local phase, batched over the banks: one launch of the va
kernel (`kernels.ops.va`) over every bank's shard."""

from __future__ import annotations

from ..core.bank_parallel import BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = True
REF_N = 2**27          # ~2 GB working set (paper-scale strong-scaling input)


def make_inputs(n: int, gen, device=None):
    return {"a": randint(gen, -1000, 1000, (n,), device),
            "b": randint(gen, -1000, 1000, (n,), device)}


def ref(a, b):
    return a + b


def run_pim(grid: BankGrid, a, b):
    # one bank-local phase, no exchange
    return grid.bank_map(lambda x, y: ops.va(x.reshape(-1), y.reshape(-1))
                         .view(x.shape), batched=True)(a, b)


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="VA",
        ops={("add", "int32"): float(n)},
        bytes_streamed=3.0 * 4 * n,        # read a, b; write c
        interbank_bytes=0.0,
        flops_equiv=float(n),
        pim_suitable=SUITABLE,
    )
