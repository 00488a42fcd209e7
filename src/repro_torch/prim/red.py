"""RED — reduction (parallel primitives; int64 in the source, int32 as the
reference runs it with x64 off). Table I: sequential + strided, add,
barrier, inter-DPU communication (the cross-bank tree).

Phases: bank-local sum (one launch of the reduction kernel's int32 route a
bank) -> cross-bank tree reduction (through the host)."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = True
REF_N = 2**27


def make_inputs(n: int, gen, device=None):
    return {"x": randint(gen, -1000, 1000, (n,), device)}


def ref(x):
    return torch.sum(x, dtype=torch.int32)


def run_pim(grid: BankGrid, x):
    # phase 1: bank-local reduce
    local = grid.local(lambda xb: ops.reduction(xb, acc=torch.int32)[None])(x)
    # phase 2: cross-bank tree (the reduce exchange)
    total = grid.exchange_reduce(local, op="add")
    return total[0]


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="RED",
        ops={("add", "int64"): float(n)},
        bytes_streamed=8.0 * n,
        interbank_bytes=8.0 * 64,          # one scalar per bank, tiny
        flops_equiv=float(n),
        pim_suitable=SUITABLE,
    )
