"""HST-S / HST-L — image histogram (uint32). Table I: sequential + random,
add, barrier (+mutex for L), inter-DPU communication (final merge).

HST-S: few bins — each UPMEM tasklet keeps a private WRAM histogram, merged
per DPU then across DPUs. HST-L: many bins — one shared per-DPU histogram
behind a mutex. The bank-local phase is one launch of the histogram kernel
a bank (its shared-memory histogram models both); the variants differ in
bin count and in the merge volume `counts()` charges (the paper's
distinction that matters at system level). Counts are returned as int32,
the bits of the reference's uint32 counts."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = True
REF_N = 2**26

BINS_S = 256
BINS_L = 4096
SHIFT = 12                      # values are < 2^12


def make_inputs(n: int, gen, device=None, bins: int = BINS_S):
    return {"x": randint(gen, 0, 1 << SHIFT, (n,), device)
            .view(torch.uint32), "bins": bins}


def ref(x, bins: int):
    """Counts of (x * bins) >> 12 in uint32 arithmetic; indices >= bins
    are dropped, as the reference's scatter drops them."""
    w = x.view(torch.int32).long() & 0xFFFFFFFF
    idx = (w * bins & 0xFFFFFFFF) >> SHIFT
    return torch.bincount(idx[idx < bins], minlength=bins).to(torch.int32)


def run_pim(grid: BankGrid, x, bins: int):
    # phase 1: bank-local histogram (tasklet-private -> per-bank merge)
    parts = grid.local(lambda xb: ops.histogram(xb, bins)[None])(x)
    # phase 2: cross-bank merge (through the host)
    merged = grid.exchange_reduce(parts, op="add")
    return merged[0]


def _counts(n: int, bins: int, name: str) -> WorkloadCounts:
    # HST-L's shared per-DPU histogram is mutex-guarded: ~2 extra
    # bookkeeping instructions per update (the paper's S/L gap)
    mutex_ops = 2.0 * n if bins > 2048 else 0.0
    return WorkloadCounts(
        name=name,
        ops={("add", "int32"): float(n) + mutex_ops,
             ("bitwise", "int32"): float(n)},
        bytes_streamed=4.0 * (n + bins),
        interbank_bytes=4.0 * bins * 8,       # tree-merged per rank
        flops_equiv=float(n),
        pim_suitable=SUITABLE,
        # GPU histogram atomics serialize hot bins: ~half effective bw
        bytes_gpu=2.0 * 4.0 * n,
    )


def counts(n: int) -> WorkloadCounts:
    return _counts(n, BINS_S, "HST-S")


def counts_l(n: int) -> WorkloadCounts:
    return _counts(n, BINS_L, "HST-L")
